"""The committed golden windows of the examples
(zang_tpu_torch/data/examples_golden_jax.npz, what chip_smoke.py holds the
card to) against the port's CPU render at each example's default seconds:
every channel < -90 dBFS RMS and each chunk's RMS within 10^(-90/20) of
the golden's; detuned on its stored warble trajectory. A file of its own
so that pytest-xdist's --dist loadfile gives these renders a worker of
their own.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from zang_tpu.oracle import examples as joex
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.host import examples as tex
from test_torch_examples import BUDGET_DB, SECONDS, SR, _rms_db

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "zang_tpu_torch", "data", "examples_golden_jax.npz")


@functools.lru_cache(maxsize=None)
def _golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("name", sorted(SECONDS))
def test_golden_windows_match_port_render(name):
    g = _golden()
    p = json.loads(str(g["params"]))["examples"][name]
    audio, sr = tex.EXAMPLES[name](seconds=p["seconds"], device="cpu")
    audio = audio.numpy()
    assert sr == p["sample_rate"] and audio.shape[0] == p["channels"]
    win = g[f"{name}_windows"]
    ours = np.stack([audio[:, o:o + win.shape[-1]] for o in g[f"{name}_offsets"]])
    for ch in range(audio.shape[0]):
        assert _rms_db(ours[:, ch], win[:, ch]) < BUDGET_DB
    c = p["chunk_size"]
    rms = np.stack([np.sqrt(np.mean(audio[:, i * c:(i + 1) * c].astype(np.float64) ** 2,
                                    axis=-1))
                    for i in range(g[f"{name}_chunk_rms"].shape[-1])], axis=-1)
    assert np.abs(rms - g[f"{name}_chunk_rms"]).max() < 10 ** (BUDGET_DB / 20)


def test_detuned_golden():
    """The detuned golden: the stored trajectory starts as the oracle
    twin's, its stored filter states are the port's own within 1e-5, and
    the port's cascade on it stays within the budget of the windows over
    the default 5 s."""
    g = _golden()
    p = json.loads(str(g["params"]))["examples"]["detuned"]
    warble, states = g["detuned_warble"], g["detuned_warble_state"]
    total, c = int(p["seconds"] * p["sample_rate"]), p["chunk_size"]
    assert warble.shape == (2, total) and warble.dtype == np.float32
    assert states.shape == (-(-total // c), 2, 2) and not states[0].any()
    np.testing.assert_array_equal(warble[:, :c], joex.detuned_warble(2, c, SR, c))
    ctx = trender.RenderCtx(SR, torch.arange(c, dtype=torch.int32), 0, c)
    nl, nb, _ = tex.DetunedInstrument.warble(torch.zeros(2), torch.zeros(2), ctx)
    assert np.abs(np.stack([nl.numpy(), nb.numpy()]) - states[1]).max() < 1e-5
    audio, sr = tex.ex_detuned(seconds=p["seconds"], device="cpu", warble_mul=warble)
    audio = audio.numpy()
    win = g["detuned_windows"]
    ours = np.stack([audio[:, o:o + win.shape[-1]] for o in g["detuned_offsets"]])
    for ch in range(2):
        assert _rms_db(ours[:, ch], win[:, ch]) < BUDGET_DB
