"""The twenty examples at a flat chunk (the flat chunk format of
tests/test_torch_flat.py), on the CPU: each through its public entry in
both packages at 3,000-frame chunks (not a whole number of 512-frame
tiles), every channel < -90 dBFS RMS from the JAX package's (the parity
budget). A file of its own so that pytest-xdist's --dist loadfile gives
these renders a worker of their own.
"""

import numpy as np
import pytest
import torch

from zang_tpu.graph import render as jrender
from zang_tpu.host import examples as jex
from zang_tpu.host import song as jsong
from zang_tpu.oracle import examples as joex
from zang_tpu_torch.host import examples as tex

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

BUDGET_DB = -90.0


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30)


# the examples at 0.5 s (three of them longer: shorter, their songs end before
# they start) with 3,000-frame chunks
# (the song example at 6,000)
EXAMPLE_SECONDS = {"mouse": 1.0, "play": 1.0, "polyphony": 2.5}
EXAMPLE_FLAT = 3000


@pytest.mark.parametrize("name", sorted(tex.EXAMPLES))
def test_example_at_a_flat_chunk(name, monkeypatch):
    """Each example through its public entry at a flat chunk. detuned on
    the JAX warble trajectory, as tests/test_torch_examples.py holds it (the
    warble feeds a phase counter)."""
    for mod in (jex, tex):
        monkeypatch.setattr(mod, "DEFAULT_CHUNK", EXAMPLE_FLAT)
    monkeypatch.setattr(tex, "SONG_CHUNK", 2 * EXAMPLE_FLAT)
    kw, seconds = {}, EXAMPLE_SECONDS.get(name, 0.5)
    if name == "song":  # the JAX example's chunk is fixed: render its song here
        total = int(seconds * jsong.SAMPLE_RATE)
        ja = np.asarray(jrender.render_performance(jsong.build_performance(total), total,
                                                   chunk_size=2 * EXAMPLE_FLAT))
    else:
        ja, sr = jex.EXAMPLES[name](seconds=seconds)
        ja = np.asarray(ja)
        if name == "detuned":
            kw["warble_mul"] = joex.detuned_warble(2, ja.shape[1], sr, EXAMPLE_FLAT)
    ta = tex.EXAMPLES[name](seconds=seconds, device="cpu", **kw)[0].numpy()
    assert ta.shape == ja.shape
    for ch in range(ja.shape[0]):
        db = _rms_db(ta[ch], ja[ch])
        print(f"{name} channel {ch} at a flat chunk: {db:.1f} dBFS")
        assert db < BUDGET_DB, (ch, db)
