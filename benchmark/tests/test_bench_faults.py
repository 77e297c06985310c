"""The comparison that decides `correct`, shown to fail: each cell run
whole on the CPU at a tiny size (past the look for a card) with its timed
path broken underneath, and the bfloat16 control in the program's place.
Plus the whole cells on the card (marker `cuda`).

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers.offline import compare
from benchmark.tests.tiny import parts, run_tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
OFFLINE = [c for c in CELLS if harness.cell_parts(harness.manifest(), c)["traffic"]["driver"]
           == "offline"]
LIVE = [c for c in CELLS if c not in OFFLINE]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_tiny_run_is_correct(name):
    correct, line, _ = run_tiny(name)
    assert correct, line


def _state_unchanged(monkeypatch):
    """Every chunk's render returns the state it was given."""
    from zang_tpu_torch.graph import render

    real = render.Performance.render_chunk

    def stuck(self, state, chunk_progs, ctx, programs=None):
        _, out = real(self, state, chunk_progs, ctx, programs)
        return state, out

    monkeypatch.setattr(render.Performance, "render_chunk", stuck)


def _half_the_voices(monkeypatch):
    """Every instrument's voices after the first half left out, the rest
    doubled: the mean taken over the half that is left."""
    from zang_tpu_torch.host import instruments as ti

    for cls in (ti.NiceInstrument, ti.PMOscInstrument):
        real = cls.render

        def half(self, state, prog, ctx, real=real):
            state, buf = real(self, state, prog, ctx)
            if buf.dim() == 2 and buf.shape[0] > 1:
                buf = buf.clone()
                buf[buf.shape[0] // 2:] = 0.0
                buf = buf * 2.0
            return state, buf

        monkeypatch.setattr(cls, "render", half)


def _offline_sample_altered(monkeypatch):
    """One sample of each job's s16 output moved by 40 LSB where it is
    produced."""
    from zang_tpu_torch.core import mixdown

    real = mixdown.mixdown_s16

    def altered(mix, vol):
        out = real(mix, vol).clone()
        flat = out.view(-1)
        flat[flat.numel() // 3] += 40
        return out

    monkeypatch.setattr(mixdown, "mixdown_s16", altered)


def _live_sample_altered(monkeypatch):
    """One sample of every lane's block moved by 1e-3 where it is produced."""
    from zang_tpu_torch.serve import live

    real = live.LiveFleet.render_block_async

    def altered(self):
        out = real(self).clone()
        out[:, :, 100] += 1e-3
        return out

    monkeypatch.setattr(live.LiveFleet, "render_block_async", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_the_voices": _half_the_voices,
          "offline_sample_altered": _offline_sample_altered,
          "live_sample_altered": _live_sample_altered}


@pytest.mark.parametrize("name, fault", [
    (c, f) for c in CELLS for f in FAULTS
    if not (f == "offline_sample_altered" and c in LIVE)
    and not (f == "live_sample_altered" and c in OFFLINE)
    # a live lane's state lives in the fleet, past render_chunk
    and not (f == "state_unchanged" and c in LIVE)])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    correct, line, _ = run_tiny(name)
    assert not correct, line


def test_a_live_state_left_unchanged_is_not_correct(monkeypatch):
    """The fleet's device state handed back as it came into the block."""
    from zang_tpu_torch.host.live import tree_map
    from zang_tpu_torch.serve import live

    real = live.LiveFleet.render_block_async

    def stuck(self):
        copy = lambda t: t.clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
        before = None if self._states is None else tree_map(copy, self._states)
        out = real(self)
        if before is not None:
            self._states = before
        return out

    monkeypatch.setattr(live.LiveFleet, "render_block_async", stuck)
    correct, line, _ = run_tiny(LIVE[0])
    assert not correct, line


@pytest.mark.parametrize("name", CELLS)
def test_the_bf16_control_fails_the_limits(name):
    """The reference computed with every voice's signal in bfloat16, put
    in the program's place, fails one of the cell's numbers at least."""
    p = parts(name)
    entry, limits = p["entry"], p["limits"]
    ctx = entry.setup(p["config"], p["traffic"])
    rng = np.random.default_rng(11)
    if p["traffic"]["driver"] == "offline":
        job = entry.draw_job(ctx, rng)
        ref, _ = entry.reference(ctx, job)
        ctl, _ = entry.reference(ctx, job, "bf16")
    else:
        frames = 48000 * 2
        ev = entry.lane_events(ctx, rng, 1, frames)[0]
        ref = entry.lane_reference(ctx, ev, frames)
        ctl = entry.lane_reference(ctx, ev, frames, "bf16")
    checks = compare(limits, ctl, ref)
    assert not all(c["ok"] for c in checks), checks


# ---------------------------------------------------------------------------
# whole cells on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_on_the_card(card, name):
    """One short run of the cell as the driver runs it: correct, with every
    end-to-end metric of the cell."""
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                        "--seed", str(2 ** 32 + 7), "--seconds", "3", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], p.stderr[-3000:]
    want = {m["name"] for m in harness.cell_parts(harness.manifest(), name)["end_to_end"]}
    assert set(line["metrics"]) == want
