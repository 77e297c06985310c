"""The sharded cell (drivers/sharded.py, entries/nice_voices_x4.py) on the
CPU: its tiny run over four gloo ranks judged correct, and judged wrong
with its timed path broken (each fault planted in the spawned ranks by the
job's pickled build); its traced tiny run read by the cell's rank-side
metrics; the bfloat16 control against its limits; the reference's worker
split; its per-layer readers; and a program without the persistent
renderer refused before a rank starts.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import functools
import json
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.drivers.offline import compare
from benchmark.reference import renders as R
from benchmark.reference import texture_streams as T
from benchmark.tests import tiny
from benchmark.tests.tiny import parts, run_tiny

CELL = "nice_voices_x4.texture_65536"
SPANS = ("rank_spread_s_per_job", "shard_build_s_per_job", "rank_plan_programs_s_per_job",
         "rank_slice_s_per_job", "rank_parts_ms_per_chunk", "rank_post_ms_per_chunk")
NEW = ("allreduce_ms_per_chunk",) + SPANS
READ = {m: harness.load_module("metrics", m).read for m in NEW}
MS = 1_000_000


def _silence_rank_1(block, rank):
    """Rank 1's block with every voice silent (no notes)."""
    from zang_tpu_torch.core.timeline import SubvoiceTimeline

    if rank != 1:
        return block
    (inst, tls), = block
    return [(inst, [SubvoiceTimeline(starts=np.zeros((0,), np.int64),
                                     resets=np.zeros((0,), bool), params=[],
                                     total=tl.total) for tl in tls])]


def _state_unchanged():
    """Every chunk's state thrown away: each chunk starts from the first."""
    from zang_tpu_torch.graph import render

    real = render.Performance.render_chunk

    def stuck(self, state, chunk_progs, ctx, programs=None):
        _, out = real(self, state, chunk_progs, ctx, programs)
        return state, out

    render.Performance.render_chunk = stuck


def _sample_altered():
    """One sample of rank 0's s16 moved by 40 LSB where it is produced."""
    from zang_tpu_torch.core import mixdown

    real = mixdown.mixdown_s16

    def altered(mix, vol):
        out = real(mix, vol).clone()
        out.view(-1)[out.numel() // 3] += 40
        return out

    mixdown.mixdown_s16 = altered


def _half_the_voices():
    """Each rank's voices after the first half left out, the rest doubled
    (test_bench_faults.py's fault, planted in the ranks)."""
    from zang_tpu_torch.host import instruments as ti

    real = ti.NiceInstrument.render

    def half(self, state, prog, ctx):
        state, buf = real(self, state, prog, ctx)
        buf = buf.clone()
        buf[buf.shape[0] // 2:] = 0.0
        return state, buf * 2.0

    ti.NiceInstrument.render = half


# planted in a rank's process before its first build (the ranks are
# spawned: what this process patches does not reach them)
PLANT = {"state_unchanged": _state_unchanged, "sample_altered": _sample_altered,
         "half_the_voices": _half_the_voices}
PLANTED = set()


def faulty_build(fault, build, rank, world):
    """A RenderJob build: `build` with `fault` planted in this rank first."""
    if fault in PLANT and fault not in PLANTED:
        PLANTED.add(fault)
        PLANT[fault]()
    parts, sr, kw = build(rank, world)
    if fault == "one_rank_silenced":
        parts = _silence_rank_1(parts, rank)
    return parts, sr, kw


def with_fault(fault):
    """tiny.parts with the entry's RenderJob built through faulty_build."""
    import dataclasses

    real_parts = tiny.parts

    def faulted(name, **traffic):
        p = real_parts(name, **traffic)
        render_job = p["entry"].render_job

        def faulted_job(ctx, job, observe=None):
            rj = render_job(ctx, job, observe)
            return dataclasses.replace(rj, build=functools.partial(faulty_build, fault,
                                                                   rj.build))

        p["entry"].render_job = faulted_job
        return p

    return faulted


FAULTS = ("none", "one_rank_silenced", "state_unchanged", "sample_altered", "half_the_voices")


@pytest.mark.parametrize("fault", FAULTS)
def test_the_sharded_cell_on_the_cpu(fault, monkeypatch):
    """Four gloo ranks at the tiny size: a sound run is correct, and each
    fault planted in the ranks' timed path makes it wrong."""
    if fault != "none":
        monkeypatch.setattr(tiny, "parts", with_fault(fault))
    correct, line, res = run_tiny(CELL)
    assert correct is (fault == "none"), line
    assert res["counts"]["ranks"] == 4 and res["counts"]["jobs"] >= 1 and not res["failed"]


def test_the_bf16_control_fails_the_limits():
    p = parts(CELL)
    entry = p["entry"]
    ctx = entry.setup(p["config"], p["traffic"])
    job = entry.draw_job(ctx, np.random.default_rng(11))
    judged = p["limits"]["judged_frames"]
    ref, sl = entry.reference(ctx, job, judged=judged)
    ctl, _ = entry.reference(ctx, job, "bf16", judged=judged)
    assert ref.shape == (2, min(judged, entry.frames(ctx))) and sl[1].stop == ref.shape[1]
    assert not all(c["ok"] for c in compare(p["limits"], ctl, ref))


def test_a_program_without_the_persistent_renderer_fails_at_once(monkeypatch):
    import multiprocessing as mp

    from zang_tpu_torch.parallel import mesh

    monkeypatch.delattr(mesh, "ShardedRenderer")
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="no ShardedRenderer"):
        run_tiny(CELL)
    assert time.monotonic() - t < 5.0 and not mp.active_children()


# ---------------------------------------------------------------------------
# the reference


def test_the_frozen_voice_streams_are_the_ports():
    from zang_tpu_torch.host import configs

    for seed, voice in [(5, 0), (5, 7), (2 ** 31 - 2, 65535)]:
        a, b = T.voice_song(8.0, seed, voice), configs.texture_voice_song(8.0, seed, voice)
        assert [(e.t, e.note_id, e.params) for e in a] == \
            [(e.t, e.note_id, e.params) for e in b]


@pytest.mark.parametrize("workers", [2, 3])
def test_the_workers_split_sums_to_one_workers_render(workers):
    """Each worker renders only its own voices; their mixes, added in worker
    order, are the one worker's mix up to f32 rounding and its s16 within 1
    LSB."""
    V, args = 12, (1.0, 7, 20000)
    one = T.texture_streams_mix(V, *args)
    split = T.texture_streams_mix(V, *args, workers=workers)
    shares = [T.voices_mix((1.0, 7, lo, hi, 20000, 44100.0, "f32"))
              for lo, hi in T.split(V, workers)]
    assert [hi - lo for lo, hi in T.split(V, workers)] == [V // workers] * workers
    np.testing.assert_array_equal(split, sum(shares[1:], shares[0]))
    np.testing.assert_allclose(split, one, rtol=0, atol=1e-5 * np.abs(one).max())
    songs = [T.voice_song(1.0, 7, v) for v in range(V)]
    np.testing.assert_array_equal(one, R.texture_voice_mix(songs, 20000, 44100.0))
    a = T.echoes_s16(one, V, 20000, 44100.0, 15000, 0.25)
    b = T.echoes_s16(split, V, 20000, 44100.0, 15000, 0.25)
    assert np.abs(a.astype(np.int32)).max() > 1000
    assert np.abs(a.astype(np.int32) - b).max() <= 1


# ---------------------------------------------------------------------------
# the readers


def _rec(name, t0_ms, t1_ms):
    return (name, 0, 0, 0, 1, int(t0_ms * MS), int(t1_ms * MS))


def _job(profiled, builds, firsts):
    """A job's records from each rank r: its shard.build (ms) from 0, then
    its plan.programs of 2 + r ms and slice of 3 + r ms, then two chunks
    from its first chunk's start (ms), of parts 1 + r and 2 + r ms and post
    0.5 ms each."""
    return {"profiled": profiled, "world": len(builds), "records": {
        r: [_rec("shard.build", 0, b), _rec("plan.programs", b, b + 2 + r),
            _rec("slice", b + 2 + r, b + 5 + 2 * r),
            _rec("chunk", f, f + 5), _rec("chunk.parts", f, f + 1 + r),
            _rec("chunk.post", f + 4, f + 4.5),
            _rec("chunk", f + 5, f + 9), _rec("chunk.parts", f + 5, f + 7 + r),
            _rec("chunk.post", f + 8, f + 8.5)]
        for r, (b, f) in enumerate(zip(builds, firsts))}}


def _res(rank_jobs=None, reading=None, chunks=0):
    return {"rank_jobs": rank_jobs, "reading": reading,
            "counts": {"chunks_traced": chunks}}


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_reads_nothing_without_the_ranks_records(name):
    assert READ[name](_res()) is None
    assert READ[name](_res([], {"busy_s": 0.0}, 6)) is None
    # a job whose ranks did not all return their spans is no job of theirs
    partial = _job(False, [100, 120], [150, 170])
    partial["records"].pop(1)
    assert READ[name](_res([partial])) is None


@pytest.mark.parametrize("name, want, profiled_only", [
    ("allreduce_ms_per_chunk", 0.5, None),
    ("rank_spread_s_per_job", 0.030, 0.9),
    ("shard_build_s_per_job", 0.125, 0.9),
    ("rank_plan_programs_s_per_job", 0.005, 0.003),
    ("rank_slice_s_per_job", 0.006, 0.004),
    ("rank_parts_ms_per_chunk", 4.5, 2.5),
    ("rank_post_ms_per_chunk", 0.5, 0.5)])
def test_a_new_reader_reads_a_hand_built_record(name, want, profiled_only):
    """Two unprofiled jobs and a profiled one (left out while unprofiled
    ones are there): spreads 20 and 40 ms, slowest builds 110 and 140 ms;
    3 ms of NCCL kernels over 6 chunks; rank 3 the slowest at every stage
    (rank 1 in the profiled job)."""
    jobs = [_job(True, [900, 100], [0, 900]),
            _job(False, [100, 110, 90, 105], [150, 170, 160, 155]),
            _job(False, [140, 120, 130, 100], [200, 210, 240, 220])]
    res = _res(jobs, {"collective_s": 0.003}, 6)
    assert READ[name](res) == pytest.approx(want)
    # with only a profiled job, that job is read
    if profiled_only is not None:
        assert READ[name](_res(jobs[:1])) == pytest.approx(profiled_only)


def test_the_traced_tiny_run_reads_the_ranks_spans():
    """The traced tiny run: every rank-side span metric reads above 0, and
    rank 0's profiled job holds the SVF entry's harness spans (the calls
    svf_roofline.offline reads on the card)."""
    correct, line, res = run_tiny(CELL, trace=True)
    out = json.loads(line)
    assert correct, line
    for m in SPANS:
        v = out["metrics"][m]["value"]
        assert v > 0 and v == v, (m, v)
    assert any(c["name"].startswith("bench.svf:") for c in res["reading"]["calls"])
    assert res["counts"]["jobs_traced"] == 1 and res["counts"]["chunks_traced"] >= 1


def test_nccl_kernels_are_counted_inside_the_window():
    from benchmark import ranks, tracing

    ev = lambda n, s, e, d: {"name": n, "device": d, "start": s * MS, "end": e * MS}  # noqa: E731
    events = [ev(tracing.WINDOW, 10, 100, False),
              ev("ncclDevKernel_AllReduce_Sum_f32", 5, 12, True),
              ev("ncclKernel_AllReduce_RING_LL_Sum_float", 50, 51, True),
              ev("svf_onepass", 20, 40, True), ev("ncclDevKernel_X", 99, 130, True)]
    assert ranks.collective_s(events) == pytest.approx((2 + 1 + 1) * 1e-3)
    assert ranks.collective_s(events[1:]) == 0.0
