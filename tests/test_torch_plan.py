"""The port's host planners against zang_tpu's, bit for bit (host only).

The JAX package's planners live in modules that import jax, so the port
keeps numpy twins: chunkify, chunkify_tiled, plan_phase_segments, painter_program,
NiceInstrument's cutoff table, mixdown_s16 and deviation_dbfs. On the
song's first 10 s every array they make must equal the JAX package's; the
instruments' plans also on the whole song, on the texture of the offline
cell's build and on a four-card rank's block of the texture of voice
streams (the port plans a part as [V, K] arrays and one native envelope
call; the JAX package a voice at a time).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.core import mixdown as jmix
from zang_tpu.core import timeline as jtl
from zang_tpu.graph import fidelity as jfid
from zang_tpu.host import configs as jconfigs
from zang_tpu.host import instruments as jinst
from zang_tpu.host import song as jsong
from zang_tpu_torch import trace
from zang_tpu_torch.core import mixdown as tmix
from zang_tpu_torch.graph import fidelity as tfid
from zang_tpu_torch.graph.render import host_slices
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import song as tsong

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

TOTAL = 10 * 48000


@pytest.fixture(scope="module")
def perfs():
    return jsong.build_performance(TOTAL), tsong.build_performance(TOTAL)


def _leaves(prog, path=""):
    """(path, array) for every array of a program tree (SegProgram fields
    flattened)."""
    if hasattr(prog, "starts") and hasattr(prog, "values"):
        yield path + ".starts", prog.starts
        for k, v in prog.values.items():
            yield f"{path}.{k}", v
    elif isinstance(prog, dict):
        for k, v in prog.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(prog, (list, tuple)):
        for i, v in enumerate(prog):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(prog)


def _assert_same_arrays(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


PLAN_KEYS = ["phase", "env", "active_from"]
TEXTURE_SEED = 2400002101  # a seed of the size the benchmark draws


@pytest.mark.parametrize("part", [0, 1], ids=["pedal", "organs"])
@pytest.mark.parametrize("key", PLAN_KEYS)
def test_plans_equal(perfs, part, key):
    jp, tp = perfs
    _assert_same_arrays(jp.programs[part][key], tp.programs[part][key])


@pytest.fixture(scope="module")
def whole_song_perfs():
    total = int(jsong.NUM_SECONDS * jsong.SAMPLE_RATE)
    return jsong.build_performance(total), tsong.build_performance(total)


@pytest.mark.parametrize("part", [0, 1], ids=["pedal", "organs"])
@pytest.mark.parametrize("key", PLAN_KEYS)
def test_whole_song_plans_equal(whole_song_perfs, part, key):
    """The whole 385 s song: the pedal's pedal_freq and the merged organ's
    per-voice color through the array planners."""
    jp, tp = whole_song_perfs
    _assert_same_arrays(jp.programs[part][key], tp.programs[part][key])


@pytest.fixture(scope="module")
def texture_perfs():
    """The offline texture cell's build (build_poly_echo_performance) at 256
    voices, 8 s, 44.1 kHz, on one seed, and the native envelope calls and
    stage walks the port's plan made."""
    jp, jtotal = jconfigs.build_poly_echo_performance(256, 8.0, 44100.0, 15000, seed=TEXTURE_SEED)
    trace.reset_counters("plan.")
    tp, ttotal = tconfigs.build_poly_echo_performance(256, 8.0, 44100.0, 15000, seed=TEXTURE_SEED)
    counts = {k: v for k, v in trace.counters().items() if k.startswith("plan.")}
    assert jtotal == ttotal
    return jp, tp, counts


@pytest.mark.parametrize("key", PLAN_KEYS)
def test_texture_plans_equal(texture_perfs, key):
    jp, tp, _ = texture_perfs
    _assert_same_arrays(jp.programs[0][key], tp.programs[0][key])


def test_texture_plan_counters(texture_perfs):
    """One native envelope call for the part, every stage walk read from a
    table (no stage of the texture starts mid-flight)."""
    _, _, counts = texture_perfs
    assert counts["plan.envelope_calls"] == 1
    assert counts["plan.stage_table"] > 256 * 50
    assert counts["plan.stage_stepped"] == 0


@pytest.fixture(scope="module", params=[(64, 1), (62, 3)], ids=["rank1_of_4", "rank3_of_4_padded"])
def block_plans(request):
    """A four-card rank's block (host/configs.texture_block_build), planned
    by the port and by the JAX package's NiceInstrument on the same
    timelines; 62 voices leave the last rank 14 voices and 2 silent pads."""
    voices, rank = request.param
    parts, sr, _ = tconfigs.texture_block_build(voices, 8.0, 44100.0, 15000, TEXTURE_SEED,
                                                rank, 4)
    inst, tls = parts[0]
    assert len(tls) == 16
    assert sum(len(tl.starts) == 0 for tl in tls) == (2 if voices == 62 else 0)
    jtls = [jtl.SubvoiceTimeline(starts=tl.starts.copy(), resets=tl.resets.copy(),
                                 params=list(tl.params), total=tl.total) for tl in tls]
    return jinst.NiceInstrument(0.3).plan(jtls, sr), inst.plan(tls, sr)


@pytest.mark.parametrize("key", PLAN_KEYS)
def test_block_plans_equal(block_plans, key):
    jp, tp = block_plans
    _assert_same_arrays(jp[key], tp[key])


def test_organ_cutoff_table_covers_notes(perfs):
    cut = perfs[1].programs[1]["phase"].values["cut"]
    assert cut.dtype == np.float32 and (cut > 0).any() and (cut <= 1).all()


@pytest.mark.parametrize("chunk", [65536, 8192])
def test_chunk_xs_equal(perfs, chunk):
    jp, tp = perfs
    jxs, jn = jp.chunk_xs(TOTAL, chunk)
    txs, tn = host_slices(tp, TOTAL, chunk)
    assert jn == tn == -(-TOTAL // chunk)
    _assert_same_arrays(jxs, txs)


def test_chunk_xs_rejects_flat_format(perfs):
    """A chunk that is not a whole number of tiles, once refused, is sliced
    in the flat format, as the JAX package slices it: the same arrays."""
    jp, tp = perfs
    jxs, jn = jp.chunk_xs(TOTAL, 1000)
    txs, tn = tp.chunk_xs(TOTAL, 1000)
    assert jn == tn == -(-TOTAL // 1000)
    assert "starts" in txs[1]["phase"] and "tb" not in txs[1]["phase"]
    _assert_same_arrays(jxs, txs)


def _mix_input():
    rng = np.random.default_rng(9)
    mix = (rng.standard_normal(5000) * 2.5).astype(np.float32)
    mix[:8] = [np.nan, np.inf, -np.inf, 4.0, -4.0, 0.99999, -0.99999, -0.0]
    return mix


@pytest.mark.parametrize("vol", [0.25, 1.0])
def test_mixdown_s16_equal(vol):
    mix = _mix_input()
    ref = jmix.mixdown_s16_np(mix, vol)
    np.testing.assert_array_equal(tmix.mixdown_s16_np(mix, vol), ref)
    got = tmix.mixdown_s16(torch.from_numpy(mix), vol)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jmix.mixdown_s16(jnp.asarray(mix), vol)), ref)
    assert ref[0] == 0 and ref[1] == 32766 and ref[2] == -32767


def test_deviation_dbfs_equal():
    rng = np.random.default_rng(10)
    a = rng.standard_normal(3000).astype(np.float32)
    b = a + rng.standard_normal(3000).astype(np.float32) * 1e-5
    assert tfid.deviation_dbfs(a, b) == jfid.deviation_dbfs(a, b)
    s = (a * 1000).astype(np.int16)
    assert tfid.deviation_dbfs(s, s + 1) == jfid.deviation_dbfs(s, s + 1)


def test_compile_envelope_needs_native(monkeypatch, tmp_path):
    """No Python event or envelope walk in the port: a native compiler
    that cannot be built is an error, not a fallback."""
    from zang_tpu_torch.core import native
    from zang_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))  # nothing built yet
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)  # no g++
    with pytest.raises(RuntimeError, match="native host compiler"):
        tsong.build_performance(4800)
