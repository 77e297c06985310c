"""The port's host planners against zang_tpu's, bit for bit (host only).

The JAX package's planners live in modules that import jax, so the port
keeps numpy twins: chunkify, chunkify_tiled, plan_phase_segments, painter_program,
NiceInstrument's cutoff table, mixdown_s16 and deviation_dbfs. On the
song's first 10 s every array they make must equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.core import mixdown as jmix
from zang_tpu.graph import fidelity as jfid
from zang_tpu.host import song as jsong
from zang_tpu_torch.core import mixdown as tmix
from zang_tpu_torch.graph import fidelity as tfid
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


@pytest.mark.parametrize("part", [0, 1], ids=["pedal", "organs"])
@pytest.mark.parametrize("key", ["phase", "env", "active_from"])
def test_plans_equal(perfs, part, key):
    jp, tp = perfs
    _assert_same_arrays(jp.programs[part][key], tp.programs[part][key])


def test_organ_cutoff_table_covers_notes(perfs):
    cut = perfs[1].programs[1]["phase"].values["cut"]
    assert cut.dtype == np.float32 and (cut > 0).any() and (cut <= 1).all()


@pytest.mark.parametrize("chunk", [65536, 8192])
def test_chunk_xs_equal(perfs, chunk):
    jp, tp = perfs
    jxs, jn = jp.chunk_xs(TOTAL, chunk)
    txs, tn = tp.chunk_xs(TOTAL, chunk)
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
