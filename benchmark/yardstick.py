"""The table of peaks and the functions that count a kernel's bytes.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s of f32 outside the tensor cores. The
SVF is bound by its bytes at every shape the cells run, so its roofline is
its bytes over the memory rate.

Bytes are counted from the shapes at the port's SVF entries, each input
byte read once and each output byte written once, as PERF.md's kernel table
counts them (chip_smoke.py svf_table_bytes_ops, dense_bytes_ops).
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def svf_table_bytes(V: int, n: int, nt: int, S: int, has_active_from: bool) -> int:
    """ops/filters.svf_filter_table on x [V, n] with tables [V, nt, S]: x
    read and out written (f32), the boundary and cutoff tables (i32, f32),
    active_from (i32 [V]), l0/b0 in and l/b out (f32 [V])."""
    return 4 * (2 * V * n + 2 * V * nt * S + (V if has_active_from else 0) + 4 * V)


def svf_dense_bytes(V: int, n: int, dense_cut: bool, has_mask: bool) -> int:
    """ops/filters.svf_filter on x [V, n]: x read and out written (f32), a
    dense cutoff [V, n] (f32) and the activity mask [V, n] (bool) read,
    l0/b0 in and l/b out (f32 [V])."""
    return 4 * 2 * V * n + (4 * V * n if dense_cut else 0) + (V * n if has_mask else 0) + 16 * V


def bound_s(n_bytes: float) -> float:
    """The least seconds the card could take to move n_bytes."""
    return n_bytes / PEAK_BYTES_PER_S


def svf_call_bytes(entry: str, args, kwargs) -> int:
    """Bytes of one call of the port's SVF entry `entry` from its
    arguments (the signatures of ops/filters.py)."""
    names = ("l0", "b0", "x", "filter_type")
    a = dict(zip(names, args[:4]), **kwargs)
    V, n = (int(s) for s in a["x"].shape[-2:])
    if entry == "svf_filter_table":
        rest = dict(zip(("tb", "cutv", "res", "t0", "active_from"), args[4:9]), **kwargs)
        _, nt, S = (int(s) for s in rest["tb"].shape)
        return svf_table_bytes(V, n, nt, S, rest.get("active_from") is not None)
    if entry == "svf_filter":
        rest = dict(zip(("cutoff", "res", "active"), args[4:7]), **kwargs)
        cut = rest["cutoff"]
        dense = hasattr(cut, "shape") and len(cut.shape) >= 1 and int(cut.shape[-1]) == n
        return svf_dense_bytes(V, n, dense, rest.get("active") is not None)
    raise ValueError(f"no byte count for SVF entry {entry!r}")
