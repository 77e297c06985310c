"""SVF state-variable filter (port of zang_tpu/ops/filters.py).

svf_filter_ref is the plain version: the reference's per-sample recurrence
(Filter.zig:96-151) is linear time-varying, so each sample's affine map is
probed on basis states and composed with an associative scan. It runs on
any device and is what the CPU uses.

svf_filter routes as the JAX package does (zang_tpu/ops/filters.py:121-145):
a CUDA tensor x [V, n] with a scalar res and a fixed type launches the
dense-cut kernel (ops/svf_cuda.py svf_dense_cuda); every other call ("mix",
"bypass", a tensor res), and every CPU tensor, takes svf_filter_ref. svf_filter_table takes the cutoff as per-tile
boundary tables (the tiled segment-program format): svf_filter_table_ref
for a CPU tensor; for a CUDA one the kernel that svf_table_route names: the
one-pass kernel (svf_onepass_cuda) at ONEPASS_V_MIN voices or more when a
time tile has at most ONEPASS_MAX_SLOTS slots, else the table-cut kernel
(svf_table_cuda), which takes any slot count.
svf_onepass_table_ref is the one-pass kernel's plain version, the sequential
recurrence as a loop over samples. No router has a fallback or a switch.
"""

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .scan import affine2_scan, as_f32
from .segprog import eval_tiled_chunk

Tensor = torch.Tensor

FCDCOFFSET = 3.814697265625e-6  # 2^-18, Filter.zig:8 (exact in f32)

# voices at which the one-pass kernel takes over from the two-phase one
# (zang_tpu/ops/pallas_svf.py ONEPASS_V_MIN, here on the true voice count)
ONEPASS_V_MIN = 4096
# the most slots a time tile may have for the one-pass kernel, which keeps a
# tile's slots in registers (csrc/svf_onepass.cu kRegSlots)
ONEPASS_MAX_SLOTS = 4

FILTER_MULS = {  # (l, b, h) output weights; bypass has none
    "bypass": None,
    "low_pass": (1.0, 0.0, 0.0),
    "band_pass": (0.0, 1.0, 0.0),
    "high_pass": (0.0, 0.0, 1.0),
    "notch": (1.0, 0.0, 1.0),
    "all_pass": (1.0, 1.0, 1.0),
}


def cutoff_from_frequency(frequency: float, sample_rate: float) -> np.float32:
    """Filter.zig:20-23 on the host, in f32: sqrt(clip(2 (1 - cos(pi f /
    sr)), 0, 1)). cos is taken in f64 and rounded to f32: numpy's f32 cos
    and XLA's differ from each other in the last place, and the rounded f64
    cos lands nearer XLA's (tests/test_torch_svf.py sweeps the audio band:
    under 1% of the cutoffs differ from the JAX package's, each by one ulp
    of cos)."""
    f = np.float32
    x = f(f(np.pi) * f(frequency) / f(sample_rate))
    v = f(2.0) * (f(1.0) - f(np.cos(np.float64(x))))
    return np.sqrt(np.clip(v, f(0.0), f(1.0)), dtype=f)


def _svf_step(l, b, inp, cut, res):
    """One output sample: the 2x oversampled update (Filter.zig:123-147),
    f32 in the reference's expression order. Returns (l', b', h)."""
    inv = inp + FCDCOFFSET
    l = l + cut * b - FCDCOFFSET
    b = b + cut * (inv - b * res - l)
    l = l + cut * b
    h = inv - b * res - l
    b = b + cut * h
    return l, b, h


def svf_filter_ref(
    l0: Tensor,
    b0: Tensor,
    x: Tensor,
    filter_type: str,
    cutoff: Union[Tensor, float],
    res: Union[Tensor, float],
    active: Optional[Tensor] = None,
    muls: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of svf_filter, on any device: run the SVF over
    x [..., n]. Returns (l_end, b_end, out [..., n]).

    cutoff/res: raw 0-1 params (clamped like the reference), broadcastable
    to x. active: bool [..., n]; inactive samples leave the state untouched
    and output 0. filter_type "mix" takes per-sample (l, b, h) output
    weights from muls (broadcastable to x): the recurrence does not depend
    on the type (Filter.zig:120-147), so a type that changes by note is a
    changing output mix; "bypass" copies the input."""
    if filter_type == "bypass":  # the state untouched
        return l0, b0, x if active is None else torch.where(active, x, torch.zeros_like(x))
    l_mul, b_mul, h_mul = muls if filter_type == "mix" else FILTER_MULS[filter_type]
    cut = torch.clamp(as_f32(cutoff, x), 0.0, 1.0).broadcast_to(x.shape)
    r = (1.0 - torch.clamp(as_f32(res, x), 0.0, 1.0)).broadcast_to(x.shape)

    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    # probe the affine step on basis states: state' = A s + c, h = Ah s + ch
    l_00, b_00, h_00 = _svf_step(zero, zero, x, cut, r)
    l_10, b_10, h_10 = _svf_step(one, zero, x, cut, r)
    l_01, b_01, h_01 = _svf_step(zero, one, x, cut, r)

    elems = [l_10 - l_00, l_01 - l_00, b_10 - b_00, b_01 - b_00, l_00, b_00]
    if active is not None:
        ident = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
        elems = [torch.where(active, e, as_f32(iv, x)) for e, iv in zip(elems, ident)]

    pre_l, pre_b, post_l, post_b = affine2_scan(tuple(elems), l0, b0)

    # output: post-step l and b, plus h from the pre-step state
    h_out = h_00 + (h_10 - h_00) * pre_l + (h_01 - h_00) * pre_b
    out = post_l * l_mul + post_b * b_mul + h_out * h_mul
    if active is not None:
        out = torch.where(active, out, torch.zeros_like(out))
    return post_l[..., -1], post_b[..., -1], out


def _is_scalar(v) -> bool:
    return (isinstance(v, (int, float, np.floating, np.integer))
            or (isinstance(v, Tensor) and v.dim() == 0))


def svf_filter(
    l0: Tensor,
    b0: Tensor,
    x: Tensor,
    filter_type: str,
    cutoff: Union[Tensor, float],
    res: Union[Tensor, float],
    active: Optional[Tensor] = None,
    muls: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The SVF over x [..., n] (see svf_filter_ref for the arguments): the
    dense-cut CUDA kernel for a CUDA x [V, n] with a scalar res and a fixed
    type; "mix", "bypass" (the input copied) and a tensor res take the
    plain version on any device, as in the JAX package."""
    if (x.device.type == "cuda" and x.dim() == 2 and _is_scalar(res)
            and filter_type not in ("mix", "bypass")):
        from .svf_cuda import svf_dense_cuda

        return svf_dense_cuda(l0, b0, x, filter_type, cutoff, res, active)
    return svf_filter_ref(l0, b0, x, filter_type, cutoff, res, active, muls)


def chunk_frames(t0, n: int, device) -> Tensor:
    """The frames t0 .. t0 + n - 1 as int32 [n] on device; t0 an int, or an
    int32 [1] tensor on device (read there, so a CUDA graph may capture
    this)."""
    frames = torch.arange(n, dtype=torch.int32, device=device)
    return frames + (t0 if isinstance(t0, Tensor) else int(t0))


def svf_filter_table_ref(
    l0: Tensor,
    b0: Tensor,
    x: Tensor,
    filter_type: str,
    tb: Tensor,
    cutv: Tensor,
    res: float,
    t0: int,
    active_from: Optional[Tensor] = None,
    donate_x: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of svf_filter_table with its signature, on any device:
    evaluate the table into a [V, n] cutoff and run svf_filter_ref (never
    the router, so the plain comparison on the card launches no kernel).
    It returns a tensor of its own and leaves x as it was, donated or not."""
    t_idx = chunk_frames(t0, x.shape[1], x.device)
    cut = eval_tiled_chunk({"tb": tb, "cut": cutv}, t_idx)["cut"]
    act = None
    if active_from is not None:
        act = t_idx[None, :] >= active_from.to(torch.int32)[:, None]
    return svf_filter_ref(l0, b0, x, filter_type, cut, res, act)


def svf_onepass_table_ref(
    l0: Tensor,
    b0: Tensor,
    x: Tensor,
    filter_type: str,
    tb: Tensor,
    cutv: Tensor,
    res: float,
    t0: int,
    active_from: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of the one-pass kernel (svf_cuda.svf_onepass_cuda), on
    any device: svf_filter_table's function as the sequential recurrence, a
    Python loop over the n samples on [V] tensors in the reference's f32
    order (no affine maps, no scan). Slow by design: about a dozen small ops
    a sample."""
    l_mul, b_mul, h_mul = FILTER_MULS[filter_type]
    n = x.shape[1]
    t_idx = chunk_frames(t0, n, x.device)
    cut = eval_tiled_chunk({"tb": tb, "cut": torch.clamp(cutv, 0.0, 1.0)}, t_idx)["cut"]
    r = 1.0 - torch.clamp(as_f32(res, x), 0.0, 1.0)
    xt, cut = x.t().contiguous(), cut.t().contiguous()  # [n, V]: a row a sample
    act = None
    if active_from is not None:
        act = t_idx[:, None] >= active_from.to(torch.int32)[None, :]
    l, b = l0, b0
    out = torch.empty_like(xt)
    for i in range(n):
        nl, nb, h = _svf_step(l, b, xt[i], cut[i], r)
        o = nl * l_mul + nb * b_mul + h * h_mul
        if act is None:
            l, b, out[i] = nl, nb, o
        else:
            l, b = torch.where(act[i], nl, l), torch.where(act[i], nb, b)
            out[i] = torch.where(act[i], o, torch.zeros_like(o))
    return l, b, out.t().contiguous()


def svf_table_route(V: int, S: int) -> str:
    """The CUDA kernel svf_filter_table takes for x [V, n] and tables of S
    slots a tile: "onepass" (svf_onepass_cuda) from ONEPASS_V_MIN voices on
    when S <= ONEPASS_MAX_SLOTS, else "table" (svf_table_cuda, any S)."""
    return "onepass" if V >= ONEPASS_V_MIN and S <= ONEPASS_MAX_SLOTS else "table"


def svf_filter_table(
    l0: Tensor,
    b0: Tensor,
    x: Tensor,
    filter_type: str,
    tb: Tensor,
    cutv: Tensor,
    res: float,
    t0: int,
    active_from: Optional[Tensor] = None,
    donate_x: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """SVF with a piecewise-constant cutoff given as per-tile boundary
    tables instead of a [V, n] array.

    x: [V, n] f32; tb/cutv: [V, nt, S] absolute boundary frames (slot 0
    always active) and raw cutoff per slot; t0: absolute frame of x[:, 0],
    an int or an int32 [1] tensor on x's device (the kernels read it there);
    active_from: [V] first-active frame. donate_x: the caller has no further
    use for x, so the output may be written over it (the one-pass kernel
    then filters in place; the other paths return a tensor of their own
    and leave x as it was, so a table-cut call at 16384 voices x 65,536
    frames holds a second 4 GiB buffer). Returns (l_end, b_end, out)."""
    if x.device.type == "cpu":
        return svf_filter_table_ref(l0, b0, x, filter_type, tb, cutv, res, t0, active_from)
    if svf_table_route(x.shape[0], tb.shape[-1]) == "onepass":
        from .svf_cuda import svf_onepass_cuda

        return svf_onepass_cuda(l0, b0, x, filter_type, tb, cutv, res, t0, active_from,
                                out=x if donate_x else None)
    from .svf_cuda import svf_table_cuda

    return svf_table_cuda(l0, b0, x, filter_type, tb, cutv, res, t0, active_from)
