"""Carry a zang_tpu Performance's programs and state across to the port.

The tests feed both packages identical programs this way; the port's own
planners are checked separately, array for array. This module does not
import jax: it reads the JAX objects' attributes (their programs are numpy).
"""

import numpy as np
import torch

from .device import require_device
from .graph.render import Performance
from .host import configs as tc
from .host import examples as te
from .host import instruments as ti
from .ops.sampler import SampleTable
from .ops.segprog import SegProgram


def _sampler(inst):
    t = inst.table
    out = tc.SamplerInstrument(
        loop=inst.loop, speed=inst.speed, distort=inst.distort,
        fake_sample_rate=inst.fake_sample_rate,
        table=SampleTable(np.array(t.data_f32, copy=True), t.num_samples,
                          t.byte_len, t.sample_rate))
    out.ratio = inst.ratio  # set by the JAX package's plan()
    return out


def _fmsynth(inst):
    out = ti.FMSynthInstrument()
    out.cfg = dict(inst.cfg)
    out._apply_cfg()
    return out


# the JAX package's instrument class name -> the port's instrument
_CONVERT = {
    "PMOscInstrument": lambda i: ti.PMOscInstrument(i.release_duration,
                                                    freq_fn=i.freq_fn),
    "NiceInstrument": lambda i: ti.NiceInstrument(np.array(i.color, copy=True),
                                                  freq_fn=i.freq_fn),
    "HardSquareInstrument": lambda i: ti.HardSquareInstrument(freq_fn=i.freq_fn),
    "FilteredSawtoothInstrument": lambda i: ti.FilteredSawtoothInstrument(
        freq_fn=i.freq_fn),
    "SquareWithEnvelope": lambda i: ti.SquareWithEnvelope(i.weird, freq_fn=i.freq_fn),
    "MousePMInstrument": lambda i: ti.MousePMInstrument(i.cfg["mode"],
                                                        controllers=i._controllers),
    "FMSynthInstrument": _fmsynth,
    "SamplerInstrument": _sampler,
    "_StereoNoise": lambda i: te.StereoNoise(),
    "_DetunedInstrument": lambda i: te.DetunedInstrument(),
}


def _instrument(inst):
    """The port's instrument for a JAX one. A subclass (the polyphony
    example's DecimatedNice) converts as the first class of its MRO that the
    port has."""
    for cls in type(inst).__mro__:
        if cls.__name__ in _CONVERT:
            return _CONVERT[cls.__name__](inst)
    raise ValueError(f"instrument {type(inst).__name__} is not ported yet")


def _program(prog):
    if type(prog).__name__ == "SegProgram":
        return SegProgram(starts=np.array(prog.starts, copy=True),
                          values={k: np.array(v, copy=True)
                                  for k, v in prog.values.items()})
    if isinstance(prog, dict):
        # "windowed" is the JAX sampler's TPU routing flag; the port has none
        return {k: _program(v) for k, v in prog.items() if k != "windowed"}
    if isinstance(prog, (list, tuple)):
        return type(prog)(_program(v) for v in prog)
    return np.array(prog, copy=True)


def from_jax_performance(perf, device, post=None) -> Performance:
    """The port's Performance for a zang_tpu.graph.render.Performance: the
    same instruments, timelines and (numpy) programs, unplanned again.

    A JAX post_fn is a closure over jax ops and cannot be converted: pass
    the port's chain as post=(post_fn, post_init_state) (for poly_echo,
    host.configs.poly_echo_post). Raises when the JAX performance has a
    post_fn and post is None."""
    require_device(device)
    if perf.post_fn is not None and post is None:
        raise ValueError("the JAX performance has a post_fn: pass the port's "
                         "post chain as post=(post_fn, post_init_state)")
    post_fn, post_init = post if post is not None else (None, None)
    parts = [(_instrument(inst), tls) for inst, tls in perf.parts]
    return Performance(parts, perf.sample_rate,
                       programs=[_program(p) for p in perf.programs],
                       num_channels=perf.num_channels, post_fn=post_fn,
                       post_init_state=post_init)


def from_jax_state(state, device):
    """A zang_tpu Performance state ((per-part states), post state) as the
    port's, on `device`: filter l/b (the detuned example's nl/nb too), the
    FM feedback carry (mod_fb1, mod_fb2), u32 phase, pan and decimator
    counters (as int64), delay buffers and echo l/b."""
    dev = require_device(device)
    states, post = state

    def conv(s):
        if isinstance(s, dict):
            return {k: conv(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(conv(v) for v in s)
        a = np.array(s)
        if a.dtype == np.uint32:  # u32 rides int64 (ops/scan.py)
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=dev)

    return [conv(s) for s in states], conv(post)
