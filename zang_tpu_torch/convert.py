"""Carry a zang_tpu Performance's programs and state across to the port.

The tests feed both packages identical programs this way; the port's own
planners are checked separately, array for array. This module does not
import jax: it reads the JAX objects' attributes (their programs are numpy).
"""

import numpy as np
import torch

from .device import require_device
from .graph.render import Performance
from .host import instruments as ti
from .ops.segprog import SegProgram


def _instrument(inst):
    name = type(inst).__name__
    if name == "PMOscInstrument":
        return ti.PMOscInstrument(inst.release_duration, freq_fn=inst.freq_fn)
    if name == "NiceInstrument":
        return ti.NiceInstrument(np.array(inst.color, copy=True), freq_fn=inst.freq_fn)
    raise ValueError(f"instrument {name} is not ported yet")


def _program(prog):
    if type(prog).__name__ == "SegProgram":
        return SegProgram(starts=np.array(prog.starts, copy=True),
                          values={k: np.array(v, copy=True)
                                  for k, v in prog.values.items()})
    if isinstance(prog, dict):
        return {k: _program(v) for k, v in prog.items()}
    if isinstance(prog, (list, tuple)):
        return type(prog)(_program(v) for v in prog)
    return np.array(prog, copy=True)


def from_jax_performance(perf, device) -> Performance:
    """The port's Performance for a zang_tpu.graph.render.Performance: the
    same instruments, timelines and (numpy) programs, unplanned again.
    Only mono performances without a post effect are ported."""
    require_device(device)
    if perf.num_channels != 1 or perf.post_fn is not None:
        raise ValueError("only mono performances without post_fn are ported")
    parts = [(_instrument(inst), tls) for inst, tls in perf.parts]
    return Performance(parts, perf.sample_rate,
                       programs=[_program(p) for p in perf.programs])


def from_jax_state(state, device):
    """A zang_tpu Performance state ((per-part states, post state)) as the
    port's per-part state list: arrays become f32 tensors on `device`."""
    dev = require_device(device)
    states, _post = state

    def conv(s):
        if isinstance(s, dict):
            return {k: conv(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(conv(v) for v in s)
        return torch.as_tensor(np.array(s), device=dev)

    return [conv(s) for s in states]
