"""Carry a zang_tpu Performance's programs, state and checkpoints, or a playing JAX
LiveSession, across to the port.

The tests feed both packages identical programs this way; the port's own
planners are checked separately, array for array. This module does not
import jax: it reads the JAX objects' attributes (their programs are numpy,
and a JAX array converts with np.asarray).
"""

import copy
import dataclasses
import importlib

import numpy as np
import torch

from .device import arrays_to_device, device_numpy, require_device
from .graph.render import Performance
from .host import configs as tc
from .host import examples as te
from .host import instruments as ti
from .ops.sampler import SampleTable
from .ops.segprog import SegProgram
from .tree import tree_map


def _sampler(inst):
    t = inst.table
    out = tc.SamplerInstrument(
        loop=inst.loop, speed=inst.speed, distort=inst.distort,
        fake_sample_rate=inst.fake_sample_rate,
        table=SampleTable(np.array(t.data_f32, copy=True), t.num_samples,
                          t.byte_len, t.sample_rate))
    out.ratio = inst.ratio  # set by the JAX package's plan()
    return out


def _script(inst):
    """The port's ScriptInstrument of the same source and module (compiled
    again by the port's front end, with the builtin packages)."""
    from .script.compile import compile_script
    from .script.torch_backend import ScriptInstrument

    src = inst.compiled.source
    return ScriptInstrument(compile_script(src.contents, filename=src.filename),
                            inst.module_name, param_map=dict(inst.param_map))


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
    "ScriptInstrument": _script,
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
    """A JAX part's program as numpy copies, its SegPrograms the port's.
    The key "windowed" of a part's program (the JAX sampler's TPU routing
    flag) goes: the port has none."""
    if isinstance(prog, dict):
        prog = {k: v for k, v in prog.items() if k != "windowed"}
    return tree_map(_program_leaf, prog)


def _program_leaf(v):
    if type(v).__name__ == "SegProgram":
        return SegProgram(starts=np.array(v.starts, copy=True),
                          values={k: np.array(a, copy=True) for k, a in v.values.items()})
    return np.array(v, copy=True)


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
        return tree_map(lambda a: torch.as_tensor(a, device=dev), _device_numpy(s))

    return [conv(s) for s in states], conv(post)


def from_jax_checkpoint(path: str, perf: Performance, device="cuda"):
    """(chunk_index, state, audio) of a checkpoint that
    zang_tpu.graph.checkpoint wrote, for the port's Performance of the same
    piece (from_jax_performance's, or the port's own plan of it): the JAX
    leaves, in its pytree order, mapped onto the port's state on `device`
    (u32 counters as int64). Raises when the leaves do not fit that state
    (another piece, or another instrument set). render_resumable(perf, ...,
    path) resumes from such a file directly."""
    from .graph.checkpoint import load_checkpoint

    return load_checkpoint(path, perf.init_state(require_device(device)))


# -- a playing LiveSession ----------------------------------------------------


def _port_data(v):
    """A value of a JAX LiveSession's host state with every dataclass of the
    zang_tpu package (Impulse, SongEvent, dispatcher slots...) rebuilt as
    the port's class of the same module path and name. Its own walk, as
    host/snapshot.py's: it goes into objects, which no tree holds."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        mod = type(v).__module__
        if mod.split(".")[0] == "zang_tpu":
            cls = getattr(importlib.import_module("zang_tpu_torch" + mod[len("zang_tpu"):]),
                          type(v).__name__)
            kw = {f.name: _port_data(getattr(v, f.name))
                  for f in dataclasses.fields(v) if f.init}
            out = cls(**kw)
            for f in dataclasses.fields(v):
                if not f.init:
                    object.__setattr__(out, f.name, _port_data(getattr(v, f.name)))
            return out
        return v
    if isinstance(v, list):
        return [_port_data(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_port_data(x) for x in v)
    if isinstance(v, dict):
        return {k: _port_data(x) for k, x in v.items()}
    return v


def _port_state(node):
    """An extract_state description of a JAX object with its data values
    made the port's (host/snapshot.py: ("v", data), ("seq", [...]),
    ("map", {...}), ("obj", class name, {attr: ...}), ("skip",)). Its own
    walk: a description is tagged nodes, not a tree of leaves."""
    kind = node[0]
    if kind == "v":
        return ("v", _port_data(node[1]))
    if kind == "seq":
        return ("seq", [_port_state(x) for x in node[1]])
    if kind == "map":
        return ("map", {k: _port_state(x) for k, x in node[1].items()})
    if kind == "obj":
        return ("obj", node[1], {k: _port_state(x) for k, x in node[2].items()})
    return node


def _device_numpy(tree):
    """JAX device state -> numpy copies, in the port's device dtypes."""
    return tree_map(lambda a: device_numpy(np.array(a)), tree)


def from_jax_live_session(sess, device="cuda", post=None, parts=None):
    """The port's LiveSession continuing a zang_tpu LiveSession mid-play:
    the same clock and plan horizon, note-id generator, held keys, queued
    events, dispatchers and triggers, segment histories, incremental
    planner walks, live parameter values and controller streams, slot
    capacity, and the device state (read back as numpy and put on
    `device`). Its next block is the JAX session's next block.

    parts: the port's [(instrument, polyphony)] (default: the JAX
    instruments converted as from_jax_performance does, zangscript ones
    compiled again from their source). A JAX post_fn cannot be converted:
    pass the port's as post=(post_fn, post_init_state)."""
    from .host import snapshot as snap
    from .host.live import LiveSession

    if sess.post_fn is not None and post is None:
        raise ValueError("the JAX session has a post_fn: pass the port's post chain "
                         "as post=(post_fn, post_init_state)")
    post_fn, post_init = post if post is not None else (None, None)
    if parts is None:
        parts = [(_instrument(p.instrument), p.polyphony) for p in sess.parts]
    out = LiveSession(parts, sess.sample_rate, sess.block_size, sess.num_channels,
                      post_fn=post_fn, post_init_state=post_init,
                      slot_capacity=sess.slot_capacity,
                      max_slot_capacity=sess.max_slot_capacity, device=device)
    if (sess.parts[0].planner is None) != (out.parts[0].planner is None):
        raise ValueError("one session plans incrementally and the other does not "
                         "(ZANG_LIVE_INC)")
    out.frame = int(sess.frame)
    out._horizon = int(sess._horizon)
    out.idgen.next_id = sess.idgen.next_id
    out._held_keys = copy.deepcopy(sess._held_keys)
    for jp, pp in zip(sess.parts, out.parts):
        if jp.params is not None:
            for k, v in jp.params.values.items():
                pp.params.set(k, v)
            out._apply_params(pp, set(jp.params.values))
        snap.graft_state(pp.queue, _port_state(snap.extract_state(jp.queue)))
        snap.graft_state(pp.dispatcher, _port_state(snap.extract_state(jp.dispatcher)))
        pp.triggers = snap.graft_state(pp.triggers,
                                       _port_state(snap.extract_state(jp.triggers)))
        pp.segs = _port_data(copy.deepcopy(jp.segs))
        if jp.planner is not None:
            snap.graft_state(pp.planner, _port_state(snap.extract_state(jp.planner)))
        pp.controllers = copy.deepcopy(jp.controllers)
        pp.plan_nonce = jp.plan_nonce
        if jp.dev_state is not None:
            pp.dev_state = arrays_to_device(_device_numpy(jp.dev_state), out.device)
    if post is not None:
        out.post_state = arrays_to_device(_device_numpy(sess.post_state), out.device)
    return out
