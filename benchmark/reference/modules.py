"""Oracle DSP modules: reference-exact Python/C++ implementations (a copy of
zang_tpu/oracle/modules.py; numpy on the host, no device).

Each class follows the reference module protocol (src/zang.zig facade +
src/modules/*): ``paint(span, outputs, temps, note_id_changed, params)``
*adds into* outputs over [span.start, span.end). Params is a dict;
constant-or-buffer params accept a float or a full-length np.float32 array.

Two modes:
- "exact":  bit-exact to the reference's float accumulation (per-sample
            f32 adds, per-paint-call phase wraps).
- "parity": the device contract — order-independent formulations (u32
            fixed-point phase counters, closed-form index arithmetic) that
            the device engines reproduce bit-for-bit. Where the reference is
            already fixed-point (PulseOsc, TriSawOsc const) or sequential
            in a way the device matches via tables (Envelope, Portamento),
            both modes are identical.

See FIDELITY.md for why the parity formulation exists (float phase
accumulation drifts across a long render in *any* reimplementation).

Frozen for the benchmark from zang_tpu_torch/oracle/modules.py: only the imports differ,
so the reference imports nothing of the port.
"""

import ctypes
from typing import Optional, Union

import numpy as np

from .curves import CurveNode, PaintCurve
from .span import Span
from . import native

COB = Union[float, np.ndarray]  # "constant or buffer"

_CURVE_KIND = {"instantaneous": 0, "linear": 1, "squared": 2, "cubed": 3}


def _is_buf(x: COB) -> bool:
    return isinstance(x, np.ndarray)


def _cob_args(x: COB, span: Span):
    """-> (is_buf, const_val, buf_ptr) for the C ABI (buffers pre-sliced)."""
    if _is_buf(x):
        sl = np.ascontiguousarray(x[span.start : span.end], dtype=np.float32)
        return 1, 0.0, native.fptr(sl), sl  # keep slice alive
    return 0, float(x), native.NULL_F32, None


class Painter:
    """Goal-seeking segment painter (src/zang/painter.zig:36-121).

    exact:  the reference's sequential loop (t += t_step per sample,
            value accumulated from the live t) — zo_paint_toward.
    parity: the device contract (ops/control.py): stage *boundaries* from
            the f32-exact sequential t table, per-sample *values* from the
            closed form min(t0 + (k+1)*t_step, 1) re-anchored at each
            paint call — bit-identical to eval_painter + _PainterWalk
            (ops/control.py:141-263)."""

    def __init__(self, mode: str = "exact") -> None:
        self.mode = mode
        self.t = np.float32(0.0)
        self.last_value = np.float32(0.0)
        self.start = np.float32(0.0)
        # parity-mode stage table state (mirrors _PainterWalk)
        self._table = None
        self._table_key = None
        self._table_pos = 0
        self._table_t0 = np.float32(0.0)

    def new_curve(self) -> None:
        self.start = self.last_value
        self.t = np.float32(0.0)
        self._table = None
        self._table_key = None
        self._table_pos = 0
        self._table_t0 = np.float32(0.0)

    def paint_flat(self, buf: np.ndarray, i: int, value: float) -> int:
        buf[i:] += np.float32(value)
        return len(buf)

    def paint_toward(self, buf: np.ndarray, i: int, curve: PaintCurve, goal: float,
                     sample_rate: float):
        """Returns (new_i, finished)."""
        if self.mode == "parity":
            return self._paint_toward_parity(buf, i, curve, goal, sample_rate)
        t = ctypes.c_float(float(self.t))
        last = ctypes.c_float(float(self.last_value))
        fin = ctypes.c_int(0)
        new_i = native.lib().zo_paint_toward(
            native.fptr(buf), len(buf), i,
            ctypes.byref(t), ctypes.byref(last),
            float(self.start), _CURVE_KIND[curve.kind], float(curve.duration),
            float(sample_rate), float(goal), ctypes.byref(fin),
        )
        self.t = np.float32(t.value)
        self.last_value = np.float32(last.value)
        return new_i, bool(fin.value)

    def _paint_toward_parity(self, buf, i, curve, goal, sample_rate):
        # mirror of ops/control.py _PainterWalk.paint_toward + eval_painter
        from .paint import paint_table

        F = np.float32
        goal = F(goal)
        if self.t >= F(1.0):
            return i, True
        if curve.kind == "instantaneous":
            self.t = F(1.0)
            self.last_value = goal
            return i, True
        key = (curve.kind, F(curve.duration).tobytes())
        if self._table_key != key:
            # stage (re)parameterized mid-flight: continue from current t
            self._table_t0 = F(self.t)
            self._table = paint_table(curve.kind, curve.duration,
                                      sample_rate, float(self.t))
            self._table_key = key
            self._table_pos = 0
        t_arr, tp_arr, t_step = self._table
        length = len(t_arr)
        if self._table_pos >= length:
            return i, True
        n = min(length - self._table_pos, len(buf) - i)
        if n > 0:
            b = F(goal - self.start)
            # closed form anchored at the STAGE start (the engine's program
            # segments span whole stages in the common one-event-per-note
            # case, so per-block calls here must NOT re-anchor — the drift
            # of the closed form vs the sequential t is the contract)
            k = np.arange(self._table_pos + 1, self._table_pos + n + 1,
                          dtype=np.float32)  # dt + 1 from the stage start
            t = np.minimum(F(self._table_t0) + k * F(t_step), F(1.0))
            it = F(1.0) - t
            if curve.kind == "linear":
                tp = t
            elif curve.kind == "squared":
                tp = F(1.0) - it * it
            else:  # cubed
                tp = F(1.0) - it * it * it
            buf[i:i + n] += self.start + b * tp
            # walker state updates use the sequential table (ops/control.py:256-259)
            self.last_value = F(self.start + F(tp_arr[self._table_pos + n - 1] * b))
            self.t = F(t_arr[self._table_pos + n - 1])
            self._table_pos += n
        if self._table_pos >= length:
            return i + n, True
        return i + n, False


class SineOsc:
    """Sine oscillator (src/modules/SineOsc.zig). State: phase.

    exact: f32 phase accumulator, wrapped per paint call (SineOsc.zig:38-40).
    parity: u32 fixed-point counter (device contract; no wrap needed).
    """

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.mode = mode
        self.t = np.float32(0.0)
        self.cnt = np.uint32(0)

    def paint(self, span, outputs, temps, note_id_changed, params):
        out = outputs[0][span.start : span.end]
        fb, fc, fp, _k1 = _cob_args(params["freq"], span)
        pb, pc, pp, _k2 = _cob_args(params["phase"], span)
        if self.mode == "exact":
            t = ctypes.c_float(float(self.t))
            native.lib().zo_sine_exact(
                native.fptr(out), len(out), ctypes.byref(t),
                fb, fc, fp, pb, pc, pp, float(params["sample_rate"]),
            )
            tv = np.float32(t.value)
            self.t = np.float32(tv - np.trunc(tv))
        else:
            cnt = ctypes.c_uint32(int(self.cnt))
            native.lib().zo_sine_parity(
                native.fptr(out), len(out), ctypes.byref(cnt),
                fb, fc, fp, pb, pc, pp, float(params["sample_rate"]),
            )
            self.cnt = np.uint32(cnt.value)


class PulseOsc:
    """Anti-aliased pulse (src/modules/PulseOsc.zig). u32 phase; both modes equal."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.cnt = np.uint32(0)

    def paint(self, span, outputs, temps, note_id_changed, params):
        out = outputs[0][span.start : span.end]
        cnt = ctypes.c_uint32(int(self.cnt))
        freq = params["freq"]
        if _is_buf(freq):
            sl = np.ascontiguousarray(freq[span.start : span.end], dtype=np.float32)
            native.lib().zo_pulse_ctl(
                native.fptr(out), len(out), ctypes.byref(cnt),
                float(params["sample_rate"]), native.fptr(sl), float(params["color"]),
            )
        else:
            native.lib().zo_pulse_const(
                native.fptr(out), len(out), ctypes.byref(cnt),
                float(params["sample_rate"]), float(freq), float(params["color"]),
            )
        self.cnt = np.uint32(cnt.value)


class TriSawOsc:
    """Anti-aliased tri/saw (src/modules/TriSawOsc.zig)."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.mode = mode
        self.cnt = np.uint32(0)
        self.t = np.float32(0.0)

    def paint(self, span, outputs, temps, note_id_changed, params):
        out = outputs[0][span.start : span.end]
        freq = params["freq"]
        if _is_buf(freq):
            sl = np.ascontiguousarray(freq[span.start : span.end], dtype=np.float32)
            if self.mode == "exact":
                t = ctypes.c_float(float(self.t))
                native.lib().zo_trisaw_ctl_exact(
                    native.fptr(out), len(out), ctypes.byref(t),
                    float(params["sample_rate"]), native.fptr(sl),
                    float(params["color"]),
                )
                self.t = np.float32(t.value)
            else:
                cnt = ctypes.c_uint32(int(self.cnt))
                native.lib().zo_trisaw_ctl_parity(
                    native.fptr(out), len(out), ctypes.byref(cnt),
                    float(params["sample_rate"]), native.fptr(sl),
                    float(params["color"]),
                )
                self.cnt = np.uint32(cnt.value)
        else:
            cnt = ctypes.c_uint32(int(self.cnt))
            native.lib().zo_trisaw_const(
                native.fptr(out), len(out), ctypes.byref(cnt),
                float(params["sample_rate"]), float(freq), float(params["color"]),
            )
            self.cnt = np.uint32(cnt.value)


class Envelope:
    """ADSR envelope (src/modules/Envelope.zig). Modes differ only in the
    painter value formulation (Painter docstring)."""

    num_outputs = 1
    num_temps = 0

    IDLE, ATTACK, DECAY, SUSTAIN, RELEASE = range(5)

    def __init__(self, mode: str = "exact") -> None:
        self.state = self.IDLE
        self.painter = Painter(mode)

    def _change_state(self, new_state: int) -> None:
        self.state = new_state
        self.painter.new_curve()

    def _paint_on(self, buf, p, new_note: bool) -> None:
        i = 0
        sr = p["sample_rate"]
        if new_note:
            self._change_state(self.ATTACK)
        assert self.state != self.RELEASE
        if self.state == self.IDLE:
            # hit by mashing the keyboard (Envelope.zig:49-52)
            self._change_state(self.ATTACK)
        if self.state == self.ATTACK:
            i, finished = self.painter.paint_toward(buf, i, p["attack"], 1.0, sr)
            if finished:
                if p["sustain_volume"] < 1.0:
                    self._change_state(self.DECAY)
                else:
                    self._change_state(self.SUSTAIN)
        if self.state == self.DECAY:
            i, finished = self.painter.paint_toward(
                buf, i, p["decay"], p["sustain_volume"], sr
            )
            if finished:
                self._change_state(self.SUSTAIN)
        if self.state == self.SUSTAIN:
            i = self.painter.paint_flat(buf, i, p["sustain_volume"])
        assert i == len(buf)

    def _paint_off(self, buf, p) -> None:
        if self.state == self.IDLE:
            return
        if self.state != self.RELEASE:
            self._change_state(self.RELEASE)
        i, finished = self.painter.paint_toward(
            buf, 0, p["release"], 0.0, p["sample_rate"]
        )
        if finished:
            self._change_state(self.IDLE)

    def paint(self, span, outputs, temps, note_id_changed, params):
        buf = outputs[0][span.start : span.end]
        if params["note_on"]:
            self._paint_on(buf, params, note_id_changed)
        else:
            self._paint_off(buf, params)


class Gate:
    """Outputs 1 while note_on (src/modules/Gate.zig:27-29)."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        pass

    def paint(self, span, outputs, temps, note_id_changed, params):
        if params["note_on"]:
            outputs[0][span.start : span.end] += np.float32(1.0)


_FILTER_MULS = {
    "bypass": None,
    "low_pass": (1.0, 0.0, 0.0),
    "band_pass": (0.0, 1.0, 0.0),
    "high_pass": (0.0, 0.0, 1.0),
    "notch": (1.0, 0.0, 1.0),
    "all_pass": (1.0, 1.0, 1.0),
}


def cutoff_from_frequency(frequency: float, sample_rate: float) -> float:
    """src/modules/Filter.zig:20-23 (f32 arithmetic)."""
    f = np.float32
    v = f(2.0) * (f(1.0) - np.cos(f(np.pi) * f(frequency) / f(sample_rate), dtype=np.float32))
    return float(np.sqrt(np.clip(v, f(0.0), f(1.0)), dtype=np.float32))


class Filter:
    """SVF state-variable filter (src/modules/Filter.zig). State: l, b."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.l = np.float32(0.0)
        self.b = np.float32(0.0)

    def paint(self, span, outputs, temps, note_id_changed, params):
        out = outputs[0][span.start : span.end]
        inp = np.ascontiguousarray(
            params["input"][span.start : span.end], dtype=np.float32
        )
        muls = _FILTER_MULS[params["type"]]
        if muls is None:  # bypass
            out += inp
            return
        cb, cc, cp, _k1 = _cob_args(params["cutoff"], span)
        rb, rc, rp, _k2 = _cob_args(params["res"], span)
        l = ctypes.c_float(float(self.l))
        b = ctypes.c_float(float(self.b))
        native.lib().zo_filter(
            native.fptr(out), native.fptr(inp), len(out),
            ctypes.byref(l), ctypes.byref(b),
            muls[0], muls[1], muls[2], cb, cc, cp, rb, rc, rp,
        )
        self.l = np.float32(l.value)
        self.b = np.float32(b.value)


class _Xoshiro256pp:
    """xoshiro256++ with splitmix64 seeding (Zig std.rand.DefaultPrng)."""

    MASK = (1 << 64) - 1

    def __init__(self, seed: int) -> None:
        self.s = []
        x = seed & self.MASK
        for _ in range(4):
            x = (x + 0x9E3779B97F4A7C15) & self.MASK
            z = x
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & self.MASK
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & self.MASK
            self.s.append(z ^ (z >> 31))

    def next_u64(self) -> int:
        s = self.s
        rotl = lambda v, k: ((v << k) | (v >> (64 - k))) & self.MASK
        result = (rotl((s[0] + s[3]) & self.MASK, 23) + s[0]) & self.MASK
        t = (s[1] << 17) & self.MASK
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = rotl(s[3], 45)
        return result

    def float_f32(self) -> np.float32:
        # best-effort match of Zig Random.float(f32): top 24 bits / 2^24
        return np.float32((self.next_u64() >> 40) * (1.0 / (1 << 24)))


_noise_next_seed = [0]


class Noise:
    """White/pink noise (src/modules/Noise.zig).

    The uniform tape source is pluggable so parity tests can inject the
    device's random stream; default is xoshiro256++ (exact-mode best effort —
    noise has no golden comparison). The reference's pink-state quirk is
    preserved: b[] restarts from zeros on every paint call (Noise.zig:68).
    """

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact", tape_fn=None,
                 tape_span_fn=None) -> None:
        seed = _noise_next_seed[0]
        _noise_next_seed[0] += 1
        self._rng = _Xoshiro256pp(seed)
        self.b = np.zeros(7, dtype=np.float32)
        self.tape_fn = tape_fn
        # positional variant: tape_span_fn(span, n) — lets differential
        # tests feed the engine's POSITIONAL tape (frame f -> tape[f])
        # rather than a sequential stream, so alignment survives the
        # paint-protocol's active-span gaps (tests/test_script_fuzz.py)
        self.tape_span_fn = tape_span_fn

    def _tape(self, span, n: int) -> np.ndarray:
        if self.tape_span_fn is not None:
            return np.ascontiguousarray(self.tape_span_fn(span, n),
                                        dtype=np.float32)
        if self.tape_fn is not None:
            return np.ascontiguousarray(self.tape_fn(n), dtype=np.float32)
        return np.array([self._rng.float_f32() for _ in range(n)], dtype=np.float32)

    def paint(self, span, outputs, temps, note_id_changed, params):
        out = outputs[0][span.start : span.end]
        n = len(out)
        tape = self._tape(span, n)
        if params["color"] == "white":
            out += tape * np.float32(2.0) - np.float32(1.0)
        else:
            native.lib().zo_noise_pink(
                native.fptr(out), native.fptr(tape), n, native.fptr(self.b)
            )
            # quirk: self.b intentionally NOT updated (Noise.zig:68)


class Portamento:
    """Scalar glide toward goal (src/modules/Portamento.zig)."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.painter = Painter(mode)

    def paint(self, span, outputs, temps, note_id_changed, params):
        buf = outputs[0][span.start : span.end]
        if params["note_on"] and params["prev_note_on"]:
            curve = params["curve"]
        else:
            curve = PaintCurve.instantaneous()
        if params["note_on"] and note_id_changed:
            self.painter.new_curve()
        i, finished = self.painter.paint_toward(
            buf, 0, curve, params["goal"], params["sample_rate"]
        )
        if finished:
            self.painter.paint_flat(buf, i, params["goal"])


class Cycle:
    """Phasor 0->1 wrapping (src/modules/Cycle.zig)."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.mode = mode
        self.t = np.float32(0.0)
        self.cnt = np.uint32(0)

    def paint(self, span, outputs, temps, note_id_changed, params):
        out = outputs[0][span.start : span.end]
        sb, sc, sp, _k = _cob_args(params["speed"], span)
        if self.mode == "exact":
            t = ctypes.c_float(float(self.t))
            native.lib().zo_cycle_exact(
                native.fptr(out), len(out), ctypes.byref(t),
                sb, sc, sp, float(params["sample_rate"]),
            )
            self.t = np.float32(t.value)
        else:
            # parity: u32 phase counter, emitted value = utof23(cnt)
            n = len(out)
            speed = params["speed"]
            srbase = np.float32(np.float32(4294967296.0) / np.float32(params["sample_rate"]))
            if _is_buf(speed):
                sl = speed[span.start : span.end].astype(np.float32)
                steps = (srbase * sl).astype(np.int64).astype(np.uint32)
            else:
                step = np.uint32(np.int64(np.float32(srbase * np.float32(speed))))
                steps = np.full(n, step, dtype=np.uint32)
            with np.errstate(over="ignore"):
                cnts = np.uint32(self.cnt) + np.concatenate(
                    [[np.uint32(0)], np.cumsum(steps[:-1], dtype=np.uint32)]
                )
                out += _utof23_np(cnts)
                self.cnt = np.uint32(np.uint32(self.cnt) + np.sum(steps, dtype=np.uint32))


def _utof23_np(x: np.ndarray) -> np.ndarray:
    bits = (x >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


class Decimator:
    """Sample-and-hold rate reduction (src/modules/Decimator.zig)."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.mode = mode
        self.dval = np.float32(0.0)
        self.dcount = np.float32(1.0)
        self.cnt = np.uint32(0xFFFFFFFF)  # parity counter: first add triggers

    def paint(self, span, outputs, temps, note_id_changed, params):
        out = outputs[0][span.start : span.end]
        inp = np.ascontiguousarray(
            params["input"][span.start : span.end], dtype=np.float32
        )
        fake = float(params["fake_sample_rate"])
        sr = float(params["sample_rate"])
        if fake >= sr:
            out += inp
            self.dval = np.float32(0.0)
            self.dcount = np.float32(1.0)
            self.cnt = np.uint32(0xFFFFFFFF)
        elif fake > 0.0:
            ratio = np.float32(np.float32(fake) / np.float32(sr))
            if self.mode == "exact":
                dval = ctypes.c_float(float(self.dval))
                dcount = ctypes.c_float(float(self.dcount))
                native.lib().zo_decimator_exact(
                    native.fptr(out), native.fptr(inp), len(out),
                    ctypes.byref(dval), ctypes.byref(dcount), float(ratio),
                )
                self.dval = np.float32(dval.value)
                self.dcount = np.float32(dcount.value)
            else:
                n = len(out)
                icount = np.uint32(np.int64(np.float32(ratio * np.float32(4294967296.0))))
                with np.errstate(over="ignore"):
                    cnts = np.uint32(self.cnt) + np.cumsum(
                        np.full(n, icount, dtype=np.uint32), dtype=np.uint32
                    )
                trig = cnts < icount  # u32 wrap happened this sample
                idx = np.where(trig, np.arange(n), -1)
                last = np.maximum.accumulate(idx)
                vals = np.where(last >= 0, inp[np.maximum(last, 0)], self.dval)
                out += vals.astype(np.float32)
                self.cnt = np.uint32(cnts[-1]) if n else self.cnt
                if np.any(trig):
                    self.dval = np.float32(inp[last[-1]])


class Distortion:
    """Overdrive/clip (src/modules/Distortion.zig). Stateless."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        pass

    def paint(self, span, outputs, temps, note_id_changed, params):
        out = outputs[0][span.start : span.end]
        inp = np.ascontiguousarray(
            params["input"][span.start : span.end], dtype=np.float32
        )
        native.lib().zo_distortion(
            native.fptr(out), native.fptr(inp), len(out),
            0 if params["type"] == "overdrive" else 1,
            float(params["ingain"]), float(params["outgain"]),
            float(params["offset"]),
        )


class Sample:
    """Decoded-sample descriptor (src/modules/Sampler.zig:16-22)."""

    FORMATS = {"unsigned8": 0, "signed16_lsb": 1, "signed24_lsb": 2, "signed32_lsb": 3}

    def __init__(self, num_channels: int, sample_rate: int, fmt: str, data: bytes):
        self.num_channels = num_channels
        self.sample_rate = sample_rate
        self.format = fmt
        self.data = np.frombuffer(data, dtype=np.uint8)


class Sampler:
    """WAV playback with resampling/loop (src/modules/Sampler.zig)."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.mode = mode
        self.t = np.float32(0.0)

    def paint(self, span, outputs, temps, note_id_changed, params):
        sample: Sample = params["sample"]
        if params["channel"] >= sample.num_channels:
            return
        if note_id_changed:
            self.t = np.float32(0.0)
        out = outputs[0][span.start : span.end]
        ratio = np.float32(
            np.float32(float(sample.sample_rate)) / np.float32(params["sample_rate"])
        )
        loop = bool(params["loop"])
        if ratio < 0.0 and not loop:
            return
        fmt = Sample.FORMATS[sample.format]
        data = sample.data
        L = native.lib()
        if 0.9999 < ratio < 1.0001:
            t_round = float(np.round(self.t))
            L.zo_sampler_copy(
                native.fptr(out), len(out), t_round, native.u8ptr(data),
                len(data), fmt, sample.num_channels, int(params["channel"]), int(loop),
            )
            self.t = np.float32(self.t + np.float32(len(out)))
        else:
            t = ctypes.c_float(float(self.t))
            fn = (
                L.zo_sampler_resample_exact
                if self.mode == "exact"
                else L.zo_sampler_resample_parity
            )
            fn(
                native.fptr(out), len(out), ctypes.byref(t), float(ratio),
                native.u8ptr(data), len(data), fmt, sample.num_channels,
                int(params["channel"]), int(loop),
            )
            self.t = np.float32(t.value)
        # quirk: wrap uses data BYTE length, not sample count (Sampler.zig:132-134)
        if self.t >= np.float32(len(data)) and loop:
            self.t = np.float32(self.t - np.float32(len(data)))


class Curve:
    """Interpolated curve playback (src/modules/Curve.zig)."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, mode: str = "exact") -> None:
        self.mode = mode
        self.t = np.float32(0.0)
        self.current_song_note = 0
        self.current_song_note_offset = 0
        self.next_song_note = 0

    def paint(self, span, outputs, temps, note_id_changed, params):
        if note_id_changed:
            self.current_song_note = 0
            self.current_song_note_offset = 0
            self.next_song_note = 0
            self.t = np.float32(0.0)
        out = outputs[0][span.start : span.end]
        nodes = self._get_curve_span_nodes(
            params["sample_rate"], len(out), params["curve"]
        )
        start = 0
        L = native.lib()
        while start < len(out):
            cs_start, cs_end, values = self._next_curve_span(nodes, start, len(out))
            if values is not None:
                (f0, v0), (f1, v1) = values
                start_x = np.float32(np.float32(cs_start - f0) / np.float32(f1 - f0))
                delta = np.float32(np.float32(v1) - np.float32(v0))
                x_step = np.float32(np.float32(1.0) / np.float32(f1 - f0))
                seg = out[cs_start:cs_end]
                if params["function"] == "linear":
                    y0 = np.float32(np.float32(v0) + start_x * delta)
                    y_step = np.float32(x_step * delta)
                    fn = (
                        L.zo_curve_linear_exact
                        if self.mode == "exact"
                        else L.zo_curve_linear_parity
                    )
                    fn(native.fptr(seg), len(seg), float(y0), float(y_step))
                else:
                    fn = (
                        L.zo_curve_smoothstep_exact
                        if self.mode == "exact"
                        else L.zo_curve_smoothstep_parity
                    )
                    fn(
                        native.fptr(seg), len(seg), float(start_x), float(x_step),
                        float(v0), float(delta),
                    )
            start = cs_end

    def _get_curve_span_nodes(self, sample_rate, out_len, curve):
        """Curve.zig:126-176: nodes relative to this block, one past the end."""
        nodes = []
        buf_time = np.float32(np.float32(out_len) / np.float32(sample_rate))
        end_t = np.float32(self.t + buf_time)
        if self.current_song_note < self.next_song_note:
            nodes.append(
                (self.current_song_note_offset, curve[self.current_song_note].value)
            )
        one_past = False
        for song_note in curve[self.next_song_note :]:
            note_t = np.float32(song_note.t)
            if note_t >= end_t:
                if not one_past:
                    one_past = True
                else:
                    break
            f = np.float32(np.float32(note_t - self.t) / buf_time)
            rel_frame_index = int(np.float32(f * np.float32(out_len)))
            if nodes and nodes[-1][0] == rel_frame_index:
                nodes.pop()
            nodes.append((rel_frame_index, song_note.value))
            if not one_past:
                self.current_song_note = self.next_song_note
                self.current_song_note_offset = 0
                self.next_song_note += 1
        self.t = np.float32(self.t + buf_time)
        self.current_song_note_offset -= out_len
        return nodes

    @staticmethod
    def _next_curve_span(nodes, dest_start, dest_end):
        """Curve.zig:180-238: next (start, end, values|None) span."""
        for i, (start_pos, value) in enumerate(nodes):
            if start_pos >= dest_end:
                break
            if i < len(nodes) - 1:
                end_pos = min(dest_end, nodes[i + 1][0])
            else:
                end_pos = dest_end
            if end_pos <= dest_start:
                continue
            note_start_clipped = start_pos if start_pos > dest_start else dest_start
            if note_start_clipped > dest_start:
                return dest_start, note_start_clipped, None
            note_end_clipped = min(end_pos, dest_end)
            if i < len(nodes) - 1:
                values = (nodes[i], nodes[i + 1])
            else:
                values = None
            return note_start_clipped, note_end_clipped, values
        return dest_start, dest_end, None


class Delay:
    """Fixed-length delay line with the two-phase chunked read/write API
    (src/zang/delay.zig:7-91)."""

    def __init__(self, delay_samples: int) -> None:
        self.delay_samples = delay_samples
        self.buffer = np.zeros(delay_samples, dtype=np.float32)
        self.index = 0

    def reset(self) -> None:
        self.buffer[:] = 0.0
        self.index = 0

    def read(self, out: np.ndarray) -> int:
        n = min(len(out), self.delay_samples)
        first = min(self.delay_samples - self.index, n)
        out[:first] += self.buffer[self.index : self.index + first]
        if first < n:
            out[first:n] += self.buffer[: n - first]
        return n

    def write(self, inp: np.ndarray) -> None:
        n = len(inp)
        assert n <= self.delay_samples
        first = min(self.delay_samples - self.index, n)
        self.buffer[self.index : self.index + first] = inp[:first]
        if first < n:
            self.buffer[: n - first] = inp[first:]
            self.index = n - first
        else:
            self.index += first
            if self.index == self.delay_samples:
                self.index = 0
