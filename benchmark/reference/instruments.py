"""Oracle instruments: composites mirroring examples/modules.zig (a copy of
zang_tpu/oracle/instruments.py).

These follow the same paint-protocol composition as the reference's example
instruments (temps zeroed by the composite, sub-modules add into them).

Frozen for the benchmark from zang_tpu_torch/oracle/instruments.py: only the imports differ,
so the reference imports nothing of the port.
"""

import numpy as np

from .curves import PaintCurve
from .span import Span
from . import modules as m


def _zero(span: Span, buf: np.ndarray) -> None:
    buf[span.start : span.end] = 0.0


class PhaseModOscillator:
    """2-op phase-mod oscillator (examples/modules.zig:6-77)."""

    num_outputs = 1
    num_temps = 2

    def __init__(self, mode: str = "exact") -> None:
        self.carrier = m.SineOsc(mode)
        self.modulator = m.SineOsc(mode)

    def paint(self, span, outputs, temps, note_id_changed, params):
        ratio = params["ratio"]
        freq = np.float32(params["freq"])
        sl = slice(span.start, span.end)
        if isinstance(ratio, np.ndarray):
            if params["relative"]:
                temps[0][sl] = ratio[sl] * freq
            else:
                temps[0][sl] = ratio[sl]
        else:
            if params["relative"]:
                temps[0][sl] = np.float32(freq * np.float32(ratio))
            else:
                temps[0][sl] = np.float32(ratio)
        _zero(span, temps[1])
        self.modulator.paint(span, [temps[1]], [], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "freq": temps[0],
            "phase": 0.0,
        })
        _zero(span, temps[0])
        mult = params["multiplier"]
        if isinstance(mult, np.ndarray):
            temps[0][sl] += temps[1][sl] * mult[sl]
        else:
            temps[0][sl] += temps[1][sl] * np.float32(mult)
        _zero(span, temps[1])
        self.carrier.paint(span, [temps[1]], [], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "freq": float(freq),
            "phase": temps[0],
        })
        outputs[0][sl] += temps[1][sl]


class PMOscInstrument:
    """PhaseModOscillator + envelope (examples/modules.zig:80-128)."""

    num_outputs = 1
    num_temps = 3

    def __init__(self, release_duration: float, mode: str = "exact") -> None:
        self.release_duration = release_duration
        self.osc = PhaseModOscillator(mode)
        self.env = m.Envelope(mode)

    def paint(self, span, outputs, temps, note_id_changed, params):
        sl = slice(span.start, span.end)
        _zero(span, temps[0])
        self.osc.paint(span, [temps[0]], [temps[1], temps[2]], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "freq": params["freq"],
            "relative": True,
            "ratio": 1.0,
            "multiplier": 1.0,
        })
        _zero(span, temps[1])
        self.env.paint(span, [temps[1]], [], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "attack": PaintCurve.cubed(0.025),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(self.release_duration),
            "sustain_volume": 0.5,
            "note_on": params["note_on"],
        })
        outputs[0][sl] += temps[0][sl] * temps[1][sl]


class FilteredSawtoothInstrument:
    """TriSaw + envelope + lowpass (examples/modules.zig:130-187)."""

    num_outputs = 1
    num_temps = 3

    def __init__(self, mode: str = "exact") -> None:
        self.osc = m.TriSawOsc(mode)
        self.env = m.Envelope(mode)
        self.flt = m.Filter(mode)

    def paint(self, span, outputs, temps, note_id_changed, params):
        from . import twelve_tet

        sl = slice(span.start, span.end)
        _zero(span, temps[0])
        self.osc.paint(span, [temps[0]], [], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "freq": params["freq"],
            "color": 0.0,
        })
        temps[0][sl] *= np.float32(1.5)
        _zero(span, temps[1])
        self.env.paint(span, [temps[1]], [], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "attack": PaintCurve.cubed(0.025),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(1.0),
            "sustain_volume": 0.5,
            "note_on": params["note_on"],
        })
        _zero(span, temps[2])
        temps[2][sl] += temps[0][sl] * temps[1][sl]
        self.flt.paint(span, [outputs[0]], [], note_id_changed, {
            "input": temps[2],
            "type": "low_pass",
            "cutoff": m.cutoff_from_frequency(
                440.0 * twelve_tet.c5, params["sample_rate"]
            ),
            "res": 0.7,
        })


class NiceInstrument:
    """Pulse + lowpass + envelope (examples/modules.zig:189-248)."""

    num_outputs = 1
    num_temps = 2

    def __init__(self, color: float, mode: str = "exact") -> None:
        self.color = color
        self.osc = m.PulseOsc(mode)
        self.flt = m.Filter(mode)
        self.env = m.Envelope(mode)

    def paint(self, span, outputs, temps, note_id_changed, params):
        sl = slice(span.start, span.end)
        _zero(span, temps[0])
        self.osc.paint(span, [temps[0]], [], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "freq": params["freq"],
            "color": self.color,
        })
        temps[0][sl] *= np.float32(0.5)
        _zero(span, temps[1])
        self.flt.paint(span, [temps[1]], [], note_id_changed, {
            "input": temps[0],
            "type": "low_pass",
            "cutoff": m.cutoff_from_frequency(
                params["freq"] * 8.0, params["sample_rate"]
            ),
            "res": 0.7,
        })
        _zero(span, temps[0])
        self.env.paint(span, [temps[0]], [], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "attack": PaintCurve.cubed(0.01),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(0.5),
            "sustain_volume": 0.8,
            "note_on": params["note_on"],
        })
        outputs[0][sl] += temps[0][sl] * temps[1][sl]


class HardSquareInstrument:
    """Pulse gated hard on/off (examples/modules.zig:250-289)."""

    num_outputs = 1
    num_temps = 2

    def __init__(self, mode: str = "exact") -> None:
        self.osc = m.PulseOsc(mode)
        self.gate = m.Gate(mode)

    def paint(self, span, outputs, temps, note_id_changed, params):
        sl = slice(span.start, span.end)
        _zero(span, temps[0])
        self.osc.paint(span, [temps[0]], [], note_id_changed, {
            "sample_rate": params["sample_rate"],
            "freq": params["freq"],
            "color": 0.5,
        })
        _zero(span, temps[1])
        self.gate.paint(span, [temps[1]], [], note_id_changed, {
            "note_on": params["note_on"],
        })
        outputs[0][sl] += temps[0][sl] * temps[1][sl]


class SimpleDelay:
    """Pure delay, no dry signal, no feedback (examples/modules.zig:341-384)."""

    num_outputs = 1
    num_temps = 0

    def __init__(self, delay_samples: int, mode: str = "exact") -> None:
        self.delay = m.Delay(delay_samples)

    def reset(self) -> None:
        self.delay.reset()

    def paint(self, span, outputs, temps, note_id_changed, params):
        start = span.start
        end = span.end
        while start < end:
            n = self.delay.read(outputs[0][start:end])
            self.delay.write(params["input"][start : start + n])
            start += n


class FilteredEchoes:
    """Feedback echo loop with lowpass (examples/modules.zig:388-462)."""

    num_outputs = 1
    num_temps = 2

    def __init__(self, delay_samples: int, mode: str = "exact") -> None:
        self.delay = m.Delay(delay_samples)
        self.filter = m.Filter(mode)

    def reset(self) -> None:
        self.delay.reset()

    def paint(self, span, outputs, temps, note_id_changed, params):
        output = outputs[0]
        inp = params["input"]
        temp0, temp1 = temps[0], temps[1]
        start, end = span.start, span.end
        while start < end:
            temp0[start:end] = 0.0
            n = self.delay.read(temp0[start:end])
            s1 = Span(start, start + n)
            sl = slice(s1.start, s1.end)
            temp0[sl] *= np.float32(params["feedback_volume"])
            temp0[sl] += inp[sl]
            temp1[sl] = 0.0
            self.filter.paint(s1, [temp1], [], note_id_changed, {
                "input": temp0,
                "type": "low_pass",
                "cutoff": params["cutoff"],
                "res": 0.0,
            })
            output[sl] += temp1[sl]
            self.delay.write(temp1[sl])
            start += n


class StereoEchoes:
    """Dry center + mirrored L/R filtered echoes (examples/modules.zig:464-525)."""

    num_outputs = 2
    num_temps = 4

    def __init__(self, main_delay: int, mode: str = "exact") -> None:
        half = main_delay // 2
        self.delay0 = SimpleDelay(half, mode)
        self.delay1 = SimpleDelay(half, mode)
        self.echoes = FilteredEchoes(main_delay, mode)

    def reset(self) -> None:
        self.delay0.reset()
        self.delay1.reset()
        self.echoes.reset()

    def paint(self, span, outputs, temps, note_id_changed, params):
        sl = slice(span.start, span.end)
        inp = params["input"]
        outputs[0][sl] += inp[sl]
        outputs[1][sl] += inp[sl]
        _zero(span, temps[0])
        self.delay0.paint(span, [temps[0]], [], note_id_changed, {"input": inp})
        _zero(span, temps[1])
        self.echoes.paint(span, [temps[1]], [temps[2], temps[3]], note_id_changed, {
            "input": temps[0],
            "feedback_volume": params["feedback_volume"],
            "cutoff": params["cutoff"],
        })
        outputs[0][sl] += temps[1][sl]
        self.delay1.paint(span, [outputs[1]], [], note_id_changed, {"input": temps[1]})
