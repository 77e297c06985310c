"""Write the Bach Toccata's note events as a Standard MIDI File.

    python zang_tpu_torch/tools/toccata_smf.py [--out PATH]

Reads zang_tpu/data/bach_toccata.npz (as data) and writes
zang_tpu_torch/data/toccata.mid by default: the flagship song as input for
the MIDI renderers of both packages (zang_tpu.host.midi and
zang_tpu_torch.host.midi), which then read the same bytes. Deterministic:
the same npz gives the same bytes. Stdlib and numpy only.

The file: format 1, one track and one channel a part in the npz's order
(0 Pedal, 1 RegularOrgan, 2 WeirdOrgan, each with its name as a track-name
meta event), 480 ticks a quarter, 120 bpm up to 192 s and 100 bpm after
it (TEMPOS; both set-tempo events in track 0), velocity 100. A time
becomes the nearest tick of that tempo map (the npz's times are f32
seconds; a tick is 1/960 s, then 1/800 s), a frequency the nearest
equal-tempered key (A4 = 440 Hz = key 69; every npz frequency is one to
the cent). A note-on for a key that is still sounding in its part releases
the old note first in the renderers (midi_songs), so the old note's own
note-off is not written.
"""

import argparse
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NPZ = os.path.join(ROOT, "zang_tpu", "data", "bach_toccata.npz")
OUT = os.path.join(ROOT, "zang_tpu_torch", "data", "toccata.mid")

PARTS = ("Pedal", "RegularOrgan", "WeirdOrgan")
DIVISION = 480  # ticks a quarter
TEMPOS = ((0.0, 500_000), (192.0, 600_000))  # (from second, microseconds a quarter)
VELOCITY = 100


def _varlen(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _tempo_ticks():
    """[(tick, second, uspq)] of each tempo segment's start."""
    marks, tick, sec, uspq = [], 0, 0.0, None
    for s, u in TEMPOS:
        if uspq is not None:
            tick += round((s - sec) * 1e6 * DIVISION / uspq)
        marks.append((tick, s, u))
        sec, uspq = s, u
    return marks


def tick_of(t: float) -> int:
    """The nearest tick to t seconds under TEMPOS."""
    tick0, s0, uspq = [m for m in _tempo_ticks() if m[1] <= t][-1]
    return tick0 + int(np.floor((t - s0) * 1e6 * DIVISION / uspq + 0.5))


def key_of(freq: float) -> int:
    """The nearest equal-tempered MIDI key (A4 = 440 Hz = 69)."""
    return int(np.floor(69.0 + 12.0 * np.log2(freq / 440.0) + 0.5))


def _meta(mtype: int, body: bytes) -> bytes:
    return bytes([0xFF, mtype]) + _varlen(len(body)) + body


def _track(part: int, z) -> bytes:
    """One part's MTrk chunk: (tick, order, message) events sorted by tick."""
    events = [(0, -2, _meta(0x03, PARTS[part].encode()))]
    if part == 0:
        events += [(tick, -1, _meta(0x51, uspq.to_bytes(3, "big")))
                   for tick, _s, uspq in _tempo_ticks()]
    sounding = {}  # key -> note id whose note-on sounds it
    keys = {}  # note id -> key
    for order, (t, nid, f, on) in enumerate(zip(z[f"t_{part}"], z[f"id_{part}"],
                                                z[f"freq_{part}"], z[f"on_{part}"])):
        tick, nid = tick_of(float(t)), int(nid)
        if on:
            key = key_of(float(f))
            keys[nid] = key
            sounding[key] = nid  # a sounding key's old note is released here
            events.append((tick, order, bytes([0x90 | part, key, VELOCITY])))
        elif sounding.get(keys.get(nid)) == nid:
            key = keys[nid]
            del sounding[key]
            events.append((tick, order, bytes([0x80 | part, key, 64])))
    events.sort(key=lambda e: (e[0], e[1]))
    body, last = b"", 0
    for tick, _order, msg in events:
        body += _varlen(tick - last) + msg
        last = tick
    body += _varlen(0) + _meta(0x2F, b"")
    return b"MTrk" + len(body).to_bytes(4, "big") + body


def toccata_smf(npz: str = NPZ) -> bytes:
    """The SMF bytes of the song in `npz`."""
    z = np.load(npz)
    head = (b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big")
            + len(PARTS).to_bytes(2, "big") + DIVISION.to_bytes(2, "big"))
    return head + b"".join(_track(p, z) for p in range(len(PARTS)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    data = toccata_smf()
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out}: {len(data)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
