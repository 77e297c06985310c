"""The NiceInstrument voice, as offline texture jobs and as a live fleet.

Texture job (example_polyphony2.zig's NiceInstrument(0.3) a voice, the
voices mixed at 1/V into example_delay.zig's StereoEchoes(15000)): the
benchmark draws the job's seed; the program builds the texture from it
(host/configs.build_poly_echo_performance: make_texture_song, planning,
the native event compiler), renders it (graph/render.render_performance:
the chunk loop, K3 from ONEPASS_V_MIN voices, the echoes' post chain) and
mixes it down on the card; the reference rebuilds the texture from the same
seed with its frozen generator (reference/renders.texture_oracle) over the
whole job, every chunk of it, its voices split over `check_workers` worker
processes.

Live fleet (example_polyphony.zig's keyboard voice, NiceInstrument(0.3) at
polyphony 4 a lane): each lane plays the score's RegularOrgan part from a
start and a transposition drawn from the seed, its events at whole frames
of the lane's clock; the program is serve/live.LiveFleet (push_event, then
a block); the reference renders a lane's events at the same frames
(reference/renders.live_lane_oracle).
"""

import os

import numpy as np

from benchmark.harness import ROOT

F32 = np.float32


def setup(config: dict, traffic: dict) -> dict:
    ctx = {"config": config, "traffic": traffic}
    if traffic["driver"] == "live":
        z = np.load(os.path.join(ROOT, config["score"]))
        i = config["live_part"]
        ctx["part"] = {"t": z[f"t_{i}"], "note_id": z[f"id_{i}"], "freq": z[f"freq_{i}"],
                       "note_on": z[f"on_{i}"]}
    return ctx


# ---------------------------------------------------------------------------
# texture jobs


def draw_job(ctx: dict, rng) -> dict:
    return {"seed": int(rng.integers(0, 2 ** 31 - 1))}


def run_job(ctx: dict, job: dict, spans, device) -> dict:
    from zang_tpu_torch.core.mixdown import mixdown_s16
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host.configs import build_poly_echo_performance

    cfg, tr = ctx["config"], ctx["traffic"]
    with spans("plan"):
        perf, total = build_poly_echo_performance(
            cfg["texture_voices"], tr["job_seconds"], cfg["texture_sample_rate"],
            cfg["echo_delay"], seed=job["seed"])
    with spans("render"):
        mix = render_performance(perf, total, chunk_size=tr["chunk"], device=device)
    with spans("fetch"):
        out = mixdown_s16(mix, cfg["mix_volume"]).cpu().numpy()
    return {"out": out, "audio_s": total / cfg["texture_sample_rate"],
            "chunks": -(-total // tr["chunk"])}


def reference(ctx: dict, job: dict, precision: str = "f32"):
    """(the reference's s16 [2, frames], the slice of the program's output
    it is compared with: all of it)."""
    from benchmark.reference.renders import texture_oracle

    cfg, tr = ctx["config"], ctx["traffic"]
    frames = int(tr["job_seconds"] * cfg["texture_sample_rate"])
    ref = texture_oracle(cfg["texture_voices"], tr["job_seconds"], job["seed"], frames,
                         cfg["texture_sample_rate"], cfg["echo_delay"], cfg["mix_volume"],
                         precision, workers=tr["check_workers"])
    return ref, np.s_[:, :]


# ---------------------------------------------------------------------------
# the live fleet


def make_fleet(ctx: dict, lanes: int, device):
    from zang_tpu_torch.host import instruments as ti
    from zang_tpu_torch.serve.live import LiveFleet

    cfg, tr = ctx["config"], ctx["traffic"]
    color, poly = cfg["live_color"], cfg["live_polyphony"]
    return LiveFleet(lambda: [(ti.NiceInstrument(color), poly)], lanes,
                     cfg["live_sample_rate"], block_size=tr["block"], device=device)


def lane_events(ctx: dict, rng, lanes: int, frames: int) -> list:
    """Each lane's (frame, note_id, freq, note_on) events in [0, frames) of
    its own clock, in order: the part from a start drawn in the score's
    first (length - the lanes' seconds), transposed by a whole number of
    semitones in f32; frame = the event's time after the start, rounded to
    the nearest frame."""
    cfg, tr = ctx["config"], ctx["traffic"]
    sr = cfg["live_sample_rate"]
    p = ctx["part"]
    t = p["t"].astype(np.float64)
    span_s = frames / sr
    lo, hi = tr["transpose"]
    out = []
    for _ in range(lanes):
        start = float(rng.uniform(0.0, max(0.0, float(t.max()) - span_s)))
        mul = F32(2.0 ** (int(rng.integers(lo, hi + 1)) / 12.0))
        f = np.floor((t - start) * sr + 0.5).astype(np.int64)
        keep = (t >= start) & (f < frames)
        ev = list(zip(f[keep].tolist(), p["note_id"][keep].tolist(),
                      (p["freq"][keep].astype(F32) * mul).astype(F32).tolist(),
                      p["note_on"][keep].tolist()))
        ev.sort(key=lambda e: e[0])  # stable: same-frame events keep the score's order
        out.append(ev)
    return out


def lane_reference(ctx: dict, events: list, frames: int, precision: str = "f32"):
    from benchmark.reference.renders import live_lane_oracle

    cfg = ctx["config"]
    return live_lane_oracle(events, frames, cfg["live_sample_rate"], cfg["live_polyphony"],
                            cfg["live_color"], precision)
