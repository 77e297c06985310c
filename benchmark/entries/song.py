"""The Toccata (write_wav.zig's offline render) as an offline job.

The benchmark makes each job's input from the seed: the score of
zang_tpu/data/bach_toccata.npz (read as data), transposed by a whole number
of semitones in f32 as host/song.live_events transposes (every part; the
Pedal's halving follows). The same plain arrays go to both sides:

- the program: host/song.build_performance(total, song=...) (planning and
  the native event compiler), graph/render.render_performance at the
  configuration's chunk (the chunk loop, the instruments, K1), then
  core/mixdown.mixdown_s16 on the card, fetched to the host;
- the reference: reference/renders.song_oracle, the whole piece.
"""

import numpy as np

from benchmark.harness import ROOT

F32 = np.float32


def setup(config: dict, traffic: dict) -> dict:
    import os

    z = np.load(os.path.join(ROOT, config["score"]))
    parts = [{"t": z[f"t_{i}"], "note_id": z[f"id_{i}"], "freq": z[f"freq_{i}"],
              "note_on": z[f"on_{i}"]} for i in range(3)]
    frames = int(config["seconds"] * config["sample_rate"])
    return {"config": config, "traffic": traffic, "parts": parts, "frames": frames}


def draw_job(ctx: dict, rng) -> dict:
    lo, hi = ctx["traffic"]["transpose"]
    return {"transpose": int(rng.integers(lo, hi + 1))}


def job_song(ctx: dict, job: dict) -> list:
    """The job's score, plain arrays a part, every frequency times
    2^(k/12) in f32."""
    mul = F32(2.0 ** (job["transpose"] / 12.0))
    return [dict(p, freq=(p["freq"].astype(F32) * mul).astype(F32)) for p in ctx["parts"]]


def run_job(ctx: dict, job: dict, spans, device) -> dict:
    """One job through the port: build, render, s16 on the host."""
    from zang_tpu_torch.core.mixdown import mixdown_s16
    from zang_tpu_torch.core.notes import SongEvent
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host.song import build_performance

    cfg = ctx["config"]
    song = [[SongEvent({"freq": float(f), "note_on": bool(on)}, t=float(t), note_id=int(n))
             for t, n, f, on in zip(p["t"], p["note_id"], p["freq"], p["note_on"])]
            for p in job_song(ctx, job)]
    total = ctx["frames"]
    with spans("plan"):
        perf = build_performance(total, song=song)
    with spans("render"):
        mix = render_performance(perf, total, chunk_size=ctx["traffic"]["chunk"], device=device)
    with spans("fetch"):
        out = mixdown_s16(mix[0], cfg["mix_volume"]).cpu().numpy()
    return {"out": out, "audio_s": total / cfg["sample_rate"],
            "chunks": -(-total // ctx["traffic"]["chunk"])}


def reference(ctx: dict, job: dict, precision: str = "f32"):
    """(the reference's s16 [frames], the slice of the program's output it
    is compared with: all of it)."""
    from benchmark.reference.renders import song_oracle

    cfg = ctx["config"]
    return (song_oracle(job_song(ctx, job), ctx["frames"], cfg["sample_rate"],
                        cfg["mix_volume"], precision), np.s_[:])
