"""The NiceInstrument texture across four cards: offline jobs of the
texture of voice streams, rendered by the port's persistent sharded
renderer (drivers/sharded.py).

A job (example_polyphony2.zig's NiceInstrument(0.3) a voice, the voices
mixed at 1/V into example_delay.zig's StereoEchoes(15000)): the benchmark
draws the job's seed; each rank builds its own contiguous block of the
voices from it (host/configs.texture_block_build: each voice's notes from
a stream of its own keyed by (seed, voice), planning and the native event
compiler for the block alone), renders it chunk by chunk with one
all_reduce of the chunk's mix over the ranks before the replicated post
chain, and rank 0 mixes down to s16 on its card. The reference rebuilds
the voices from the same seed with its frozen generator
(reference/texture_streams.py) over the job's first frames, its voices
split over `check_workers` worker processes that each draw only their own.
"""

import functools



def setup(config: dict, traffic: dict) -> dict:
    return {"config": config, "traffic": traffic}


def prepare(ctx: dict, device) -> None:
    """Build, in this process and before the ranks start, the port's
    libraries the ranks load: the native event compiler and K3 (each rank
    holds 16,384 voices). The CPU needs neither."""
    if str(device) == "cpu":
        return
    from zang_tpu_torch.core import native
    from zang_tpu_torch.ops import _build

    native.build()
    _build.build("svf_onepass")


def frames(ctx: dict) -> int:
    return int(ctx["traffic"]["job_seconds"] * ctx["config"]["texture_sample_rate"])


def chunks(ctx: dict) -> int:
    return -(-frames(ctx) // ctx["traffic"]["chunk"])


def audio_s(ctx: dict) -> float:
    return frames(ctx) / ctx["config"]["texture_sample_rate"]


def draw_job(ctx: dict, rng) -> dict:
    return {"seed": int(rng.integers(0, 2 ** 31 - 1))}


def render_job(ctx: dict, job: dict, observe=None):
    """The port's RenderJob for one job: a rank's build of its block,
    s16 from rank 0 at the configuration's volume."""
    from zang_tpu_torch.host import configs
    from zang_tpu_torch.parallel.mesh import RenderJob

    cfg, tr = ctx["config"], ctx["traffic"]
    build = functools.partial(configs.texture_block_build, cfg["texture_voices"],
                              tr["job_seconds"], cfg["texture_sample_rate"],
                              cfg["echo_delay"], job["seed"])
    return RenderJob(build, frames(ctx), tr["chunk"], volume=cfg["mix_volume"],
                     observe=observe)


def reference(ctx: dict, job: dict, precision: str = "f32", judged=None):
    """(the reference's s16 [2, n], the slice of the program's output it is
    compared with): the job's first `judged` frames (default all of it)."""
    from benchmark.reference.texture_streams import texture_streams_oracle

    cfg, tr = ctx["config"], ctx["traffic"]
    n = frames(ctx) if judged is None else min(int(judged), frames(ctx))
    ref = texture_streams_oracle(cfg["texture_voices"], tr["job_seconds"], job["seed"], n,
                                 cfg["texture_sample_rate"], cfg["echo_delay"],
                                 cfg["mix_volume"], precision, workers=tr["check_workers"])
    return ref, (slice(None), slice(0, n))
