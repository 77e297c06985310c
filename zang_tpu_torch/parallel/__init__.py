"""Several devices: voice-sharded offline renders, one process a device, and
the device list that LiveFleet splits its lanes over (zang_tpu/parallel)."""

from .mesh import (  # noqa: F401
    Mesh,
    Rank,
    RenderJob,
    make_mesh,
    pad_timelines,
    render_performance_sharded,
    render_rank,
    run_ranks,
    shard_parts,
)
