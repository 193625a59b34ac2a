"""Device-mesh sharding layer (new component — no reference counterpart;
SURVEY.md §2.3): channel/time sharding of the DSP engines over a device
mesh, halo exchange for overlap-save, psum reductions for metering."""

from .mesh import make_mesh, channel_sharding, shard_channels
from .convolve import (
    channel_sharded_step,
    channel_sharded_render,
    channel_sharded_nonuniform_render,
    time_sharded_render,
    time_sharded_nonuniform_render,
)
from .loudness import sharded_integrated_loudness
from .comms import (
    CommEnv,
    allreduce_bytes,
    collective_seconds,
    config5_scaling_table,
    halo_bytes,
    scaling_efficiency,
    time_sharded_efficiency,
)

__all__ = [
    "CommEnv",
    "allreduce_bytes",
    "collective_seconds",
    "config5_scaling_table",
    "halo_bytes",
    "scaling_efficiency",
    "time_sharded_efficiency",
    "make_mesh",
    "channel_sharding",
    "shard_channels",
    "channel_sharded_step",
    "channel_sharded_render",
    "channel_sharded_nonuniform_render",
    "time_sharded_render",
    "time_sharded_nonuniform_render",
    "sharded_integrated_loudness",
]
