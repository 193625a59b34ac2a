"""Device mesh construction + sharding helpers.

First-class NEW component with no reference counterpart (SURVEY.md §2.3,
§5): the reference is a single-process CPU library; pod-scale operation
(BASELINE.json config #5: 1024 channels x 64k-tap IRs over N hosts) comes
from a ``jax.sharding.Mesh`` with

* a ``"ch"`` axis — audio channels sharded across devices (the dominant,
  communication-free axis for convolution/EQ),
* optionally a ``"t"`` axis — stream time sharded into spans for offline
  rendering, with overlap-save halos exchanged between neighbours
  (:mod:`bbcat_dsp_tpu.parallel.convolve`).

Collectives ride NVLink within a host / DCN across hosts; XLA inserts them
from the shardings (psum for loudness/mix reductions, ppermute for halos).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "channel_sharding", "shard_channels", "P"]


def make_mesh(n_devices: int | None = None, axis_name: str = "ch") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def channel_sharding(mesh: Mesh, ndim: int, channel_axis: int = 0,
                     axis_name: str = "ch") -> NamedSharding:
    """NamedSharding placing ``axis_name`` on ``channel_axis`` of an
    ``ndim``-dim array, replicating the rest."""
    spec = [None] * ndim
    spec[channel_axis] = axis_name
    return NamedSharding(mesh, P(*spec))


def shard_channels(arr, mesh: Mesh, channel_axis: int = 0,
                   axis_name: str = "ch"):
    """Device-put ``arr`` with its channel axis sharded over the mesh."""
    return jax.device_put(
        arr, channel_sharding(mesh, np.ndim(arr), channel_axis, axis_name)
    )
