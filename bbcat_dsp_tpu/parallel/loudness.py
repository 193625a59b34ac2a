"""Mesh-sharded BS.1770 loudness: channel-sharded K-weighting + psum.

Per-channel K-weighting and mean-squares are embarrassingly parallel over a
channel-sharded mesh; the weighted channel sum z_j = sum_c G_c ms_cj is the
single collective (``psum`` over the channel axis, riding NVLink between cards) — the
pattern SURVEY.md §5 calls out for the distributed build.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..loudness.itu1770 import _block_mean_squares, _gated_mean, k_weight_params
from ..filters.iir import modal_apply, modal_init

__all__ = ["sharded_integrated_loudness"]


def sharded_integrated_loudness(mesh: Mesh, fs: float, nchannels: int,
                                axis_name: str = "ch"):
    """Build a jitted ``(x [C, T], weights [C]) -> LKFS`` with channels
    sharded over ``mesh``."""
    p_shelf, p_rlb = k_weight_params(fs)
    blk = int(round(0.400 * fs))
    step = int(round(0.100 * fs))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name)),
        out_specs=P(),
        check_vma=False,
    )
    def _loudness(x, w):
        y, _ = modal_apply(x, p_shelf, modal_init(p_shelf, x.shape[:-1], x.dtype))
        y, _ = modal_apply(y, p_rlb, modal_init(p_rlb, x.shape[:-1], x.dtype))
        ms = _block_mean_squares(y, blk, step)  # [C_local, nblocks]
        z_local = jnp.sum(w[:, None] * ms, axis=0)
        z = jax.lax.psum(z_local, axis_name)    # the one collective
        return _gated_mean(z)

    return jax.jit(_loudness)
