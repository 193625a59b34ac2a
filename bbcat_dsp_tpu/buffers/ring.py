"""Generic circular buffer as a functional state pytree.

Batched-array equivalent of the reference's ``RingBuffer<T>``
(ref: src/RingBuffer.h:10-159): the mutable ring + write cursor becomes an
explicit ``(data [..., L], writepos)`` pytree threaded through pure jitted
ops.  Channel axes lead; time is the last (lane) axis.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["Ring", "ring_init", "ring_write", "ring_read_delayed", "ring_advance"]


class Ring(NamedTuple):
    data: jax.Array      # [..., length]
    writepos: jax.Array  # [] int32 (monotonic; wraps modulo length)


def ring_init(shape, length: int, dtype=jnp.float32) -> Ring:
    return Ring(
        data=jnp.zeros(tuple(shape) + (length,), dtype),
        writepos=jnp.zeros((), jnp.int32),
    )


@jax.jit
def ring_write(ring: Ring, block: jax.Array) -> Ring:
    """Write ``block [..., B]`` at the cursor and advance
    (ref: RingBuffer::Write, src/RingBuffer.h:68-107).

    Scatter-free: the (possibly wrapping) write avoids element
    scatters, so the (possibly wrapping) write is one contiguous
    ``dynamic_update_slice`` into an L+B extension, with the overhang
    folded back by masked elementwise select.
    """
    L = ring.data.shape[-1]
    B = block.shape[-1]
    if B > L:
        raise ValueError(f"block ({B}) longer than ring ({L})")
    start = jnp.mod(ring.writepos, L)
    blk = jnp.broadcast_to(
        block.astype(ring.data.dtype), ring.data.shape[:-1] + (B,)
    )
    ext = jnp.zeros(ring.data.shape[:-1] + (L + B,), ring.data.dtype)
    ext = jax.lax.dynamic_update_slice(
        ext, blk, (0,) * (ring.data.ndim - 1) + (start,)
    )
    main = ext[..., :L]
    over = ext[..., L:]
    pos = jnp.arange(L)
    wrap_len = start + B - L  # may be negative (no wrap)
    in_main = (pos >= start) & (pos < jnp.minimum(start + B, L))
    in_over = pos < wrap_len
    vals = jnp.where(in_over, jnp.pad(over, [(0, 0)] * (ring.data.ndim - 1)
                                      + [(0, L - B)]), main)
    data = jnp.where(in_main | in_over, vals, ring.data)
    return Ring(data=data, writepos=ring.writepos + B)


@partial(jax.jit, static_argnames=("n",))
def ring_read_delayed(ring: Ring, delay, n: int = 1) -> jax.Array:
    """Read ``n`` consecutive samples starting ``delay`` samples behind the
    cursor (ref: RingBuffer::Read, src/RingBuffer.h:115-118).

    Gather-free: one dynamic slice of the doubled ring."""
    L = ring.data.shape[-1]
    start = jnp.mod(ring.writepos - delay, L)
    dbl = jnp.concatenate([ring.data, ring.data], axis=-1)
    out = jax.lax.dynamic_slice_in_dim(dbl, start, n, axis=-1)
    return out[..., 0] if n == 1 else out


@jax.jit
def ring_advance(ring: Ring, n) -> Ring:
    """Advance the cursor without writing (zero-skip, ref: Advance,
    src/RingBuffer.h:124-127)."""
    return Ring(ring.data, ring.writepos + jnp.asarray(n, jnp.int32))
