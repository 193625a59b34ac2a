"""Fractional-sample (polyphase windowed-sinc) delay reads on device.

Batched formulation of the reference's 14-tap / 128-phase polyphase read
(ref: src/FractionalSample.cpp:255-341): instead of a scalar 14-MAC loop per
output sample, all requested positions are resolved at once — a batched
gather of the 14 source samples per position plus a ``[N, 14] x [14]``
weighted reduction.

Index contract (exact parity, ref: src/FractionalSample.cpp:283-291):

    phase fpos = 128 - 1 - (int(128 * pos) % 128)
    base  bpos = (int(pos) + length - 14) % length

so the result lags ~7 samples (documented group delay,
ref: src/FractionalSample.h:29-33).  The coefficient table is the
reference's exact filter data re-encoded as q23 int32
(see :mod:`bbcat_dsp_tpu.golden.fractional`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..golden.fractional import OVERSAMPLING, TAPS, ADDITIONAL_DELAY, polyphase_table

__all__ = [
    "OVERSAMPLING",
    "TAPS",
    "ADDITIONAL_DELAY",
    "additional_delay_required",
    "fractional_read",
    "FractionalDelayLine",
]

_TABLE_TP = None  # [128 phases, 14 taps] numpy float32 (host constant —
# cached as numpy, NOT jnp, so a jit trace never leaks a tracer here)


def _table_phase_major(dtype=jnp.float32) -> np.ndarray:
    """Polyphase table as ``[phase, tap]`` for gather-free weight lookup."""
    global _TABLE_TP
    if _TABLE_TP is None:
        t = polyphase_table().reshape(TAPS, OVERSAMPLING).T  # [phase, tap]
        _TABLE_TP = np.ascontiguousarray(t, np.float32)
    return _TABLE_TP.astype(dtype) if _TABLE_TP.dtype != dtype else _TABLE_TP


def additional_delay_required() -> int:
    """ref: FractionalSampleAdditionalDelayRequired(),
    src/FractionalSample.cpp:249-252."""
    return ADDITIONAL_DELAY


@jax.jit
def fractional_read(buf: jax.Array, pos: jax.Array) -> jax.Array:
    """Read fractional positions from a circular buffer.

    ``buf`` is ``[..., length]`` (channel-major);
    ``pos`` is ``[..., n]`` float positions (broadcast against the leading
    dims of ``buf``).  Returns ``[..., n]`` samples in ``buf.dtype``.
    """
    length = buf.shape[-1]
    posf = pos.astype(jnp.float32)
    ipos = jnp.floor(posf).astype(jnp.int32)
    phase = (
        OVERSAMPLING - 1
        - (jnp.floor(posf * OVERSAMPLING).astype(jnp.int32) % OVERSAMPLING)
    )
    base = (ipos + length - TAPS) % length
    taps = jnp.arange(TAPS, dtype=jnp.int32)
    idx = (base[..., None] + taps) % length  # [..., n, 14]
    # flat gather along the ring axis — NO [..., n, L] broadcast of the
    # ring (which would materialise n copies of the buffer)
    flat_idx = idx.reshape(idx.shape[:-2] + (-1,))
    out_batch = jnp.broadcast_shapes(buf.shape[:-1], idx.shape[:-2])
    flat_idx = jnp.broadcast_to(flat_idx, out_batch + flat_idx.shape[-1:])
    bufb = jnp.broadcast_to(buf, out_batch + buf.shape[-1:])
    gathered = jnp.take_along_axis(bufb, flat_idx, axis=-1).reshape(
        out_batch + idx.shape[-2:]
    )
    weights = jnp.asarray(_table_phase_major(buf.dtype))[phase]  # [..., n, 14]
    return jnp.sum(gathered * weights, axis=-1).astype(buf.dtype)


@partial(jax.jit, static_argnames=("n", "out_len"))
def fractional_read_stream(buf: jax.Array, start_pos: jax.Array, n: int | None = None,
                           out_len: int = 0) -> jax.Array:
    """Read ``out_len`` CONSECUTIVE fractional positions per channel,
    starting at ``start_pos [C]`` — the constant-delay streaming case.

    Because consecutive positions share one polyphase phase per channel,
    this is a fixed-phase 14-tap FIR: one per-channel dynamic slice of
    ``out_len + 14`` samples plus 14 shifted multiply-adds — NO gathers.
    Identical results to :func:`fractional_read` at integer-spaced position
    sequences.
    """
    if n is not None:
        out_len = n
    length = buf.shape[-1]
    posf = start_pos.astype(jnp.float32)
    ipos = jnp.floor(posf).astype(jnp.int32)
    phase = (
        OVERSAMPLING - 1
        - (jnp.floor(posf * OVERSAMPLING).astype(jnp.int32) % OVERSAMPLING)
    )
    base = (ipos + length - TAPS) % length
    # per-channel contiguous slab [C, out_len + TAPS - 1] from the ring,
    # wrapped: double the ring (cheap concat) so one dynamic slice suffices
    dbl = jnp.concatenate([buf, buf], axis=-1)
    span = out_len + TAPS - 1

    def slice_ch(row, b):
        return jax.lax.dynamic_slice_in_dim(row, b, span, axis=-1)

    slab = jax.vmap(slice_ch)(dbl, base)  # [C, span]
    w = jnp.asarray(_table_phase_major(buf.dtype))[phase]  # [C, 14]
    out = jnp.zeros(slab.shape[:-1] + (out_len,), buf.dtype)
    for k in range(TAPS):
        out = out + w[..., k, None] * jax.lax.slice_in_dim(
            slab, k, k + out_len, axis=-1
        )
    return out


class FractionalDelayLine:
    """Streaming fractional delay: a circular write head + fractional reads.

    Composes a channel-major ring (write side) with :func:`fractional_read`;
    the ring must be at least ``max_delay + ADDITIONAL_DELAY`` long
    (headroom contract, ref: src/FractionalSample.cpp:249-252).
    """

    def __init__(self, nchannels: int, length: int, dtype=jnp.float32):
        self.length = int(length)
        self.buf = jnp.zeros((nchannels, self.length), dtype)
        self.writepos = 0  # host-side frame counter (monotonic mod length)

    def write(self, block: jax.Array) -> None:
        """Append ``[C, B]`` samples at the write head (scatter-free)."""
        from ..buffers.ring import Ring, ring_write

        B = block.shape[-1]
        r = ring_write(
            Ring(self.buf, jnp.asarray(self.writepos, jnp.int32)), block
        )
        self.buf = r.data
        self.writepos += B

    def read(self, delays: jax.Array) -> jax.Array:
        """Read at fractional ``delays[C, n]`` (in frames) behind the write
        head.  Accounts for the filter's built-in ~7-sample lag is the
        caller's choice; the raw contract matches the reference."""
        pos = (self.writepos % self.length) - jnp.asarray(delays) + self.length
        return fractional_read(self.buf, pos % self.length)



