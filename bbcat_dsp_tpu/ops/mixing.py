"""Mixing: rectangle scale-and-add with optional click-free gain ramps.

Batched MixSamples (ref: src/SoundMixing.h:55-110, src/SoundMixing.cpp):
the reference's strided rectangle loops become channel-window slices over
``[C, T]`` arrays; the per-frame linear gain ramp (``Interpolator& interp,
inc`` overload, ref: src/SoundMixing.cpp:23-52) becomes a materialised ramp
vector fused into the multiply-add.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .interpolator import Interpolator, interp_ramp

__all__ = ["mix_samples", "mix_samples_ramped"]


def mix_samples(
    dst: jax.Array,
    src: jax.Array,
    mul=1.0,
    src_channel: int = 0,
    dst_channel: int = 0,
    nchannels: int | None = None,
) -> jax.Array:
    """``dst[dc:dc+n] += mul * src[sc:sc+n]`` over ``[C, T]`` arrays
    (ref: MixSamples template, src/SoundMixing.h:55-81; zero-mul early-out
    is free under XLA constant folding).  Returns updated ``dst``."""
    if nchannels is None:
        nchannels = min(src.shape[0] - src_channel, dst.shape[0] - dst_channel)
    nchannels = max(0, min(
        nchannels, src.shape[0] - src_channel, dst.shape[0] - dst_channel
    ))
    if nchannels == 0:
        return dst
    T = min(src.shape[-1], dst.shape[-1])
    block = src[src_channel:src_channel + nchannels, :T]
    return dst.at[dst_channel:dst_channel + nchannels, :T].add(
        jnp.asarray(mul, dst.dtype) * block.astype(dst.dtype)
    )


def mix_samples_ramped(
    dst: jax.Array,
    src: jax.Array,
    interp: Interpolator,
    inc,
    src_channel: int = 0,
    dst_channel: int = 0,
    nchannels: int | None = None,
):
    """Mix with a per-frame linear gain ramp driven by ``interp``
    (ref: src/SoundMixing.cpp:23-52 — the gain changes every frame, hence
    ``allowsinglechannel=false`` there; here the ramp broadcasts over the
    channel window for free).  Returns ``(dst, advanced_interp)``."""
    if nchannels is None:
        nchannels = min(src.shape[0] - src_channel, dst.shape[0] - dst_channel)
    T = min(src.shape[-1], dst.shape[-1])
    ramp, interp = interp_ramp(interp, inc, T)
    block = src[src_channel:src_channel + nchannels, :T]
    dst = dst.at[dst_channel:dst_channel + nchannels, :T].add(
        ramp * block.astype(dst.dtype)
    )
    return dst, interp
