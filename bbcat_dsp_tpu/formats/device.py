"""On-device (JAX) sample conversion ops.

The device-side half of L1: conversions between the normalized
representations (MSB-aligned int32, float32) as pure jittable ops over
``[..., channels, time]`` arrays.  Byte-packed formats never reach the device
— they are unpacked at the host edge (:mod:`bbcat_dsp_tpu.formats.host`).

Numeric contract matches the reference (ref: src/genconversions.php:137,
262-264) except that the float->int clamp runs in float32 on device (the
reference uses double); the int16/int24 truncation semantics are exact since
they are integer ops.  Use the host path when bit-exact double rounding of
full-scale int32 values matters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .sample_format import SampleFormat, is_sample_integer

_SCALE_UP = 2147483648.0  # 2^31
_SCALE_DOWN = 2.0**-31
# largest float32 below 2^31: clamping to this guarantees the cast fits int32
_MAX_F32_INT = 2147483520.0


def float_to_int32(x: jax.Array) -> jax.Array:
    """float32 -> MSB-aligned int32: scale by 2^31, saturate, truncate."""
    d = jnp.clip(x.astype(jnp.float32) * _SCALE_UP, -_SCALE_UP, _MAX_F32_INT)
    return jnp.trunc(d).astype(jnp.int32)


def int32_to_float(x: jax.Array) -> jax.Array:
    """MSB-aligned int32 -> float32: scale by 2^-31."""
    return x.astype(jnp.float32) * jnp.float32(_SCALE_DOWN)


def quantize(x: jax.Array, fmt: SampleFormat, key=None) -> jax.Array:
    """Round-trip float32 through an integer format's quantisation grid.

    On-device equivalent of a float -> int -> float conversion chain: exposes
    exactly the precision loss a packed file write would introduce.

    With a PRNG ``key``, TPDF dither is applied in the 32-bit integer
    register before truncation — the same contract as the host
    :class:`~bbcat_dsp_tpu.formats.dither.TPDFDitherer` (two uniforms over
    one target LSB, offset by half an LSB to unbias the floor truncation;
    ref: src/genconversions.php:220-223 placement), with jax.random instead
    of the host RNG stream.
    """
    if fmt == SampleFormat.INT16:
        bits = 16
    elif fmt == SampleFormat.INT24:
        bits = 8
    elif fmt == SampleFormat.INT32:
        bits = 0
    else:
        raise ValueError(f"quantize expects an integer format, got {fmt!r}")
    v = float_to_int32(x)
    if key is not None and bits > 0:
        lsb = 1 << bits
        r = jax.random.randint(key, x.shape, 0, lsb, jnp.int32)
        k2 = jax.random.fold_in(key, 1)
        r = r + jax.random.randint(k2, x.shape, 0, lsb, jnp.int32)
        # exact int32 add; pre-clamp so the +-1 LSB dither cannot wrap at
        # the extremes (costs at most 2 LSB of headroom at digital full
        # scale, matching the host path's saturation behaviour)
        v = jnp.clip(v, -(2**31) + 2 * lsb, 2**31 - 1 - 2 * lsb)
        v = v + (r - (lsb >> 1))
    if bits:
        v = (v >> bits) << bits
    return int32_to_float(v)


def convert(x: jax.Array, src_fmt: SampleFormat, dst_fmt: SampleFormat) -> jax.Array:
    """Convert a normalized device array between format domains."""
    src_int = is_sample_integer(src_fmt)
    dst_int = is_sample_integer(dst_fmt)
    if src_int and not dst_int:
        return int32_to_float(x)
    if dst_int and not src_int:
        v = float_to_int32(x)
        if dst_fmt == SampleFormat.INT16:
            v = (v >> 16) << 16
        elif dst_fmt == SampleFormat.INT24:
            v = (v >> 8) << 8
        return v
    if dst_int:  # int -> int: normalized representation is shared
        if dst_fmt == SampleFormat.INT16:
            return (x >> 16) << 16
        if dst_fmt == SampleFormat.INT24:
            return (x >> 8) << 8
        return x
    return x.astype(jnp.float32)


def transfer_window(
    src: jax.Array,
    dst: jax.Array,
    src_channel: int = 0,
    dst_channel: int = 0,
    nchannels: int | None = None,
    src_fmt: SampleFormat = SampleFormat.FLOAT,
    dst_fmt: SampleFormat = SampleFormat.FLOAT,
) -> jax.Array:
    """Copy/convert a channel window of ``src`` into a channel window of ``dst``.

    Device equivalent of the reference's rectangle TransferSamples
    (ref: src/SoundFormatConversions.cpp:151-198) over ``[channels, time]``
    arrays: channels become a sliced leading axis instead of an interleave
    stride.  Returns the updated ``dst`` (functional update).
    """
    if nchannels is None:
        nchannels = min(src.shape[-2] - src_channel, dst.shape[-2] - dst_channel)
    nchannels = min(nchannels, src.shape[-2] - src_channel, dst.shape[-2] - dst_channel)
    if nchannels <= 0:
        return dst
    block = jax.lax.slice_in_dim(src, src_channel, src_channel + nchannels, axis=-2)
    block = convert(block, src_fmt, dst_fmt)
    nt = min(block.shape[-1], dst.shape[-1])
    block = block[..., :nt]
    start = [0] * (dst.ndim - 2) + [dst_channel, 0]
    return jax.lax.dynamic_update_slice(dst, block.astype(dst.dtype), start)


def interleave(x: jax.Array) -> jax.Array:
    """[channels, time] -> interleaved [time, channels] (host-edge layout).

    ref: the Interleave() concept in src/SoundFormatConversions.h:11-13.
    """
    return jnp.swapaxes(x, -1, -2)


def deinterleave(x: jax.Array) -> jax.Array:
    """Interleaved [time, channels] -> [channels, time]."""
    return jnp.swapaxes(x, -1, -2)
