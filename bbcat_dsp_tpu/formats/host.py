"""Host-side (CPU) byte-level sample format conversion.

Host-side replacement for the reference's generated 94-function conversion
matrix (ref: src/SoundFormatRawConversions.cpp, generated by
src/genconversions.php).  Instead of 94 scalar loops selected through a 4-D
function-pointer table, this module implements ONE vectorised numpy path per
stage — unpack (bytes -> normalized), convert (normalized -> normalized),
pack (normalized -> bytes) — with the reference's exact numeric contract:

* integer samples are MSB-aligned in a 32-bit register: int16 << 16,
  int24 << 8 (ref: src/genconversions.php:180-218)
* int -> float:  float(i32) * 2**-31, the factor cast to the destination
  float type (ref: src/genconversions.php:137)
* float -> int:  clamp(x * 2**31, -2147483648.0, 2147483647.0) computed in
  double, then a TRUNCATING cast (C cast semantics)
  (ref: src/genconversions.php:262-264)
* narrowing int writes keep the top bytes (arithmetic >> 16 for int16,
  >> 8 for int24) (ref: src/SoundFormatRawConversions.cpp:668-712)
* dither is applied to the 32-bit register before any narrowing int write
  (dst is integer and dst bytes < src bytes), with ``bits`` = number of bits
  about to be discarded (ref: src/genconversions.php:220-223)

An optional C++ fast path (native/src/formatconv.cpp) accelerates the packed
int24 / byte-swap cases; numpy is the always-available fallback.
"""

from __future__ import annotations

import numpy as np

from .sample_format import (
    SampleFormat,
    block_transfer_sanity_checks,
    get_bytes_per_sample,
    is_sample_integer,
)
from .dither import Ditherer

_INT_NP = {
    SampleFormat.INT16: ("i2", 16),
    SampleFormat.INT32: ("i4", 0),
}
_FLT_NP = {
    SampleFormat.FLOAT: "f4",
    SampleFormat.DOUBLE: "f8",
}


def _endian_char(big_endian: bool) -> str:
    return ">" if big_endian else "<"


def unpack(raw: np.ndarray, fmt: SampleFormat, big_endian: bool = False) -> np.ndarray:
    """Unpack a flat uint8 byte buffer into the normalized representation.

    Returns int32 (MSB-aligned) for integer formats, float32/float64 for
    float formats.
    """
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    e = _endian_char(big_endian)
    if fmt in _INT_NP:
        code, shift = _INT_NP[fmt]
        vals = raw.view(e + code).astype(np.int32)
        return vals << shift if shift else vals
    if fmt == SampleFormat.INT24:
        b = raw.reshape(-1, 3).astype(np.uint32)
        if big_endian:
            u = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8)
        else:
            u = (b[:, 2] << 24) | (b[:, 1] << 16) | (b[:, 0] << 8)
        return u.view(np.int32)
    if fmt in _FLT_NP:
        return raw.view(e + _FLT_NP[fmt]).copy()
    raise ValueError(f"cannot unpack format {fmt!r}")


def pack(vals: np.ndarray, fmt: SampleFormat, big_endian: bool = False) -> np.ndarray:
    """Pack a normalized array into a flat uint8 byte buffer."""
    e = _endian_char(big_endian)
    if fmt == SampleFormat.INT16:
        return np.frombuffer(
            (vals >> 16).astype(np.int16).astype(e + "i2").tobytes(), np.uint8
        )
    if fmt == SampleFormat.INT32:
        return np.frombuffer(vals.astype(np.int32).astype(e + "i4").tobytes(), np.uint8)
    if fmt == SampleFormat.INT24:
        u = vals.view(np.uint32) if vals.dtype == np.int32 else vals.astype(np.int32).view(np.uint32)
        out = np.empty((u.size, 3), np.uint8)
        if big_endian:
            out[:, 0] = (u >> 24) & 0xFF
            out[:, 1] = (u >> 16) & 0xFF
            out[:, 2] = (u >> 8) & 0xFF
        else:
            out[:, 2] = (u >> 24) & 0xFF
            out[:, 1] = (u >> 16) & 0xFF
            out[:, 0] = (u >> 8) & 0xFF
        return out.reshape(-1)
    if fmt in _FLT_NP:
        return np.frombuffer(vals.astype(e + _FLT_NP[fmt]).tobytes(), np.uint8)
    raise ValueError(f"cannot pack format {fmt!r}")


def float_to_int32(x: np.ndarray) -> np.ndarray:
    """float -> normalized int32 with the reference's scale/saturate/truncate.

    ref: src/genconversions.php:262-264 — clamp in double then C-cast
    (truncation toward zero).
    """
    d = np.clip(np.asarray(x, np.float64) * 2147483648.0, -2147483648.0, 2147483647.0)
    return np.trunc(d).astype(np.int64).astype(np.int32)


def int32_to_float(x: np.ndarray, double: bool = False) -> np.ndarray:
    """normalized int32 -> float.  ref: src/genconversions.php:137."""
    if double:
        return np.asarray(x, np.float64) * np.float64(2.0**-31)
    # the reference computes cast(float, sval) * (float)2^-31 in float32
    return (np.asarray(x).astype(np.float32) * np.float32(2.0**-31)).astype(np.float32)


def convert_normalized(
    x: np.ndarray,
    src_fmt: SampleFormat,
    dst_fmt: SampleFormat,
    ditherer: Ditherer | None = None,
    channels: np.ndarray | None = None,
) -> np.ndarray:
    """Convert between normalized representations.

    ``channels`` optionally carries the per-sample channel index for the
    ditherer hook (the reference passes the frame counter ``i``;
    see __Convert_* bodies — we pass true channel indices, which is what the
    Ditherer interface documents).
    """
    src_int = is_sample_integer(src_fmt)
    dst_int = is_sample_integer(dst_fmt)

    if dst_int:
        v = np.asarray(x, np.int32) if src_int else float_to_int32(x)
        nbytes_src = get_bytes_per_sample(src_fmt)
        nbytes_dst = get_bytes_per_sample(dst_fmt)
        if ditherer is not None and nbytes_dst < nbytes_src:
            bits = (4 - nbytes_dst) * 8
            v = ditherer.dither_block(v, bits, channels)
        # normalized representation keeps MSB alignment; narrowing happens at
        # pack() time (top bytes kept), so zero the discarded low bits here to
        # make the normalized value exactly representable in the target width.
        if dst_fmt == SampleFormat.INT16:
            v = (v >> 16) << 16
        elif dst_fmt == SampleFormat.INT24:
            v = (v >> 8) << 8
        return v

    if src_int:
        return int32_to_float(x, double=(dst_fmt == SampleFormat.DOUBLE))
    # float -> float
    return np.asarray(x, np.float64 if dst_fmt == SampleFormat.DOUBLE else np.float32)


def transfer_samples(
    src: np.ndarray,
    src_fmt: SampleFormat,
    src_be: bool,
    src_channel: int,
    src_channels: int,
    dst: np.ndarray,
    dst_fmt: SampleFormat,
    dst_be: bool,
    dst_channel: int,
    dst_channels: int,
    nchannels: int,
    nframes: int,
    ditherer: Ditherer | None = None,
) -> bool:
    """Rectangle-to-rectangle copy / convert / (de)interleave on byte buffers.

    Full-parity equivalent of the reference's ``TransferSamples``
    (ref: src/SoundFormatConversions.cpp:151-198).  ``src`` and ``dst`` are
    flat uint8 buffers of interleaved frames.  Overlapping src/dst is safe for
    ALL cases (the source rectangle is materialised before writing, a stronger
    guarantee than the reference's backwards-walk trick at
    src/SoundFormatConversions.cpp:178-185).
    """
    ok, src_channel, dst_channel, nchannels, nframes = block_transfer_sanity_checks(
        src_channel, src_channels, dst_channel, dst_channels, nchannels, nframes,
        # frame collapse changes which "channel" index the ditherer sees;
        # disable it when dithering so channel indices stay meaningful
        allow_single_channel=ditherer is None,
    )
    if not ok:
        return False

    sbytes = get_bytes_per_sample(src_fmt)
    dbytes = get_bytes_per_sample(dst_fmt)
    src = np.ascontiguousarray(src).view(np.uint8).reshape(-1)
    dst = dst.view(np.uint8).reshape(-1)

    if ditherer is None:
        # native C++ fast path (native/src/formatconv.cpp) — same contract,
        # no Python in the per-sample loops; falls through to numpy when no
        # compiler/library is available
        from ..utils.native import transfer_rect

        if transfer_rect(
            src, src_fmt, src_be, src_channel, src_channels,
            dst, dst_fmt, dst_be, dst_channel, dst_channels,
            nchannels, nframes,
        ):
            return True

    # gather source rectangle bytes: [nframes, nchannels*sbytes]
    frame_stride = src_channels * sbytes
    col = np.arange(nchannels * sbytes) + src_channel * sbytes
    row = np.arange(nframes)[:, None] * frame_stride
    rect = src[row + col[None, :]].reshape(-1)

    vals = unpack(rect, src_fmt, src_be)
    if ditherer is not None:
        ch = np.tile(np.arange(nchannels), nframes)
    else:
        ch = None
    vals = convert_normalized(vals, src_fmt, dst_fmt, ditherer, channels=ch)
    out_bytes = pack(vals, dst_fmt, dst_be)

    dframe_stride = dst_channels * dbytes
    dcol = np.arange(nchannels * dbytes) + dst_channel * dbytes
    drow = np.arange(nframes)[:, None] * dframe_stride
    dst[drow + dcol[None, :]] = out_bytes.reshape(nframes, -1)
    return True


def transfer_samples_typed(
    src: np.ndarray,
    src_channel: int,
    dst: np.ndarray,
    dst_channel: int,
    nchannels: int,
    nframes: int,
    ditherer: Ditherer | None = None,
) -> bool:
    """Typed rectangle transfer: formats inferred from the numpy dtypes
    (ref: the templated TransferSamples wrapper,
    src/SoundFormatConversions.h:190-198).  ``src``/``dst`` are
    ``[frames, channels]`` interleaved arrays of concrete sample dtypes."""
    from .sample_format import sample_format_of

    sfmt = sample_format_of(src.dtype)
    dfmt = sample_format_of(dst.dtype)
    if sfmt == SampleFormat.UNKNOWN or dfmt == SampleFormat.UNKNOWN:
        raise TypeError(
            f"unsupported sample dtypes {src.dtype}/{dst.dtype}"
        )
    sbe = src.dtype.byteorder == ">"
    dbe = dst.dtype.byteorder == ">"
    return transfer_samples(
        np.ascontiguousarray(src).view(np.uint8).reshape(-1), sfmt, sbe,
        src_channel, src.shape[1],
        dst.view(np.uint8).reshape(-1), dfmt, dbe,
        dst_channel, dst.shape[1], nchannels, nframes, ditherer,
    )


def transfer_samples_linear(
    src: np.ndarray,
    src_fmt: SampleFormat,
    src_be: bool,
    dst: np.ndarray,
    dst_fmt: SampleFormat,
    dst_be: bool,
    nsamples: int,
    ditherer: Ditherer | None = None,
) -> bool:
    """Contiguous 1-D transfer (ref: TransferSamplesLinear,
    src/SoundFormatConversions.h:170-186)."""
    return transfer_samples(
        src, src_fmt, src_be, 0, 1, dst, dst_fmt, dst_be, 0, 1, 1, nsamples, ditherer
    )
