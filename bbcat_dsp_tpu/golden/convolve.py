"""Golden convolution: direct float64 FIR + uniformly-partitioned overlap-save
with click-free IR crossfade.

The BlockConvolver/Convolver sources are documented-but-absent in the
reference snapshot (ref: README:38-44; SURVEY.md §0/§2.2); behavior here is
the canonical uniformly-partitioned overlap-save algorithm (SURVEY.md §3.7),
in float64, serving as the oracle for the device implementation.

Crossfade contract (this framework's definition of the reference's
"fade out old filter + fade in new filter over one block",
BASELINE.json north star): during the swap block, with block length B,

    y[n] = (1 - r[n]) * y_old[n] + r[n] * y_new[n],   r[n] = (n + 1) / B

so the old filter is fully out by the end of the block and there is no
discontinuity at the block boundary (r[B-1] = 1).
"""

from __future__ import annotations

import numpy as np


def direct_convolve(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Full direct convolution in float64 (length ``len(x)+len(h)-1``)."""
    return np.convolve(np.asarray(x, np.float64), np.asarray(h, np.float64))


def _partition_ir(h: np.ndarray, block: int) -> np.ndarray:
    """Zero-pad IR to a multiple of ``block`` and split into partitions.

    Returns rFFT spectra ``[P, block+1]`` complex128 of each partition
    zero-padded to ``2*block``.
    """
    h = np.asarray(h, np.float64)
    nparts = max(1, -(-h.size // block))
    hp = np.zeros(nparts * block, np.float64)
    hp[: h.size] = h
    parts = hp.reshape(nparts, block)
    padded = np.concatenate([parts, np.zeros_like(parts)], axis=1)
    return np.fft.rfft(padded, axis=1)


def partitioned_convolve(x: np.ndarray, h: np.ndarray, block: int) -> np.ndarray:
    """Uniformly-partitioned overlap-save convolution, float64.

    Per block: slide a 2B input window, rFFT, push into a P-deep spectral
    queue, multiply-accumulate against the P IR partition spectra, irFFT,
    keep the last B samples (overlap-save discards the first B)
    (SURVEY.md §3.7).  ``len(x)`` must be a multiple of ``block``.
    Returns ``y`` of the same length as ``x`` (streaming output; the tail
    beyond len(x) is not emitted).
    """
    x = np.asarray(x, np.float64)
    B = block
    assert x.size % B == 0, "input length must be a multiple of the block size"
    H = _partition_ir(h, B)
    P = H.shape[0]
    queue = np.zeros((P, B + 1), np.complex128)
    prev = np.zeros(B, np.float64)
    out = np.empty_like(x)
    for i in range(x.size // B):
        xb = x[i * B : (i + 1) * B]
        window = np.concatenate([prev, xb])
        prev = xb
        queue = np.roll(queue, 1, axis=0)
        queue[0] = np.fft.rfft(window)
        acc = np.sum(queue * H, axis=0)
        y2 = np.fft.irfft(acc, n=2 * B)
        out[i * B : (i + 1) * B] = y2[B:]
    return out


def crossfade_swap_convolve(
    x: np.ndarray,
    h_old: np.ndarray,
    h_new: np.ndarray,
    block: int,
    swap_block: int,
) -> np.ndarray:
    """Streamed partitioned convolution where the IR is exchanged click-free
    at the start of block index ``swap_block``.

    Runs the old and new filters in parallel for the swap block and fades
    linearly between them (module docstring contract); afterwards only the
    new filter runs.  State (the spectral input queue) is shared — only the
    IR spectra change — so the fade is the only transient.
    """
    x = np.asarray(x, np.float64)
    B = block
    assert x.size % B == 0
    H_old = _partition_ir(h_old, B)
    H_new = _partition_ir(h_new, B)
    P = max(H_old.shape[0], H_new.shape[0])
    F = B + 1

    def _pad(H):
        out = np.zeros((P, F), np.complex128)
        out[: H.shape[0]] = H
        return out

    H_old, H_new = _pad(H_old), _pad(H_new)
    queue = np.zeros((P, F), np.complex128)
    prev = np.zeros(B, np.float64)
    ramp = (np.arange(B) + 1.0) / B
    out = np.empty_like(x)
    for i in range(x.size // B):
        xb = x[i * B : (i + 1) * B]
        window = np.concatenate([prev, xb])
        prev = xb
        queue = np.roll(queue, 1, axis=0)
        queue[0] = np.fft.rfft(window)
        if i < swap_block:
            H = H_old
            y = np.fft.irfft(np.sum(queue * H, axis=0), n=2 * B)[B:]
        elif i == swap_block:
            y_old = np.fft.irfft(np.sum(queue * H_old, axis=0), n=2 * B)[B:]
            y_new = np.fft.irfft(np.sum(queue * H_new, axis=0), n=2 * B)[B:]
            y = (1.0 - ramp) * y_old + ramp * y_new
        else:
            y = np.fft.irfft(np.sum(queue * H_new, axis=0), n=2 * B)[B:]
        out[i * B : (i + 1) * B] = y
    return out
