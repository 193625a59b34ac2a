"""Golden biquad: RBJ coefficient math + DF2T recurrence in float64.

Numeric contract reproduced from the reference implementation
(ref: src/BiQuad.cpp:181-325 coefficient formulas; src/BiQuad.h:200-206 DF2T
tick; src/BiQuad.cpp:379-395 shared-controller coefficient interpolation;
src/BiQuad.cpp:114-130 complex response).
"""

from __future__ import annotations

import enum
import math

import numpy as np


class FilterType(enum.IntEnum):
    """Filter taxonomy — integer values MATCH the reference enum order
    (ref: src/BiQuad.h:31-42: FLAT, LPF6, HPF6, LPF12, HPF12, BPF, NOTCH,
    PEQ, LSH, HSH)."""

    FLAT = 0
    LPF6 = 1
    HPF6 = 2
    LPF12 = 3
    HPF12 = 4
    BPF = 5
    NOTCH = 6
    PEQ = 7
    LSH = 8
    HSH = 9


def biquad_coeffs(
    ftype: FilterType,
    freq: float,
    fs: float,
    gain: float = 0.0,
    bandwidth: float = 1.0,
) -> np.ndarray:
    """RBJ Audio-EQ-Cookbook coefficients, a0-normalized.

    Returns ``[b0, b1, b2, a1, a2]`` (float64).  Formula parity with
    ref: src/BiQuad.cpp:181-325 (including the non-cookbook 6/12 dB
    LPF/HPF variants and the shared alpha/beta setup).
    """
    A = 10.0 ** (gain / 40.0)
    omega = 2.0 * math.pi * freq / fs
    sn = math.sin(omega)
    cs = math.cos(omega)
    alpha = sn * math.sinh(math.log(2.0) / 2.0 * bandwidth * omega / sn)
    beta = math.sqrt(A + A)

    t = FilterType(ftype)
    if t == FilterType.FLAT:
        b0, b1, b2, a0, a1, a2 = 1.0, 0.0, 0.0, 1.0, 0.0, 0.0
    elif t == FilterType.LPF6:
        b0, b1, b2, a0, a1, a2 = sn, 0.0, 0.0, 1.0 + sn, -1.0, 0.0
    elif t == FilterType.LPF12:
        b0, b1, b2 = sn * sn, 0.0, 0.0
        a0, a1, a2 = (1.0 + sn) ** 2, -2.0 * (1.0 + sn), 1.0
    elif t == FilterType.HPF6:
        b0, b1, b2, a0, a1, a2 = 1.0, -1.0, 0.0, 1.0, -(1.0 - sn), 0.0
    elif t == FilterType.HPF12:
        b0, b1, b2 = 1.0, -2.0, 1.0
        a0, a1, a2 = 1.0, -2.0 * (1.0 - sn), (1.0 - sn) ** 2
    elif t == FilterType.BPF:
        b0, b1, b2 = alpha, 0.0, -alpha
        a0, a1, a2 = 1.0 + alpha, -2.0 * cs, 1.0 - alpha
    elif t == FilterType.NOTCH:
        b0, b1, b2 = 1.0, -2.0 * cs, 1.0
        a0, a1, a2 = 1.0 + alpha, -2.0 * cs, 1.0 - alpha
    elif t == FilterType.PEQ:
        b0, b1, b2 = 1.0 + alpha * A, -2.0 * cs, 1.0 - alpha * A
        a0, a1, a2 = 1.0 + alpha / A, -2.0 * cs, 1.0 - alpha / A
    elif t == FilterType.LSH:
        b0 = A * ((A + 1.0) - (A - 1.0) * cs + beta * sn)
        b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cs)
        b2 = A * ((A + 1.0) - (A - 1.0) * cs - beta * sn)
        a0 = (A + 1.0) + (A - 1.0) * cs + beta * sn
        a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cs)
        a2 = (A + 1.0) + (A - 1.0) * cs - beta * sn
    elif t == FilterType.HSH:
        b0 = A * ((A + 1.0) + (A - 1.0) * cs + beta * sn)
        b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cs)
        b2 = A * ((A + 1.0) + (A - 1.0) * cs - beta * sn)
        a0 = (A + 1.0) - (A - 1.0) * cs + beta * sn
        a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cs)
        a2 = (A + 1.0) - (A - 1.0) * cs - beta * sn
    else:  # pragma: no cover
        raise ValueError(f"unknown filter type {ftype!r}")

    n = 1.0 / a0
    return np.array([b0 * n, b1 * n, b2 * n, a1 * n, a2 * n], np.float64)


def biquad_response(coeffs: np.ndarray, f, fs: float) -> np.ndarray:
    """Complex response H at frequency/ies ``f``.

    Uses the reference's convention z1 = exp(+2*pi*j*f/fs)
    (ref: src/BiQuad.cpp:114-130).
    """
    coeffs = np.asarray(coeffs, np.float64)
    b0, b1, b2, a1, a2 = coeffs
    z1 = np.exp(2j * np.pi * np.asarray(f, np.float64) / fs)
    z2 = z1 * z1
    return (b0 + b1 * z1 + b2 * z2) / (1.0 + a1 * z1 + a2 * z2)


def biquad_process(x: np.ndarray, coeffs: np.ndarray, state=None):
    """DF2T biquad over 1-D ``x`` (ref: src/BiQuad.h:200-206).

    ``state`` is ``[w0, w1]`` float64 (the double-precision w regs,
    ref: src/BiQuad.h:240).  Returns ``(y, state)``.
    """
    x = np.asarray(x, np.float64)
    b0, b1, b2, a1, a2 = np.asarray(coeffs, np.float64)
    w0, w1 = (0.0, 0.0) if state is None else (float(state[0]), float(state[1]))
    y = np.empty_like(x)
    for n in range(x.size):
        xn = x[n]
        yn = b0 * xn + w0
        w0 = b1 * xn - a1 * yn + w1
        w1 = b2 * xn - a2 * yn
        y[n] = yn
    return y, np.array([w0, w1], np.float64)


def biquad_process_interpolated(
    x: np.ndarray,
    current: np.ndarray,
    targets: np.ndarray,
    interp_samples: float,
    state=None,
    sample_rounding: bool = False,
):
    """DF2T with per-sample shared-controller coefficient interpolation.

    Reproduces ref: src/BiQuad.cpp:75-102 (SetCoeffs: diffs, mul=1,
    dec=1/interp_samples) + src/BiQuad.cpp:379-395 (Interpolate per sample:
    mul -= dec; current = target - mul*diff) + the static multichannel
    Process loop ordering (coeffs interpolate AFTER each frame,
    ref: src/BiQuad.cpp:473-494).

    ``sample_rounding=True`` additionally models the reference's
    ``Sample_t`` (float32) cast of ``y`` INSIDE the feedback path
    (``Sample_t y = (Sample_t)(x*num0 + w[0]); w[0] = ... - y*den1 ...``,
    ref: src/BiQuad.h:200-206) — for near-unit-circle poles that cast is a
    ~95 dB self-noise floor in the reference's own output.  Default False
    keeps the ideal double recurrence (what the device engines target).
    """
    x = np.asarray(x, np.float64)
    cur = np.asarray(current, np.float64).copy()
    tgt = np.asarray(targets, np.float64)
    diffs = tgt - cur
    if interp_samples > 0:
        mul, dec = 1.0, 1.0 / interp_samples
    else:
        mul, dec = 0.0, 0.0
        cur = tgt.copy()
    w0, w1 = (0.0, 0.0) if state is None else (float(state[0]), float(state[1]))
    y = np.empty_like(x)
    for n in range(x.size):
        b0, b1, b2, a1, a2 = cur
        xn = x[n]
        yn = b0 * xn + w0
        if sample_rounding:
            yn = float(np.float32(yn))
        w0 = b1 * xn - a1 * yn + w1
        w1 = b2 * xn - a2 * yn
        y[n] = yn
        if mul > 0.0:
            mul = max(mul - dec, 0.0)
            cur = tgt - mul * diffs
    return y, np.array([w0, w1], np.float64), cur


def cascade_process(x: np.ndarray, coeffs: np.ndarray, states=None):
    """Serial biquad cascade (ref: src/BiQuad.h:698-711, the non-vectorized
    true-serial path).  ``coeffs`` is ``[stages, 5]``.  Returns (y, states)."""
    coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
    nstages = coeffs.shape[0]
    if states is None:
        states = np.zeros((nstages, 2), np.float64)
    else:
        states = np.asarray(states, np.float64).copy()
    y = np.asarray(x, np.float64)
    for s in range(nstages):
        y, states[s] = biquad_process(y, coeffs[s], states[s])
    return y, states
