"""Biquad coefficient design (host-side, float64) + batched response curves.

Coefficient design is control-plane work: it happens at parameter-change
rate (Hz), not sample rate, so the design computes it on the host
in float64 — exactly the golden model's math (ref: src/BiQuad.cpp:181-325) —
and ships the resulting ``[b0, b1, b2, a1, a2]`` arrays to the device.

This module wraps the golden math with batch/vectorised helpers used by the
device engine in :mod:`bbcat_dsp_tpu.filters.iir`.
"""

from __future__ import annotations

import numpy as np

from ..golden.biquad import FilterType, biquad_coeffs, biquad_response

__all__ = [
    "FilterType",
    "biquad_coeffs",
    "biquad_response",
    "design_bank",
    "cascade_response",
    "write_response",
]


def design_bank(specs) -> np.ndarray:
    """Design a stack of biquads from ``(type, freq[, gain[, bandwidth]])``
    tuples.  Returns ``[stages, 5]`` float64.

    The ``fs`` key must be supplied per spec dict or as tuples
    ``(type, freq, fs, gain, bandwidth)``; see also
    :class:`bbcat_dsp_tpu.filters.manager.FilterManager` for named configs.
    """
    rows = []
    for spec in specs:
        if isinstance(spec, dict):
            rows.append(
                biquad_coeffs(
                    FilterType[spec["type"]] if isinstance(spec["type"], str) else spec["type"],
                    spec["freq"],
                    spec["fs"],
                    spec.get("gain", 0.0),
                    spec.get("bandwidth", 1.0),
                )
            )
        else:
            rows.append(biquad_coeffs(*spec))
    return np.stack(rows)


def cascade_response(coeffs: np.ndarray, f, fs: float) -> np.ndarray:
    """Complex response of a biquad cascade = product of stage responses
    (ref: src/BiQuad.cpp:715-724)."""
    coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
    h = np.ones_like(np.asarray(f, np.float64), dtype=np.complex128)
    for row in coeffs:
        h = h * biquad_response(row, f, fs)
    return h


def write_response(path, coeffs, fs: float, npoints: int = 1000,
                   fmin: float = 10.0) -> np.ndarray:
    """Dump an ``npoints``-point log-spaced magnitude response (dB) of a
    biquad / cascade to ``path`` — the debug diagnostic the reference emits
    from ``BiQuadCoeffs::CalcCoeffs`` at debug level (ref:
    src/BiQuad.cpp:351-370, 1000 log-spaced points to ``coeffs.dat``).

    One ``<freq_hz> <mag_db>`` pair per line.  Returns the frequency grid.
    """
    fmax = fs / 2.0
    f = fmin * (fmax / fmin) ** (np.arange(npoints) / (npoints - 1))
    mag = np.abs(cascade_response(coeffs, f, fs))
    db = 20.0 * np.log10(np.maximum(mag, 1e-30))
    with open(path, "w") as fh:
        for fi, di in zip(f, db):
            fh.write(f"{fi:.6f} {di:.6f}\n")
    return f
