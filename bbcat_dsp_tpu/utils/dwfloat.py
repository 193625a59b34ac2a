"""Double-word float32 arithmetic (error-free transforms).

Float64 is slow or absent on accelerators, but some recurrences need more
than float32: the reference interpolates biquad coefficients per sample
and runs the DF2T tick with DOUBLE coefficients and DOUBLE state
(ref: src/BiQuad.cpp:379-395, 473-494; src/BiQuad.h:200-240), so a
float32-only parallel scan can be 50+ dB short for low-frequency /
high-Q filters whose poles sit within ~1e-4 of the unit circle — the
dominant error being the *rounding of the coefficients themselves*
(pole perturbation), not the scan arithmetic.

This module represents each number as an unevaluated pair ``hi + lo`` of
float32s (a "double-word", ~49-bit effective mantissa) and provides the
classical error-free building blocks:

* ``two_sum``   — Knuth's branch-free exact addition (6 flops)
* ``split``     — Dekker's 12/12-bit splitter (constant 2**12 + 1)
* ``two_prod``  — Dekker/Veltkamp exact product (no FMA required)
* ``dw_add`` / ``dw_mul`` — normalized double-word ops

All operations are pure element-wise jnp arithmetic: they vectorize,
survive ``jit`` (XLA does not reassociate float ops, and
mul+add contraction into FMA only *tightens* the ``two_prod`` error
term), and work identically on CPU and GPU (``chip_smoke.py`` checks the
transforms exact under jit on the card).  The double-word companion scan
tracks a float64 reference at ~148 dB SNR where plain float32 reaches
60-85 dB (``tests/test_dwfloat.py``).

References: T. J. Dekker, "A floating-point technique for extending the
available precision" (1971); Hida, Li & Bailey, "Algorithms for
quad-double precision floating point arithmetic" (2001).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "two_sum",
    "split",
    "two_prod",
    "dw_add",
    "dw_mul",
    "dw_neg",
    "dw_from_f64",
    "dw_collapse",
]

# 2**12 + 1: Veltkamp splitter for float32's 24-bit mantissa.
_SPLIT = 4097.0


def two_sum(a, b):
    """Exact addition: returns ``(s, e)`` with ``s = fl(a+b)`` and
    ``a + b = s + e`` exactly (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def split(a):
    """Veltkamp split of ``a`` into 12-bit halves ``(hi, lo)``,
    ``a = hi + lo`` exactly."""
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact product: returns ``(p, e)`` with ``p = fl(a*b)`` and
    ``a * b = p + e`` exactly (Dekker, FMA-free)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _renorm(hi, lo):
    s = hi + lo
    return s, lo - (s - hi)


def dw_add(xh, xl, yh, yl):
    """Double-word addition (normalized)."""
    s, e = two_sum(xh, yh)
    return _renorm(s, e + (xl + yl))


def dw_mul(xh, xl, yh, yl):
    """Double-word multiplication (normalized)."""
    p, e = two_prod(xh, yh)
    return _renorm(p, e + (xh * yl + xl * yh))


def dw_neg(xh, xl):
    return -xh, -xl


def dw_from_f64(a, dtype=jnp.float32):
    """Split a host float64 array into double-word planes ``(hi, lo)``.

    ``hi`` is ``a`` rounded to float32 and ``lo`` the float32 residual;
    ``hi + lo`` recovers ``a`` to ~49 bits — enough to preserve biquad
    pole positions that float32 alone perturbs audibly.
    """
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi, dtype), jnp.asarray(lo, dtype)


def dw_collapse(hi, lo):
    """Best float32 approximation of the pair (host: exact float64 sum)."""
    if isinstance(hi, np.ndarray) or np.isscalar(hi):
        return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    return hi + lo
