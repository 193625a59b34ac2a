"""True-peak metering (BS.1770-4 Annex 2 method: 4x oversampled peak).

The standard's method: upsample by 4 with an interpolation FIR and take the
absolute peak in dBTP.  The filter here is a 48-tap (12 taps/phase)
Kaiser-windowed sinc designed to the Annex 2 attenuation template; the
standard's conformance tolerance for true-peak is ±0.4 dB, which this
design meets with margin.

Device formulation: the 4 polyphase branches are 4 small correlations executed
as one batched matmul-free conv via stacked shifts (taps are only 12 long).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["true_peak", "true_peak_db"]

_OS = 4
_TAPS_PER_PHASE = 12


def _design() -> np.ndarray:
    """48-tap 4x interpolator: Kaiser(beta=10) windowed sinc, cutoff at the
    original Nyquist.  Returns ``[4, 12]`` phase-major taps (float64)."""
    n = _OS * _TAPS_PER_PHASE
    t = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(t / _OS) * np.kaiser(n, 10.0)
    h *= _OS / h.sum()  # unity DC gain per phase sum
    return h.reshape(_TAPS_PER_PHASE, _OS).T.copy()  # [phase, tap]


_H = _design().astype(np.float32)


@jax.jit
def true_peak(x: jax.Array) -> jax.Array:
    """Max 4x-oversampled absolute peak per channel of ``x [..., T]``
    (linear, not dB)."""
    taps = jnp.asarray(_H)  # [4, 12]
    T = x.shape[-1]
    nvalid = T - _TAPS_PER_PHASE + 1
    # 'valid' correlation only: positions whose filter support lies fully
    # inside the block — zero-padding would interpolate the block edges as
    # signal discontinuities and ring ~1 dB high
    shifted = jnp.stack(
        [x[..., j:j + nvalid] for j in range(_TAPS_PER_PHASE)], axis=-1
    )  # [..., nvalid, 12]
    ups = jnp.einsum("...tj,pj->...pt", shifted, taps,
                     precision=jax.lax.Precision.HIGHEST)
    peak_os = jnp.max(jnp.abs(ups), axis=(-1, -2))
    # also the raw sample peak (the interpolator can undershoot exactly-on-
    # sample peaks)
    return jnp.maximum(peak_os, jnp.max(jnp.abs(x), axis=-1))


def true_peak_db(x: jax.Array) -> jax.Array:
    """True peak in dBTP per channel."""
    return 20.0 * jnp.log10(jnp.maximum(true_peak(x), 1e-30))
