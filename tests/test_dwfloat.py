"""Double-word float32 arithmetic + the assoc_dw ramp engine.

The reference interpolates biquad coefficients per sample and ticks DF2T
with DOUBLE coefficients and DOUBLE state (ref: src/BiQuad.cpp:379-395,
473-494; src/BiQuad.h:200-240).  Float64 is slow or absent on accelerators, so the
parallel ramp engine carries hi+lo float32 pairs (error-free transforms)
instead; these tests pin (a) the EFT primitives' exactness under jit,
(b) the engine's ~148 dB match to a float64 golden on HARD filters
(near-unit-circle poles) where plain float32 is 50+ dB short, and
(c) the bank-level ramp path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bbcat_dsp_tpu.utils.dwfloat import (
    dw_add,
    dw_collapse,
    dw_from_f64,
    dw_mul,
    two_prod,
    two_sum,
)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_two_sum_exact_under_jit(rng):
    a = rng.standard_normal(4096).astype(np.float32)
    b = (rng.standard_normal(4096) * 1e-6).astype(np.float32)
    s, e = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    s, e = np.asarray(s, np.float64), np.asarray(e, np.float64)
    np.testing.assert_array_equal(
        s + e, a.astype(np.float64) + b.astype(np.float64)
    )


def test_two_prod_exact_under_jit(rng):
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    p, e = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    p, e = np.asarray(p, np.float64), np.asarray(e, np.float64)
    np.testing.assert_array_equal(
        p + e, a.astype(np.float64) * b.astype(np.float64)
    )


def test_dw_roundtrip_and_ops(rng):
    a = rng.standard_normal(1024) * np.exp(rng.standard_normal(1024))
    b = rng.standard_normal(1024) * np.exp(rng.standard_normal(1024))
    ah, al = dw_from_f64(a)
    bh, bl = dw_from_f64(b)
    # split residual ~2^-49 relative
    ra = np.asarray(ah, np.float64) + np.asarray(al, np.float64)
    assert np.max(np.abs(ra - a) / np.abs(a)) < 2.0 ** -48
    sh, sl = jax.jit(dw_add)(ah, al, bh, bl)
    s = np.asarray(sh, np.float64) + np.asarray(sl, np.float64)
    assert np.max(np.abs(s - (a + b)) / (np.abs(a + b) + 1e-30)) < 1e-13
    ph, pl = jax.jit(dw_mul)(ah, al, bh, bl)
    p = np.asarray(ph, np.float64) + np.asarray(pl, np.float64)
    assert np.max(np.abs(p - a * b) / (np.abs(a * b) + 1e-30)) < 1e-13


def _hard_ramp_case(rng, C=8, T=2048):
    """Low-frequency HPF ramp: poles within ~1e-4 of the unit circle."""
    from bbcat_dsp_tpu.golden.biquad import FilterType, biquad_coeffs

    x = rng.standard_normal((C, T))
    c0 = np.stack([
        biquad_coeffs(FilterType.HPF12, 80.0 + 0.5 * i, 48000.0)
        for i in range(C)
    ])
    c1 = np.stack([
        biquad_coeffs(FilterType.HPF12, 40.0 + 0.5 * i, 48000.0)
        for i in range(C)
    ])
    return x, c0, c1


def _golden_ramp(x, c0, c1, interp_samples):
    from bbcat_dsp_tpu.golden.biquad import biquad_process_interpolated

    return np.stack([
        biquad_process_interpolated(x[c], c0[c], c1[c], interp_samples)[0]
        for c in range(x.shape[0])
    ])


def _snr(y, g):
    y = np.asarray(y, np.float64)
    return 10 * np.log10(np.sum(g ** 2) / np.sum((y - g) ** 2))


def test_assoc_dw_matches_f64_golden_on_hard_filters(rng):
    """The dw engine tracks the double-precision reference semantics to
    ~140+ dB where the plain float32 engines are far short."""
    from bbcat_dsp_tpu.filters.iir import DWCoeffs, biquad_apply

    x, c0, c1 = _hard_ramp_case(rng)
    T = x.shape[-1]
    g = _golden_ramp(x, c0, c1, T)  # ramp spans the whole block
    mul = np.maximum(1.0 - np.arange(T) / T, 0.0)
    traj = c1[:, None, :] - mul[None, :, None] * (c1 - c0)[:, None, :]
    hi, lo = dw_from_f64(traj)
    y, _ = biquad_apply(jnp.asarray(x, jnp.float32), DWCoeffs(hi, lo))
    assert _snr(y, g) > 130.0
    # the same trajectory rounded to plain f32 is way short — this pins
    # that the dw planes (not luck) carry the precision
    y32, _ = biquad_apply(
        jnp.asarray(x, jnp.float32), jnp.asarray(traj, jnp.float32),
        engine="assoc",
    )
    assert _snr(y32, g) < 110.0


def test_assoc_dw_streaming_state_handover(rng):
    """Block-streamed dw ramp == one-shot dw ramp (state threads exactly)."""
    from bbcat_dsp_tpu.filters.iir import DWCoeffs, biquad_apply

    x, c0, c1 = _hard_ramp_case(rng, C=4, T=1024)
    T = x.shape[-1]
    mul = np.maximum(1.0 - np.arange(T) / T, 0.0)
    traj = c1[:, None, :] - mul[None, :, None] * (c1 - c0)[:, None, :]
    hi, lo = dw_from_f64(traj)
    x32 = jnp.asarray(x, jnp.float32)
    y_full, _ = biquad_apply(x32, DWCoeffs(hi, lo))
    B = T // 4
    outs, st = [], None
    for k in range(4):
        sl = slice(k * B, (k + 1) * B)
        y, st = biquad_apply(
            x32[..., sl], DWCoeffs(hi[:, sl], lo[:, sl]), st
        )
        outs.append(y)
    y_stream = jnp.concatenate(outs, -1)
    g = _golden_ramp(x, c0, c1, T)
    assert _snr(y_stream, g) > 125.0
    # and the two paths agree closely with each other
    assert _snr(np.asarray(y_stream), np.asarray(y_full, np.float64)) > 120.0


def test_bank_ramp_uses_dw_and_matches_golden(rng):
    """bank_process(engine='assoc_dw') reproduces the double-precision
    interpolated ramp through the bank API."""
    from bbcat_dsp_tpu.filters.bank import (
        bank_init,
        bank_process,
        bank_set_stage,
    )

    x, c0, c1 = _hard_ramp_case(rng, C=1, T=2048)
    T = x.shape[-1]
    st = bank_init(1, 1)
    st = bank_set_stage(st, 0, c0[0], 0)
    st = bank_set_stage(st, 0, c1[0], T)
    st, y = bank_process(st, jnp.asarray(x, jnp.float32), engine="assoc_dw")
    g = _golden_ramp(x, c0, c1, T)
    assert _snr(y, g) > 130.0
    assert float(st.mul[0]) == 0.0


def test_bank_class_ramp_then_steady(rng):
    """BiQuadFilterBank default path: dw ramp block, then modal steady
    blocks, state handed over exactly."""
    from bbcat_dsp_tpu.filters.bank import BiQuadFilterBank
    from bbcat_dsp_tpu.golden.biquad import FilterType, biquad_coeffs
    from bbcat_dsp_tpu.golden.biquad import biquad_process_interpolated

    C, B = 4, 512
    x = rng.standard_normal((C, 3 * B))
    bank = BiQuadFilterBank(1, C)
    bank.set_filter(0, FilterType.HPF12, 80.0)
    bank.set_filter(0, FilterType.HPF12, 40.0, interp_time=B / 48000.0)
    y = np.concatenate(
        [np.asarray(bank.process(jnp.asarray(x[:, k * B:(k + 1) * B],
                                             jnp.float32)))
         for k in range(3)], -1)
    c0 = biquad_coeffs(FilterType.HPF12, 80.0, 48000.0)
    c1 = biquad_coeffs(FilterType.HPF12, 40.0, 48000.0)
    g = np.stack([
        biquad_process_interpolated(x[c], c0, c1, float(B))[0]
        for c in range(C)
    ])
    assert _snr(y, g) > 110.0
