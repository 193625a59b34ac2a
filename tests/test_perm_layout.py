"""Permuted-layout half-window engine (the transpose-free large-n path).

For n > _MAX_DIRECT the dftmm backend stores half-window spectra in a
radix-r permuted bin order (bin k = r*k1 + k2 at position k2*(n1/2)+k1,
Nyquist tail last) so both transforms become one batched matmul plus
elementwise stages — no materialised transposes.  The engines only use spectra
elementwise, so results must match the standard layout exactly (up to
summation-order rounding).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bbcat_dsp_tpu.convolve import fft as F


def snr_db(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    if err == 0:
        return np.inf
    return 10 * np.log10(np.sum(ref**2) / err)


def test_perm_layout_resolution(monkeypatch):
    assert F.half_engine_layout(1024, "dftmm") == "std"
    assert F.half_engine_layout(8192, "dftmm") == "perm"
    assert F.half_engine_layout(8192, "xla") == "std"
    # auto radix targets the 256..1024 inner-transform window
    assert F._perm_radix(8192) == 32
    assert F._perm_radix(4096) == 16
    assert F._perm_radix(16384) == 32
    assert F._perm_radix(32768) == 32
    # past the window (n1 > 1024 at radix 32, > _MAX_DIRECT at the radix-8
    # fallback) the std four-step serves
    assert F.half_engine_layout(65536, "dftmm") == "std"
    assert F.spectral_nbins(8192, "dftmm") == 32 * 129  # n1 = 256
    assert F.spectral_nbins(1024, "dftmm") == 513
    # explicit env radix bypasses the window
    monkeypatch.setenv("BBCAT_DSP_PERM_RADIX", "8")
    assert F._perm_radix(8192) == 8
    assert F.spectral_nbins(8192, "dftmm") == 8 * 513


@pytest.mark.parametrize("n", [4096, 8192])
def test_perm_rfft_half_matches_numpy(rng, n):
    x = rng.standard_normal((3, n // 2)).astype(np.float32)
    X = np.fft.rfft(np.concatenate([x, np.zeros_like(x)], -1), axis=-1)
    exp = F.permute_half_spectrum(X, n)
    got = np.asarray(F._perm_rfft_half(jnp.asarray(x), n, prec="highest"))
    gc = got[0] + 1j * got[1]
    assert np.abs(gc - exp).max() / np.abs(exp).max() < 1e-5


@pytest.mark.parametrize("n", [4096, 8192])
def test_perm_irfft_tail_matches_numpy(rng, n):
    Fn = n // 2 + 1
    spec = (rng.standard_normal((3, Fn))
            + 1j * rng.standard_normal((3, Fn)))
    y_ref = np.fft.irfft(spec, n=n, axis=-1)[..., n // 2:]
    ps = F.permute_half_spectrum(spec, n)
    sp = np.stack([ps.real, ps.imag]).astype(np.float32)
    got = np.asarray(F._perm_irfft_tail(jnp.asarray(sp), n, prec="highest"))
    assert np.abs(got - y_ref).max() / np.abs(y_ref).max() < 1e-5


def test_perm_signs_shift_theorem(rng):
    """Window assembly in the permuted layout: Xperm(prev half) +
    s_perm * Xperm(cur half) == permuted spectrum of the full window."""
    n = 4096
    w = rng.standard_normal((2, n)).astype(np.float32)
    a, b = w[..., : n // 2], w[..., n // 2:]
    Xa = np.asarray(F._perm_rfft_half(jnp.asarray(a), n, prec="highest"))
    Xb = np.asarray(F._perm_rfft_half(jnp.asarray(b), n, prec="highest"))
    s = F.half_window_signs(n, "dftmm")
    got = Xa + s * Xb
    exp = F.permute_half_spectrum(np.fft.rfft(w, axis=-1), n)
    gc = got[0] + 1j * got[1]
    assert np.abs(gc - exp).max() / np.abs(exp).max() < 1e-5


def test_perm_radix16_matches_numpy(rng, monkeypatch):
    """BBCAT_DSP_PERM_RADIX=16 (halved stage matmul, doubled radix stage):
    forward and inverse still match numpy, signs/bins/permutation agree."""
    monkeypatch.setenv("BBCAT_DSP_PERM_RADIX", "16")
    n = 8192
    r = F._perm_radix(n)
    assert r == 16
    assert F.spectral_nbins(n, "dftmm") == 16 * (512 // 2 + 1)
    x = rng.standard_normal((4, n // 2)).astype(np.float32)
    X = np.fft.rfft(np.concatenate([x, np.zeros_like(x)], -1), axis=-1)
    exp = F.permute_half_spectrum(X, n)
    got = np.asarray(F._perm_rfft_half(jnp.asarray(x), n, prec="highest"))
    gc = got[0] + 1j * got[1]
    assert np.abs(gc - exp).max() / np.abs(exp).max() < 1e-5

    Fn = n // 2 + 1
    spec = (rng.standard_normal((4, Fn))
            + 1j * rng.standard_normal((4, Fn)))
    y_ref = np.fft.irfft(spec, n=n, axis=-1)[..., n // 2:]
    ps = F.permute_half_spectrum(spec, n)
    sp = np.stack([ps.real, ps.imag]).astype(np.float32)
    y = np.asarray(F._perm_irfft_tail(jnp.asarray(sp), n, prec="highest"))
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5


def test_perm_radix32_matches_numpy(rng, monkeypatch):
    """Radix 32 (smallest stage matmul, heaviest unrolled radix stage)."""
    monkeypatch.setenv("BBCAT_DSP_PERM_RADIX", "32")
    n = 8192
    assert F._perm_radix(n) == 32
    x = rng.standard_normal((2, n // 2)).astype(np.float32)
    X = np.fft.rfft(np.concatenate([x, np.zeros_like(x)], -1), axis=-1)
    exp = F.permute_half_spectrum(X, n)
    got = np.asarray(F._perm_rfft_half(jnp.asarray(x), n, prec="highest"))
    gc = got[0] + 1j * got[1]
    assert np.abs(gc - exp).max() / np.abs(exp).max() < 1e-5
    Fn = n // 2 + 1
    spec = (rng.standard_normal((2, Fn)) + 1j * rng.standard_normal((2, Fn)))
    y_ref = np.fft.irfft(spec, n=n, axis=-1)[..., n // 2:]
    ps = F.permute_half_spectrum(spec, n)
    sp = np.stack([ps.real, ps.imag]).astype(np.float32)
    y = np.asarray(F._perm_irfft_tail(jnp.asarray(sp), n, prec="highest"))
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5


def test_cmatmul_karatsuba_matches_classic(rng, monkeypatch):
    """BBCAT_DSP_CMATMUL=karatsuba (3 real matmuls) == the classic 4-matmul
    complex multiply, across the transforms that use it."""
    n = 8192
    x = rng.standard_normal((4, n // 2)).astype(np.float32)
    spec = rng.standard_normal(
        (2, 4, F.spectral_nbins(n, "dftmm"))).astype(np.float32)

    monkeypatch.setenv("BBCAT_DSP_CMATMUL", "classic")
    f_ref = np.asarray(F._perm_rfft_half(jnp.asarray(x), n, prec="highest"))
    i_ref = np.asarray(F._perm_irfft_tail(jnp.asarray(spec), n,
                                          prec="highest"))
    monkeypatch.setenv("BBCAT_DSP_CMATMUL", "karatsuba")
    jax.clear_caches()
    f_got = np.asarray(F._perm_rfft_half(jnp.asarray(x), n, prec="highest"))
    i_got = np.asarray(F._perm_irfft_tail(jnp.asarray(spec), n,
                                          prec="highest"))
    jax.clear_caches()
    sf = np.abs(f_ref).max()
    si = np.abs(i_ref).max()
    np.testing.assert_allclose(f_got / sf, f_ref / sf, atol=2e-6)
    np.testing.assert_allclose(i_got / si, i_ref / si, atol=2e-6)


@pytest.fixture
def force_dftmm(monkeypatch):
    """Route the default backend to dftmm so the permuted layout engages
    wherever a radix applies."""
    monkeypatch.setattr(F, "default_backend", lambda: "dftmm")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_block_convolver_perm_layout_matches_xla(rng, force_dftmm):
    """Uniform engine at a perm-layout block size: render + streaming
    steps + click-free swap all agree with the std (xla) path."""
    from bbcat_dsp_tpu.convolve import BlockConvolver

    B, C = 2048, 2
    ir = (rng.standard_normal((C, 3 * B)) * 0.3).astype(np.float64)
    ir2 = (rng.standard_normal((C, 3 * B)) * 0.3).astype(np.float64)
    x = rng.standard_normal((C, 8 * B)).astype(np.float32)

    conv = BlockConvolver(ir, block=B)
    assert conv.state.queue.shape[-1] == F.spectral_nbins(2 * B, "dftmm")
    y1 = np.asarray(conv.process(jnp.asarray(x[:, : 4 * B])))
    conv.set_filter(ir2)
    y2 = np.concatenate(
        [np.asarray(conv.process_block(jnp.asarray(
            x[:, (4 + k) * B:(5 + k) * B]))) for k in range(4)], axis=-1)
    got = np.concatenate([y1, y2], axis=-1)

    # std reference via the xla backend
    import bbcat_dsp_tpu.convolve.fft as fftmod
    orig = fftmod.default_backend
    fftmod.default_backend = lambda: "xla"
    jax.clear_caches()
    try:
        ref = BlockConvolver(ir, block=B)
        r1 = np.asarray(ref.process(jnp.asarray(x[:, : 4 * B])))
        ref.set_filter(ir2)
        r2 = np.concatenate(
            [np.asarray(ref.process_block(jnp.asarray(
                x[:, (4 + k) * B:(5 + k) * B]))) for k in range(4)], axis=-1)
        exp = np.concatenate([r1, r2], axis=-1)
    finally:
        fftmod.default_backend = orig
    assert snr_db(exp, got) > 100.0


def test_nonuniform_perm_tail_matches_xla(rng, force_dftmm):
    """Two-level engine whose TAIL runs in the permuted layout: whole
    renders + small-block streaming interleave match the std path."""
    from bbcat_dsp_tpu.convolve import NonUniformConvolver

    B, ratio, C = 256, 8, 2
    B2 = B * ratio  # 2048 -> tail FFT 4096 > _MAX_DIRECT -> perm
    N = 2 * B2 + 5 * B2  # head + 5 tail partitions
    ir = (rng.standard_normal((C, N)) * 0.2).astype(np.float64)
    x = rng.standard_normal((C, 10 * B2)).astype(np.float32)

    conv = NonUniformConvolver(ir, block=B, ratio=ratio)
    assert conv.state.tail.queue.shape[-1] == F.spectral_nbins(
        2 * B2, "dftmm")
    got = np.asarray(conv.process(jnp.asarray(x)))

    import bbcat_dsp_tpu.convolve.fft as fftmod
    orig = fftmod.default_backend
    fftmod.default_backend = lambda: "xla"
    jax.clear_caches()
    try:
        ref = NonUniformConvolver(ir, block=B, ratio=ratio)
        exp = np.asarray(ref.process(jnp.asarray(x)))
    finally:
        fftmod.default_backend = orig
    assert snr_db(exp, got) > 100.0


def test_nonuniform_perm_crossfade_matches_xla(rng, force_dftmm):
    """Click-free IR exchange with the tail in the permuted layout:
    super-block streaming with a mid-stream set_filter matches the std
    path, and the small-block low-latency mode stays consistent."""
    from bbcat_dsp_tpu.convolve import NonUniformConvolver

    B, ratio, C = 256, 8, 2
    B2 = B * ratio
    N = 2 * B2 + 3 * B2
    ir1 = (rng.standard_normal((C, N)) * 0.2).astype(np.float64)
    ir2 = (rng.standard_normal((C, N)) * 0.2).astype(np.float64)
    x = rng.standard_normal((C, 8 * B2)).astype(np.float32)

    def run(conv):
        ys = []
        for j in range(4):
            ys.append(np.asarray(conv.process_block(
                jnp.asarray(x[:, j * B2:(j + 1) * B2]))))
        conv.set_filter(ir2)
        for j in range(4, 6):
            ys.append(np.asarray(conv.process_block(
                jnp.asarray(x[:, j * B2:(j + 1) * B2]))))
        # small-block streaming continues from the same state
        for k in range(ratio):
            s = 6 * B2 + k * B
            ys.append(np.asarray(conv.process_small_block(
                jnp.asarray(x[:, s:s + B]))))
        return np.concatenate(ys, axis=-1)

    got = run(NonUniformConvolver(ir1, block=B, ratio=ratio))

    import bbcat_dsp_tpu.convolve.fft as fftmod
    orig = fftmod.default_backend
    fftmod.default_backend = lambda: "xla"
    jax.clear_caches()
    try:
        exp = run(NonUniformConvolver(ir1, block=B, ratio=ratio))
    finally:
        fftmod.default_backend = orig
    assert snr_db(exp, got) > 100.0


def test_unpermute_inverts_permute(rng):
    """unpermute_half_spectrum is the exact inverse of
    permute_half_spectrum (both directions, incl. the redundant
    conjugate-mirror bins on the perm side)."""
    for n in (4096, 8192):
        spec = (rng.standard_normal((3, n // 2 + 1))
                + 1j * rng.standard_normal((3, n // 2 + 1)))
        # real-signal hermitian constraints the forward transform imposes
        spec[..., 0] = spec[..., 0].real
        spec[..., -1] = spec[..., -1].real
        perm = F.permute_half_spectrum(spec, n)
        back = F.unpermute_half_spectrum(perm, n)
        np.testing.assert_array_equal(back, spec)
        np.testing.assert_array_equal(
            F.permute_half_spectrum(back, n), perm)
    with pytest.raises(ValueError):
        F.unpermute_half_spectrum(perm, 1024)  # no perm layout at 1024


def test_engine_constructor_falls_back_when_perm_build_fails(
        rng, force_dftmm, monkeypatch):
    """If the permuted-layout program fails to BUILD on the
    target backend, the engine constructor falls back to the standard
    layout with a warning and still produces a working convolver."""
    from bbcat_dsp_tpu.convolve import BlockConvolver

    monkeypatch.setattr(F, "_LAYOUT_BLOCKED", set())
    monkeypatch.setattr(F, "_LAYOUT_OK", set())

    def boom(x, n, prec=None):
        raise RuntimeError("mosaic rejected the program")

    monkeypatch.setattr(F, "_perm_rfft_half", boom)

    B = 2048  # 2*B = 4096 > _MAX_DIRECT -> perm would apply
    ir = (rng.standard_normal(3 * B) * 0.3).astype(np.float64)
    x = rng.standard_normal(4 * B).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="failed to build"):
        conv = BlockConvolver(ir, block=B)
    # the whole engine resolved std: state sized for natural bin order
    assert F.half_engine_layout(2 * B, "dftmm") == "std"
    assert conv.state.queue.shape[-1] == 2 * B // 2 + 1
    got = np.concatenate(
        [np.asarray(conv.process_block(jnp.asarray(x[k * B:(k + 1) * B])))
         for k in range(4)])
    from scipy.signal import fftconvolve

    exp = fftconvolve(x.astype(np.float64), ir)[: 4 * B]
    assert snr_db(exp, got) > 90.0
