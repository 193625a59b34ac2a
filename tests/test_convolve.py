"""Partitioned convolution vs golden oracle: accuracy, streaming, crossfade,
matrix mix-down (SURVEY.md §4; BASELINE.json configs #1 and #3)."""

import numpy as np
import jax.numpy as jnp
import pytest

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.convolve import (
    BlockConvolver,
    MatrixConvolver,
    convolver_init,
    convolver_render,
    convolver_step,
    partition_ir,
)
from conftest import snr_db


def _exp_ir(rng, n, decay=500.0):
    return (rng.standard_normal(n) * np.exp(-np.arange(n) / decay)).astype(
        np.float64
    )


def test_baseline_config1_mono_4096taps(rng):
    """BASELINE.json config #1: 48 kHz mono, 512-block, 4096-tap IR;
    >=90 dB SNR vs the float64 golden model."""
    B, N, T = 512, 4096, 512 * 16
    ir = _exp_ir(rng, N)
    x = rng.standard_normal(T)
    ref = golden.direct_convolve(x, ir)[:T]
    conv = BlockConvolver(ir, block=B)
    y = np.asarray(conv.process(jnp.asarray(x, jnp.float32)))
    assert snr_db(ref, y) > 90.0


def test_streaming_equals_render(rng):
    B, N, T = 256, 1024, 256 * 8
    ir = _exp_ir(rng, N)
    x = rng.standard_normal((3, T)).astype(np.float32)
    c1 = BlockConvolver(np.broadcast_to(ir, (3, N)), block=B)
    y_render = np.asarray(c1.process(jnp.asarray(x)))
    c2 = BlockConvolver(np.broadcast_to(ir, (3, N)), block=B)
    outs = [
        np.asarray(c2.process_block(jnp.asarray(x[:, i * B:(i + 1) * B])))
        for i in range(T // B)
    ]
    np.testing.assert_allclose(np.concatenate(outs, -1), y_render, atol=1e-5)


def test_multichannel_distinct_irs(rng):
    B, N, T = 128, 512, 128 * 6
    irs = np.stack([_exp_ir(rng, N, 100), _exp_ir(rng, N, 300)])
    x = rng.standard_normal((2, T))
    conv = BlockConvolver(irs, block=B)
    y = np.asarray(conv.process(jnp.asarray(x, jnp.float32)))
    for c in range(2):
        ref = golden.direct_convolve(x[c], irs[c])[:T]
        assert snr_db(ref, y[c]) > 90.0


def test_partitioned_vs_golden_partitioned(rng):
    """Block-exact agreement with the golden partitioned (not just direct)
    model — validates the overlap-save scheduling itself."""
    B, N, T = 64, 512, 64 * 12
    ir = _exp_ir(rng, N, 80)
    x = rng.standard_normal(T)
    ref = golden.partitioned_convolve(x, ir, B)
    conv = BlockConvolver(ir, block=B)
    y = np.asarray(conv.process(jnp.asarray(x, jnp.float32)))
    assert snr_db(ref, y) > 90.0


def test_crossfade_swap_matches_golden(rng):
    B, N, T = 128, 768, 128 * 10
    swap_block = 5
    h_old = _exp_ir(rng, N, 100)
    h_new = _exp_ir(rng, N, 400)
    x = rng.standard_normal(T)
    ref = golden.crossfade_swap_convolve(x, h_old, h_new, B, swap_block)
    conv = BlockConvolver(h_old, block=B)
    outs = []
    for i in range(T // B):
        if i == swap_block:
            conv.set_filter(h_new)
        outs.append(
            np.asarray(conv.process_block(jnp.asarray(x[i * B:(i + 1) * B],
                                                      jnp.float32)))
        )
    y = np.concatenate(outs)
    assert snr_db(ref, y) > 90.0


def test_swap_same_ir_is_identity(rng):
    """Swapping in the identical IR must be bit-benign (no click)."""
    B, N, T = 128, 512, 128 * 6
    ir = _exp_ir(rng, N)
    x = rng.standard_normal(T).astype(np.float32)
    c1 = BlockConvolver(ir, block=B)
    y_plain = [np.asarray(c1.process_block(jnp.asarray(x[i*B:(i+1)*B])))
               for i in range(T // B)]
    c2 = BlockConvolver(ir, block=B)
    outs = []
    for i in range(T // B):
        c2.set_filter(ir)  # swap every block
        outs.append(np.asarray(c2.process_block(jnp.asarray(x[i*B:(i+1)*B]))))
    np.testing.assert_allclose(
        np.concatenate(outs), np.concatenate(y_plain), atol=2e-5
    )


def test_matrix_convolver_hrtf_shape(rng):
    """64-in x 2-out mix-down equals the sum of per-pair direct
    convolutions (BASELINE.json config #3, shrunk)."""
    ci, co, B, N, T = 8, 2, 64, 256, 64 * 6
    irm = rng.standard_normal((ci, co, N)) * np.exp(
        -np.arange(N) / 60.0
    )
    x = rng.standard_normal((ci, T))
    conv = MatrixConvolver(irm, block=B)
    outs = [
        np.asarray(conv.process_block(jnp.asarray(x[:, i*B:(i+1)*B], jnp.float32)))
        for i in range(T // B)
    ]
    y = np.concatenate(outs, -1)
    for o in range(co):
        ref = np.zeros(T)
        for i in range(ci):
            ref += golden.direct_convolve(x[i], irm[i, o])[:T]
        assert snr_db(ref, y[o]) > 90.0


def test_matrix_crossfade(rng):
    ci, co, B, N, T = 4, 2, 64, 128, 64 * 8
    irm_a = rng.standard_normal((ci, co, N)) * 0.5
    irm_b = rng.standard_normal((ci, co, N)) * 0.5
    x = rng.standard_normal((ci, T))
    swap = 4
    conv = MatrixConvolver(irm_a, block=B)
    outs = []
    for i in range(T // B):
        if i == swap:
            conv.set_filter_matrix(irm_b)
        outs.append(np.asarray(conv.process_block(
            jnp.asarray(x[:, i*B:(i+1)*B], jnp.float32))))
    y = np.concatenate(outs, -1)
    ramp = (np.arange(B) + 1.0) / B
    for o in range(co):
        ya = np.zeros(T)
        yb = np.zeros(T)
        for i in range(ci):
            ya += golden.direct_convolve(x[i], irm_a[i, o])[:T]
            yb += golden.direct_convolve(x[i], irm_b[i, o])[:T]
        ref = ya.copy()
        s = swap * B
        ref[s:s+B] = (1 - ramp) * ya[s:s+B] + ramp * yb[s:s+B]
        ref[s+B:] = yb[s+B:]
        assert snr_db(ref, y[o]) > 90.0


def test_ir_shorter_than_block(rng):
    B, N, T = 256, 40, 256 * 4
    ir = rng.standard_normal(N)
    x = rng.standard_normal(T)
    conv = BlockConvolver(ir, block=B)
    y = np.asarray(conv.process(jnp.asarray(x, jnp.float32)))
    ref = golden.direct_convolve(x, ir)[:T]
    assert snr_db(ref, y) > 90.0


def test_nparts_padding(rng):
    """Extra partitions (pre-allocated headroom for longer swap IRs) are
    harmless zeros."""
    B, N, T = 128, 300, 128 * 4
    ir = rng.standard_normal(N)
    x = rng.standard_normal(T)
    a = BlockConvolver(ir, block=B)
    b = BlockConvolver(ir, block=B, nparts=8)
    ya = np.asarray(a.process(jnp.asarray(x, jnp.float32)))
    yb = np.asarray(b.process(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(ya, yb, atol=1e-6)


def test_dftmm_backend_matches_xla(rng):
    """The matmul-DFT backend must match jnp.fft."""
    from bbcat_dsp_tpu.convolve import rfft_planes, irfft_planes

    x = rng.standard_normal((3, 1024)).astype(np.float32)
    a = np.asarray(rfft_planes(jnp.asarray(x), 1024, backend="xla"))
    b = np.asarray(rfft_planes(jnp.asarray(x), 1024, backend="dftmm"))
    assert snr_db(a, b) > 110.0
    ya = np.asarray(irfft_planes(jnp.asarray(a), 1024, backend="xla"))
    yb = np.asarray(irfft_planes(jnp.asarray(a), 1024, backend="dftmm"))
    assert snr_db(ya, yb) > 110.0
    np.testing.assert_allclose(ya, x, atol=1e-4)


def test_uniform_static_slot_render_matches_dynamic(rng):
    """Zero-gather uniform render == dynamic-slot render, across chained
    calls and mixed with per-block streaming."""
    from bbcat_dsp_tpu.convolve import convolver_init
    from bbcat_dsp_tpu.convolve.block import convolver_render

    B, N = 64, 512
    ir = rng.standard_normal(N) * 0.3
    conv = BlockConvolver(ir, block=B)
    P = conv.nparts
    T = B * P * 2
    x = rng.standard_normal((1, T)).astype(np.float32)
    y1 = np.asarray(conv.process(jnp.asarray(x)))       # fast path
    y2 = np.asarray(conv.process(jnp.asarray(x)))       # fast path, slot carried

    st = convolver_init(1, B, P)
    st, r1 = convolver_render(st, conv.H, jnp.asarray(x), B)
    st, r2 = convolver_render(st, conv.H, jnp.asarray(x), B)
    np.testing.assert_allclose(y1, np.asarray(r1), atol=1e-5)
    np.testing.assert_allclose(y2, np.asarray(r2), atol=1e-5)


def test_matrix_render_and_per_input_swap(rng):
    ci, co, B, N, T = 4, 2, 64, 128, 64 * 8
    irm = rng.standard_normal((ci, co, N)) * 0.4
    x = rng.standard_normal((ci, T)).astype(np.float32)
    a = MatrixConvolver(irm, block=B)
    y_render = np.asarray(a.process(jnp.asarray(x)))
    b = MatrixConvolver(irm, block=B)
    outs = [np.asarray(b.process_block(jnp.asarray(x[:, i*B:(i+1)*B])))
            for i in range(T // B)]
    np.testing.assert_allclose(np.concatenate(outs, -1), y_render, atol=1e-5)

    # per-input swap: only input 2's contribution changes
    new2 = rng.standard_normal((co, N)) * 0.4
    c = MatrixConvolver(irm, block=B)
    outs = []
    for i in range(T // B):
        if i == 2:
            c.set_filter_matrix(new2, in_channel=2)
        outs.append(np.asarray(c.process_block(jnp.asarray(x[:, i*B:(i+1)*B]))))
    y = np.concatenate(outs, -1)
    irm2 = irm.copy()
    irm2[2] = new2
    settle = 5 * B
    for o in range(co):
        ref = np.zeros(T)
        for i in range(ci):
            ref += golden.direct_convolve(x[i], irm2[i, o])[:T]
        assert snr_db(ref[settle:], y[o, settle:]) > 90.0


def test_offline_convolve_matches_golden(rng):
    """Big-chunk overlap-save (bounce path) >= 90 dB vs golden, multiple
    IR/signal size combinations incl. multi-chunk."""
    from bbcat_dsp_tpu.convolve import offline_convolve

    for C, N, T in [(1, 400, 5000), (3, 1000, 12000), (2, 64, 700)]:
        irs = rng.standard_normal((C, N)) * np.exp(-np.arange(N) / (N / 4))
        x = rng.standard_normal((C, T))
        y = np.asarray(offline_convolve(jnp.asarray(x, jnp.float32), irs,
                                        n_fft=4096))
        for c in range(C):
            ref = golden.direct_convolve(x[c], irs[c])[:T]
            assert snr_db(ref, y[c]) > 90.0, (C, N, T, c)


def test_offline_matches_streaming_engine(rng):
    from bbcat_dsp_tpu.convolve import offline_convolve

    B, N, T = 128, 1024, 128 * 10
    ir = rng.standard_normal((2, N)) * 0.2
    x = rng.standard_normal((2, T)).astype(np.float32)
    stream = BlockConvolver(ir, block=B)
    ys = np.asarray(stream.process(jnp.asarray(x)))
    yo = np.asarray(offline_convolve(jnp.asarray(x), ir))
    assert snr_db(ys, yo) > 90.0


def test_uniform_mixed_mode_slot_tracking(rng):
    """BlockConvolver: per-block streaming then whole-signal render keeps
    the host step mirror (and therefore the static slot) correct."""
    B, N = 64, 512
    ir = rng.standard_normal(N) * 0.3
    conv = BlockConvolver(ir, block=B)
    P = conv.nparts
    T1 = B * 3                  # odd number of blocks via process_block
    T2 = B * P * 2              # then fast-path render
    x = rng.standard_normal(T1 + T2).astype(np.float32)
    ys = [np.asarray(conv.process_block(jnp.asarray(x[None, i*B:(i+1)*B])))
          for i in range(3)]
    y2 = np.asarray(conv.process(jnp.asarray(x[None, T1:])))
    y = np.concatenate(ys + [y2], -1)[0]
    ref = golden.direct_convolve(x, ir)[: y.size]
    assert snr_db(ref, y) > 90.0


def test_rfft_halfwin_large_matches_numpy(rng):
    """Rectangular four-step half-window forward (>_MAX_DIRECT sizes) ==
    numpy rfft of [x, zeros]."""
    from bbcat_dsp_tpu.convolve.fft import _rfft_halfwin_large

    n = 8192
    x = rng.standard_normal((3, n // 2)).astype(np.float32)
    got = np.asarray(_rfft_halfwin_large(jnp.asarray(x), n))
    ref = np.fft.rfft(np.concatenate([x, np.zeros_like(x)], -1), axis=-1)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got[0], ref.real, atol=2e-4 * scale)
    np.testing.assert_allclose(got[1], ref.imag, atol=2e-4 * scale)


def test_irfft_tail_large_matches_numpy(rng):
    """Rectangular four-step tail-only inverse (>_MAX_DIRECT sizes) ==
    last n/2 samples of numpy irfft."""
    from bbcat_dsp_tpu.convolve.fft import _irfft_tail_large

    n = 8192
    F = n // 2 + 1
    spec = rng.standard_normal((2, 3, F)).astype(np.float32)
    got = np.asarray(_irfft_tail_large(jnp.asarray(spec), n))
    z = spec[0] + 1j * spec[1]
    ref = np.fft.irfft(z, n=n, axis=-1)[..., n // 2:]
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale)


def test_half_transforms_odd_factor_fallback(rng):
    """Sizes whose balanced factors are odd fall back to the generic
    four-step (correctness over speed)."""
    from bbcat_dsp_tpu.convolve.fft import (
        _balanced_factors, _irfft_tail_large, _rfft_halfwin_large)

    n = 4608  # 2^9 * 3^2 -> at least one odd factor possible
    n1, n2 = _balanced_factors(n)
    x = rng.standard_normal((2, n // 2)).astype(np.float32)
    got = np.asarray(_rfft_halfwin_large(jnp.asarray(x), n))
    ref = np.fft.rfft(np.concatenate([x, np.zeros_like(x)], -1), axis=-1)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got[0], ref.real, atol=2e-4 * scale)
    np.testing.assert_allclose(got[1], ref.imag, atol=2e-4 * scale)
    F = n // 2 + 1
    spec = rng.standard_normal((2, 2, F)).astype(np.float32)
    got2 = np.asarray(_irfft_tail_large(jnp.asarray(spec), n))
    z = spec[0] + 1j * spec[1]
    ref2 = np.fft.irfft(z, n=n, axis=-1)[..., n // 2:]
    scale2 = np.max(np.abs(ref2))
    np.testing.assert_allclose(got2, ref2, atol=2e-4 * scale2)


def test_matrix_static_slot_render_nonzero_cursor(rng):
    """Matrix render entered at a nonzero queue cursor (static-roll path)
    == pure per-block streaming."""
    ci, co, B, N = 4, 2, 64, 64 * 5  # P = 5
    irm = rng.standard_normal((ci, co, N)) * 0.4
    nblocks = 3 + 5 + 10  # 3 streamed (slot0=3), then two render calls
    x = rng.standard_normal((ci, B * nblocks)).astype(np.float32)
    a = MatrixConvolver(irm, block=B)
    ref = np.concatenate(
        [np.asarray(a.process_block(jnp.asarray(x[:, i*B:(i+1)*B])))
         for i in range(nblocks)], -1)
    b = MatrixConvolver(irm, block=B)
    assert b.nparts == 5
    parts = [np.asarray(b.process_block(jnp.asarray(x[:, i*B:(i+1)*B])))
             for i in range(3)]
    parts.append(np.asarray(b.process(jnp.asarray(x[:, 3*B:8*B]))))
    parts.append(np.asarray(b.process(jnp.asarray(x[:, 8*B:]))))
    got = np.concatenate(parts, -1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=3e-6)
