"""Composed-model pipelines vs golden chains + driver entry points."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.filters import FilterType, biquad_coeffs
from bbcat_dsp_tpu.models import (
    BinauralRenderer,
    EQDelayPipeline,
    MixdownPipeline,
)
from conftest import snr_db

FS = 48000.0


def test_binaural_renderer_vs_golden(rng):
    ci, B, N, T = 4, 64, 256, 64 * 10
    hrtf = rng.standard_normal((ci, 2, N)) * np.exp(-np.arange(N) / 60.0)
    eq = [biquad_coeffs(FilterType.PEQ, 1000, FS, gain=4)]
    r = BinauralRenderer(hrtf, block=B, eq_stages=eq, fs=FS)
    x = rng.standard_normal((ci, T)).astype(np.float32)
    outs = [
        np.asarray(r.process_block(jnp.asarray(x[:, i*B:(i+1)*B])))
        for i in range(T // B)
    ]
    y = np.concatenate(outs, -1)
    # golden: EQ each channel then sum per-pair convolutions
    for o in range(2):
        ref = np.zeros(T)
        for i in range(ci):
            xe, _ = golden.biquad_process(x[i], eq[0])
            ref += golden.direct_convolve(xe, hrtf[i, o])[:T]
        assert snr_db(ref, y[o]) > 90.0
    # metering is alive
    L = r.loudness()
    assert np.isfinite(L["momentary_lkfs"])


def test_binaural_hrtf_swap_no_click(rng):
    ci, B, N, T = 2, 64, 128, 64 * 8
    h1 = rng.standard_normal((ci, 2, N)) * 0.3
    h2 = rng.standard_normal((ci, 2, N)) * 0.3
    r = BinauralRenderer(h1, block=B)
    x = rng.standard_normal((ci, T)).astype(np.float32)
    outs = []
    for i in range(T // B):
        if i == 4:
            r.set_hrtf(h2)
        outs.append(np.asarray(r.process_block(jnp.asarray(x[:, i*B:(i+1)*B]))))
    y = np.concatenate(outs, -1)
    # after the fade settles, output equals the new HRTF's steady state
    ref = np.zeros((2, T))
    for o in range(2):
        for i in range(ci):
            ref[o] += golden.direct_convolve(x[i], h2[i, o])[:T]
    settle = 6 * B
    assert snr_db(ref[:, settle:], y[:, settle:]) > 90.0


def test_eq_delay_pipeline(rng):
    C, B, T = 2, 128, 128 * 2  # T <= ring length so the ring holds the whole stream
    eq = np.stack([
        golden.biquad_coeffs(FilterType.LPF12, 8000, FS),
        golden.biquad_coeffs(FilterType.PEQ, 500, FS, gain=-3),
    ])
    pipe = EQDelayPipeline(eq, nchannels=C, block=B, max_delay=64.0, fs=FS)
    x = rng.standard_normal((C, T)).astype(np.float32)
    delays = np.array([20.0, 33.25])
    outs = [
        np.asarray(pipe.process_block(jnp.asarray(x[:, i*B:(i+1)*B]), delays))
        for i in range(T // B)
    ]
    y = np.concatenate(outs, -1)
    # golden: EQ then exact polyphase fractional read at the same positions
    for c in range(C):
        ye, _ = golden.cascade_process(x[c], eq)
        # delayed output d frames + the polyphase group delay contract:
        # positions pos = wp - d; golden fractional read lags (14 - 7)
        # implicitly via its bpos contract — compare against the pipeline's
        # own definition using the golden reader on the same ring contents
        L = pipe.length
        ring = np.zeros(L)
        ring[:T] = ye[:T]
        for i in [150, 200, 250]:
            pos = (i - delays[c]) % L
            want = golden.fractional_sample(
                np.repeat(ring, 1), 0, 1, L, float(pos)
            )
            assert abs(y[c, i] - want) < 2e-3


def test_mixdown_pipeline(rng):
    """Config #4: format conversion + gain-matrix mixdown + loudness."""
    from bbcat_dsp_tpu.models import MixdownPipeline
    from bbcat_dsp_tpu.formats.sample_format import SampleFormat
    from bbcat_dsp_tpu.formats.host import float_to_int32

    C, B = 16, 4800
    gains = np.zeros((2, C), np.float32)
    gains[0, :8] = 0.125
    gains[1, 8:] = 0.125
    pipe = MixdownPipeline(gains, fs=FS, in_format=SampleFormat.INT32,
                           out_format=SampleFormat.FLOAT)
    xf = (rng.standard_normal((C, B * 10)) * 0.1).astype(np.float32)
    xi = float_to_int32(xf)  # int32 MSB-aligned input
    outs = [np.asarray(pipe.process_block(jnp.asarray(xi[:, i*B:(i+1)*B])))
            for i in range(10)]
    y = np.concatenate(outs, -1)
    ref = gains.astype(np.float64) @ xf.astype(np.float64)
    assert snr_db(ref, y) > 90.0
    L = pipe.integrated_loudness()
    ref_L = golden.integrated_loudness(ref, FS)
    assert abs(L - ref_L) < 0.1


def test_comb_apply_vs_scalar(rng):
    from bbcat_dsp_tpu.filters import comb_apply

    x = rng.standard_normal((2, 300)).astype(np.float32)
    g, d = 0.6, 17
    y = np.asarray(comb_apply(jnp.asarray(x), g, d)[0])
    ref = np.zeros_like(x)
    for c in range(2):
        for n in range(300):
            ref[c, n] = x[c, n] + (g * ref[c, n - d] if n >= d else 0.0)
    assert snr_db(ref, y) > 110.0


def test_schroeder_reverb(rng):
    """Impulse through the reverb: dense exponentially-decaying tail with
    approximately the requested RT60; stable; streaming-consistent."""
    from bbcat_dsp_tpu.models import SchroederReverb

    fs, rt60 = 48000.0, 0.5
    rev = SchroederReverb(2, fs=fs, rt60=rt60, mix=1.0)
    B = 4800
    x = np.zeros((2, B * 10), np.float32)
    x[:, 0] = 1.0
    outs = [np.asarray(rev.process_block(jnp.asarray(x[:, i*B:(i+1)*B])))
            for i in range(10)]
    y = np.concatenate(outs, -1)
    assert np.all(np.isfinite(y))
    # energy in consecutive 100 ms windows decays roughly -6 dB per rt60/10
    w = int(0.1 * fs)
    env = [np.sum(y[0, i*w:(i+1)*w]**2) for i in range(2, 8)]
    drops = [10 * np.log10(env[i] / env[i+1]) for i in range(len(env)-1)]
    # RT60 0.5 s -> -12 dB per 100 ms; allow generous tolerance (sparse
    # early tail)
    assert 6.0 < np.mean(drops) < 20.0, drops
    # tail is dense: most samples in the 0.2-0.4 s window are nonzero
    tail = y[0, int(0.2*fs):int(0.4*fs)]
    assert np.mean(np.abs(tail) > 1e-7) > 0.8
    # channels decorrelated (different comb tunings)
    c = np.corrcoef(y[0, :w*5], y[1, :w*5])[0, 1]
    assert abs(c) < 0.5


@pytest.mark.parametrize("per_sample", [False, True])
def test_eq_delay_pipeline_after_long_stream(rng, per_sample):
    """Hours into a stream the ring's write counter is large; the
    fractional read must not lose the delay's sub-sample phase to float32
    rounding of that counter.  A pipeline whose counter starts at a large
    multiple of the ring length holds the same ring layout as a fresh one,
    so both must produce the same output."""
    C, B = 2, 256
    eq = np.stack([golden.biquad_coeffs(FilterType.PEQ, 500, FS, gain=3)])
    fresh = EQDelayPipeline(eq, nchannels=C, block=B, max_delay=64.0, fs=FS)
    late = EQDelayPipeline(eq, nchannels=C, block=B, max_delay=64.0, fs=FS)
    ring = late.state.ring
    late.state = late.state._replace(ring=ring._replace(
        writepos=jnp.asarray((1 << 20) * late.length, jnp.int32)))
    delays = np.array([20.97, 33.03])
    if per_sample:
        delays = delays[:, None] + np.linspace(0.0, 0.5, B)[None]
    x = rng.standard_normal((C, 3 * B)).astype(np.float32)
    for i in range(3):
        xb = jnp.asarray(x[:, i * B:(i + 1) * B])
        want = np.asarray(fresh.process_block(xb, delays))
        got = np.asarray(late.process_block(xb, delays))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
