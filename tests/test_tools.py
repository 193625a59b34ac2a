"""WAV I/O round-trips + CLI tools end-to-end."""

import numpy as np
import jax.numpy as jnp
import pytest

from bbcat_dsp_tpu.formats.sample_format import SampleFormat
from bbcat_dsp_tpu.formats.dither import TPDFDitherer
from bbcat_dsp_tpu.formats.device import quantize
from bbcat_dsp_tpu.tools import read_wav, write_wav
from bbcat_dsp_tpu.tools.loudness_cli import main as loudness_main
from bbcat_dsp_tpu.tools.convolve_cli import main as convolve_main


@pytest.mark.parametrize("fmt,tol", [
    (SampleFormat.INT16, 2**-15),
    (SampleFormat.INT24, 2**-23 * 2),
    (SampleFormat.INT32, 2**-23 * 2),  # float32 source precision bound
    (SampleFormat.FLOAT, 0.0),
])
def test_wav_roundtrip(tmp_path, rng, fmt, tol):
    # keep inside (-1, 1): full-scale saturation is by-design lossy
    audio = np.clip(rng.standard_normal((2, 480)) * 0.3, -0.99, 0.99).astype(
        np.float32)
    p = str(tmp_path / "t.wav")
    write_wav(p, audio, 48000.0, fmt)
    got, fs = read_wav(p)
    assert fs == 48000.0
    np.testing.assert_allclose(got, audio, atol=max(tol, 1e-7))


def test_wav_dithered_write(tmp_path, rng):
    audio = (rng.standard_normal((1, 4800)) * 1e-4).astype(np.float32)
    p = str(tmp_path / "d.wav")
    write_wav(p, audio, 48000.0, SampleFormat.INT16, TPDFDitherer(seed=7))
    got, _ = read_wav(p)
    # dithered low-level signal keeps nonzero variance (not truncated to 0)
    assert np.std(got) > 0


def test_device_quantize_dither(rng):
    import jax

    x = jnp.asarray((rng.standard_normal(48000) * 1e-4).astype(np.float32))
    q_plain = np.asarray(quantize(x, SampleFormat.INT16))
    q_dith = np.asarray(quantize(x, SampleFormat.INT16,
                                 key=jax.random.PRNGKey(0)))
    # undithered: signal far below 1 LSB truncates to (mostly) zero;
    # TPDF dither preserves the signal in the noise (higher correlation)
    c_plain = np.corrcoef(np.asarray(x), q_plain)[0, 1] if q_plain.any() else 0.0
    c_dith = np.corrcoef(np.asarray(x), q_dith)[0, 1]
    assert c_dith > 0.1
    assert abs(np.mean(q_dith)) < 2**-15  # unbiased


def test_loudness_cli(tmp_path, capsys):
    t = np.arange(48000) / 48000.0
    x = (0.1 * np.sin(2 * np.pi * 997 * t)).astype(np.float32)
    p = str(tmp_path / "sine.wav")
    write_wav(p, x[None], 48000.0, SampleFormat.FLOAT)
    assert loudness_main([p]) == 0
    out = capsys.readouterr().out
    assert "LKFS" in out and "dBTP" in out


def test_convolve_cli(tmp_path, rng, capsys):
    x = (rng.standard_normal((1, 9000)) * 0.1).astype(np.float32)
    ir = np.zeros((1, 64), np.float32)
    ir[0, 0] = 1.0  # identity
    pi = str(tmp_path / "in.wav")
    pr = str(tmp_path / "ir.wav")
    po = str(tmp_path / "out.wav")
    write_wav(pi, x, 48000.0, SampleFormat.FLOAT)
    write_wav(pr, ir, 48000.0, SampleFormat.FLOAT)
    assert convolve_main([pi, pr, po]) == 0
    y, _ = read_wav(po)
    assert y.shape[-1] == x.shape[-1]
    # identity IR -> output ~ input (24-bit quantisation)
    np.testing.assert_allclose(y[0], x[0], atol=1e-3)


def test_convolve_cli_sofa(tmp_path, rng):
    """Binaural render branch: input.wav + hrtf.sofa -> stereo out."""
    from bbcat_dsp_tpu.sofa import write_sofa

    x = (rng.standard_normal((4, 2048)) * 0.1).astype(np.float32)
    ir = rng.standard_normal((8, 2, 64)) * np.exp(-np.arange(64) / 20.0)
    az = np.linspace(0, 315, 8)
    pos = np.stack([az, np.zeros(8), np.ones(8)], -1)
    pi = str(tmp_path / "in.wav")
    ps = str(tmp_path / "h.sofa")
    po = str(tmp_path / "out.wav")
    write_wav(pi, x, 48000.0, SampleFormat.FLOAT)
    write_sofa(ps, ir, 48000.0, pos)
    assert convolve_main([pi, ps, po]) == 0
    y, fs = read_wav(po)
    assert y.shape[0] == 2 and y.shape[1] == x.shape[1] and fs == 48000.0
    assert np.abs(y).max() > 0
