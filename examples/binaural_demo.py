"""End-to-end demo: synthesize a multichannel scene, render it binaurally
through a SOFA HRTF set, meter it, and write a WAV.

    python examples/binaural_demo.py [out.wav]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("JAX_PLATFORMS"):
    # some site configs override the env var after the fact; re-assert it
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import jax.numpy as jnp

from bbcat_dsp_tpu.filters import FilterType, biquad_coeffs
from bbcat_dsp_tpu.models import BinauralRenderer
from bbcat_dsp_tpu.sofa import SOFAFile, write_sofa
from bbcat_dsp_tpu.formats.sample_format import SampleFormat
from bbcat_dsp_tpu.tools import write_wav


def synth_hrtf(tmp=os.path.join(tempfile.gettempdir(), "demo_hrtf.sofa"),
               fs=48000.0):
    """A toy HRTF set: direction-dependent delay + shadowing."""
    rng = np.random.default_rng(0)
    M, N = 12, 256
    az = np.linspace(0, 330, M)
    ir = np.zeros((M, 2, N))
    for m, a in enumerate(np.radians(az)):
        itd = 0.0007 * np.sin(a) * fs  # +-0.7 ms interaural delay
        for ear, sign in ((0, +1), (1, -1)):
            d = int(round(20 + sign * itd / 2))
            ir[m, ear, d] = 1.0
            ir[m, ear] += rng.standard_normal(N) * 0.02 * np.exp(
                -np.arange(N) / 40.0)
    write_sofa(tmp, ir, fs, np.stack([az, np.zeros(M), np.ones(M)], -1))
    return tmp


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        tempfile.gettempdir(), "binaural_demo.wav")
    fs = 48000.0
    sofa = SOFAFile.open(synth_hrtf())
    dirs = [(0.0, 0.0), (90.0, 0.0), (270.0, 0.0)]
    hrtf = sofa.hrtf_matrix(dirs)

    # three sources: front tone, left noise burst train, right chirp
    T = int(fs * 3)
    t = np.arange(T) / fs
    x = np.zeros((3, T), np.float32)
    x[0] = 0.2 * np.sin(2 * np.pi * 440 * t)
    burst = (np.arange(T) % int(fs * 0.5)) < int(fs * 0.05)
    x[1] = 0.3 * np.random.default_rng(1).standard_normal(T) * burst
    x[2] = 0.2 * np.sin(2 * np.pi * (200 + 400 * t) * t)

    eq = [biquad_coeffs(FilterType.HPF12, 60.0, fs)]
    r = BinauralRenderer(hrtf, block=512, eq_stages=eq, fs=fs)
    B = 512
    n = T // B
    outs = [np.asarray(r.process_block(jnp.asarray(x[:, i*B:(i+1)*B])))
            for i in range(n)]
    y = np.concatenate(outs, -1)
    print("loudness:", r.loudness())
    write_wav(out, y / max(1.0, np.abs(y).max()), fs, SampleFormat.INT24)
    print("wrote", out)


if __name__ == "__main__":
    main()
