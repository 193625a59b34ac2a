"""Doppler / moving-source demo: the FractionalSample use case.

The reference documents FractionalSample as the primitive for moving-source
rendering — a circular buffer read at a smoothly varying fractional delay
(ref: src/FractionalSample.h:29-34).  This demo renders a source closing on
the listener at constant speed through :class:`FractionalDelayLine` (the
exact reference 14-tap x 128-phase polyphase table) and verifies the
physics: the received tone is shifted by the Doppler factor 1 + v/c.

Cross-check: the same shift is produced by the ASRC (:class:`Resampler`)
running at ratio 1 + v/c — time-varying delay and asynchronous resampling
are the same operation, which is why both sit on the same polyphase core.

    python examples/doppler.py [out.wav]
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

from bbcat_dsp_tpu.filters.fractional import FractionalDelayLine
from bbcat_dsp_tpu.filters.resample import resample
from bbcat_dsp_tpu.tools import write_wav

FS = 48000.0
C_SOUND = 343.0  # m/s
F0 = 1000.0      # emitted tone (Hz)
V = 20.0         # closing speed (m/s) -> expected shift factor 1 + v/c
D0 = 90.0        # initial distance (m)
BLOCK = 512
SECONDS = 2.0


def peak_freq(y: np.ndarray, fs: float) -> float:
    """FFT peak with quadratic (parabolic) bin interpolation."""
    w = np.hanning(y.size)
    s = np.abs(np.fft.rfft(y * w))
    k = int(np.argmax(s))
    if 0 < k < s.size - 1:  # parabolic refinement
        a, b, c = np.log(s[k - 1]), np.log(s[k]), np.log(s[k + 1])
        k = k + 0.5 * (a - c) / (a - 2 * b + c)
    return k * fs / y.size


def main(out_path=os.path.join(tempfile.gettempdir(), "doppler.wav")):
    nblocks = int(SECONDS * FS) // BLOCK
    T = nblocks * BLOCK
    t = np.arange(T) / FS
    src = (0.5 * np.sin(2 * np.pi * F0 * t)).astype(np.float32)[None, :]

    # distance shrinks linearly; delay(t) = d(t)/c in frames
    dist = D0 - V * t
    delay_frames = dist / C_SOUND * FS
    max_delay = float(delay_frames.max())

    line = FractionalDelayLine(nchannels=1, length=1 << 15)
    out = np.zeros((1, T), np.float32)
    for b in range(nblocks):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        line.write(jnp.asarray(src[:, sl]))
        # output sample k of this block was emitted delay_k frames ago;
        # express that relative to the (post-write) head position
        k = np.arange(BLOCK)
        d = (BLOCK - k) + delay_frames[sl]
        out[:, sl] = np.asarray(line.read(jnp.asarray(d[None, :], jnp.float32)))

    # discard the fill-in transient (until the longest delay has history)
    settle = int(max_delay) + 64
    received = out[0, settle:]
    f_meas = peak_freq(received, FS)
    f_theory = F0 * (1.0 + V / C_SOUND)

    # ASRC cross-check: resampling the tone by the Doppler ratio lands on
    # the same frequency (same polyphase core, same physics)
    ratio = 1.0 + V / C_SOUND
    y_asrc = np.asarray(resample(jnp.asarray(src), 1.0 / ratio))
    f_asrc = peak_freq(y_asrc[0, settle:], FS)

    print(f"emitted                 : {F0:8.2f} Hz")
    print(f"theory  (1 + v/c) * f0  : {f_theory:8.2f} Hz")
    print(f"fractional-delay render : {f_meas:8.2f} Hz "
          f"({abs(f_meas - f_theory) / f_theory * 100:.3f}% off)")
    print(f"ASRC at ratio {ratio:.4f}  : {f_asrc:8.2f} Hz "
          f"({abs(f_asrc - f_theory) / f_theory * 100:.3f}% off)")

    assert abs(f_meas - f_theory) / f_theory < 0.005, "doppler shift wrong"
    assert abs(f_asrc - f_theory) / f_theory < 0.005, "ASRC shift wrong"

    stereo = np.concatenate([out, out], axis=0)
    write_wav(out_path, stereo / max(1e-9, np.abs(stereo).max()) * 0.5, FS)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
