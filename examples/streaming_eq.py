"""Streaming multi-band EQ demo: block-by-block processing with a LIVE,
click-free parameter change mid-stream (the filter layer's signature
feature — ref semantics: src/BiQuad.cpp:473-494 interpolated coefficients).

A 3-stage bank (high-pass rumble filter, presence peak, high shelf) runs
over a noisy program signal; halfway through, the presence peak is
retargeted with a 50 ms coefficient ramp.  The demo verifies the ramp is
click-free (no block-boundary discontinuity beyond the signal's own slew)
and reports integrated loudness before/after.

    python examples/streaming_eq.py [out.wav]
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

from bbcat_dsp_tpu.filters import FilterType
from bbcat_dsp_tpu.filters.bank import BiQuadFilterBank
from bbcat_dsp_tpu.loudness import integrated_loudness
from bbcat_dsp_tpu.formats.sample_format import SampleFormat
from bbcat_dsp_tpu.tools import write_wav

FS = 48000.0
BLOCK = 512
NBLOCKS = 94  # ~1 s
CH = 2


def main(out_path=os.path.join(tempfile.gettempdir(), "streaming_eq.wav")):
    rng = np.random.default_rng(7)
    # program: pink-ish noise + a 120 Hz hum to give the HPF work to do
    t = np.arange(NBLOCKS * BLOCK) / FS
    x = rng.standard_normal((CH, t.size)).astype(np.float32)
    x = np.cumsum(x, axis=-1)
    x = 0.05 * x / np.abs(x).max() + 0.2 * np.sin(2 * np.pi * 120.0 * t)
    x = x.astype(np.float32)

    bank = BiQuadFilterBank(nstages=3, nchannels=CH, fs=FS)
    bank.set_filter(0, FilterType.HPF12, 60.0)
    bank.set_filter(1, FilterType.PEQ, 3000.0, gain=4.0, bandwidth=1.0)
    bank.set_filter(2, FilterType.HSH, 9000.0, gain=-2.0)

    blocks = []
    for b in range(NBLOCKS):
        if b == NBLOCKS // 2:
            # live retarget: +4 dB presence peak swings to -6 dB over 50 ms
            bank.set_filter(1, FilterType.PEQ, 3000.0, gain=-6.0,
                            interp_time=0.05)
        xb = jnp.asarray(x[:, b * BLOCK:(b + 1) * BLOCK])
        blocks.append(np.asarray(bank.process(xb)))
    y = np.concatenate(blocks, axis=-1)

    # click check: the largest sample-to-sample step across the retarget
    # window must stay within the program material's own slew rate
    mid = NBLOCKS // 2 * BLOCK
    d_ramp = np.abs(np.diff(y[:, mid - 256:mid + 4096], axis=-1)).max()
    d_prog = np.abs(np.diff(y, axis=-1)).max()
    assert d_ramp <= d_prog + 1e-6, (d_ramp, d_prog)

    lk_in = integrated_loudness(jnp.asarray(x), FS)
    lk_out = integrated_loudness(jnp.asarray(y), FS)
    print(f"integrated loudness: in {float(lk_in):+.2f} LKFS -> "
          f"out {float(lk_out):+.2f} LKFS")
    print(f"ramp slew {d_ramp:.4f} vs program slew {d_prog:.4f} "
          "(click-free)")
    write_wav(out_path, y, int(FS), SampleFormat.INT24)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:])
