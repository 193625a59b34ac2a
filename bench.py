"""Benchmark harness — the BASELINE.md headline configuration on one GPU.

Measures the real-time factor of 64-channel x 32768-tap two-level
partitioned convolution at 48 kHz (``NonUniformConvolver``, block 512,
ratio 8) through ``.process``, plus the SNR of the same computation against
the float64 golden convolution on 4 channels.

    python bench.py

Each timed render consumes a distinct signal (repeating one input would
let XLA hoist its transforms out of the loop) and ends in
``block_until_ready``; the estimate is the median over the renders.
Compilation is reported separately, as set-up.  An earlier line names the
card and its power limit; the LAST line of stdout is the result:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

where ``vs_baseline`` is the real-time factor over the 100x target.
Refuses to run without a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

FS = 48000.0
C, N, B, RATIO = 64, 32768, 512, 8
RENDERS = 12


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    import jax.numpy as jnp
    from scipy.signal import fftconvolve

    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    print("device:", dev.platform, dev.device_kind, len(jax.devices()))

    rng = np.random.default_rng(0)
    irs = rng.standard_normal((C, N)) * np.exp(-np.arange(N) / 4000.0)
    conv = NonUniformConvolver(irs, block=B, ratio=RATIO)
    T = conv.tail_parts * conv.super_block     # one render group
    xs = [jnp.asarray(rng.standard_normal((C, T)).astype(np.float32))
          for _ in range(RENDERS + 1)]

    t0 = time.perf_counter()
    y0 = jax.block_until_ready(conv.process(xs[0]))
    print(f"compile + first render: {time.perf_counter() - t0:.3f} s")
    times = []
    for x in xs[1:]:
        t0 = time.perf_counter()
        jax.block_until_ready(conv.process(x))
        times.append(time.perf_counter() - t0)
    per_render = float(np.median(times))
    rtf = T / FS / per_render

    x0, y0 = np.asarray(xs[0]), np.asarray(y0)
    snrs = []
    for c in (0, 21, 42, 63):
        ref = fftconvolve(x0[c].astype(np.float64), irs[c])[:T]
        snrs.append(10.0 * np.log10(np.sum(ref ** 2)
                                    / np.sum((ref - y0[c]) ** 2)))
    print(json.dumps({
        "metric": "rtf_64ch_32ktap_48kHz_1chip",
        "value": rtf,
        "unit": "x_realtime",
        "vs_baseline": rtf / 100.0,
        "snr_db_vs_golden": float(min(snrs)),
        "samples_per_sec_per_chip": C * T / per_render,
        "engine": f"nonuniform_partitioned(B={B}, ratio={RATIO})",
        "render_s": times,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
