"""Multi-device walkthrough, runnable without the devices.

Simulates 8 devices with virtual CPU devices and drives the REAL
channel-sharded path end-to-end — the same `shard_map` programs a
multi-card deployment runs (docs/DEPLOYMENT.md "Several cards"), at a
scaled-down geometry:

1. channel-sharded two-level convolver render (BASELINE config #5's
   engine),
2. sharded BS.1770 integrated loudness (one psum over the mesh),
3. the communication model's byte accounting.

Self-checking: sharded output must match the same engine run on one
device (>= 110 dB), and the loudness psum must match the unsharded meter.

    python examples/pod_render.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# 8 virtual devices BEFORE jax initialises (same trick tests/conftest.py
# and dryrun_multichip use; several hosts would jax.distributed.initialize())
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp


def main():
    fs = 48000.0
    C, B, ratio = 128, 128, 16        # scaled-down config-#5 shape
    SB = B * ratio

    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
    from bbcat_dsp_tpu.loudness import integrated_loudness
    from bbcat_dsp_tpu.parallel import (
        allreduce_bytes,
        channel_sharded_nonuniform_render,
        make_mesh,
        shard_channels,
        sharded_integrated_loudness,
    )

    # the engine's spectral specs, frozen at construction and shared by
    # the single-device and the sharded program
    sh = resolve_spectral_spec(2 * B)
    st = resolve_spectral_spec(2 * SB)
    rng = np.random.default_rng(0)
    irs = rng.standard_normal((C, 4 * SB)) * np.exp(
        -np.arange(4 * SB) / (SB / 2.0))
    # >= 0.5 s so BS.1770's 400 ms gating blocks exist (48 super-blocks,
    # a multiple of the tail partition count -> static-slot path)
    x = (0.1 * rng.standard_normal((C, 48 * SB))).astype(np.float32)

    # ---- single-device reference
    conv = NonUniformConvolver(irs, block=B, ratio=ratio, spectral=(sh, st))
    y_ref = np.asarray(conv.process(jnp.asarray(x)))

    # ---- the same engine, channel-sharded over the mesh
    mesh = make_mesh()                 # all 8 (virtual) devices, axis "ch"
    conv2 = NonUniformConvolver(irs, block=B, ratio=ratio, spectral=(sh, st))
    render = channel_sharded_nonuniform_render(mesh, B, tail_slot0=0,
                                               specs=(sh, st))
    _, y = render(conv2.state, conv2.H_head, conv2.H_tail,
                  shard_channels(x, mesh))
    y = np.asarray(y)
    # the per-shard channel count differs from the single-device batch,
    # so the two programs may round differently — the contract is the
    # dryrun's: >= 110 dB
    err = np.sum((y_ref.astype(np.float64) - y.astype(np.float64)) ** 2)
    sig = np.sum(y_ref.astype(np.float64) ** 2)
    snr_db = float("inf") if err == 0 else 10 * np.log10(sig / err)

    # ---- sharded loudness: ONE psum rides the mesh
    lkfs_ref = float(integrated_loudness(jnp.asarray(y_ref), fs))
    weights = jnp.ones((C,), jnp.float32)
    lkfs = float(sharded_integrated_loudness(mesh, fs, C)(
        shard_channels(y, mesh), shard_channels(weights, mesh)))

    # ---- what a real slice would communicate per render
    psum_bytes = allreduce_bytes(4, len(jax.devices()))

    print(f"devices                 : {len(jax.devices())} "
          f"(virtual CPU)")
    print(f"engine                  : NonUniform B={B} ratio={ratio}, "
          f"transforms={st.backend}")
    print(f"sharded vs single       : {snr_db:.1f} dB SNR (contract >= 110)")
    print(f"loudness (sharded psum) : {lkfs:7.2f} LKFS "
          f"(unsharded {lkfs_ref:7.2f})")
    print(f"collective bytes/render : {psum_bytes} (loudness psum; "
          f"render itself is communication-free)")
    assert snr_db >= 110.0, f"sharded render diverged: {snr_db:.1f} dB"
    assert abs(lkfs - lkfs_ref) < 1e-4, (lkfs, lkfs_ref)


if __name__ == "__main__":
    main()
