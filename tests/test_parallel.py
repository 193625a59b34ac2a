"""Sharded == single-device equivalence on the 8-device CPU mesh
(SURVEY.md §4: distributed tests without a cluster)."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from bbcat_dsp_tpu import golden
from bbcat_dsp_tpu.convolve import BlockConvolver, partition_ir, convolver_init
from bbcat_dsp_tpu.parallel import (
    make_mesh,
    shard_channels,
    channel_sharded_step,
    channel_sharded_render,
    time_sharded_render,
)
from conftest import snr_db


def test_channel_sharded_step_matches_single(rng):
    C, N, B = 16, 1024, 128  # 16 channels over 8 devices
    irs = rng.standard_normal((C, N)) * np.exp(-np.arange(N) / 200.0)
    x = rng.standard_normal((C, B * 6)).astype(np.float32)

    ref_conv = BlockConvolver(irs, block=B)
    y_ref = np.asarray(ref_conv.process(jnp.asarray(x)))

    mesh = make_mesh(8)
    H = partition_ir(irs, B)
    P_ = H.shape[1]
    state = convolver_init(C, B, P_)
    step = channel_sharded_step(mesh)
    outs = []
    for i in range(6):
        state, y = step(state, H, jnp.asarray(x[:, i * B:(i + 1) * B]))
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs, -1), y_ref, atol=1e-5)


def test_channel_sharded_render_matches_single(rng):
    C, N, B, T = 8, 512, 128, 128 * 8
    irs = rng.standard_normal((C, N)) * 0.3
    x = rng.standard_normal((C, T)).astype(np.float32)
    ref = BlockConvolver(irs, block=B)
    y_ref = np.asarray(ref.process(jnp.asarray(x)))

    mesh = make_mesh(8)
    H = partition_ir(irs, B)
    state = convolver_init(C, B, H.shape[1])
    render = channel_sharded_render(mesh, B)
    state, y = render(state, H, shard_channels(x, mesh))
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=1e-5)


def test_time_sharded_render_matches_single(rng):
    """Halo-exchange time sharding == sequential stream (bit-comparable)."""
    C, N, B = 2, 512, 64
    n_dev = 8
    P_ = N // B  # 8 partitions -> halo = 512 samples per span
    span = 2 * P_ * B  # span comfortably >= halo
    T = span * n_dev
    irs = rng.standard_normal((C, N)) * np.exp(-np.arange(N) / 100.0)
    x = rng.standard_normal((C, T)).astype(np.float32)

    ref = BlockConvolver(irs, block=B)
    y_ref = np.asarray(ref.process(jnp.asarray(x)))

    mesh = make_mesh(n_dev, axis_name="t")
    H = partition_ir(irs, B)
    render = time_sharded_render(mesh, B, H.shape[1], axis_name="t")
    y = np.asarray(render(H, jnp.asarray(x)))
    assert snr_db(y_ref, y) > 110.0

    # and against the golden model
    for c in range(C):
        refc = golden.direct_convolve(x[c].astype(np.float64), irs[c])[:T]
        assert snr_db(refc, y[c]) > 90.0


def test_sharded_loudness_matches_single(rng):
    """Channel-sharded loudness (psum collective) == single-device."""
    from bbcat_dsp_tpu.loudness import integrated_loudness, default_channel_weights
    from bbcat_dsp_tpu.parallel import sharded_integrated_loudness

    C, T = 16, 48000
    x = (rng.standard_normal((C, T)) * 0.1).astype(np.float32)
    w = default_channel_weights(C).astype(np.float32)
    ref = float(integrated_loudness(jnp.asarray(x), 48000.0, w))
    mesh = make_mesh(8)
    f = sharded_integrated_loudness(mesh, 48000.0, C)
    got = float(f(jnp.asarray(x), jnp.asarray(w)))
    assert abs(got - ref) < 0.02


def test_channel_sharded_nonuniform_render_matches_single(rng):
    """Pod-config flagship path: the two-level engine channel-sharded over
    the 8-device mesh == the single-device render (zero communication)."""
    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.parallel import channel_sharded_nonuniform_render

    C, B, ratio = 16, 32, 2
    B2 = B * ratio
    N = 2 * B2 + 3 * B2
    irs = rng.standard_normal((C, N)) * 0.3
    x = rng.standard_normal((C, 6 * B2)).astype(np.float32)

    ref = NonUniformConvolver(irs, block=B, ratio=ratio)
    y_ref = np.asarray(ref.process(jnp.asarray(x)))

    single = NonUniformConvolver(irs, block=B, ratio=ratio)
    mesh = make_mesh(8)
    render = channel_sharded_nonuniform_render(mesh, B, tail_slot0=0)
    state, y = render(single.state, single.H_head, single.H_tail,
                      shard_channels(x, mesh))
    assert snr_db(y_ref, np.asarray(y)) > 110.0
    # streaming continuation from the (gathered) sharded state matches the
    # reference stream — the sharded render left interchangeable state
    single.state = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a)), state)
    single._tail_steps = 6
    x2 = rng.standard_normal((C, B2)).astype(np.float32)
    y2_ref = np.asarray(ref.process_block(jnp.asarray(x2)))
    y2 = np.asarray(single.process_block(jnp.asarray(x2)))
    assert snr_db(y2_ref, y2) > 110.0


def test_comm_model_accounting():
    """Communication model: byte counts are deterministic
    from shapes, the channel-sharded render is communication-free, and the
    config #5 projection meets the >=80 % multi-host target on collectives."""
    from bbcat_dsp_tpu.parallel import (
        CommEnv,
        allreduce_bytes,
        collective_seconds,
        config5_scaling_table,
        halo_bytes,
        time_sharded_efficiency,
    )

    # ring all-reduce: 2*(N-1)/N * payload, zero for one device
    assert allreduce_bytes(4, 1) == 0
    assert allreduce_bytes(4, 8) == 7
    assert allreduce_bytes(1024, 4) == 1536
    # halo: C_local * nparts * block * 4 bytes
    assert halo_bytes(16, 64, 512) == 16 * 64 * 512 * 4
    env = CommEnv()
    t = collective_seconds(halo_bytes(16, 64, 512), env)
    assert 0 < t < 1e-3  # ~10 us over NVLink

    rows = config5_scaling_table(16.4)
    by_n = {r["chips"]: r for r in rows}
    assert by_n[1]["comm_s"] == 0.0 and by_n[1]["efficiency"] == 1.0
    # >=80 % target met with margin on every multi-host row
    for r in rows:
        if r["hosts"] >= 2:
            assert r["efficiency"] >= 0.95, r
    # aggregate throughput grows ~linearly
    assert by_n[64]["aggregate_rtf"] > 60 * by_n[1]["aggregate_rtf"]
    # the input ceiling is reported, and is the binding constraint the
    # docs call out (~16x/host at 1024 f32 channels over 25 Gb/s)
    assert 10 < by_n[8]["input_bound_rtf"] < 20

    eff = time_sharded_efficiency(16.4, span_seconds=10.0, c_local=16,
                                  nparts=64, block=512, n_devices=8)
    assert eff["efficiency"] > 0.999
    assert eff["halo_bytes"] == halo_bytes(16, 64, 512)


def test_pod_default_sharded_perm_kernels_matches_single(rng):
    """shard_map x dftmm x permuted tail layout: the channel-sharded
    two-level render with a frozen non-default spec pair matches the
    single-device render of the same specs."""
    import pytest

    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
    from bbcat_dsp_tpu.parallel import channel_sharded_nonuniform_render

    C, B, ratio = 128, 256, 8           # 16 ch per device on the 8-mesh
    B2 = B * ratio                      # 2*B2 = 4096 > 2048 -> perm tail
    N = 2 * B2 + 2 * B2                 # head + 2 tail partitions
    irs = rng.standard_normal((C, N)) * 0.1
    x = rng.standard_normal((C, 2 * 2 * B2)).astype(np.float32)

    sh = resolve_spectral_spec(2 * B, backend="dftmm", probe=False)
    st = resolve_spectral_spec(2 * B2, backend="dftmm", probe=False)
    assert st.layout == "perm" and st.radix == 16
    specs = (sh, st)

    single = NonUniformConvolver(irs, block=B, ratio=ratio, spectral=specs)
    y_ref = np.asarray(single.process(jnp.asarray(x)))

    sharded = NonUniformConvolver(irs, block=B, ratio=ratio, spectral=specs)
    mesh = make_mesh(8)
    render = channel_sharded_nonuniform_render(mesh, B, tail_slot0=0,
                                               specs=specs)
    state, y = render(sharded.state, sharded.H_head, sharded.H_tail,
                      shard_channels(x, mesh))
    assert snr_db(y_ref, np.asarray(y)) > 110.0
    # the sharded state is interchangeable with the single-device state
    for got, want in zip(jax.tree.leaves(state),
                         jax.tree.leaves(single.state)):
        assert got.shape == want.shape
        assert snr_db(np.asarray(want), np.asarray(got)) > 110.0


def test_channel_sharded_uniform_perm_matches_single(rng):
    """The UNIFORM engine sharded with a frozen perm spec (dftmm at a
    large block)."""
    from bbcat_dsp_tpu.convolve import BlockConvolver
    from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec

    C, B = 128, 2048                    # 2*B = 4096 -> perm (radix 16)
    N = 3 * B
    spec = resolve_spectral_spec(2 * B, backend="dftmm", probe=False)
    assert spec.layout == "perm"
    irs = rng.standard_normal((C, N)) * 0.2
    x = rng.standard_normal((C, 3 * B)).astype(np.float32)

    single = BlockConvolver(irs, block=B, spectral=spec)
    y_ref = np.asarray(single.process(jnp.asarray(x)))

    sharded = BlockConvolver(irs, block=B, spectral=spec)
    mesh = make_mesh(8)
    render = channel_sharded_render(mesh, B, spec=spec)
    _, y = render(sharded.state, sharded.H, shard_channels(x, mesh))
    assert snr_db(y_ref, np.asarray(y)) > 110.0


def test_time_sharded_render_perm_matches_single(rng):
    """Time-sharded halo-exchange render with a frozen perm spec: the
    ppermute halo + queue REBUILD (rfft of halo windows in the permuted
    layout) must agree with the sequential stream."""
    from bbcat_dsp_tpu.convolve import BlockConvolver
    from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
    from jax.sharding import Mesh

    C, B = 8, 2048
    spec = resolve_spectral_spec(2 * B, backend="dftmm", probe=False)
    assert spec.layout == "perm"
    taps = 2 * B
    irs = rng.standard_normal((C, taps)) * 0.2
    H = partition_ir(irs, B, spec=spec)
    nparts = H.shape[1]
    n_dev = 4
    span = nparts * B * 2
    T = span * n_dev
    x = rng.standard_normal((C, T)).astype(np.float32)

    mesh = make_mesh(n_dev, axis_name="t")
    render = time_sharded_render(mesh, B, nparts, axis_name="t", spec=spec)
    y = np.asarray(render(H, jnp.asarray(x)))

    ref = BlockConvolver(irs, block=B, spectral=spec)
    y_ref = np.asarray(ref.process(jnp.asarray(x)))
    assert snr_db(y_ref, y) > 110.0


def test_time_sharded_nonuniform_matches_sequential(rng):
    """Two-level TIME sharding: each device rebuilds
    the head carry, the tail queue AND the 2-slot pending schedule from
    one (Pt+2)-super ppermute halo; the sharded offline render must match
    the sequential stream from zero state."""
    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.parallel import time_sharded_nonuniform_render

    C, B, ratio = 4, 32, 2
    B2 = B * ratio
    N = 2 * ratio * B + 3 * B2          # head + Pt=3 tail partitions
    irs = rng.standard_normal((C, N)) * 0.3
    conv = NonUniformConvolver(irs, block=B, ratio=ratio)
    Pt, Ph = conv.tail_parts, conv.head_parts
    n_t = 4
    T = n_t * 2 * Pt * B2               # 2 render groups per device
    x = rng.standard_normal((C, T)).astype(np.float32)

    mesh = make_mesh(n_t, axis_name="t")
    render = time_sharded_nonuniform_render(
        mesh, B, ratio, Ph, Pt, axis_name="t", specs=conv.specs)
    y = np.asarray(render(conv.H_head, conv.H_tail, jnp.asarray(x)))

    ref = NonUniformConvolver(irs, block=B, ratio=ratio)
    y_ref = np.asarray(ref.process(jnp.asarray(x)))
    assert snr_db(y_ref, y) > 110.0


def test_time_sharded_nonuniform_2d_mesh(rng):
    """Same, on a 2-D (ch, t) mesh — channels and time sharded at once."""
    from jax.sharding import Mesh
    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.parallel import time_sharded_nonuniform_render

    C, B, ratio = 8, 16, 2
    B2 = B * ratio
    N = 2 * ratio * B + 2 * B2
    irs = rng.standard_normal((C, N)) * 0.3
    conv = NonUniformConvolver(irs, block=B, ratio=ratio)
    Pt, Ph = conv.tail_parts, conv.head_parts
    n_t = 4
    T = n_t * Pt * B2
    x = rng.standard_normal((C, T)).astype(np.float32)

    T = n_t * 2 * Pt * B2               # span must cover the (Pt+2) halo
    x = rng.standard_normal((C, T)).astype(np.float32)
    devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("ch", "t"))
    render = time_sharded_nonuniform_render(
        mesh, B, ratio, Ph, Pt, axis_name="t", ch_axis="ch",
        specs=conv.specs)
    y = np.asarray(render(conv.H_head, conv.H_tail, jnp.asarray(x)))

    ref = NonUniformConvolver(irs, block=B, ratio=ratio)
    y_ref = np.asarray(ref.process(jnp.asarray(x)))
    assert snr_db(y_ref, y) > 110.0


def test_pod_midgeometry_sharded_matches_single():
    """The multi-card code path (perm RADIX-32 tail,
    channel-sharded two-level render) exercised in the DEFAULT suite at a
    non-toy geometry — 256 ch x 32k taps, ~1/8 the work of the full
    BBCAT_SLOW pod test below, same spec path (B=512, ratio=8 ->
    2*B2 = 8192 -> perm radix 32, Pt=6)."""
    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
    from bbcat_dsp_tpu.parallel import channel_sharded_nonuniform_render

    rng = np.random.default_rng(7)
    C, B, ratio, taps = 256, 512, 8, 32768
    B2 = B * ratio
    ir = (rng.standard_normal((C, taps)) * 0.05).astype(np.float64)
    sh = resolve_spectral_spec(2 * B, backend="dftmm", probe=False)
    st = resolve_spectral_spec(2 * B2, backend="dftmm", probe=False)
    assert st.layout == "perm" and st.radix == 32
    specs = (sh, st)

    single = NonUniformConvolver(ir, block=B, ratio=ratio, spectral=specs)
    T = single.tail_parts * B2          # one full render group (6 * 4096)
    x = rng.standard_normal((C, T)).astype(np.float32)
    y_ref = np.asarray(single.process(jnp.asarray(x)))

    sharded = NonUniformConvolver(ir, block=B, ratio=ratio, spectral=specs)
    mesh = make_mesh(8)
    render = channel_sharded_nonuniform_render(mesh, B, tail_slot0=0,
                                               specs=specs)
    _, y = render(sharded.state, sharded.H_head, sharded.H_tail,
                  shard_channels(x, mesh))
    assert snr_db(y_ref, np.asarray(y)) > 110.0


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("BBCAT_SLOW") != "1",
                    reason="pod-geometry test (~6 min CPU); BBCAT_SLOW=1 "
                           "or `pytest -m slow` with the env set runs it")
def test_pod_geometry_sharded_matches_single():
    """Config #5 at REAL geometry: 1024 ch x 64k-tap
    non-uniform render, channel-sharded on the 8-CPU mesh, against the
    single-device render of the SAME frozen (perm-tail) spec pair.
    Catches shape/memory/spec bugs the toy geometries cannot (measured
    here: queue ~470 MB, bit-exact agreement)."""
    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
    from bbcat_dsp_tpu.parallel import channel_sharded_nonuniform_render

    rng = np.random.default_rng(5)
    C, B, ratio, taps = 1024, 512, 8, 65536
    B2 = B * ratio
    ir = (rng.standard_normal((C, taps)) * 0.05).astype(np.float64)
    sh = resolve_spectral_spec(2 * B, backend="dftmm", probe=False)
    st = resolve_spectral_spec(2 * B2, backend="dftmm", probe=False)
    assert st.layout == "perm" and st.radix == 32
    specs = (sh, st)

    single = NonUniformConvolver(ir, block=B, ratio=ratio, spectral=specs)
    T = single.tail_parts * B2          # one full render group (14 * 4096)
    x = rng.standard_normal((C, T)).astype(np.float32)
    y_ref = np.asarray(single.process(jnp.asarray(x)))

    sharded = NonUniformConvolver(ir, block=B, ratio=ratio, spectral=specs)
    mesh = make_mesh(8)
    render = channel_sharded_nonuniform_render(mesh, B, tail_slot0=0,
                                               specs=specs)
    _, y = render(sharded.state, sharded.H_head, sharded.H_tail,
                  shard_channels(x, mesh))
    assert snr_db(y_ref, np.asarray(y)) > 110.0
