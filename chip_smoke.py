"""On-card smoke test: the main paths at full width on one GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the config-5 channel-sharded
                                  # render and sharded loudness, nothing else

Every phase drives a public entry point at one of the repo's own
configurations (BASELINE.json), with signals and IRs drawn from a seed, and
compares the result with the float64 golden model in
``bbcat_dsp_tpu/golden`` (or, for the sharded path, with the single-card
result).  Each phase prints its first-call (compile + run) and warm-call
times, the device's peak memory so far, and every comparison with its
tolerance.  The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed.

The script refuses to run on anything but a GPU: without one it exits
non-zero and prints no result.  All computation is float32 on the card;
the transforms are ``jnp.fft`` (cuFFT) and the matrix mixes run at
``Precision.HIGHEST``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

FS = 48000.0
SNR_GATE_DB = 90.0          # BASELINE.md accuracy contract vs float64
PRECISION = "float32 on card (xla/cuFFT transforms); reference float64"


class Check(NamedTuple):
    what: str
    value: float
    bound: float
    higher_is_better: bool   # value >= bound passes, else value <= bound

    @property
    def ok(self) -> bool:
        return (self.value >= self.bound if self.higher_is_better
                else self.value <= self.bound)

    def line(self) -> str:
        op = ">=" if self.higher_is_better else "<="
        return (f"  {'PASS' if self.ok else 'FAIL'} {self.what}: "
                f"{self.value!r} (tolerance {op} {self.bound!r})")


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return float("inf") if err == 0 else float(
        10.0 * np.log10(np.sum(ref ** 2) / err))


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _golden_conv(x: np.ndarray, ir: np.ndarray) -> np.ndarray:
    """Float64 golden convolution, truncated to the input length."""
    from scipy.signal import fftconvolve

    return fftconvolve(np.asarray(x, np.float64),
                       np.asarray(ir, np.float64))[: x.shape[-1]]


def _decaying_irs(rng, C: int, N: int, decay: float) -> np.ndarray:
    return rng.standard_normal((C, N)) * np.exp(-np.arange(N) / decay)


# ---------------------------------------------------------------------------
# phases: each returns (checks, timings) and is callable at any size
# ---------------------------------------------------------------------------

def phase_nonuniform(C: int, N: int, block: int = 512, ratio: int = 8,
                     groups: int = 1, blocks: int = 2, decay: float = 4000.0,
                     n_golden: int = 4, seed: int = 0, label: str = ""):
    """``NonUniformConvolver`` driven through ``.process`` (two renders of
    ``groups`` render groups each: the first compiles, the second is warm)
    then ``.process_block`` for ``blocks`` super-blocks, against the
    float64 golden convolution on ``n_golden`` channels."""
    import jax.numpy as jnp

    from bbcat_dsp_tpu.convolve import NonUniformConvolver

    rng = np.random.default_rng(seed)
    irs = _decaying_irs(rng, C, N, decay)
    conv = NonUniformConvolver(irs, block=block, ratio=ratio)
    SB = conv.super_block
    T1 = groups * conv.tail_parts * SB
    T = 2 * T1 + blocks * SB
    x = rng.standard_normal((C, T)).astype(np.float32)

    y1, t_first = _timed(conv.process, jnp.asarray(x[:, :T1]))
    y2, t_warm = _timed(conv.process, jnp.asarray(x[:, T1:2 * T1]))
    outs = [np.asarray(y1), np.asarray(y2)]
    t_blocks = []
    for k in range(blocks):
        s = 2 * T1 + k * SB
        yb, dt = _timed(conv.process_block, jnp.asarray(x[:, s:s + SB]))
        outs.append(np.asarray(yb))
        t_blocks.append(dt)
    y = np.concatenate(outs, axis=-1)

    chans = np.linspace(0, C - 1, min(n_golden, C)).astype(int)
    checks = [Check("output finite, shape %s" % (y.shape,),
                    float(np.isfinite(y).all() and y.shape == (C, T)),
                    1.0, True)]
    for c in chans:
        checks.append(Check(f"{label}ch{c} SNR dB vs float64 golden",
                            snr_db(_golden_conv(x[c], irs[c]), y[c]),
                            SNR_GATE_DB, True))
    audio_s = T1 / FS
    timings = {"first_call_s": t_first, "warm_call_s": t_warm,
               "warm_render_rtf": audio_s / t_warm,
               "process_block_s": t_blocks,
               "tail_parts": conv.tail_parts, "T": T}
    return checks, timings


def phase_headline(C: int = 64, N: int = 32768, **kw):
    """BASELINE headline: 64 ch x 32k taps, block 512, ratio 8."""
    kw.setdefault("groups", 2)
    kw.setdefault("blocks", 3)
    return phase_nonuniform(C, N, label="headline ", **kw)


def phase_config5(C: int = 1024, N: int = 65536, **kw):
    """Config 5: 1024 ch x 64k taps (14 tail partitions at block 512)."""
    kw.setdefault("decay", 8000.0)
    return phase_nonuniform(C, N, label="config5 ", **kw)


def phase_config1(N: int = 4096, block: int = 512, nblocks: int = 64,
                  stream_blocks: int = 4, seed: int = 1):
    """Config 1: ``BlockConvolver``, mono, 4096 taps, block 512."""
    import jax.numpy as jnp

    from bbcat_dsp_tpu.convolve import BlockConvolver

    rng = np.random.default_rng(seed)
    ir = _decaying_irs(rng, 1, N, 500.0)[0]
    conv = BlockConvolver(ir, block=block)
    T1 = nblocks * block
    x = rng.standard_normal(T1 + stream_blocks * block).astype(np.float32)
    y1, t_first = _timed(conv.process, jnp.asarray(x[:T1]))
    outs, t_blocks = [np.asarray(y1)], []
    for k in range(stream_blocks):
        s = T1 + k * block
        yb, dt = _timed(conv.process_block, jnp.asarray(x[s:s + block]))
        outs.append(np.asarray(yb))
        t_blocks.append(dt)
    y = np.concatenate(outs)
    checks = [Check("config1 SNR dB vs float64 golden",
                    snr_db(_golden_conv(x, ir), y), SNR_GATE_DB, True)]
    return checks, {"first_call_s": t_first, "process_block_s": t_blocks}


def phase_config2(C: int = 8, block: int = 4096, nblocks: int = 4,
                  max_delay: float = 256.0, seed: int = 2):
    """Config 2: ``EQDelayPipeline``, 8 ch, 8-stage EQ, fractional delay."""
    import jax.numpy as jnp

    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.golden.biquad import FilterType
    from bbcat_dsp_tpu.models import EQDelayPipeline

    rng = np.random.default_rng(seed)
    eq = np.stack([
        golden.biquad_coeffs(FilterType.PEQ, 100.0 * (i + 1), FS,
                             gain=(-1.0) ** i * 3.0)
        for i in range(8)
    ])
    pipe = EQDelayPipeline(eq, nchannels=C, block=block,
                           max_delay=max_delay, fs=FS)
    delays = np.linspace(20.0, 0.8 * max_delay, C) + 0.37  # fractional
    T = nblocks * block
    x = rng.standard_normal((C, T)).astype(np.float32)
    outs, times = [], []
    for k in range(nblocks):
        yb, dt = _timed(pipe.process_block,
                        jnp.asarray(x[:, k * block:(k + 1) * block]), delays)
        outs.append(np.asarray(yb))
        times.append(dt)
    y = np.concatenate(outs, axis=-1)

    # golden: float64 EQ cascade, then the reference polyphase read at
    # t - delay from a zero-padded linear buffer
    pad = int(np.ceil(max_delay)) + 64
    err = 0.0
    ref_all, got_all = [], []
    for c in range(C):
        ye, _ = golden.cascade_process(x[c], eq)
        buf = np.concatenate([np.zeros(pad), ye])
        pos = pad + np.arange(T) - delays[c]
        ref = golden.fractional_delay_block(buf[None], pos[None],
                                            buf.size)[0]
        err = max(err, float(np.max(np.abs(ref - y[c]))))
        ref_all.append(ref)
        got_all.append(y[c])
    checks = [
        Check("config2 max abs error vs float64 golden", err, 2e-3, False),
        Check("config2 SNR dB vs float64 golden",
              snr_db(np.stack(ref_all), np.stack(got_all)), SNR_GATE_DB,
              True),
    ]
    return checks, {"first_call_s": times[0], "warm_block_s": times[1:]}


def phase_config3(C_in: int = 64, N: int = 1024, block: int = 512,
                  nblocks: int = 128, stream_blocks: int = 4, seed: int = 3):
    """Config 3: 64 -> 2 HRTF matrix convolution through
    ``MatrixConvolver.process`` and ``BinauralRenderer.process_block``,
    with HRIRs synthesised from the seed (decaying noise, per-ear delay)."""
    import jax.numpy as jnp

    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.convolve import MatrixConvolver
    from bbcat_dsp_tpu.filters import FilterType, biquad_coeffs
    from bbcat_dsp_tpu.models import BinauralRenderer

    rng = np.random.default_rng(seed)
    hrir = rng.standard_normal((C_in, 2, N)) * np.exp(-np.arange(N) / 200.0)
    itd = rng.integers(0, 32, size=(C_in, 2))
    for i in range(C_in):
        for o in range(2):
            hrir[i, o] = np.roll(hrir[i, o], itd[i, o])
            hrir[i, o, :itd[i, o]] = 0.0
    T = nblocks * block
    x = rng.standard_normal((C_in, T)).astype(np.float32)

    conv = MatrixConvolver(hrir, block=block)
    y, t_first = _timed(conv.process, jnp.asarray(x))
    y = np.asarray(y)
    ref = np.stack([sum(_golden_conv(x[i], hrir[i, o]) for i in range(C_in))
                    for o in range(2)])
    checks = [Check("config3 MatrixConvolver SNR dB vs float64 golden",
                    snr_db(ref, y), SNR_GATE_DB, True)]

    eq = [biquad_coeffs(FilterType.PEQ, 1000.0, FS, gain=4.0)]
    rend = BinauralRenderer(hrir, block=block, eq_stages=eq, fs=FS)
    Ts = stream_blocks * block
    outs, times = [], []
    for k in range(stream_blocks):
        yb, dt = _timed(rend.process_block,
                        jnp.asarray(x[:, k * block:(k + 1) * block]))
        outs.append(np.asarray(yb))
        times.append(dt)
    yb = np.concatenate(outs, axis=-1)
    xe = [golden.biquad_process(x[i, :Ts], eq[0])[0] for i in range(C_in)]
    refb = np.stack([sum(_golden_conv(xe[i], hrir[i, o]) for i in range(C_in))
                     for o in range(2)])
    checks.append(Check("config3 BinauralRenderer SNR dB vs float64 golden",
                        snr_db(refb, yb), SNR_GATE_DB, True))
    return checks, {"first_call_s": t_first, "binaural_block_s": times}


def phase_config4(C: int = 128, seconds: float = 1.0, seed: int = 4):
    """Config 4: K-weighted 128-channel BS.1770 integrated loudness, and
    the 997 Hz -20 dBFS sine -> -23.0 LKFS reference point."""
    import jax.numpy as jnp

    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.loudness import integrated_loudness

    rng = np.random.default_rng(seed)
    T = int(seconds * FS)
    x = (rng.standard_normal((C, T)) * 0.1
         * rng.uniform(0.2, 1.0, size=(C, 1))).astype(np.float32)
    L, t_first = _timed(integrated_loudness, jnp.asarray(x), FS)
    L_ref = golden.integrated_loudness(x, FS)
    t = np.arange(int(3 * FS)) / FS
    sine = (np.sin(2 * np.pi * 997.0 * t) * 10 ** (-20 / 20)).astype(
        np.float32)
    Ls, _ = _timed(integrated_loudness, jnp.asarray(sine[None]), FS)
    checks = [
        Check("config4 |LKFS - float64 golden| (LU)",
              abs(float(L) - float(L_ref)), 0.05, False),
        Check("config4 997 Hz -20 dBFS sine |LKFS - (-23.0)| (LU)",
              abs(float(Ls) + 23.0), 0.1, False),
    ]
    return checks, {"first_call_s": t_first, "lkfs": float(L)}


def phase_assoc_dw(C: int = 64, T: int = 4096, seed: int = 5):
    """The double-word ``assoc_dw`` ramp engine (``filters/iir.py``) on
    near-unit-circle poles against the golden float64 DF2T ramp, and the
    error-free transforms of ``utils/dwfloat.py`` exact under jit on the
    card (a contracted multiply-add would break them)."""
    import jax
    import jax.numpy as jnp

    from bbcat_dsp_tpu.filters.iir import DWCoeffs, biquad_apply
    from bbcat_dsp_tpu.golden.biquad import (
        FilterType,
        biquad_coeffs,
        biquad_process_interpolated,
    )
    from bbcat_dsp_tpu.utils.dwfloat import dw_from_f64, two_prod, two_sum

    rng = np.random.default_rng(seed)
    a = rng.standard_normal(1 << 16).astype(np.float32)
    b = rng.standard_normal(1 << 16).astype(np.float32)
    s, e = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b * 1e-6))
    sum_exact = np.array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) + (b * np.float32(1e-6)).astype(np.float64))
    p, e = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    prod_exact = np.array_equal(
        np.asarray(p, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) * b.astype(np.float64))

    x = rng.standard_normal((C, T))
    c0 = np.stack([biquad_coeffs(FilterType.HPF12, 80.0 + 0.5 * i, FS)
                   for i in range(C)])
    c1 = np.stack([biquad_coeffs(FilterType.HPF12, 40.0 + 0.5 * i, FS)
                   for i in range(C)])
    mul = np.maximum(1.0 - np.arange(T) / T, 0.0)
    traj = c1[:, None, :] - mul[None, :, None] * (c1 - c0)[:, None, :]
    hi, lo = dw_from_f64(traj)
    (y, _), t_first = _timed(biquad_apply, jnp.asarray(x, jnp.float32),
                             DWCoeffs(hi, lo))
    g = np.stack([biquad_process_interpolated(x[c], c0[c], c1[c], T)[0]
                  for c in range(C)])
    checks = [
        Check("two_sum exact under jit", float(sum_exact), 1.0, True),
        Check("two_prod exact under jit", float(prod_exact), 1.0, True),
        Check("assoc_dw ramp SNR dB vs float64 golden DF2T",
              snr_db(g, np.asarray(y)), 130.0, True),
    ]
    return checks, {"first_call_s": t_first}


def phase_four_sharded(C: int = 1024, N: int = 65536, block: int = 512,
                       ratio: int = 8, n_dev: int = 4, groups: int = 1,
                       n_golden: int = 4, seed: int = 6):
    """Config 5 channel-sharded over a 1-D ``"ch"`` mesh of ``n_dev``
    cards (``channel_sharded_nonuniform_render``) plus
    ``sharded_integrated_loudness``, both against the single-card result,
    and the sharded render against the float64 golden convolution."""
    import jax
    import jax.numpy as jnp

    from bbcat_dsp_tpu.convolve import NonUniformConvolver
    from bbcat_dsp_tpu.loudness import integrated_loudness
    from bbcat_dsp_tpu.parallel import (
        channel_sharded_nonuniform_render,
        channel_sharding,
        make_mesh,
        shard_channels,
        sharded_integrated_loudness,
    )

    devs = jax.devices()[:n_dev]
    if len(devs) != n_dev:
        raise RuntimeError(f"need {n_dev} devices, have {len(devs)}")
    rng = np.random.default_rng(seed)
    irs = _decaying_irs(rng, C, N, 8000.0)
    single = NonUniformConvolver(irs, block=block, ratio=ratio)
    T = groups * single.tail_parts * single.super_block
    x = rng.standard_normal((C, T)).astype(np.float32)
    y_ref, t_single = _timed(single.process, jnp.asarray(x))
    L_ref = float(integrated_loudness(y_ref, FS))
    y_ref = np.asarray(y_ref)

    mesh = make_mesh(n_dev, "ch")
    conv = NonUniformConvolver(irs, block=block, ratio=ratio)

    def put(a, axis):
        return jax.device_put(a, channel_sharding(mesh, a.ndim, axis))

    state = conv.state._replace(
        xcarry=put(conv.state.xcarry, 2), prev=put(conv.state.prev, 1),
        tail=conv.state.tail._replace(
            queue=put(conv.state.tail.queue, 2),
            prev=put(conv.state.tail.prev, 1)),
        pending=put(conv.state.pending, 1))
    H_head, H_tail = put(conv.H_head, 2), put(conv.H_tail, 2)
    render = channel_sharded_nonuniform_render(mesh, block, tail_slot0=0,
                                               specs=conv.specs)
    (state, y), t_sharded = _timed(render, state, H_head, H_tail,
                                   shard_channels(x, mesh))
    # (array, channel axis): every big leaf must really span the mesh
    spans = [(y, 0), (state.tail.queue, 2), (state.xcarry, 2)]
    spread = all(
        len(a.sharding.device_set) == n_dev
        and len({s.device for s in a.addressable_shards}) == n_dev
        and all(s.data.shape[ax] == C // n_dev for s in a.addressable_shards)
        for a, ax in spans)
    weights = shard_channels(jnp.ones((C,), jnp.float32), mesh)
    L, _ = _timed(sharded_integrated_loudness(mesh, FS, C), y, weights)
    y = np.asarray(y)
    checks = [
        Check("sharded state and output span %d devices, %d ch each"
              % (n_dev, C // n_dev), float(spread), 1.0, True),
        Check("sharded render SNR dB vs single-card render",
              snr_db(y_ref, y), 110.0, True),
        Check("|sharded LKFS - single-card LKFS| (LU)",
              abs(float(L) - L_ref), 1e-3, False),
    ]
    for c in np.linspace(0, C - 1, min(n_golden, C)).astype(int):
        checks.append(Check(f"sharded ch{c} SNR dB vs float64 golden",
                            snr_db(_golden_conv(x[c], irs[c]), y[c]),
                            SNR_GATE_DB, True))
    return checks, {"single_first_call_s": t_single,
                    "sharded_first_call_s": t_sharded}


ONE_CARD_PHASES = [
    ("headline", phase_headline),
    ("config5", phase_config5),
    ("config1", phase_config1),
    ("config2", phase_config2),
    ("config3", phase_config3),
    ("config4", phase_config4),
    ("assoc_dw", phase_assoc_dw),
]
FOUR_CARD_PHASES = [("config5_sharded_4", phase_four_sharded)]


def run_phases(phases) -> bool:
    """Run every phase, print its report, and return True iff all passed."""
    import jax

    dev = jax.devices()[0]
    all_ok = True
    for name, fn in phases:
        print(f"== phase {name}: "
              + " ".join(fn.__doc__.split("\n\n")[0].split()))
        print(f"  precision: {PRECISION}")
        try:
            checks, timings = fn()
        except Exception as e:  # noqa: BLE001 — report and fail the run
            import traceback

            traceback.print_exc()
            print(f"  FAIL {name}: {type(e).__name__}: {e}")
            all_ok = False
            continue
        for c in checks:
            print(c.line())
            all_ok &= c.ok
        print(f"  timings: {json.dumps(timings)}")
        stats = dev.memory_stats() or {}
        print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
        sys.stdout.flush()
    return all_ok


def card_identity() -> str:
    """``nvidia-smi`` name and power limit of the card(s)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r}); "
              "refusing to run", file=sys.stderr)
        return 2
    if four and len(devs) < 4:
        print(f"chip_smoke --four: need 4 GPUs, have {len(devs)}",
              file=sys.stderr)
        return 2

    from bbcat_dsp_tpu.utils.compile_cache import configure_compile_cache

    print("compile cache:", configure_compile_cache())
    print("card (nvidia-smi name, power.limit):")
    print(card_identity())
    print("jax.devices():", devs)
    ok = run_phases(FOUR_CARD_PHASES if four else ONE_CARD_PHASES)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
