"""Benchmark sweep: every BASELINE.json config on one GPU.

Prints one JSON line per config (real-time factor from the median of
several warm calls, each ending in ``block_until_ready``) and, with
``--out PATH``, writes them all to PATH.

    python scripts/bench_all.py [--out chiprun_out/bench_all.json]

Each config runs in a child process of its own; the parent never imports
JAX, so only one process at a time holds the card.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

FS = 48000.0


def _median_time(run, reps: int = 10) -> float:
    """Median seconds per warm call (the first call compiles)."""
    import jax

    jax.block_until_ready(run())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_config1():
    """Mono 512-block 4096-tap uniform convolver."""
    import jax.numpy as jnp
    from bbcat_dsp_tpu.convolve import BlockConvolver

    rng = np.random.default_rng(0)
    B, N, T = 512, 4096, 512 * 64
    ir = rng.standard_normal(N) * np.exp(-np.arange(N) / 500.0)
    conv = BlockConvolver(ir, block=B)
    x = jnp.asarray(rng.standard_normal((1, T)).astype(np.float32))

    def run():
        return conv.process(x)  # engages the static-slot zero-gather path

    dt = _median_time(run)
    return {"config": "1: mono 512-block 4096-tap", "rtf": T / FS / dt}


def bench_config2():
    """8-stage biquad EQ over 8 channels + fractional delay."""
    import jax.numpy as jnp
    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.golden.biquad import FilterType
    from bbcat_dsp_tpu.models import EQDelayPipeline

    rng = np.random.default_rng(0)
    C, B = 8, 4096
    eq = np.stack([
        golden.biquad_coeffs(FilterType.PEQ, 100.0 * (i + 1), FS,
                             gain=(-1.0) ** i * 3.0)
        for i in range(8)
    ])
    pipe = EQDelayPipeline(eq, nchannels=C, block=B, max_delay=256.0, fs=FS)
    import jax

    delays = jnp.asarray(np.linspace(20, 200, C).astype(np.float32))[:, None]
    nblk = 16
    xs = jnp.asarray(rng.standard_normal((nblk, C, B)).astype(np.float32))

    # device-resident streaming: scan over blocks inside ONE jit call
    @jax.jit
    def run_scan(state, xs):
        def body(st, xb):
            st, y = pipe._step_impl(st, xb, delays, False)
            return st, y[:, -1]
        st, tails = jax.lax.scan(body, state, xs)
        return st, tails

    box = {"st": pipe.state}

    def run():
        box["st"], t = run_scan(box["st"], xs)
        return t

    dt = _median_time(run)
    dt /= nblk
    return {"config": "2: 8ch 8-stage EQ + fractional delay", "rtf": B / FS / dt}


def bench_config3():
    """64-in x 2-out HRTF matrix convolver."""
    import jax.numpy as jnp
    from bbcat_dsp_tpu.convolve import MatrixConvolver

    rng = np.random.default_rng(0)
    ci, B, N = 64, 512, 1024
    irm = rng.standard_normal((ci, 2, N)) * np.exp(-np.arange(N) / 200.0)
    conv = MatrixConvolver(irm, block=B)
    from bbcat_dsp_tpu.convolve.matrix import matrix_render

    # long render per dispatch: at these tiny per-block costs per-call
    # host overhead dominates anything shorter
    nblk = 128
    x = jnp.asarray(rng.standard_normal((ci, nblk * B)).astype(np.float32))
    H = conv.H
    box = {"st": conv.state}

    def run():
        box["st"], y = matrix_render(box["st"], H, x, B)
        return y

    dt = _median_time(run)
    dt /= nblk
    return {"config": "3: 64x2 HRTF matrix conv", "rtf": B / FS / dt}


def bench_config4():
    """128-channel loudness + mixdown pipeline."""
    import jax.numpy as jnp
    from bbcat_dsp_tpu.loudness import block_powers, k_weight_params
    from bbcat_dsp_tpu.filters.iir import modal_apply, modal_init

    rng = np.random.default_rng(0)
    C, T = 128, 48000
    x = jnp.asarray((rng.standard_normal((C, T)) * 0.1).astype(np.float32))
    gains = jnp.asarray(rng.standard_normal((2, C)).astype(np.float32) * 0.1)
    import jax

    p_shelf, p_rlb = k_weight_params(FS)
    s1 = modal_init(p_shelf, (C,))
    s2 = modal_init(p_rlb, (C,))

    @jax.jit
    def step(x, s1, s2, g):
        y, s1 = modal_apply(x, p_shelf, s1)
        y, s2 = modal_apply(y, p_rlb, s2)
        blk = int(round(0.4 * FS))
        stp = int(round(0.1 * FS))
        cs = jnp.cumsum(jnp.square(y), axis=-1)
        nb = (T - blk) // stp + 1
        starts = jnp.arange(nb) * stp
        z = jnp.sum((cs[:, starts + blk - 1] - cs[:, starts]) / blk, axis=0)
        mix = jnp.matmul(g, x, precision=jax.lax.Precision.HIGHEST)
        return z, mix, s1, s2

    box = {"s1": s1, "s2": s2}

    def run():
        z, mix, box["s1"], box["s2"] = step(x, box["s1"], box["s2"], gains)
        return mix

    dt = _median_time(run)
    return {"config": "4: 128ch loudness + mixdown (1s)", "rtf": T / FS / dt}


def bench_config5():
    """1024 channels x 64k-tap IRs — the single-card capacity point."""
    import jax.numpy as jnp
    from bbcat_dsp_tpu.convolve import NonUniformConvolver

    rng = np.random.default_rng(0)
    C, N, B, ratio = 1024, 65536, 512, 8
    SB = B * ratio
    irs = (rng.standard_normal((C, N)) * np.exp(-np.arange(N) / 8000.0)
           ).astype(np.float32)
    conv = NonUniformConvolver(irs, block=B, ratio=ratio)
    # nsuper must be a multiple of the tail partition count or the render
    # silently falls back to the dynamic-slot (gather) path
    T = SB * conv.tail_parts
    x = jnp.asarray(rng.standard_normal((C, T)).astype(np.float32))

    def run():
        return conv.process(x)

    rtf = T / FS / _median_time(run)
    return {
        "config": "5: 1024ch x 64k-tap (single-card capacity point)",
        "rtf": rtf,
        "samples_per_sec_per_card": C * rtf * FS,
    }


def _provenance() -> dict:
    """Git SHA + UTC timestamp + layout env, so every result is
    attributable to the exact code state that produced it."""
    import subprocess
    import time

    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=10, check=True,
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "-uno"],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=10, check=True,
        ).stdout.strip() != ""
    except Exception:  # noqa: BLE001
        sha, dirty = "unknown", None
    out = {
        "git_sha": sha,
        "git_dirty": dirty,
        "timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "env": {
            k: v for k, v in os.environ.items()
            if k.startswith("BBCAT_DSP_")
        },
    }
    if dirty:
        # a dirty tree makes the SHA stamp meaningless — pin the exact
        # code state with a diff hash instead
        import hashlib

        diff = subprocess.run(
            ["git", "diff", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=10).stdout
        out["git_diff_sha256"] = hashlib.sha256(
            diff.encode()).hexdigest()[:16]
    return out


_CONFIGS = ["bench_config1", "bench_config2", "bench_config3",
            "bench_config4", "bench_config5"]


def _run_one(name: str):
    import jax

    from bbcat_dsp_tpu.utils.compile_cache import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        return {"config": name, "error": f"no GPU ({dev.platform})"}
    configure_compile_cache()
    try:
        r = globals()[name]()
        r["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}
    except Exception as e:  # noqa: BLE001
        import traceback

        traceback.print_exc()  # the JSON keeps only repr; stderr gets
        r = {"config": name, "error": repr(e)[:300]}  # the stack
    return r


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--only":
        # child mode: one config, print its JSON line, touch nothing else
        print(json.dumps(_run_one(argv[1])))
        return 0

    prov = _provenance()
    if prov.get("git_dirty") and "--allow-dirty" not in argv:
        print("refusing to benchmark a dirty tree (tracked files "
              "modified); commit first or pass --allow-dirty",
              file=sys.stderr)
        return 2
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print("card:", card)
    results = {"card": card, "provenance": prov}
    for name in _CONFIGS:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--only", name],
            capture_output=True, text=True, timeout=1200)
        r = None
        for ln in reversed(p.stdout.strip().splitlines()):
            try:
                r = json.loads(ln)
                break
            except ValueError:
                continue
        if r is None:
            r = {"config": name,
                 "error": "subprocess produced no JSON (rc=%d): %s"
                 % (p.returncode, p.stderr[-200:])}
        results[name] = r
        print(json.dumps(r))
    if "--out" in argv:
        out = argv[argv.index("--out") + 1]
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fp:
            json.dump(results, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
