"""Per-op device timings of the two-level convolver's XLA formulations,
the transform A/B (``xla`` = cuFFT vs ``dftmm`` matrix DFTs), and one
profiler trace of the headline and of the config-5 render, on one GPU.

    python scripts/measure_xla_ops.py [--out chiprun_out/xla_ops.json]

Shapes are the ones the engine's grouped render uses at the BASELINE
headline (64 ch x 32k taps) and config 5 (1024 ch x 64k taps), both at
block 512 / ratio 8.  Each op is jitted alone and timed on the host clock
over back-to-back calls ending in ``block_until_ready``; bytes are the
least the op must move (inputs read once, outputs written once), and the
share is against the H100's published 3.35 TB/s.  Refuses to run without
a GPU.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FS = 48000.0
SHAPES = {
    # name: (C, N taps, block, ratio)
    "headline": (64, 32768, 512, 8),
    "config5": (1024, 65536, 512, 8),
}


def _time(fn, *args, reps: int = 20) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _nbytes(*arrs) -> int:
    return int(sum(a.size * a.dtype.itemsize for a in arrs))


def op_timings(name: str) -> list[dict]:
    import jax
    import jax.numpy as jnp

    from bbcat_dsp_tpu.convolve.fft import (
        half_window_signs,
        irfft_tail_planes,
        resolve_spectral_spec,
        rfft_half_planes,
    )
    from bbcat_dsp_tpu.convolve.nonuniform import (
        _choose_chunk,
        _delayed_add,
        _gather_supers,
        _head_mac,
        _head_step,
        _tail_group_mac,
    )

    C, N, B, ratio = SHAPES[name]
    B2 = B * ratio
    Pt = -(-(N - 2 * ratio * B) // B2)
    Ph = 2 * ratio
    F, F2 = B + 1, B2 + 1
    n_small = Pt * ratio
    hc = _choose_chunk(n_small, 16 if C >= 512 else (32 if C >= 128
                                                       else n_small))
    key = jax.random.PRNGKey(0)
    r = lambda *s: jax.random.normal(key, s, jnp.float32)  # noqa: E731
    sh = resolve_spectral_spec(2 * B)
    st = resolve_spectral_spec(2 * B2)
    rows = []

    def row(op, fn, args, out_bytes, note=""):
        dt = _time(jax.jit(fn), *args)
        nb = _nbytes(*args) + out_bytes
        rows.append({"cell": name, "op": op, "seconds": dt, "bytes": nb,
                     "GBps": nb / dt / 1e9,
                     "hbm_share": nb / dt / HBM_BYTES_PER_S, "note": note})
        print(json.dumps(rows[-1]))
        sys.stdout.flush()

    xext, Hh = r(2, Ph + hc, C, F), r(2, Ph, C, F)
    row("head_mac", lambda a, h: _head_mac(a, h, hc), (xext, Hh),
        4 * 2 * hc * C * F, f"P={Ph} ratio={hc} C={C} F={F}")
    xcarry, prev, xh = r(2, Ph, C, F), r(2, C, F), r(C, hc * B)
    row("head_step (fused head)",
        lambda a, p, h, x: _head_step(a, p, h, x, B, hc, sh),
        (xcarry, prev, Hh, xh), 4 * (C * hc * B + 2 * Ph * C * F
                                     + 2 * C * F),
        "rfft_half + window assembly + MAC + irfft_tail, one chunk")
    q, xt, Ht = r(2, Pt, C, F2), r(2, Pt, C, F2), r(2, Pt, C, F2)
    s2 = jnp.asarray(half_window_signs(2 * B2, spec=st))
    row("tail_group_mac", lambda a, b, h: _tail_group_mac(
        a, jnp.int32(0), b, h, s2, 0), (q, xt, Ht), 4 * 2 * Pt * C * F2,
        f"Pt={Pt} C={C} F={F2} slot0=0")
    xg = r(C, Pt * B2)
    row("gather_supers", lambda x: _gather_supers(x, Pt), (xg,),
        4 * C * Pt * B2)
    xs = r(Pt, C, B2)
    row("tail rfft_half n=%d" % (2 * B2),
        lambda x: rfft_half_planes(x, 2 * B2, spec=st), (xs,),
        4 * 2 * Pt * C * F2)
    row("tail irfft_tail n=%d" % (2 * B2),
        lambda s: irfft_tail_planes(s, 2 * B2, spec=st), (xt,),
        4 * Pt * C * B2)
    yh, pend, ot = r(C, Pt * B2), r(2, C, B2), r(Pt, C, B2)
    row("delayed_add", _delayed_add, (yh, pend, ot),
        4 * (C * Pt * B2 + 2 * C * B2))
    return rows


def transform_ab(name: str) -> list[dict]:
    """cuFFT vs matrix-DFT (HIGHEST) half-window transforms at the head
    (n = 2B) and tail (n = 2B2) sizes, timed and checked against numpy."""
    import jax
    import jax.numpy as jnp

    from bbcat_dsp_tpu.convolve import fft

    C, N, B, ratio = SHAPES[name]
    B2 = B * ratio
    Pt = -(-(N - 2 * ratio * B) // B2)
    out = []
    for n, lead in ((2 * B, (16, C)), (2 * B2, (Pt, C))):
        x = np.random.default_rng(0).standard_normal(
            lead + (n // 2,)).astype(np.float32)
        ref = np.fft.rfft(np.concatenate(
            [x[:2].astype(np.float64), np.zeros_like(x[:2], np.float64)],
            -1), axis=-1)
        for backend in ("xla", "dftmm"):
            spec = fft.resolve_spectral_spec(n, backend=backend)
            fwd = jax.jit(lambda a, s=spec: fft.rfft_half_planes(a, n,
                                                                 spec=s))
            inv = jax.jit(lambda a, s=spec: fft.irfft_tail_planes(a, n,
                                                                  spec=s))
            xd = jnp.asarray(x)
            X = fwd(xd)
            tf, ti = _time(fwd, xd), _time(inv, X)
            got = np.asarray(X[:, :2])
            if spec.layout == "perm":
                got_c = fft.unpermute_half_spectrum(
                    got[0] + 1j * got[1], n, radix=spec.radix)
            else:
                got_c = got[0] + 1j * got[1]
            err = np.sum(np.abs(got_c - ref) ** 2)
            snr = 10 * np.log10(np.sum(np.abs(ref) ** 2) / err)
            out.append({"cell": name, "n": n, "backend": backend,
                        "layout": spec.layout, "batch": list(lead),
                        "fwd_s": tf, "inv_s": ti, "fwd_snr_db": snr})
            print(json.dumps(out[-1]))
            sys.stdout.flush()
    return out


def end_to_end(name: str, backend: str, precision: str = "highest",
               trace_dir: str | None = None) -> dict:
    """One render group through ``NonUniformConvolver.process`` with both
    levels on ``backend``: median of 5 warm renders (distinct inputs) and
    SNR vs float64 golden on 4 channels."""
    import jax
    import jax.numpy as jnp
    from scipy.signal import fftconvolve

    from bbcat_dsp_tpu.convolve import NonUniformConvolver, fft

    C, N, B, ratio = SHAPES[name]
    fft.set_precision(precision)
    jax.clear_caches()
    try:
        rng = np.random.default_rng(0)
        irs = rng.standard_normal((C, N)) * np.exp(-np.arange(N) / 8000.0)
        specs = (fft.resolve_spectral_spec(2 * B, backend=backend),
                 fft.resolve_spectral_spec(2 * B * ratio, backend=backend))
        conv = NonUniformConvolver(irs, block=B, ratio=ratio, spectral=specs)
        T = conv.tail_parts * conv.super_block
        xs = [jnp.asarray(rng.standard_normal((C, T)).astype(np.float32))
              for _ in range(7)]
        t0 = time.perf_counter()
        y0 = jax.block_until_ready(conv.process(xs[0]))
        first = time.perf_counter() - t0
        warms = []
        for x in xs[1:6]:
            t0 = time.perf_counter()
            jax.block_until_ready(conv.process(x))
            warms.append(time.perf_counter() - t0)
        warm = float(np.median(warms))
        if trace_dir:
            with jax.profiler.trace(trace_dir):
                jax.block_until_ready(conv.process(xs[6]))
        x0 = np.asarray(xs[0])
        y0 = np.asarray(y0)
        snrs = []
        for c in (0, C // 3, 2 * C // 3, C - 1):
            ref = fftconvolve(x0[c].astype(np.float64), irs[c])[:T]
            snrs.append(float(10 * np.log10(
                np.sum(ref ** 2) / np.sum((ref - y0[c]) ** 2))))
    finally:
        fft.set_precision("highest")
        jax.clear_caches()
    res = {"cell": name, "backend": backend, "precision": precision,
           "tail_layout": specs[1].layout, "first_call_s": first,
           "warm_render_s": warm, "warm_renders_s": warms,
           "rtf": T / FS / warm,
           "snr_db_min": min(snrs), "snr_db": snrs}
    print(json.dumps(res))
    sys.stdout.flush()
    return res


def reduce_trace(trace_dir: str) -> dict:
    """Per-device-line totals and the 30 costliest op names of a trace."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = ProfileData.from_file(sorted(paths)[-1])
    lines = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            ev = [(e.name, e.start_ns, e.duration_ns) for e in line.events]
            if not ev:
                continue
            tot = {}
            for n, _, d in ev:
                tot[n] = tot.get(n, 0.0) + d
            ivs = sorted((s, s + d) for _, s, d in ev)
            busy, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][1]
            for s, e in ivs[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            window = max(e for _, e in ivs) - ivs[0][0]
            top = sorted(tot.items(), key=lambda kv: -kv[1])[:30]
            lines[f"{plane.name} | {line.name}"] = {
                "events": len(ev), "busy_ns": busy, "window_ns": window,
                "top_ns": top}
    return lines


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/xla_ops.json")
    args = ap.parse_args(argv)
    import jax

    if jax.devices()[0].platform != "gpu":
        print("measure_xla_ops: no GPU; refusing to run", file=sys.stderr)
        return 2
    from bbcat_dsp_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print("card:", card)
    res = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "ops": [], "transforms": [], "end_to_end": []}
    for name in SHAPES:
        res["ops"] += op_timings(name)
        res["transforms"] += transform_ab(name)
    out_dir = os.path.dirname(args.out) or "."
    for name in SHAPES:
        for backend in ("xla", "dftmm"):
            trace_dir = (os.path.join(out_dir, f"trace_{name}")
                         if backend == "xla" else None)
            res["end_to_end"].append(end_to_end(name, backend,
                                                trace_dir=trace_dir))
            if trace_dir:
                res[f"trace_{name}_xla"] = reduce_trace(trace_dir)
    res["end_to_end"].append(end_to_end("headline", "dftmm", "high"))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(res, fp, indent=1)
    for name in SHAPES:
        for k, v in res[f"trace_{name}_xla"].items():
            print(name, k, "events", v["events"], "busy_ns", v["busy_ns"],
                  "window_ns", v["window_ns"])
            for n, d in v["top_ns"][:12]:
                print("   %12.0f ns  %s" % (d, n[:110]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
