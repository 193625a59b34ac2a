"""Bit-exact conformance against the COMPILED reference conversion matrix.

Builds the actual reference sources (/root/reference, read-only) out-of-tree
with a minimal bbcat-base stub (tests/ref_conformance/) and compares our
transfer engine against the reference's TransferSamples over every format /
endianness pair.  Skipped when the reference tree or a compiler is absent.
"""

import ctypes
import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest

from bbcat_dsp_tpu.formats import host
from bbcat_dsp_tpu.formats.sample_format import SampleFormat, get_bytes_per_sample

REF = "/root/reference/src"
HERE = os.path.dirname(os.path.abspath(__file__))

FORMATS = [SampleFormat.INT16, SampleFormat.INT24, SampleFormat.INT32,
           SampleFormat.FLOAT, SampleFormat.DOUBLE]


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    if not os.path.isdir(REF) or shutil.which("g++") is None:
        pytest.skip("reference tree or compiler unavailable")
    bd = tmp_path_factory.mktemp("refbuild")
    os.makedirs(bd / "bbcat-base", exist_ok=True)
    shutil.copy(os.path.join(HERE, "ref_conformance", "misc_stub.h"),
                bd / "bbcat-base" / "misc.h")
    shim = os.path.join(HERE, "ref_conformance", "shim.cpp")
    so = bd / "libref.so"
    subprocess.run(
        ["g++", "-O2", "-fPIC", "-shared", f"-I{bd}", f"-I{REF}",
         shim, f"{REF}/SoundFormatConversions.cpp",
         f"{REF}/SoundFormatRawConversions.cpp", "-o", str(so)],
        check=True, capture_output=True, timeout=180,
    )
    lib = ctypes.CDLL(str(so))
    lib.ref_transfer.restype = ctypes.c_int
    lib.ref_transfer.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_uint, ctypes.c_uint,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_uint, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_uint]
    return lib


def _random_packed(rng, fmt, be, nsamples):
    if fmt in (SampleFormat.FLOAT, SampleFormat.DOUBLE):
        vals = np.concatenate([
            rng.standard_normal(nsamples - 4) * 0.7,
            [0.0, 1.0, -1.0, 1.5],  # saturation edges
        ])
        dt = np.dtype("f4" if fmt == SampleFormat.FLOAT else "f8")
        return vals.astype(dt.newbyteorder(">" if be else "<")).tobytes()
    if fmt == SampleFormat.INT16:
        v = rng.integers(-2**15, 2**15, nsamples)
        v[:2] = [-2**15, 2**15 - 1]
        return v.astype(np.dtype(">i2" if be else "<i2")).tobytes()
    if fmt == SampleFormat.INT32:
        v = rng.integers(-2**31, 2**31, nsamples)
        v[:2] = [-2**31, 2**31 - 1]
        return v.astype(np.dtype(">i4" if be else "<i4")).tobytes()
    return rng.integers(0, 256, nsamples * 3).astype(np.uint8).tobytes()


@pytest.mark.parametrize("sfmt,dfmt", list(itertools.product(FORMATS, FORMATS)))
def test_bit_exact_vs_compiled_reference(ref_lib, rng, sfmt, dfmt):
    for sbe, dbe in [(False, False), (True, True), (True, False), (False, True)]:
        nfr, sch, dch, nch, s0, d0 = 13, 3, 4, 2, 1, 2
        raw = np.frombuffer(
            _random_packed(rng, sfmt, sbe, nfr * sch), np.uint8
        ).copy()
        ours = np.zeros(nfr * dch * get_bytes_per_sample(dfmt), np.uint8)
        ref = ours.copy()

        assert host.transfer_samples(
            raw, sfmt, sbe, s0, sch, ours, dfmt, dbe, d0, dch, nch, nfr
        )
        ref_lib.ref_transfer(
            raw.ctypes.data, int(sfmt), int(sbe), s0, sch,
            ref.ctypes.data, int(dfmt), int(dbe), d0, dch, nch, nfr,
        )
        np.testing.assert_array_equal(
            ours, ref,
            err_msg=f"{sfmt.name}{'BE' if sbe else 'LE'} -> "
                    f"{dfmt.name}{'BE' if dbe else 'LE'}",
        )


# ---------------------------------------------------------------------------
# DSP-layer conformance: compiled reference BiQuad / FractionalSample /
# AllPassFilter vs our golden model and device engines


@pytest.fixture(scope="module")
def ref_dsp(tmp_path_factory):
    if not os.path.isdir(REF) or shutil.which("g++") is None:
        pytest.skip("reference tree or compiler unavailable")
    bd = tmp_path_factory.mktemp("refdsp")
    os.makedirs(bd / "bbcat-base", exist_ok=True)
    shutil.copy(os.path.join(HERE, "ref_conformance", "misc_stub.h"),
                bd / "bbcat-base" / "misc.h")
    shutil.copy(os.path.join(HERE, "ref_conformance", "enhancedfile_stub.h"),
                bd / "bbcat-base" / "EnhancedFile.h")
    shim = os.path.join(HERE, "ref_conformance", "shim_dsp.cpp")
    so = bd / "libref_dsp.so"
    subprocess.run(
        ["g++", "-O2", "-fPIC", "-shared", f"-I{bd}", f"-I{REF}",
         shim, f"{REF}/BiQuad.cpp", f"{REF}/FractionalSample.cpp",
         "-o", str(so)],
        check=True, capture_output=True, timeout=180,
    )
    lib = ctypes.CDLL(str(so))
    lib.ref_biquad_coeffs.argtypes = [ctypes.c_int, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_void_p]
    lib.ref_biquad_process.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_uint]
    lib.ref_biquad_process_interp.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]
    lib.ref_fractional_sample.restype = ctypes.c_double
    lib.ref_fractional_sample.argtypes = [ctypes.c_void_p, ctypes.c_uint,
                                          ctypes.c_uint, ctypes.c_uint,
                                          ctypes.c_double]
    lib.ref_fractional_headroom.restype = ctypes.c_uint
    lib.ref_allpass_process.argtypes = [ctypes.c_float, ctypes.c_uint,
                                        ctypes.c_uint, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_uint]
    return lib


def test_biquad_coeffs_match_compiled_reference(ref_dsp):
    """Our RBJ design == the compiled reference's CalcCoeffs, bit-exact."""
    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.golden.biquad import FilterType

    out = np.zeros(5, np.float64)
    for t in FilterType:
        for freq, gain, bw in [(1000.0, 6.0, 1.0), (80.0, -4.5, 0.33),
                               (15000.0, 2.0, 2.0)]:
            ref_dsp.ref_biquad_coeffs(int(t), freq, 48000.0, gain, bw,
                                      out.ctypes.data)
            ours = golden.biquad_coeffs(t, freq, 48000.0, gain, bw)
            np.testing.assert_allclose(ours, out, rtol=0, atol=0,
                                       err_msg=str(t))


def test_biquad_process_matches_compiled_reference(ref_dsp, rng):
    """Our golden DF2T == the compiled reference tick (float in, double
    state — identical arithmetic, tiny float rounding differences only)."""
    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.golden.biquad import FilterType

    c = golden.biquad_coeffs(FilterType.PEQ, 700.0, 48000.0, 5.0, 1.0)
    x = rng.standard_normal(2048).astype(np.float32)
    y_ref = np.zeros_like(x)
    ref_dsp.ref_biquad_process(c.ctypes.data, x.ctypes.data,
                               y_ref.ctypes.data, x.size)
    y_g, _ = golden.biquad_process(x, c)
    # reference emits float32 samples from double state
    assert 10 * np.log10(
        np.sum(y_ref.astype(np.float64)**2)
        / np.sum((y_ref - y_g.astype(np.float32))**2)
    ) > 120.0


def test_interpolated_ramp_matches_compiled_reference(ref_dsp, rng):
    """Click-free coefficient interpolation: our golden (and therefore the
    device bank, already tested against golden) == compiled reference."""
    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.golden.biquad import FilterType

    c0 = golden.biquad_coeffs(FilterType.PEQ, 1000.0, 48000.0, 0.0)
    c1 = golden.biquad_coeffs(FilterType.PEQ, 1000.0, 48000.0, 9.0)
    x = rng.standard_normal(600).astype(np.float32)
    y_ref = np.zeros_like(x)
    ref_dsp.ref_biquad_process_interp(c0.ctypes.data, c1.ctypes.data, 400.0,
                                      x.ctypes.data, y_ref.ctypes.data, x.size)
    y_g, _, _ = golden.biquad_process_interpolated(x, c0, c1, 400.0)
    assert 10 * np.log10(
        np.sum(y_ref.astype(np.float64)**2)
        / np.sum((y_ref - y_g.astype(np.float32))**2)
    ) > 120.0


def test_fractional_sample_matches_compiled_reference(ref_dsp, rng):
    """Polyphase fractional read: bit-comparable to the compiled reference
    (identical table + index contract)."""
    from bbcat_dsp_tpu import golden

    assert ref_dsp.ref_fractional_headroom() == golden.ADDITIONAL_DELAY
    L, C = 128, 2
    buf = (rng.standard_normal(L * C) * 0.5).astype(np.float32)
    for pos in [14.0, 20.25, 63.99, 100.5, 127.0078125]:
        for ch in range(C):
            want = ref_dsp.ref_fractional_sample(
                buf.ctypes.data, ch, C, L, pos
            )
            got = golden.fractional_sample(buf, ch, C, L, pos)
            assert abs(want - got) < 1e-9, (pos, ch)


def test_allpass_matches_compiled_reference(ref_dsp, rng):
    from bbcat_dsp_tpu import golden

    C, d, T = 2, 7, 512
    x = (rng.standard_normal((T, C)) * 0.5).astype(np.float32)  # interleaved
    y_ref = np.zeros_like(x)
    ref_dsp.ref_allpass_process(0.5, d, C, x.ctypes.data, y_ref.ctypes.data, T)
    y_g, _ = golden.allpass_process(x.T, 0.5, d)
    assert 10 * np.log10(
        np.sum(y_ref.T.astype(np.float64)**2)
        / np.sum((y_ref.T - y_g.astype(np.float32))**2 + 1e-30)
    ) > 120.0


def test_fuzz_transfers_vs_compiled_reference(ref_lib, rng):
    """Randomised fuzz: 200 random rectangle transfers, bit-exact."""
    for _ in range(200):
        sfmt, dfmt = rng.choice(FORMATS, 2)
        sbe, dbe = bool(rng.integers(2)), bool(rng.integers(2))
        sch = int(rng.integers(1, 6))
        dch = int(rng.integers(1, 6))
        s0 = int(rng.integers(0, sch))
        d0 = int(rng.integers(0, dch))
        nch = int(rng.integers(1, 8))
        nfr = int(rng.integers(1, 40))
        raw = np.frombuffer(
            _random_packed(rng, sfmt, sbe, max(nfr * sch, 8)), np.uint8
        ).copy()
        ours = np.zeros(nfr * dch * get_bytes_per_sample(dfmt), np.uint8)
        ref = ours.copy()
        ok = host.transfer_samples(
            raw, sfmt, sbe, s0, sch, ours, dfmt, dbe, d0, dch, nch, nfr
        )
        ref_lib.ref_transfer(
            raw.ctypes.data, int(sfmt), int(sbe), s0, sch,
            ref.ctypes.data, int(dfmt), int(dbe), d0, dch, nch, nfr,
        )
        assert ok
        np.testing.assert_array_equal(
            ours, ref,
            err_msg=f"{sfmt} be={sbe} ch{s0}/{sch} -> {dfmt} be={dbe} "
                    f"ch{d0}/{dch} n={nch}x{nfr}",
        )


def test_fuzz_biquads_vs_compiled_reference(ref_dsp, rng):
    """Randomised fuzz: 50 random filter designs + processing runs."""
    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.golden.biquad import FilterType

    out = np.zeros(5, np.float64)
    for _ in range(50):
        t = FilterType(int(rng.integers(0, 10)))
        freq = float(rng.uniform(20.0, 20000.0))
        gain = float(rng.uniform(-12.0, 12.0))
        bw = float(rng.uniform(0.1, 3.0))
        ref_dsp.ref_biquad_coeffs(int(t), freq, 48000.0, gain, bw,
                                  out.ctypes.data)
        c = golden.biquad_coeffs(t, freq, 48000.0, gain, bw)
        np.testing.assert_allclose(c, out, rtol=0, atol=0,
                                   err_msg=f"{t} f={freq} g={gain} bw={bw}")
        x = rng.standard_normal(256).astype(np.float32)
        y_ref = np.zeros_like(x)
        ref_dsp.ref_biquad_process(c.ctypes.data, x.ctypes.data,
                                   y_ref.ctypes.data, x.size)
        y_g, _ = golden.biquad_process(x, c)
        err = np.abs(y_ref - y_g.astype(np.float32)).max()
        scale = max(np.abs(y_ref).max(), 1e-9)
        assert err / scale < 1e-5, f"{t} f={freq} g={gain} bw={bw}"


def test_dw_ramp_vs_compiled_reference_hard_filters(ref_dsp, rng):
    """Hard-filter ramp conformance (C=64, T=4096,
    near-unit-circle poles).  Three pinned facts:

    1. The compiled reference casts y to float32 INSIDE its feedback path
       (ref: src/BiQuad.h:200-206) — on these filters that is a ~95 dB
       self-noise floor, so NO engine can match its output beyond that
       without replicating the cast.  Our golden with
       ``sample_rounding=True`` reproduces the cast and matches the
       compiled reference >130 dB — we model its numerics exactly.
    2. The parallel double-word engine matches the IDEAL double recurrence
       (the semantics the reference's double coeffs/state aim for)
       >140 dB — i.e. it is strictly MORE accurate than the reference.
    3. It therefore matches the compiled reference right down to the
       reference's own noise floor (>90 dB).
    """
    import jax.numpy as jnp

    from bbcat_dsp_tpu import golden
    from bbcat_dsp_tpu.golden.biquad import (
        FilterType,
        biquad_process_interpolated,
    )
    from bbcat_dsp_tpu.filters.iir import DWCoeffs, biquad_apply
    from bbcat_dsp_tpu.utils.dwfloat import dw_from_f64

    C, T = 64, 4096
    x = rng.standard_normal((C, T)).astype(np.float32)
    y_ref = np.zeros_like(x)
    c0s = np.stack([golden.biquad_coeffs(FilterType.HPF12, 80.0 + 0.1 * c,
                                         48000.0) for c in range(C)])
    c1s = np.stack([golden.biquad_coeffs(FilterType.HPF12, 40.0 + 0.1 * c,
                                         48000.0) for c in range(C)])
    for c in range(C):
        ref_dsp.ref_biquad_process_interp(
            c0s[c].ctypes.data, c1s[c].ctypes.data, float(T),
            x[c].ctypes.data, y_ref[c].ctypes.data, T)
    ref64 = y_ref.astype(np.float64)

    def snr(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.sum((a - b) ** 2)
        if err == 0.0:  # exact agreement (no RuntimeWarning)
            return np.inf
        return 10 * np.log10(np.sum(b ** 2) / err)

    # (1) golden with the reference's Sample_t cast == compiled reference
    g_cast = np.stack([
        biquad_process_interpolated(x[c], c0s[c], c1s[c], float(T),
                                    sample_rounding=True)[0]
        for c in range(C)
    ])
    assert snr(g_cast, ref64) > 130.0

    # (2) dw engine vs the ideal double recurrence
    ideal = np.stack([
        biquad_process_interpolated(x[c], c0s[c], c1s[c], float(T))[0]
        for c in range(C)
    ])
    mul = np.maximum(1.0 - np.arange(T) / T, 0.0)
    traj = c1s[:, None, :] - mul[None, :, None] * (c1s - c0s)[:, None, :]
    hi, lo = dw_from_f64(traj)
    y, _ = biquad_apply(jnp.asarray(x), DWCoeffs(hi, lo))
    assert snr(y, ideal) > 140.0
    # the reference itself is ~95 dB from the ideal here — we beat it
    assert snr(y, ideal) > snr(ref64, ideal) + 20.0

    # (3) and we sit on the reference's own noise floor
    assert snr(y, ref64) > 90.0
