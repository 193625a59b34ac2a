"""Real-FFT abstraction over re/im PLANES.

The reference had a pluggable FFT interface with FFTW and KISS backends
(ref: README:46-51, documented-absent sources; debian/control:5).  Here the
framework's spectral representation is a stacked real array ``[2, ..., F]``
(plane 0 = real, plane 1 = imag), and two backends provide the transforms:

* ``"xla"`` (the default everywhere): ``jnp.fft`` wrapped to/from the
  plane layout.  XLA lowers it to cuFFT on the GPU and to its own FFT on
  the CPU.

* ``"dftmm"``: the DFT as real matrix products against precomputed
  cos/sin matrices at ``Precision.HIGHEST`` (float32 outside the tensor
  cores; lower precisions run float32 products in TF32 on the GPU, which
  the >= 90 dB convolution contract does not survive).  Sizes above
  ``_MAX_DIRECT`` use a four-step factorisation or, for the half-window
  engine, the permuted spectral layout below.  Kept as a named backend for
  A/B measurements; nothing selects it by default.

Complex helpers (:func:`cmul`) are explicit elementwise arithmetic on the
planes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "rfft_planes",
    "irfft_planes",
    "cmul",
    "planes_from_complex",
    "default_backend",
    "register_backend",
    "backends",
    "half_engine_layout",
    "spectral_nbins",
    "permute_half_spectrum",
    "unpermute_half_spectrum",
    "convert_perm_order",
    "ensure_layout_usable",
    "SpectralSpec",
    "resolve_spectral_spec",
]

# Matrix-product precision of the dftmm backend.  HIGHEST keeps the
# products in float32; HIGH and DEFAULT run them in reduced-precision
# tensor-core formats (TF32 on the GPU), ~11 mantissa bits, which costs
# the convolution engines their >= 90 dB contract.
_PREC = jax.lax.Precision.HIGHEST


def set_precision(p) -> None:
    """Set the dftmm backend's matrix-product precision ("high"/"highest"
    or a jax.lax.Precision).  Takes effect for newly traced computations."""
    global _PREC
    if isinstance(p, str):
        p = getattr(jax.lax.Precision, p.upper())
    _PREC = p

# host-side cache of DFT matrices per n: (cos [n,F], msin [n,F], icos [F,n],
# isin [F,n]) as float32 numpy (numpy, not jnp, so jit traces never leak)
_MATS: dict[int, tuple] = {}


def _mats(n: int):
    if n not in _MATS:
        k = np.arange(n // 2 + 1)
        t = np.arange(n)
        ang = 2.0 * np.pi * np.outer(t, k) / n  # [n, F]
        cos = np.cos(ang)
        sin = np.sin(ang)
        # forward: Re = x @ cos, Im = -(x @ sin)
        # inverse: x[t] = sum_k w_k (Re[k] cos[t,k] - Im[k] sin[t,k]) / n
        w = np.full(n // 2 + 1, 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        icos = (w[:, None] * cos.T) / n          # [F, n]
        isin = (-w[:, None] * sin.T) / n         # [F, n]
        _MATS[n] = (
            cos.astype(np.float32),
            (-sin).astype(np.float32),
            icos.astype(np.float32),
            isin.astype(np.float32),
        )
    return _MATS[n]


# direct matmul-DFT up to this size; beyond it, Cooley-Tukey four-step with
# balanced factors (matrix constants stay small)
_MAX_DIRECT = 2048

_CMATS: dict[int, tuple] = {}


def _cmats(n: int):
    """Complex DFT_n matrix planes (cos, -sin) [n, n] float32, cached."""
    if n not in _CMATS:
        ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(n)) / n
        _CMATS[n] = (
            np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32),
        )
    return _CMATS[n]


_TWIDDLE: dict[int, tuple] = {}


def _twiddle(n1: int, n2: int):
    """Four-step twiddle planes W[n1, k2] = exp(-2pi i n1 k2 / (n1 n2))."""
    key = (n1, n2)
    if key not in _TWIDDLE:
        ang = 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2)
        _TWIDDLE[key] = (
            np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32),
        )
    return _TWIDDLE[key]


def _balanced_factors(n: int) -> tuple[int, int]:
    """n = n1 * n2 with both <= 1024 and as balanced as possible."""
    f = 2
    m = n
    factors = []
    while m > 1:
        while m % f == 0:
            factors.append(f)
            m //= f
        f += 1
    n1 = 1
    for f in sorted(factors, reverse=True):
        if n1 * f <= int(np.sqrt(n)) * 2 and (n // (n1 * f)) >= 1:
            if n1 * f <= 1024:
                n1 *= f
        if n1 >= int(np.sqrt(n)):
            break
    n2 = n // n1
    if n1 > 1024 or n2 > 1024:
        raise ValueError(f"cannot factor FFT size {n} into <=1024 factors")
    return n1, n2


def _cmatmul(ar, ai, br, bi, prec=None, mode: str | None = None):
    """(ar + i ai) @ (br + i bi) with configurable-precision real matmuls.

    ``mode="karatsuba"`` switches to the 3-matmul formulation
    (re = t1 - t2, im = (ar+ai)@(br+bi) - t1 - t2) — 25% fewer matmul flops
    at ~1.5x the rounding of the classic 4-matmul form.  ``mode=None``
    falls back to the BBCAT_DSP_CMATMUL env toggle (trace-time read;
    engines pass the mode from their frozen SpectralSpec instead)."""
    import os

    p = prec or _PREC
    if mode is None:
        mode = os.environ.get("BBCAT_DSP_CMATMUL", "classic")
    if mode == "karatsuba":
        t1 = jnp.matmul(ar, br, precision=p)
        t2 = jnp.matmul(ai, bi, precision=p)
        t3 = jnp.matmul(ar + ai, br + bi, precision=p)
        return t1 - t2, t3 - t1 - t2
    rr = jnp.matmul(ar, br, precision=p) - jnp.matmul(ai, bi, precision=p)
    ri = jnp.matmul(ar, bi, precision=p) + jnp.matmul(ai, br, precision=p)
    return rr, ri


def _fft_c(xr: jax.Array, xi: jax.Array, n: int, prec=None):
    """Full complex DFT of the last axis (length n), plane in/out.

    Direct matmul for n <= _MAX_DIRECT; otherwise the four-step algorithm
    x[N1*n2 + n1] -> A[n1, n2] --DFT_N2--> twiddle --DFT_N1--> X[N2*k1+k2].
    """
    if n <= _MAX_DIRECT:
        cr, ci = _cmats(n)
        return _cmatmul(xr, xi, jnp.asarray(cr), jnp.asarray(ci), prec)
    n1, n2 = _balanced_factors(n)
    lead = xr.shape[:-1]
    # A[n1, n2] = x[n1 + n1total*n2]  (n = n1*n2; index n1 fast)
    ar = xr.reshape(lead + (n2, n1)).swapaxes(-1, -2)
    ai = xi.reshape(lead + (n2, n1)).swapaxes(-1, -2)
    c2r, c2i = _cmats(n2)
    yr, yi = _cmatmul(ar, ai, jnp.asarray(c2r), jnp.asarray(c2i), prec)  # [.., n1, k2]
    twr, twi = _twiddle(n1, n2)
    twr = jnp.asarray(twr)
    twi = jnp.asarray(twi)
    tr = yr * twr - yi * twi
    ti = yr * twi + yi * twr
    c1r, c1i = _cmats(n1)
    # DFT over the n1 axis: move it last, matmul, move back
    tr = tr.swapaxes(-1, -2)  # [.., k2, n1]
    ti = ti.swapaxes(-1, -2)
    zr, zi = _cmatmul(tr, ti, jnp.asarray(c1r), jnp.asarray(c1i), prec)  # [.., k2, k1]
    # X[N2*k1 + k2] -> flatten with k1 slow: transpose to [k1, k2]
    zr = zr.swapaxes(-1, -2).reshape(lead + (n,))
    zi = zi.swapaxes(-1, -2).reshape(lead + (n,))
    return zr, zi


def _rfft_halfwin_large(x: jax.Array, n: int, prec=None,
                        cmatmul: str | None = None) -> jax.Array:
    """Four-step rFFT of ``[x, zeros]`` (``len(x) == n//2``) exploiting all
    three rectangles: real input (no imaginary stage-1 matmuls), zero
    second half (stage-1 contraction over n2/2 rows), and half-spectrum
    output (stage-3 restricted to k1 <= n1/2).  ~2.7x fewer matmul FLOPs
    than the generic complex four-step this replaces.

    Index map (matches :func:`_fft_c`): input j = n2_idx*n1 + n1_idx (n1
    fast) so the zero half is exactly columns n2_idx >= n2/2; output
    k = n2*k1 + k2 (k1 slow) so k <= n/2 is exactly k1 <= n1/2.
    """
    n1, n2 = _balanced_factors(n)
    if n1 % 2 or n2 % 2:
        xr = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])
        zr, zi = _fft_c(xr, jnp.zeros_like(xr), n, prec)
        F = n // 2 + 1
        return jnp.stack([zr[..., :F], zi[..., :F]], axis=0)
    p = prec or _PREC
    lead = x.shape[:-1]
    F = n // 2 + 1
    h2 = n2 // 2
    # A[n1, n2] with only the first n2/2 columns nonzero
    ar = x.reshape(lead + (h2, n1)).swapaxes(-1, -2)       # [.., n1, h2]
    c2r, c2i = _cmats(n2)
    yr = jnp.matmul(ar, jnp.asarray(c2r[:h2]), precision=p)
    yi = jnp.matmul(ar, jnp.asarray(c2i[:h2]), precision=p)
    twr, twi = _twiddle(n1, n2)
    twr = jnp.asarray(twr)
    twi = jnp.asarray(twi)
    tr = yr * twr - yi * twi
    ti = yr * twi + yi * twr
    c1r, c1i = _cmats(n1)
    k1 = n1 // 2 + 1
    c1r = jnp.asarray(c1r[:, :k1])
    c1i = jnp.asarray(c1i[:, :k1])
    tr = tr.swapaxes(-1, -2)  # [.., n2(k2), n1]
    ti = ti.swapaxes(-1, -2)
    zr, zi = _cmatmul(tr, ti, c1r, c1i, prec, mode=cmatmul)  # [.., k2, k1]
    zr = zr.swapaxes(-1, -2).reshape(lead + (k1 * n2,))[..., :F]
    zi = zi.swapaxes(-1, -2).reshape(lead + (k1 * n2,))[..., :F]
    return jnp.stack([zr, zi], axis=0)


# ---------------------------------------------------------------------------
# Permuted-layout half-window engine (the transpose-free large-n path)
#
# The partitioned-convolution engines only ever use spectra ELEMENTWISE
# (window assembly, the partition MAC), so the bin ORDER of the half-window
# spectral representation is free as long as every party — forward
# transform, (-1)^k window signs, IR spectra, queue state, inverse — agrees.
# For n > _MAX_DIRECT the standard four-step pays two materialised
# transposes per transform.  The permuted layout removes ALL transposes by
# splitting n = r * n1 with a small OUTER radix r:
#
#   forward  (input x[j], j = n2*n1 + n1i, n1 FAST = natural memory view):
#     stage 1:  Y[k2, n1i] = sum_{n2 < r/2} x[n2, n1i] W_r^{n2 k2}
#                     (half-window: rows n2 >= r/2 are zero; x real)
#     stage 2:  T = Y * W_n^{n1i k2}           (elementwise twiddle)
#     stage 3:  Z[k2, k1] = sum_{n1i} T[k2, n1i] W_n1^{n1i k1}
#                     — ONE batched matmul, contraction over the LAST axis
#   storage ("order 2"): bin k = r*k1 + k2 lives at
#       q = k2*(n1/2) + k1          for k1 <  n1/2   (r aligned sections)
#       q = r*(n1/2)  + k2          for k1 == n1/2   (the Nyquist TAIL)
#     so every section is exactly n1/2 bins.  (The legacy "order 1",
#     q = k2*(n1/2+1) + k1, survives only in checkpoint migration.)
#     Tail bins with k > n/2 (k2 >= 1) hold the conjugate-mirror values
#     the DFT naturally produces there; the inverse masks them.
#   window signs: (-1)^k = (-1)^{k2} — constant per k2 section, then
#     alternating per element over the r-bin Nyquist tail.
#
#   inverse tail (y[t], t = t2*n1 + t1, outputs t2 >= r/2 only):
#     stage A:  G[k2, t1] = sum_{k1} (w X)[k2, k1] e^{+2pi i k1 t1/n1}
#                     (w = hermitian-half weights, 0 on the k > n/2 bins)
#     stage B:  B = G * e^{+2pi i k2 t1 / n}
#     stage C:  y[t2, t1] = Re sum_{k2} B[k2, t1] e^{+2pi i k2 t2/r} / n
#
# Everything is elementwise/broadcast + one big matmul per direction;
# reshapes only split/merge adjacent axes (free).  Numerics match the
# standard path (same _PREC matmuls) up to summation-order rounding.
# ---------------------------------------------------------------------------

_PERM_RADIX = 8


def _perm_radix(n: int, force: bool = False) -> int | None:
    """Outer radix of the permuted half-window layout for size ``n``, or
    ``None`` when the standard layout applies (small n, or n1 too big for
    a direct stage-3 matrix).

    BBCAT_DSP_PERM_RADIX selects the radix; the default ("auto") picks
    the largest radix <= 32 that keeps the inner transform in the
    256..1024 window (the dense [n1, n1/2+1] stage matmul dominates, so a
    smaller n1 does less work until the unrolled butterfly stage takes
    over).  An explicit env radix bypasses the window.  Falls back to 8,
    then std, when the candidates do not divide ``n`` suitably.

    ``force`` serves EXPLICIT perm requests (resolve_spectral_spec
    layout="perm") at sizes the auto resolution leaves on the direct
    path (n <= _MAX_DIRECT) — e.g. the round-5 head-radix experiment: a
    radix-r head trades the direct half-window matmul's ~n^2/2 MACs for
    ~2 n^2/r (complex), a real FLOP cut for r > 4."""
    if n <= _MAX_DIRECT and not force:
        return None
    import os

    spec = os.environ.get("BBCAT_DSP_PERM_RADIX", "auto")
    cands: list[int] = []
    if spec != "auto":
        try:
            cands.append(int(spec))
        except ValueError:
            pass
    cands += [r for r in (32, 16, 8) if 256 <= n // r <= 1024]
    cands.append(_PERM_RADIX)
    for r in cands:
        if (r >= 4 and r & (r - 1) == 0  # radix stage is radix-2 DIT
                and n % (2 * r) == 0 and n // r <= _MAX_DIRECT
                and (n // r) % 2 == 0):
            return r
    return None


# (backend, n, radix) triples whose permuted-layout program failed to
# build on this process's backend — half_engine_layout returns "std" for
# them so every engine component agrees on the fallback.  Populated by
# ensure_layout_usable(); never cleared (a broken build stays broken for
# the life of the process).
_LAYOUT_BLOCKED: set = set()
_LAYOUT_OK: set = set()


def half_engine_layout(n: int, backend: str | None = None) -> str:
    """Spectral layout of the half-window engine pair
    (:func:`rfft_half_planes` / :func:`irfft_tail_planes`) at size ``n``:
    ``"std"`` (natural bin order) or ``"perm"`` (r-radix permuted order).
    Purely a function of (n, resolved backend, BBCAT_DSP_PERM_LAYOUT,
    layout-health registry) so every engine component — forward, signs,
    IR partitioning, inverse — resolves identically.
    BBCAT_DSP_PERM_LAYOUT=0 forces std (A/B toggle); default engages perm
    wherever it applies and the build has not been black-listed by
    :func:`ensure_layout_usable`."""
    import os

    if os.environ.get("BBCAT_DSP_PERM_LAYOUT", "auto") == "0":
        return "std"
    b = backend or default_backend()
    r = _perm_radix(n)
    if not (b == "dftmm" and r):
        return "std"
    if (b, n, r) in _LAYOUT_BLOCKED:
        return "std"
    return "perm"


def ensure_layout_usable(n: int, backend: str | None = None) -> str:
    """Verify the permuted-layout transform pair actually BUILDS for size
    ``n`` on the current jax backend, falling back to the standard layout
    (with a warning) if it does not.  Returns the layout that will be used.

    The permuted layout's program is larger than the std path's and is
    built only for the dftmm backend.  Engine constructors call this BEFORE
    sizing spectral queues so a user on a backend that rejects the perm
    program still gets a working convolver instead of a compile error at
    first render.  The probe compiles the forward+inverse pair once per
    (backend, n, radix) per process (cached, and cheap vs the engine's own
    first compile, which shares the jax compilation cache).

    Set ``BBCAT_DSP_LAYOUT_PROBE=0`` to skip probing (e.g. when the
    backend is known-good and constructor latency matters)."""
    import os
    import warnings

    b = backend or default_backend()
    layout = half_engine_layout(n, b)
    if layout != "perm":
        return layout
    return _probe_perm_build(n, b)


def _probe_perm_build(n: int, backend: str) -> str:
    """Build-probe the permuted transform pair for (backend, n); returns
    the layout that will actually be used ("perm", or "std" with a warning
    + process-wide blacklist when the build fails).  Does NOT consult
    ``BBCAT_DSP_PERM_LAYOUT`` — callers have already resolved the layout
    request (possibly via an explicit ``layout="perm"`` override that the
    env must not silently undo)."""
    import os
    import warnings

    b = backend
    if os.environ.get("BBCAT_DSP_LAYOUT_PROBE", "1") == "0":
        return "perm"
    r = _perm_radix(n)
    key = (b, n, r)
    if key in _LAYOUT_BLOCKED:
        return "std"
    if key in _LAYOUT_OK:
        return "perm"
    try:
        fwd = jax.jit(lambda x: _perm_rfft_half(x, n))
        fwd.lower(
            jax.ShapeDtypeStruct((8, n // 2), jnp.float32)
        ).compile()
        # the PERM bin count, computed directly — spectral_nbins would
        # re-read BBCAT_DSP_PERM_LAYOUT and hand the inverse probe the std
        # count under env=0, failing the build for the wrong reason
        F = r * (n // r // 2 + 1)
        inv = jax.jit(lambda s: _perm_irfft_tail(s, n))
        inv.lower(
            jax.ShapeDtypeStruct((2, 8, F), jnp.float32)
        ).compile()
    except Exception as e:  # noqa: BLE001 — any build failure blocks perm
        _LAYOUT_BLOCKED.add(key)
        warnings.warn(
            f"permuted spectral layout (n={n}, radix={r}) failed to build "
            f"on backend '{jax.default_backend()}' "
            f"({type(e).__name__}: {e}); falling back to the standard "
            "layout for this size",
            RuntimeWarning,
            stacklevel=2,
        )
        return "std"
    _LAYOUT_OK.add(key)
    return "perm"


class SpectralSpec(NamedTuple):
    """FROZEN spectral configuration of a half-window engine at size ``n``.

    Engines resolve one of these at CONSTRUCTION (``resolve_spectral_spec``
    reads the env toggles exactly once) and pass it as a static argument
    into every transform call, so changing ``BBCAT_DSP_PERM_LAYOUT`` /
    ``BBCAT_DSP_PERM_RADIX`` / ``BBCAT_DSP_CMATMUL`` after an engine is
    built provably cannot change that engine's traced program — the trace
    is a pure function of the spec.  The module-level
    functions keep their env-resolved defaults (``spec=None``) for direct
    functional use.

    Hashable (a NamedTuple of primitives), so it can be a jit static
    argument.
    """

    n: int                 # FFT size (2 * engine block)
    backend: str           # "dftmm" | "xla" | registered name
    layout: str            # "std" | "perm"
    radix: int | None      # perm outer radix (None when layout == "std")
    cmatmul: str           # "classic" | "karatsuba" (dftmm stage dots)


def resolve_spectral_spec(
    n: int, backend: str | None = None, probe: bool = True,
    layout: str | None = None,
) -> SpectralSpec:
    """Resolve the env toggles ONCE into a frozen :class:`SpectralSpec`.

    ``probe`` (default) verifies a resolved permuted layout actually builds
    on the current jax backend (see :func:`ensure_layout_usable`), falling
    back to std with a warning when it does not.  ``layout`` overrides the
    env/auto resolution ("std" forces the standard layout; "perm" requests
    the permuted layout where a radix applies — still probed)."""
    import os

    b = backend or default_backend()
    if layout is None:
        lay = (ensure_layout_usable(n, b) if probe
               else half_engine_layout(n, b))
    elif layout == "perm":
        lay = ("perm" if (b == "dftmm" and _perm_radix(n, force=True))
               else "std")
        if lay == "perm" and probe:
            # probe ONLY verifies the program builds — it must not route
            # through half_engine_layout, whose BBCAT_DSP_PERM_LAYOUT=0
            # read would silently undo this explicit override
            lay = _probe_perm_build(n, b)
    else:
        lay = "std"
    r = (_perm_radix(n, force=(layout == "perm"))
         if lay == "perm" else None)
    return SpectralSpec(
        n=int(n),
        backend=b,
        layout=lay,
        radix=r,
        cmatmul=os.environ.get("BBCAT_DSP_CMATMUL", "classic"),
    )


def _check_spec(spec: SpectralSpec | None, n: int) -> SpectralSpec | None:
    if spec is not None and spec.n != n:
        raise ValueError(
            f"SpectralSpec is for n={spec.n}, called with n={n}")
    return spec


def spectral_nbins(n: int, backend: str | None = None,
                   spec: SpectralSpec | None = None) -> int:
    """Number of spectral bins the half-window engine stores for FFT size
    ``n`` (``n//2 + 1`` std; ``r * (n1//2 + 1)`` permuted — includes the
    r-1 masked conjugate-mirror bins)."""
    _check_spec(spec, n)
    layout = spec.layout if spec else half_engine_layout(n, backend)
    if layout == "std":
        return n // 2 + 1
    r = spec.radix if spec else _perm_radix(n)
    return r * (n // r // 2 + 1)


def _radix_fft(xs: list, sign: float):
    """Power-of-two DFT over a fully UNROLLED axis via radix-2 DIT
    butterflies on vector operands.

    ``xs`` is a list of ``(re, im)`` pairs of equally-shaped jnp arrays;
    either component may be ``None`` (exact zero) — zeros and the
    0/±1/±i twiddles prune to nothing, so a half-support real input
    costs ~(r/2)·log2(r) genuine butterflies instead of the naive
    r·(r/2) MACs.  ``sign=-1`` is the forward DFT, ``+1`` the inverse
    kernel (no 1/r normalisation).  Returns r ``(re, im)`` pairs in
    natural frequency order (it is just unrolled arithmetic).
    """
    r = len(xs)
    if r == 1:
        return [xs[0]]

    def cadd(a, b):
        (ar, ai), (br, bi) = a, b
        re = br if ar is None else (ar if br is None else ar + br)
        im = bi if ai is None else (ai if bi is None else ai + bi)
        return (re, im)

    def cneg(a):
        ar, ai = a
        return (None if ar is None else -ar, None if ai is None else -ai)

    def cmulc(a, wr: float, wi: float):
        """a * (wr + i wi) with exact-constant pruning."""
        ar, ai = a
        if wi == 0.0:
            if wr == 1.0:
                return a
            if wr == -1.0:
                return cneg(a)
            return (None if ar is None else ar * wr,
                    None if ai is None else ai * wr)
        if wr == 0.0:
            # i*wi: (ar + i ai)(i wi) = -ai*wi + i ar*wi
            if wi == 1.0:
                return (None if ai is None else -ai, ar)
            if wi == -1.0:
                return (ai, None if ar is None else -ar)
            return (None if ai is None else ai * -wi,
                    None if ar is None else ar * wi)
        re = None
        if ar is not None:
            re = ar * wr
        if ai is not None:
            re = -ai * wi if re is None else re - ai * wi
        im = None
        if ar is not None:
            im = ar * wi
        if ai is not None:
            im = ai * wr if im is None else im + ai * wr
        return (re, im)

    ev = _radix_fft(xs[0::2], sign)
    od = _radix_fft(xs[1::2], sign)
    out = [None] * r
    for k in range(r // 2):
        ang = sign * 2.0 * np.pi * k / r
        wr, wi = float(np.cos(ang)), float(np.sin(ang))
        if abs(wr) < 1e-12:
            wr = 0.0
        if abs(wi) < 1e-12:
            wi = 0.0
        for v in (1.0, -1.0):
            if abs(wr - v) < 1e-12:
                wr = v
            if abs(wi - v) < 1e-12:
                wi = v
        t = cmulc(od[k], wr, wi)
        out[k] = cadd(ev[k], t)
        out[k + r // 2] = cadd(ev[k], cneg(t))
    return out


_PERMC: dict[tuple, tuple] = {}


def _perm_consts(n: int, r: int | None = None):
    """Numpy constant planes for the permuted engine at size ``n``
    (keyed by (n, radix) — the radix is env-selectable; pass ``r``
    explicitly when the caller's radix is fixed by its data shape, so a
    different env default cannot mismatch the tables)."""
    if r is None:
        r = _perm_radix(n)
    key = (n, r)
    if key not in _PERMC:
        n1 = n // r
        n1h1 = n1 // 2 + 1
        k2 = np.arange(r)
        # stage 2 twiddle: W_n^{k2 n1i}  (the radix stage and inverse
        # recombination are butterflied with compile-time constants in
        # _radix_fft, so no stage-1/stage-C tables are needed)
        a2 = 2.0 * np.pi * np.outer(k2, np.arange(n1)) / n
        twr, twi = np.cos(a2), -np.sin(a2)                  # [r, n1]
        # inverse stage B twiddle: conj
        # inverse stage A weights (hermitian half + mirror mask), per plane
        k = r * np.arange(n1h1)[None, :] + k2[:, None]      # [r, n1h1]
        wr = np.full((r, n1h1), 2.0)
        wr[0, 0] = 1.0
        wr[k == n // 2] = 1.0
        wr[k > n // 2] = 0.0
        wi = wr.copy()
        wi[0, 0] = 0.0          # numpy.irfft drops DC/Nyquist imag parts
        wi[0, n1h1 - 1] = 0.0
        _PERMC[key] = tuple(
            a.astype(np.float32) for a in (twr, twi, wr, wi)
        )
    return _PERMC[key]


def _perm_rfft_half(x: jax.Array, n: int, prec=None,
                    spec: SpectralSpec | None = None) -> jax.Array:
    """Permuted-layout rFFT of ``[x, zeros]`` (``len(x) == n//2``)."""
    r = spec.radix if spec else _perm_radix(n)
    n1 = n // r
    n1h1 = n1 // 2 + 1
    m = n // 2
    T = x.shape[-1]
    if T < m:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, m - T)])
    elif T > m:
        x = x[..., :m]
    lead = x.shape[:-1]
    xm = x.reshape(lead + (r // 2, n1))
    twr, twi = _perm_consts(n, r)[:2]
    # radix stage: DFT_r of the half-support real rows, butterflied
    # (~(r/2)·log2(r) genuine vector butterflies instead of r·(r/2) MACs)
    xs = [(xm[..., j, :], None) for j in range(r // 2)]
    xs += [(None, None)] * (r // 2)
    Y = _radix_fft(xs, -1.0)
    zero = jnp.zeros(lead + (n1,), x.dtype)
    yr = jnp.stack([re if re is not None else zero for re, _ in Y], axis=-2)
    yi = jnp.stack([im if im is not None else zero for _, im in Y], axis=-2)
    twr = jnp.asarray(twr)
    twi = jnp.asarray(twi)
    tr = yr * twr - yi * twi                                # [.., r, n1]
    ti = yr * twi + yi * twr
    h = n1 // 2
    cr, ci = _cmats(n1)
    # tile-aligned order: r sections of exactly n1/2 bins from the dot
    # (Nyquist column dropped), then the r-bin Nyquist tail via the exact
    # (-1)^j weights
    zr, zi = _cmatmul(tr, ti, jnp.asarray(cr[:, :h]),
                      jnp.asarray(ci[:, :h]), prec,
                      mode=spec.cmatmul if spec else None)  # [.., r, h]
    sgn = jnp.asarray((1.0 - 2.0 * (np.arange(n1) % 2)).astype(np.float32))
    nyr = jnp.sum(tr * sgn, axis=-1)                        # [.., r]
    nyi = jnp.sum(ti * sgn, axis=-1)
    return jnp.stack([
        jnp.concatenate([zr.reshape(lead + (r * h,)), nyr], axis=-1),
        jnp.concatenate([zi.reshape(lead + (r * h,)), nyi], axis=-1),
    ], axis=0)


def _perm_irfft_tail(sp: jax.Array, n: int, prec=None,
                     spec: SpectralSpec | None = None) -> jax.Array:
    """Inverse of :func:`_perm_rfft_half`'s layout, last ``n//2`` samples."""
    r = spec.radix if spec else _perm_radix(n)
    n1 = n // r
    n1h1 = n1 // 2 + 1
    lead = sp.shape[1:-1]
    twr, twi, wr, wi = _perm_consts(n, r)
    h = n1 // 2
    # tile-aligned order: r sections of n1/2 bins + the r-bin Nyquist tail
    # -> rebuild the per-section [.., r, n1h1] view for the stage-A matmul
    main = sp[..., : r * h].reshape((2,) + lead + (r, h))
    tail = sp[..., r * h:]
    Xr = jnp.concatenate([main[0], tail[0][..., :, None]], axis=-1)
    Xi = jnp.concatenate([main[1], tail[1][..., :, None]], axis=-1)
    Xr = Xr * jnp.asarray(wr)
    Xi = Xi * jnp.asarray(wi)
    # stage A: conj-DFT matmul over k1 (E1 = cos + i sin of the n1 matrix)
    cr, ci = _cmats(n1)
    e1r = jnp.asarray(cr[:n1h1])          # [n1h1, n1]
    e1i = jnp.asarray(-ci[:n1h1])         # +sin
    gr, gi = _cmatmul(Xr, Xi, e1r, e1i, prec,
                      mode=spec.cmatmul if spec else None)  # [.., r, n1]
    # stage B: conj twiddle
    twr = jnp.asarray(twr)
    twi = jnp.asarray(twi)
    br = gr * twr + gi * twi
    bi = gi * twr - gr * twi
    # stage C: radix-r recombination (inverse-sign butterflies), tail
    # outputs t2 >= r/2 only, real parts only
    zs = [(br[..., k2, :], bi[..., k2, :]) for k2 in range(r)]
    Yt = _radix_fft(zs, 1.0)
    zero = jnp.zeros(lead + (n1,), sp.dtype)
    outs = [Yt[r // 2 + t2][0] if Yt[r // 2 + t2][0] is not None else zero
            for t2 in range(r // 2)]
    y = jnp.stack(outs, axis=-2)                            # [.., r/2, n1]
    return y.reshape(lead + (n // 2,)) / n


def _perm_bin_of_position(n: int, r: int, order: int = 2) -> np.ndarray:
    """Natural bin index ``k`` stored at each flat permuted position."""
    n1 = n // r
    h = n1 // 2
    F = r * (h + 1)
    q = np.arange(F)
    if order == 2:
        tail = q >= r * h
        k2 = np.where(tail, q - r * h, q // h)
        k1 = np.where(tail, h, q % h)
    elif order == 1:  # legacy round-3 order: q = k2*(h+1) + k1
        k2 = q // (h + 1)
        k1 = q % (h + 1)
    else:
        raise ValueError(f"unknown perm order {order}")
    return r * k1 + k2


def permute_half_spectrum(spec: np.ndarray, n: int,
                          radix: int | None = None,
                          order: int = 2) -> np.ndarray:
    """Host-side: standard complex half spectrum ``[.., n//2+1]`` ->
    permuted-layout complex array ``[.., spectral_nbins]`` (conjugate-mirror
    values on the k > n/2 bins, matching what the forward DFT produces
    there).  ``radix`` overrides the env-resolved layout radix; ``order=1``
    emits the legacy round-3 bin order (checkpoint conversion only)."""
    r = radix if radix is not None else _perm_radix(n)
    k = _perm_bin_of_position(n, r, order)
    base = np.minimum(k, n - k)
    vals = spec[..., base]
    return np.where(k <= n // 2, vals, np.conj(vals))


def unpermute_half_spectrum(
    spec: np.ndarray, n: int, radix: int | None = None, order: int = 2
) -> np.ndarray:
    """Host-side inverse of :func:`permute_half_spectrum`: permuted-layout
    complex array ``[.., r*(n1//2+1)]`` -> standard half spectrum
    ``[.., n//2+1]`` (natural bin order).  The r-1 conjugate-mirror bins
    the permuted layout carries are redundant and simply dropped.

    ``radix`` overrides the layout radix (needed when converting a
    checkpoint written under a different ``BBCAT_DSP_PERM_RADIX``);
    ``order=1`` reads the legacy round-3 bin order."""
    r = radix if radix is not None else _perm_radix(n)
    if r is None:
        raise ValueError(f"no permuted layout applies at n={n}")
    n1 = n // r
    h = n1 // 2
    if spec.shape[-1] != r * (h + 1):
        raise ValueError(
            f"expected {r * (h + 1)} permuted bins (n={n}, radix={r}), "
            f"got {spec.shape[-1]}"
        )
    k = np.arange(n // 2 + 1)
    k1 = k // r
    k2 = k % r
    if order == 2:
        pos = np.where(k1 < h, k2 * h + k1, r * h + k2)
    elif order == 1:
        pos = k2 * (h + 1) + k1
    else:
        raise ValueError(f"unknown perm order {order}")
    return spec[..., pos]


def convert_perm_order(spec: np.ndarray, n: int, radix: int,
                       from_order: int, to_order: int) -> np.ndarray:
    """Host-side reorder of a permuted-layout complex array between bin
    orders (legacy 1 <-> tile-aligned 2) at fixed (n, radix)."""
    if from_order == to_order:
        return spec
    std = unpermute_half_spectrum(spec, n, radix=radix, order=from_order)
    return permute_half_spectrum(std, n, radix=radix, order=to_order)


_PACKW: dict[int, tuple] = {}


def _packw(n: int):
    """Even/odd packing weights w[k] = exp(2pi i k / n), k < n/2."""
    if n not in _PACKW:
        ang = 2.0 * np.pi * np.arange(n // 2) / n
        _PACKW[n] = (np.cos(ang).astype(np.float32),
                     np.sin(ang).astype(np.float32))
    return _PACKW[n]


def _irfft_tail_large(spec: jax.Array, n: int, prec=None,
                      cmatmul: str | None = None) -> jax.Array:
    """Inverse rFFT returning ONLY the last ``n//2`` samples, via even/odd
    complex packing: the length-n hermitian inverse becomes a length-m
    (m = n/2) COMPLEX inverse whose outputs interleave as
    ``x[2t'] = Re z[t']``, ``x[2t'+1] = Im z[t']``:

        Z[k] = (G[k] + G[k+m])/2 + i e^{2pi i k/n} (G[k] - G[k+m])/2
        G[k+m] = conj(spec[m-k])  ->  B = flip(conj(spec[1:]))

    — no materialised hermitian mirror (the reverse+concat to [.., n] it
    replaces moved ~2 GB at the pod config) and HALF-length transform
    stages.  Tail outputs ``t >= m`` are exactly ``t' >= m/2``, so stage 3
    keeps only those columns (the packed analogue of the k1 >= n1/2
    trick).  Output assembly is one interleave of the two planes.
    """
    p = prec or _PREC
    m = n // 2
    h = m // 2
    if m % 2:
        return _dftmm_irfft(spec, n, prec)[..., m:]
    lead = spec.shape[1:-1]
    re, im = spec[0], spec[1]
    # DC and Nyquist imaginary parts do not contribute to a real inverse
    # (numpy.irfft semantics); both land at lane 0 of the packed planes
    dcmask = jnp.asarray(
        np.concatenate([[0.0], np.ones(m - 1)]).astype(np.float32))
    ar, ai = re[..., :m], im[..., :m] * dcmask
    br = re[..., 1:][..., ::-1]
    bi = -im[..., 1:][..., ::-1] * dcmask
    wr, wi = _packw(n)
    wr = jnp.asarray(wr)
    wi = jnp.asarray(wi)
    dr, di = ar - br, ai - bi
    zr = (ar + br) - wi * dr - wr * di
    zi = (ai + bi) + wr * dr - wi * di
    if m <= _MAX_DIRECT:
        cr, ci = _cmats(m)
        tr, ti = _cmatmul(zr, zi, jnp.asarray(cr[:, h:]),
                          jnp.asarray(-ci[:, h:]), prec, mode=cmatmul)
    else:
        m1, m2 = _balanced_factors(m)
        if m1 % 2:
            return _dftmm_irfft(spec, n, prec)[..., m:]
        # inverse four-step: conjugated stage matrices and twiddles
        qr = zr.reshape(lead + (m2, m1)).swapaxes(-1, -2)  # [.., m1(k1), m2]
        qi = zi.reshape(lead + (m2, m1)).swapaxes(-1, -2)
        c2r, c2i = _cmats(m2)
        yr, yi = _cmatmul(qr, qi, jnp.asarray(c2r), jnp.asarray(-c2i), prec,
                          mode=cmatmul)
        twr, twi = _twiddle(m1, m2)
        twr = jnp.asarray(twr)
        twi = jnp.asarray(twi)
        tr = yr * twr + yi * twi
        ti = yi * twr - yr * twi
        c1r, c1i = _cmats(m1)
        h1 = m1 // 2
        c1r = jnp.asarray(c1r[:, h1:])
        c1i = jnp.asarray(-c1i[:, h1:])
        tr = tr.swapaxes(-1, -2)  # [.., m2(t2), m1(k1)]
        ti = ti.swapaxes(-1, -2)
        tr, ti = _cmatmul(tr, ti, c1r, c1i, prec,
                          mode=cmatmul)                    # [.., t2, t1h]
        tr = tr.swapaxes(-1, -2)  # [.., t1h, t2]
        ti = ti.swapaxes(-1, -2)
    # interleave even/odd: x[2t'] = Re z[t'], x[2t'+1] = Im z[t']
    out = jnp.stack([tr, ti], axis=-1).reshape(lead + (m,))
    return out / n


def _dftmm_rfft(x: jax.Array, n: int, prec=None) -> jax.Array:
    T = x.shape[-1]
    if T < n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - T)])
    elif T > n:
        x = x[..., :n]
    if n <= _MAX_DIRECT:
        cos, msin, _, _ = _mats(n)
        p = prec or _PREC
        re = jnp.matmul(x, jnp.asarray(cos), precision=p)
        im = jnp.matmul(x, jnp.asarray(msin), precision=p)
        return jnp.stack([re, im], axis=0)
    zr, zi = _fft_c(x, jnp.zeros_like(x), n, prec)
    F = n // 2 + 1
    return jnp.stack([zr[..., :F], zi[..., :F]], axis=0)


def _dftmm_irfft(spec: jax.Array, n: int, prec=None) -> jax.Array:
    if n <= _MAX_DIRECT:
        _, _, icos, isin = _mats(n)
        p = prec or _PREC
        return (
            jnp.matmul(spec[0], jnp.asarray(icos), precision=p)
            + jnp.matmul(spec[1], jnp.asarray(isin), precision=p)
        )
    # hermitian-extend the half spectrum, inverse via conj(fft(conj(.)))/n
    re, im = spec[0], spec[1]
    body_r = re[..., 1:-1][..., ::-1]
    body_i = im[..., 1:-1][..., ::-1]
    fr = jnp.concatenate([re, body_r], axis=-1)
    fi = jnp.concatenate([im, -body_i], axis=-1)
    zr, zi = _fft_c(fr, -fi, n, prec)
    del zi  # output of a hermitian inverse is real
    return zr / n


def _xla_rfft(x: jax.Array, n: int) -> jax.Array:
    X = jnp.fft.rfft(x, n=n, axis=-1)
    return jnp.stack([X.real, X.imag], axis=0)


def _xla_irfft(spec: jax.Array, n: int) -> jax.Array:
    return jnp.fft.irfft(jax.lax.complex(spec[0], spec[1]), n=n, axis=-1)


_BACKENDS: dict[str, tuple] = {
    "dftmm": (_dftmm_rfft, _dftmm_irfft),
    "xla": (_xla_rfft, _xla_irfft),
}


def default_backend() -> str:
    """The transform backend engines resolve when none is named: ``"xla"``
    (``jnp.fft``) on every platform."""
    return "xla"


def register_backend(name: str, rfft_fn, irfft_fn) -> None:
    _BACKENDS[name] = (rfft_fn, irfft_fn)


def backends() -> list[str]:
    return sorted(_BACKENDS)


def rfft_planes(x: jax.Array, n: int, backend: str | None = None,
                precision=None) -> jax.Array:
    """Real FFT of the last axis -> ``[2, ..., n//2+1]`` re/im planes."""
    b = backend or default_backend()
    if b == "dftmm":
        return _dftmm_rfft(x, n, precision)
    return _BACKENDS[b][0](x, n)


def rfft_half_planes(x: jax.Array, n: int, backend: str | None = None,
                     spec: SpectralSpec | None = None) -> jax.Array:
    """rFFT of ``[x, zeros]`` where ``len(x) == n//2`` — the overlap-save
    half-window transform.

    The full window spectrum then assembles as
    ``X_window = Xhalf_prev + (-1)^k * Xhalf_cur`` (shift theorem for the
    second half), so streaming engines transform only n/2 NEW samples per
    block instead of the whole 2B window — half the forward-DFT matmul.

    ``spec`` (a frozen :class:`SpectralSpec`) fixes backend/layout/radix;
    without it they resolve from env at trace time.
    """
    _check_spec(spec, n)
    b = spec.backend if spec else (backend or default_backend())
    # layout check BEFORE the direct-matmul shortcut: a frozen spec may
    # explicitly request perm below _MAX_DIRECT (head-radix experiment)
    if (b == "dftmm"
            and (spec.layout if spec
                 else half_engine_layout(n, b)) == "perm"):
        return _perm_rfft_half(x, n, spec=spec)
    if b == "dftmm" and n <= _MAX_DIRECT:
        cos, msin, _, _ = _mats(n)
        h = n // 2
        re = jnp.matmul(x, jnp.asarray(cos[:h]), precision=_PREC)
        im = jnp.matmul(x, jnp.asarray(msin[:h]), precision=_PREC)
        return jnp.stack([re, im], axis=0)
    if b == "dftmm":
        T = x.shape[-1]
        if T < n // 2:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n // 2 - T)])
        return _rfft_halfwin_large(x[..., :n // 2], n,
                                   cmatmul=spec.cmatmul if spec else None)
    return _BACKENDS[b][0](x, n)


def half_window_signs(n: int, backend: str | None = None,
                      spec: SpectralSpec | None = None) -> np.ndarray:
    """The (-1)^k spectrum signs for the second-half shift, in the
    half-window engine's layout for size ``n`` (std: alternating over
    ``n//2+1`` bins; permuted: constant per k2 section)."""
    _check_spec(spec, n)
    layout = spec.layout if spec else half_engine_layout(n, backend)
    if layout == "perm":
        r = spec.radix if spec else _perm_radix(n)
        h = n // r // 2
        k2_signs = (1.0 - 2.0 * (np.arange(r) % 2)).astype(np.float32)
        return np.concatenate([np.repeat(k2_signs, h), k2_signs])
    s = np.ones(n // 2 + 1, np.float32)
    s[1::2] = -1.0
    return s


def irfft_tail_planes(spec_planes: jax.Array, n: int,
                      backend: str | None = None,
                      spec: SpectralSpec | None = None) -> jax.Array:
    """Inverse rFFT returning ONLY the last ``n//2`` samples — all
    overlap-save ever keeps — at half the inverse-DFT matmul cost.

    Consumes the layout :func:`rfft_half_planes` produces for ``n``
    (permuted for large dftmm sizes — see ``half_engine_layout`` /
    the frozen ``spec``)."""
    _check_spec(spec, n)
    b = spec.backend if spec else (backend or default_backend())
    layout = (spec.layout if spec else
              (half_engine_layout(n, b) if b == "dftmm" else "std"))
    if (b == "dftmm" and layout == "perm"
            and spec_planes.shape[-1] == spectral_nbins(n, b, spec=spec)):
        return _perm_irfft_tail(spec_planes, n, spec=spec)
    if b == "dftmm" and n <= _MAX_DIRECT:
        _, _, icos, isin = _mats(n)
        h = n // 2
        return (
            jnp.matmul(spec_planes[0], jnp.asarray(icos[:, h:]),
                       precision=_PREC)
            + jnp.matmul(spec_planes[1], jnp.asarray(isin[:, h:]),
                         precision=_PREC)
        )
    if b == "dftmm":
        return _irfft_tail_large(spec_planes, n,
                                 cmatmul=spec.cmatmul if spec else None)
    return _BACKENDS[b][1](spec_planes, n)[..., n // 2:]


def irfft_planes(spec: jax.Array, n: int, backend: str | None = None,
                 precision=None) -> jax.Array:
    """``[2, ..., F]`` planes -> ``n`` real samples on the last axis."""
    b = backend or default_backend()
    if b == "dftmm":
        return _dftmm_irfft(spec, n, precision)
    return _BACKENDS[b][1](spec, n)


def cmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Elementwise complex multiply of two plane arrays (float32)."""
    return jnp.stack(
        [a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]], axis=0
    )


def planes_from_complex(z: np.ndarray, dtype=jnp.float32) -> jax.Array:
    """Host complex array -> device plane array ``[2, ...]``."""
    z = np.asarray(z)
    return jnp.asarray(np.stack([z.real, z.imag]), dtype)
