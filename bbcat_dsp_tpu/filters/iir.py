"""IIR engine: biquads and cascades as parallel scans.

The reference computes biquads with a per-sample sequential DF2T recurrence
(ref: src/BiQuad.h:200-206) — inherently serial in time, which would leave a
parallel device idle; this module reformulates the recurrence as an affine
state-space scan that parallelises over time (SURVEY.md §7 hard part #1):

DF2T:  y[n] = b0*x[n] + w0[n-1]
       w0[n] = b1*x[n] - a1*y[n] + w1[n-1]
       w1[n] = b2*x[n] - a2*y[n]

Substituting y[n] gives the linear state recurrence  s[n] = A s[n-1] + B x[n]
with  s = [w0, w1],  A = [[-a1, 1], [-a2, 0]],  B = [b1 - a1*b0, b2 - a2*b0],
and the output  y[n] = b0*x[n] + s[n-1][0].

Affine maps compose associatively — (A2, v2) ∘ (A1, v1) = (A2 A1, A2 v1 + v2)
— so the whole time axis runs through ``jax.lax.associative_scan`` in
O(log T) depth.  A sequential ``lax.scan`` engine is kept as the
correctness anchor and for tiny blocks.

Three engines, selected by precision/structure trade-off:

* ``"modal"`` (default for time-invariant coefficients): the numerically
  robust path.  The companion-form scan above loses precision for poles near
  the unit circle (float32 products of non-normal 2x2 matrices with
  transient growth cap SNR near 50 dB for RLB-style filters).  Instead the
  biquad is factored into its poles:  numerator FIR first
  (``v[n] = d1*x[n-1] + d2*x[n-2]`` keeps every internal signal bounded by
  the filter's own response), then two first-order complex-pole recurrences
  ``t[n] = p1*t[n-1] + v[n]``, ``w[n] = p2*w[n-1] + t[n]``,
  ``y[n] = b0*x[n] + Re(w[n])``.  Scalar complex pole products are perfectly
  conditioned (|p| <= 1, no non-normal growth), measured 96-145 dB SNR in
  float32 across all RBJ types including double-pole HPF12 at 80 Hz and the
  BS.1770 RLB filter.  Poles are computed from the coefficients on the host
  in float64 (design-time), avoiding the sqrt cancellation of float32 root
  finding.

* ``"assoc"``: the companion-form parallel scan — required for per-sample
  TIME-VARYING coefficients (the reference's click-free coefficient
  interpolation, ref: src/BiQuad.cpp:379-395, 473-494), where A and B vary
  per sample and pole factorisation would change the (realization-dependent)
  transient semantics.  Ramps are short transients, so the companion form's
  precision is sufficient there.

* ``"scan"``: the literal sequential DF2T tick via ``lax.scan`` — the
  correctness anchor.

All engines operate on ``[..., T]`` arrays (leading dims = channels / banks,
batched) with explicit state pytrees.  Composition arithmetic is
explicitly elementwise (never ``einsum``/``dot``) so nothing runs as a
default-precision matrix product, whose reduced-precision operand rounding
would cap SNR near 30 dB.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dwfloat import dw_add, dw_collapse, dw_from_f64, dw_mul

__all__ = [
    "biquad_ssm",
    "biquad_apply",
    "DWCoeffs",
    "cascade_apply",
    "interp_trajectory",
    "ModalParams",
    "ModalState",
    "ParallelCascadeParams",
    "ParallelCascadeState",
    "parallel_cascade_params",
    "parallel_cascade_apply",
    "modal_params",
    "modal_apply",
    "modal_init",
]


class ModalParams(NamedTuple):
    """Pole-factored biquad parameters (host-designed, see module doc)."""

    b0: jax.Array   # [...] direct gain
    d1: jax.Array   # [...] numerator FIR tap 1 (= b1 - a1*b0)
    d2: jax.Array   # [...] numerator FIR tap 2 (= b2 - a2*b0)
    p1r: jax.Array  # [...] pole 1 (real, imag)
    p1i: jax.Array
    p2r: jax.Array  # [...] pole 2 (real, imag)
    p2i: jax.Array


class ModalState(NamedTuple):
    """Streaming state of the modal realization: input history + the two
    complex one-pole states."""

    x1: jax.Array  # x[n-1]
    x2: jax.Array  # x[n-2]
    tr: jax.Array  # t (complex) after pole 1
    ti: jax.Array
    wr: jax.Array  # w (complex) after pole 2
    wi: jax.Array


def modal_params(coeffs, dtype=jnp.float32) -> ModalParams:
    """Factor ``[..., 5]`` host coefficients into poles + numerator FIR.

    Root-finding runs in float64 on the host (design time): float32 quadratic
    roots would suffer sqrt cancellation for near-repeated poles.  Pass the
    ORIGINAL float64 coefficients — casting to float32 first costs ~30 dB
    for near-real-axis pole pairs through discriminant cancellation.
    """
    c = np.asarray(coeffs, np.float64)
    b0, b1, b2, a1, a2 = np.moveaxis(c, -1, 0)
    d1 = b1 - a1 * b0
    d2 = b2 - a2 * b0
    disc = a1 * a1 - 4.0 * a2
    sq = np.sqrt(disc.astype(np.complex128))
    p1 = (-a1 + sq) / 2.0
    p2 = (-a1 - sq) / 2.0
    as_ = lambda v: jnp.asarray(v, dtype)  # noqa: E731
    return ModalParams(
        b0=as_(b0), d1=as_(d1), d2=as_(d2),
        p1r=as_(p1.real), p1i=as_(p1.imag),
        p2r=as_(p2.real), p2i=as_(p2.imag),
    )


def modal_init(params: ModalParams, batch_shape=(), dtype=jnp.float32) -> ModalState:
    shape = jnp.broadcast_shapes(batch_shape, params.b0.shape)
    z = jnp.zeros(shape, dtype)
    return ModalState(z, z, z, z, z, z)


def _cpx_affine_scan(ar, ai, vr, vi, s0r, s0i):
    """Inclusive scan of ``s[n] = a[n]*s[n-1] + v[n]`` (complex, elementwise)
    along the LAST axis.  Returns the full complex trajectory.

    Time sits on the minor (contiguous) axis so every compose op is a
    contiguous elementwise pass, with few channels as well as many.
    ``s0*`` are the incoming states shaped like the batch (no time axis).
    """

    def compose(f, g):
        far, fai, fvr, fvi = f
        gar, gai, gvr, gvi = g
        return (
            gar * far - gai * fai,
            gar * fai + gai * far,
            gar * fvr - gai * fvi + gvr,
            gar * fvi + gai * fvr + gvi,
        )

    car, cai, cvr, cvi = jax.lax.associative_scan(
        compose, (ar, ai, vr, vi), axis=-1
    )
    s0r = s0r[..., None]
    s0i = s0i[..., None]
    sr = car * s0r - cai * s0i + cvr
    si = car * s0i + cai * s0r + cvi
    return sr, si


# chunk length for the Toeplitz (matmul) constant-pole scan
_TOEP_CHUNK = 128


def _pole_powers(pr, pi, n: int):
    """``p^0 .. p^{n-1}`` along a new last axis via log-depth doubling
    (exact complex multiplies; n must be a power of two)."""
    powr = jnp.ones(pr.shape + (1,), pr.dtype)
    powi = jnp.zeros(pi.shape + (1,), pi.dtype)
    while powr.shape[-1] < n:
        # p^m = powers[-1] * p ; [p^m..p^{2m-1}] = p^m * powers
        lr = powr[..., -1] * pr - powi[..., -1] * pi
        li = powr[..., -1] * pi + powi[..., -1] * pr
        powr, powi = (
            jnp.concatenate([powr, lr[..., None] * powr
                             - li[..., None] * powi], -1),
            jnp.concatenate([powi, lr[..., None] * powi
                             + li[..., None] * powr], -1),
        )
    return powr, powi


def _cpx_affine_scan_const(pr, pi, vr, vi, s0r, s0i):
    """:func:`_cpx_affine_scan` for a CONSTANT complex pole ``p`` (no time
    axis on ``pr/pi``), computed as blocked Toeplitz MATMULS.

    ``s[i] = sum_{j<=i} p^{i-j} v[j] + p^{i+1} s0`` — within each 128-sample
    chunk that inner sum is ``v_chunk @ M`` with the upper-triangular
    ``M[j, i] = p^{i-j}``; chunks couple through a tiny n-element carry
    scan.  Replaces ``lax.associative_scan``'s O(log T) pad/slice ladder
    (~90 XLA ops per call) with 2-4
    batched matmuls.  Matmuls run at HIGHEST (1.3e-7 operand error, exact
    enough for the >=120 dB engine contracts); the reduction per output is
    one 128-term dot — fewer roundings than the sequential recurrence.

    ``pr/pi [K]``; ``vr/vi [K, B, T]`` (T a multiple of 128); ``vi=None``
    means the input is real.  ``s0r/s0i [K, B]``.
    """
    K, Bb, T = vr.shape
    L = _TOEP_CHUNK
    n = T // L
    powr, powi = _pole_powers(pr, pi, 2 * L)          # [K, 2L]
    ii = jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)  # output index i
    jj = jax.lax.broadcasted_iota(jnp.int32, (L, L), 0)  # input index j
    d = jnp.where(ii >= jj, ii - jj, 0)
    mask = (ii >= jj).astype(vr.dtype)
    Mr = powr[:, d] * mask                             # [K, L, L]
    Mi = powi[:, d] * mask

    hi = jax.lax.Precision.HIGHEST

    def bmm(a, m):  # [K, B*, L] @ [K, L, L] -> [K, B*, L]
        return jnp.einsum("kbnl,klm->kbnm", a, m, precision=hi)

    vcr = vr.reshape(K, Bb, n, L)
    if vi is None:
        yr = bmm(vcr, Mr)
        yi = bmm(vcr, Mi)
    else:
        vci = vi.reshape(K, Bb, n, L)
        yr = bmm(vcr, Mr) - bmm(vci, Mi)
        yi = bmm(vcr, Mi) + bmm(vci, Mr)

    # cross-chunk carry: c[m] = p^L c[m-1] + e[m], e = chunk-end locals
    pLr = powr[:, L]
    pLi = powi[:, L]
    er = yr[..., -1]                                   # [K, B, n]
    ei = yi[..., -1]
    cr, ci = _cpx_affine_scan(
        jnp.broadcast_to(pLr[:, None, None], er.shape),
        jnp.broadcast_to(pLi[:, None, None], er.shape),
        er, ei, s0r, s0i,
    )
    cpr = jnp.concatenate([s0r[..., None], cr[..., :-1]], -1)  # carry INTO m
    cpi = jnp.concatenate([s0i[..., None], ci[..., :-1]], -1)
    # add p^{i+1} * carry to every in-chunk sample
    pwr = powr[:, None, None, 1:L + 1]                 # [K,1,1,L]
    pwi = powi[:, None, None, 1:L + 1]
    sr = yr + pwr * cpr[..., None] - pwi * cpi[..., None]
    si = yi + pwr * cpi[..., None] + pwi * cpr[..., None]
    return sr.reshape(K, Bb, T), si.reshape(K, Bb, T)


@jax.jit
def modal_apply(x: jax.Array, params: ModalParams, state: ModalState | None = None):
    """Run a (time-invariant) biquad in the modal realization over
    ``x[..., T]``.  Returns ``(y, new_state)``; T must be >= 2."""
    T = x.shape[-1]
    if state is None:
        state = modal_init(params, x.shape[:-1], x.dtype)
    b = jnp.broadcast_shapes(x.shape[:-1], params.b0.shape)
    full = b + (T,)
    xb = jnp.broadcast_to(x, full)

    x1 = jnp.broadcast_to(state.x1, b)[..., None]
    x2 = jnp.broadcast_to(state.x2, b)[..., None]
    xm1 = jnp.concatenate([x1, xb[..., :-1]], -1)
    xm2 = jnp.concatenate([x2, x1, xb[..., :-2]], -1)
    v = (params.d1[..., None] * xm1 + params.d2[..., None] * xm2)

    ps = params.b0.shape
    kn = int(np.prod(ps)) if ps else 1
    if (T % _TOEP_CHUNK == 0 and T >= 2 * _TOEP_CHUNK and kn <= 128
            and b[len(b) - len(ps):] == ps):
        # constant poles, pole dims trailing the batch: Toeplitz matmul
        # scan.  Layout [lead..., K, T] -> [K, lead, T] so each pole's
        # chunk matrices batch on the K axis.
        Bf = int(np.prod(b[:len(b) - len(ps)])) if len(ps) < len(b) else 1

        def to_kbt(a):
            return jnp.moveaxis(a.reshape((Bf, kn) + a.shape[len(b):]), 0, 1)

        def from_kbt(a):
            return jnp.moveaxis(a, 1, 0).reshape(b + a.shape[2:])

        p1r = params.p1r.reshape(kn)
        p1i = params.p1i.reshape(kn)
        p2r = params.p2r.reshape(kn)
        p2i = params.p2i.reshape(kn)
        s_tr = to_kbt(jnp.broadcast_to(state.tr, b))
        s_ti = to_kbt(jnp.broadcast_to(state.ti, b))
        s_wr = to_kbt(jnp.broadcast_to(state.wr, b))
        s_wi = to_kbt(jnp.broadcast_to(state.wi, b))
        tr_, ti_ = _cpx_affine_scan_const(
            p1r, p1i, to_kbt(v), None, s_tr, s_ti)
        wr_, wi_ = _cpx_affine_scan_const(
            p2r, p2i, tr_, ti_, s_wr, s_wi)
        tr = from_kbt(tr_)
        ti = from_kbt(ti_)
        wr = from_kbt(wr_)
        wi = from_kbt(wi_)
    else:
        tr, ti = _cpx_affine_scan(
            jnp.broadcast_to(params.p1r[..., None], full),
            jnp.broadcast_to(params.p1i[..., None], full),
            v, jnp.zeros_like(v), state.tr, state.ti,
        )
        wr, wi = _cpx_affine_scan(
            jnp.broadcast_to(params.p2r[..., None], full),
            jnp.broadcast_to(params.p2i[..., None], full),
            tr, ti, state.wr, state.wi,
        )
    y = params.b0[..., None] * xb + wr
    new_state = ModalState(
        x1=xb[..., -1], x2=xm1[..., -1],
        tr=tr[..., -1], ti=ti[..., -1], wr=wr[..., -1], wi=wi[..., -1],
    )
    return y, new_state


@jax.jit
def modal_from_df2t(params: ModalParams, w_state: jax.Array) -> ModalState:
    """Exact DF2T -> modal state conversion.

    Given the companion/DF2T w-registers ``[..., 2]`` (ref: src/BiQuad.h:240)
    and the stage's (time-invariant) :class:`ModalParams`, produce the
    :class:`ModalState` whose zero-input response matches the DF2T state's —
    so a stream can switch realizations (e.g. at the end of a coefficient
    ramp) without a click.

    Derivation: the DF2T free decay is ``y[n] = c1*p1^n + c2*p2^n`` with
    ``y[0] = w0``, ``y[1] = -a1*w0 + w1``; the modal free decay (with zeroed
    FIR history) is ``Re(alpha*p1^n + beta*p2^n)`` with
    ``alpha = T0*p1^2/(p1-p2)``, ``beta = p2*W0 - T0*p1*p2/(p1-p2)``.
    Matching: complex-conjugate poles take ``alpha=2*c1, beta=0``; real
    distinct poles take ``alpha=c1, beta=c2``; repeated/zero poles use the
    degenerate limits.
    """
    w0 = w_state[..., 0]
    w1 = w_state[..., 1]
    p1 = params.p1r + 1j * params.p1i
    p2 = params.p2r + 1j * params.p2i
    a1 = -(p1 + p2).real
    y0 = w0
    y1 = -a1 * w0 + w1

    tol = 1e-6
    dp = p1 - p2
    dp_safe = jnp.where(jnp.abs(dp) < tol, 1.0, dp)
    p1_safe = jnp.where(jnp.abs(p1) < tol, 1.0, p1)
    p2_safe = jnp.where(jnp.abs(p2) < tol, 1.0, p2)

    c1 = (y1 - p2 * y0) / dp_safe
    c2 = (y1 - p1 * y0) / -dp_safe

    is_cplx = jnp.abs(params.p1i) > 0
    # complex-conjugate pair
    T0_c = 2.0 * c1 * dp / (p1_safe * p1_safe)
    W0_c = 2.0 * c1 / p1_safe
    # real distinct poles
    T0_r = c1 * dp / (p1_safe * p1_safe)
    W0_r = c2 / p2_safe + c1 / p1_safe
    # repeated real pole p: y = (g0 + g1*n) p^n
    p = params.p1r
    prs = jnp.where(jnp.abs(p) < tol, 1.0, p)
    g1 = y1 / prs - y0
    T0_rep = (g1 / prs).astype(p1.dtype)
    W0_rep = ((y0 - g1) / prs).astype(p1.dtype)
    # p2 == 0 (single-pole filter): w1 is structurally 0, y decays as p1^n
    T0_z = (y0 / p1_safe).astype(p1.dtype)
    W0_z = jnp.zeros_like(T0_z)

    near_rep = (~is_cplx) & (jnp.abs(dp) < tol)
    p2_zero = jnp.abs(p2) < tol
    T0 = jnp.where(is_cplx, T0_c, jnp.where(near_rep, T0_rep, T0_r))
    W0 = jnp.where(is_cplx, W0_c, jnp.where(near_rep, W0_rep, W0_r))
    T0 = jnp.where(p2_zero, T0_z, T0)
    W0 = jnp.where(p2_zero, W0_z, W0)
    all_zero = jnp.abs(p1) < tol
    T0 = jnp.where(all_zero, 0.0, T0)
    W0 = jnp.where(all_zero, 0.0, W0)

    z = jnp.zeros_like(w0)
    return ModalState(
        x1=z, x2=z,
        tr=T0.real.astype(w0.dtype), ti=T0.imag.astype(w0.dtype),
        wr=W0.real.astype(w0.dtype), wi=W0.imag.astype(w0.dtype),
    )


class ParallelCascadeParams(NamedTuple):
    """Parallel (partial-fraction) form of a whole biquad cascade.

    A static cascade of S biquads is one 2S-order LTI system; decomposing it
    over its (simple) poles gives  H(u) = c + sum_j r_j / (1 - p_j u),
    i.e. 2S INDEPENDENT first-order complex recurrences — the entire
    cascade then runs as ONE batched associative scan instead of 2S
    sequential ones (the launch-bound regime for small channel counts).

    Residues are computed from the FACTORED form (poles straight from each
    biquad's quadratic) — expanding the 2S-order polynomials would wreck
    the poles (classic Wilkinson sensitivity; measured: expanded roots of
    an 8-stage EQ land OUTSIDE the unit circle).  Measured 135 dB SNR in
    float32 for an 8-stage EQ cascade.
    """

    c: jax.Array    # [] direct gain
    pr: jax.Array   # [K] pole real/imag
    pi: jax.Array
    rr: jax.Array   # [K] residue real/imag
    ri: jax.Array


class ParallelCascadeState(NamedTuple):
    sr: jax.Array   # [K, ...batch]
    si: jax.Array


def parallel_cascade_params(
    coeffs, dtype=jnp.float32, min_pole_dist: float = 1e-4
) -> ParallelCascadeParams:
    """Factor ``[S, 5]`` host coefficients into the parallel form.

    Raises ValueError when the decomposition is ill-conditioned (repeated /
    clustered poles, |p| >= 1) — callers fall back to the serial modal
    engine.
    """
    c = np.atleast_2d(np.asarray(coeffs, np.float64))
    poles = []
    for b0, b1, b2, a1, a2 in c:
        sq = np.sqrt(complex(a1 * a1 - 4.0 * a2))
        poles += [(-a1 + sq) / 2.0, (-a1 - sq) / 2.0]
    poles = np.asarray(poles)
    if np.abs(poles).max() >= 1.0:
        raise ValueError("unstable cascade")
    K = poles.size
    dist = np.abs(poles[:, None] - poles[None, :]) + np.eye(K)
    if dist.min() < min_pole_dist:
        raise ValueError("clustered/repeated poles: parallel form "
                         "ill-conditioned; use the serial modal engine")

    def num_at(u):
        v = np.ones_like(u, complex)
        for b0, b1, b2, _, _ in c:
            v = v * (b0 + b1 * u + b2 * u * u)
        return v

    a2s = c[:, 4]
    b2s = c[:, 2]
    if np.all(a2s != 0):
        c_direct = float(np.prod(b2s) / np.prod(a2s))
    else:
        raise ValueError("zero pole (a2 == 0): use the serial modal engine")
    u = 1.0 / poles
    r = np.empty(K, complex)
    for j in range(K):
        den = np.prod(np.delete(1.0 - poles * u[j], j))
        r[j] = num_at(u[j:j + 1])[0] / den
    if not np.all(np.isfinite(r)) or np.abs(r).max() > 1e6:
        raise ValueError("huge residues: parallel form ill-conditioned")
    as_ = lambda v: jnp.asarray(v, dtype)  # noqa: E731
    return ParallelCascadeParams(
        c=as_(c_direct), pr=as_(poles.real), pi=as_(poles.imag),
        rr=as_(r.real), ri=as_(r.imag),
    )


@jax.jit
def parallel_cascade_apply(
    x: jax.Array, params: ParallelCascadeParams,
    state: ParallelCascadeState | None = None,
):
    """Whole-cascade evaluation over ``x [..., T]`` with ONE batched complex
    scan.  Returns ``(y, state)``."""
    T = x.shape[-1]
    K = params.pr.shape[0]
    batch = x.shape[:-1]
    if state is None:
        z = jnp.zeros((K,) + batch, x.dtype)
        state = ParallelCascadeState(z, z)
    full = (K,) + batch + (T,)
    xb = jnp.broadcast_to(x, full)
    shape_k = (K,) + (1,) * len(batch) + (1,)
    if T % _TOEP_CHUNK == 0 and T >= 2 * _TOEP_CHUNK:
        # constant poles + long block: Toeplitz matmul scan instead
        # of the associative scan's pad/slice ladder
        Bf = int(np.prod(batch)) if batch else 1
        sr, si = _cpx_affine_scan_const(
            params.pr, params.pi, xb.reshape(K, Bf, T), None,
            state.sr.reshape(K, Bf), state.si.reshape(K, Bf),
        )
        sr = sr.reshape(full)
        si = si.reshape(full)
    else:
        ar = jnp.broadcast_to(params.pr.reshape(shape_k), full)
        ai = jnp.broadcast_to(params.pi.reshape(shape_k), full)
        sr, si = _cpx_affine_scan(ar, ai, xb, jnp.zeros_like(xb),
                                  state.sr, state.si)
    rr = params.rr.reshape(shape_k)
    ri = params.ri.reshape(shape_k)
    y = params.c * x + jnp.sum(rr * sr - ri * si, axis=0)
    return y, ParallelCascadeState(sr[..., -1], si[..., -1])


def biquad_ssm(coeffs: jax.Array):
    """Split ``[..., 5]`` coefficients into the state-space form.

    Returns ``(A, B, b0)`` with shapes ``[..., 2, 2]``, ``[..., 2]``,
    ``[...]``.
    """
    b0, b1, b2, a1, a2 = jnp.moveaxis(coeffs, -1, 0)
    one = jnp.ones_like(a1)
    zero = jnp.zeros_like(a1)
    A = jnp.stack(
        [jnp.stack([-a1, one], -1), jnp.stack([-a2, zero], -1)], -2
    )
    B = jnp.stack([b1 - a1 * b0, b2 - a2 * b0], -1)
    return A, B, b0


def _coef_t(coeffs, T, time_varying, batch_ndim):
    """Per-sample coefficient tuples, time leading: five ``[T, *ones, *cb]``
    arrays shaped so the coefficient batch dims right-align against an
    ``[T, *batch]`` data array of ``batch_ndim`` batch dims."""
    if time_varying:
        c = jnp.moveaxis(coeffs, -2, 0)  # [T, *cb, 5]
        rows = tuple(jnp.moveaxis(c, -1, 0))  # 5 x [T, *cb]
        cb = coeffs.shape[:-2]
    else:
        rows = tuple(
            jnp.broadcast_to(coeffs[..., k], (T,) + coeffs.shape[:-1])
            for k in range(5)
        )
        cb = coeffs.shape[:-1]
    pad = (1,) * (batch_ndim - len(cb))
    return tuple(r.reshape((T,) + pad + cb) for r in rows)


def _apply_scan(x, coeffs, state, time_varying):
    """Sequential engine: lax.scan of the literal DF2T tick over time
    (ref: src/BiQuad.h:200-206) — the correctness anchor."""

    def step(s, inp):
        xn, b0, b1, b2, a1, a2 = inp
        w0, w1 = s[..., 0], s[..., 1]
        y = b0 * xn + w0
        w0n = b1 * xn - a1 * y + w1
        w1n = b2 * xn - a2 * y
        return jnp.stack([w0n, w1n], axis=-1), y

    T = x.shape[-1]
    ins = (jnp.moveaxis(x, -1, 0),) + _coef_t(coeffs, T, time_varying, x.ndim - 1)
    state, ys = jax.lax.scan(step, state, ins)
    return jnp.moveaxis(ys, 0, -1), state


def _coef_planes(coeffs, time_varying):
    """Five ``[..., T]`` (time-varying) or ``[..., 1]`` (static) coefficient
    planes, time on the minor axis, right-alignable against ``x[..., T]``."""
    if time_varying:
        return tuple(coeffs[..., k] for k in range(5))
    return tuple(coeffs[..., k][..., None] for k in range(5))


def _chunk_scan(elem, identity, compose, T, K):
    """Two-level scan scaffold, time on the MINOR axis.

    Pads ``elem`` planes ``[..., T]`` to a multiple of ``K`` with
    ``identity``, reshapes to ``[..., nc, K]`` and associative-scans within
    chunks.  Returns ``(scanned, totals)`` where ``totals`` are the
    ``[..., nc]`` whole-chunk maps.  Time sits on the lane (minor) axis
    throughout so every compose runs on the contiguous axis.
    """
    pad = (-T) % K
    if pad:
        elem = tuple(
            jnp.concatenate(
                [e, jnp.broadcast_to(jnp.asarray(i, e.dtype),
                                     e.shape[:-1] + (pad,))], -1)
            for e, i in zip(elem, identity)
        )
    nc = (T + pad) // K
    batch = elem[0].shape[:-1]
    chunked = tuple(e.reshape(batch + (nc, K)) for e in elem)
    scanned = jax.lax.associative_scan(compose, chunked, axis=-1)
    totals = tuple(s[..., -1] for s in scanned)
    return scanned, totals, nc


def _outer_seq(totals, carry0, step):
    """Sequential chunk-to-chunk state propagation: scan ``step`` over the
    ``[..., nc]`` totals (moved to the leading axis), returning the list of
    per-chunk INCOMING states, each ``[..., nc]``."""
    tot_lead = tuple(jnp.moveaxis(t, -1, 0) for t in totals)
    _, sins = jax.lax.scan(step, carry0, tot_lead)
    return tuple(jnp.moveaxis(s, 0, -1) for s in sins)


def _apply_assoc(x, coeffs, state, time_varying):
    """Parallel engine: associative scan over affine maps (O(log T) depth).

    The 2x2 map composition is written as explicit elementwise arithmetic —
    NOT einsum/dot — so it runs in plain float32.  (Tiny matmuls at the
    default precision would run in reduced-precision tensor-core formats,
    which caps SNR near 30 dB.)

    Hierarchical two-level structure for float32 robustness: the associative
    scan runs within chunks of K samples (error ~ K*eps), and chunk-to-chunk
    state propagates through a short sequential lax.scan (error like the
    sequential engine).  A flat full-length scan would accumulate error over
    products of thousands of non-normal matrices.
    """
    T = x.shape[-1]
    b0, b1, b2, a1, a2 = _coef_planes(coeffs, time_varying)
    # s[n] = A s[n-1] + B x[n];  A = [[-a1, 1], [-a2, 0]],
    # B = [b1 - a1*b0, b2 - a2*b0]
    v1 = (b1 - a1 * b0) * x
    v2 = (b2 - a2 * b0) * x
    full = v1.shape
    elem = (
        jnp.broadcast_to(-a1, full),
        jnp.broadcast_to(jnp.ones_like(a1), full),
        jnp.broadcast_to(-a2, full),
        jnp.broadcast_to(jnp.zeros_like(a1), full),
        v1,
        v2,
    )

    def compose(f, g):
        # g ∘ f (f earlier): A = Ag Af, v = Ag vf + vg — elementwise 2x2.
        f11, f12, f21, f22, fv1, fv2 = f
        g11, g12, g21, g22, gv1, gv2 = g
        return (
            g11 * f11 + g12 * f21,
            g11 * f12 + g12 * f22,
            g21 * f11 + g22 * f21,
            g21 * f12 + g22 * f22,
            g11 * fv1 + g12 * fv2 + gv1,
            g21 * fv1 + g22 * fv2 + gv2,
        )

    K = min(128, T)
    (c11, c12, c21, c22, cv1, cv2), totals, nc = _chunk_scan(
        elem, (1.0, 0.0, 0.0, 1.0, 0.0, 0.0), compose, T, K
    )

    def outer(carry, tot):
        s1c, s2c = carry
        t11, t12, t21, t22, tv1, tv2 = tot
        return (
            (t11 * s1c + t12 * s2c + tv1, t21 * s1c + t22 * s2c + tv2),
            carry,
        )

    batch = full[:-1]
    s0_1 = jnp.broadcast_to(state[..., 0], batch)
    s0_2 = jnp.broadcast_to(state[..., 1], batch)
    sin1, sin2 = _outer_seq(totals, (s0_1, s0_2), outer)
    # s[n] within chunk m relative to that chunk's incoming state
    s1 = c11 * sin1[..., None] + c12 * sin2[..., None] + cv1
    s2 = c21 * sin1[..., None] + c22 * sin2[..., None] + cv2
    w0_prev = jnp.concatenate(
        [sin1[..., None], s1[..., :-1]], -1).reshape(batch + (nc * K,))[..., :T]
    s1f = s1.reshape(batch + (nc * K,))
    s2f = s2.reshape(batch + (nc * K,))
    y = b0 * x + w0_prev
    new_state = jnp.stack([s1f[..., T - 1], s2f[..., T - 1]], axis=-1)
    return y, new_state


def _compose_dw(f, g):
    """Double-word composition of affine 2x2 maps (g ∘ f), 12 hi/lo planes.

    Element-wise double-word arithmetic keeps ~49 effective mantissa bits
    through the products of non-normal companion matrices — the parallel
    analogue of the reference's double-precision DF2T state
    (ref: src/BiQuad.h:200-240)."""
    (f11h, f11l, f12h, f12l, f21h, f21l, f22h, f22l,
     fv1h, fv1l, fv2h, fv2l) = f
    (g11h, g11l, g12h, g12l, g21h, g21l, g22h, g22l,
     gv1h, gv1l, gv2h, gv2l) = g
    r11 = dw_add(*dw_mul(g11h, g11l, f11h, f11l),
                 *dw_mul(g12h, g12l, f21h, f21l))
    r12 = dw_add(*dw_mul(g11h, g11l, f12h, f12l),
                 *dw_mul(g12h, g12l, f22h, f22l))
    r21 = dw_add(*dw_mul(g21h, g21l, f11h, f11l),
                 *dw_mul(g22h, g22l, f21h, f21l))
    r22 = dw_add(*dw_mul(g21h, g21l, f12h, f12l),
                 *dw_mul(g22h, g22l, f22h, f22l))
    rv1 = dw_add(*dw_add(*dw_mul(g11h, g11l, fv1h, fv1l),
                         *dw_mul(g12h, g12l, fv2h, fv2l)), gv1h, gv1l)
    rv2 = dw_add(*dw_add(*dw_mul(g21h, g21l, fv1h, fv1l),
                         *dw_mul(g22h, g22l, fv2h, fv2l)), gv2h, gv2l)
    return r11 + r12 + r21 + r22 + rv1 + rv2


# Chunk length of the double-word scan.  XLA:CPU's fusion emitter silently
# degrades the error-free transforms once the fused scan graph grows past
# ~3 levels (`--xla_disable_hlo_passes=fusion` restores exactness; barriers
# do NOT); chunks of 8 keep them exact there, and the GPU is checked at
# the same size by chip_smoke.py's assoc_dw phase.
_DW_CHUNK = 8


def _apply_assoc_dw(x, chi, clo, state):
    """Double-word parallel engine for per-sample time-varying coefficients.

    Takes the coefficient trajectory as double-word planes ``chi``/``clo``
    (``[..., T, 5]`` each, split from the float64 design with
    :func:`~bbcat_dsp_tpu.utils.dwfloat.dw_from_f64`) and runs the
    companion-form scan entirely in double-word float32.  This reproduces
    the reference's double-coefficient / double-state interpolated tick
    (ref: src/BiQuad.cpp:473-494) to ~148 dB SNR even for poles within
    1e-4 of the unit circle, where plain float32 — sequential OR parallel —
    is 50+ dB short because rounding the coefficients alone moves the poles
    audibly.

    ``state`` is the standard float32 ``[..., 2]`` w-register pair; one
    float32 rounding of the *state value* per block boundary is harmless
    (it is not amplified — unlike coefficient rounding).
    """
    T = x.shape[-1]
    b0h, b1h, b2h, a1h, a2h = _coef_planes(chi, True)
    b0l, b1l, b2l, a1l, a2l = _coef_planes(clo, True)
    z = jnp.zeros_like(x)
    # v1 = (b1 - a1*b0)*x, v2 = (b2 - a2*b0)*x in double-word
    t1h, t1l = dw_mul(a1h, a1l, b0h, b0l)
    d1h, d1l = dw_add(b1h, b1l, -t1h, -t1l)
    t2h, t2l = dw_mul(a2h, a2l, b0h, b0l)
    d2h, d2l = dw_add(b2h, b2l, -t2h, -t2l)
    v1h, v1l = dw_mul(d1h, d1l, x, z)
    v2h, v2l = dw_mul(d2h, d2l, x, z)
    full = v1h.shape
    bc = lambda a: jnp.broadcast_to(a, full)  # noqa: E731
    elem = (bc(-a1h), bc(-a1l), bc(jnp.ones_like(a1h)), bc(z),
            bc(-a2h), bc(-a2l), bc(z), bc(z),
            bc(v1h), bc(v1l), bc(v2h), bc(v2l))

    K = min(_DW_CHUNK, T)
    # identity map A = I, v = 0 in the plane order
    # (a11h,a11l, a12h,a12l, a21h,a21l, a22h,a22l, v1h,v1l, v2h,v2l)
    ident = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    scanned, totals, nc = _chunk_scan(elem, ident, _compose_dw, T, K)
    (c11h, c11l, c12h, c12l, c21h, c21l, c22h, c22l,
     cv1h, cv1l, cv2h, cv2l) = scanned

    def outer(carry, tot):
        s1h, s1l, s2h, s2l = carry
        (t11h, t11l, t12h, t12l, t21h, t21l, t22h, t22l,
         tv1h, tv1l, tv2h, tv2l) = tot
        n1 = dw_add(*dw_add(*dw_mul(t11h, t11l, s1h, s1l),
                            *dw_mul(t12h, t12l, s2h, s2l)), tv1h, tv1l)
        n2 = dw_add(*dw_add(*dw_mul(t21h, t21l, s1h, s1l),
                            *dw_mul(t22h, t22l, s2h, s2l)), tv2h, tv2l)
        return (n1[0], n1[1], n2[0], n2[1]), (s1h, s1l, s2h, s2l)

    batch = full[:-1]
    zb = jnp.zeros(batch, x.dtype)
    s0_1 = jnp.broadcast_to(state[..., 0], batch)
    s0_2 = jnp.broadcast_to(state[..., 1], batch)
    sin1h, sin1l, sin2h, sin2l = _outer_seq(
        totals, (s0_1, zb, s0_2, zb), outer)
    s1h, s1l = dw_add(*dw_add(
        *dw_mul(c11h, c11l, sin1h[..., None], sin1l[..., None]),
        *dw_mul(c12h, c12l, sin2h[..., None], sin2l[..., None])), cv1h, cv1l)
    s2h, s2l = dw_add(*dw_add(
        *dw_mul(c21h, c21l, sin1h[..., None], sin1l[..., None]),
        *dw_mul(c22h, c22l, sin2h[..., None], sin2l[..., None])), cv2h, cv2l)
    # keep w0 in double-word through the final add: for near-unit poles the
    # w-state can be ~1e3x the output (b0*x and w0 nearly cancel), so
    # collapsing it to single float32 here would cap SNR near 84 dB.
    w0_prev_h = jnp.concatenate(
        [sin1h[..., None], s1h[..., :-1]],
        -1).reshape(batch + (nc * K,))[..., :T]
    w0_prev_l = jnp.concatenate(
        [sin1l[..., None], s1l[..., :-1]],
        -1).reshape(batch + (nc * K,))[..., :T]
    ybh, ybl = dw_mul(b0h, b0l, x, z)
    y = dw_collapse(*dw_add(ybh, ybl, w0_prev_h, w0_prev_l))
    s1f = (s1h + s1l).reshape(batch + (nc * K,))
    s2f = (s2h + s2l).reshape(batch + (nc * K,))
    new_state = jnp.stack([s1f[..., T - 1], s2f[..., T - 1]], axis=-1)
    return y, new_state


class DWCoeffs(NamedTuple):
    """Double-word coefficient trajectory: ``hi + lo`` float32 planes of the
    float64 per-sample coefficients (``[..., T, 5]`` each).  Built with
    :func:`~bbcat_dsp_tpu.utils.dwfloat.dw_from_f64` or
    :func:`~bbcat_dsp_tpu.filters.bank._bank_trajectories`."""

    hi: jax.Array
    lo: jax.Array


@partial(jax.jit, static_argnames=("engine", "time_varying"))
def _biquad_companion(x, coeffs, state, engine, time_varying):
    chi = coeffs.hi if isinstance(coeffs, DWCoeffs) else coeffs
    if state is None:
        shape = jnp.broadcast_shapes(
            x.shape[:-1],
            chi.shape[:-2] if time_varying else chi.shape[:-1],
        )
        state = jnp.zeros(shape + (2,), x.dtype)
    if engine == "assoc_dw":
        return _apply_assoc_dw(x, chi, coeffs.lo, state)
    if isinstance(coeffs, DWCoeffs):
        coeffs = coeffs.hi  # plain engines use the rounded-to-f32 value
    if engine == "assoc":
        return _apply_assoc(x, coeffs, state, time_varying)
    if engine == "scan":
        return _apply_scan(x, coeffs, state, time_varying)
    raise ValueError(f"unknown engine {engine!r}")


def biquad_apply(
    x: jax.Array,
    coeffs,
    state=None,
    engine: str = "auto",
):
    """Run one biquad over ``x[..., T]``.

    ``coeffs`` is ``[..., 5]`` (static), ``[..., T, 5]`` (per-sample,
    time-varying — e.g. from :func:`interp_trajectory`), a pre-factored
    :class:`ModalParams`, or a :class:`DWCoeffs` double-word trajectory.
    ``engine``:

    * ``"auto"`` — modal for time-invariant host coefficients, companion
      assoc otherwise (module docstring rationale); ``assoc_dw`` when given
      :class:`DWCoeffs`.
    * ``"modal"`` / ``"assoc"`` / ``"assoc_dw"`` / ``"scan"`` — forced.

    The state pytree is ``[..., 2]`` w-registers for companion engines
    (ref: src/BiQuad.h:240) or :class:`ModalState` for modal; streaming
    callers just thread whatever was returned.  Returns ``(y, new_state)``.
    """
    if isinstance(coeffs, ModalParams):
        if engine not in ("auto", "modal"):
            raise ValueError("ModalParams requires the modal engine")
        return modal_apply(x, coeffs, state)
    if isinstance(coeffs, DWCoeffs):
        tv = coeffs.hi.ndim == x.ndim + 1 and coeffs.hi.shape[-2] == x.shape[-1]
        if not tv:
            raise ValueError("DWCoeffs must be a [..., T, 5] trajectory")
        if engine == "auto":
            engine = "assoc_dw"
        return _biquad_companion(x, coeffs, state, engine, True)
    time_varying = coeffs.ndim == x.ndim + 1 and coeffs.shape[-2] == x.shape[-1]
    if engine == "assoc_dw":
        if not time_varying:
            raise ValueError("assoc_dw requires a [..., T, 5] trajectory")
        # plain trajectory: lo = 0 (still gains the dw scan arithmetic)
        return _biquad_companion(
            x, DWCoeffs(coeffs, jnp.zeros_like(coeffs)), state, engine, True)
    if engine == "auto":
        if not time_varying and not isinstance(coeffs, jax.core.Tracer):
            engine = "modal"
        else:
            engine = "assoc"
    if engine == "modal":
        if time_varying:
            raise ValueError("modal engine requires time-invariant coeffs")
        return modal_apply(x, modal_params(coeffs, _dtype_of(x)), state)
    return _biquad_companion(x, coeffs, state, engine, time_varying)


def _dtype_of(x):
    return getattr(x, "dtype", jnp.float32)


def cascade_apply(
    x: jax.Array,
    coeffs,
    states=None,
    engine: str = "auto",
    systolic: bool = False,
):
    """Serial biquad cascade: ``coeffs[S, ..., 5]`` stages applied in order
    (ref: src/BiQuad.cpp:639-662 stage-serial processing; src/BiQuad.h:698-711
    serial cascade).

    ``engine="parallel"`` runs the whole (static, simple-pole) cascade as
    its partial-fraction parallel form — one batched scan
    (:class:`ParallelCascadeParams`); raises ValueError when
    ill-conditioned, so callers can fall back to the default.

    ``systolic=True`` reproduces the reference's vectorised-cascade semantics
    (ref: src/BiQuad.h:591-624): every stage ticks on the previous output of
    the stage before it, which is algebraically the serial cascade with one
    sample of delay inserted between stages — output lags ``S-1`` samples.
    The parallel-scan engine doesn't need that trick for speed, but
    the mode is kept for bit-parity with reference configurations that used
    it.

    ``states`` is a list of per-stage state pytrees (engine-dependent; pass
    back what was returned).  Returns ``(y, new_states)``.
    """
    if engine == "parallel" or isinstance(coeffs, ParallelCascadeParams):
        if systolic:
            raise ValueError("systolic mode is a serial-form semantic")
        params = (coeffs if isinstance(coeffs, ParallelCascadeParams)
                  else parallel_cascade_params(coeffs, _dtype_of(x)))
        return parallel_cascade_apply(x, params, states)
    S = coeffs.shape[0] if not isinstance(coeffs, ModalParams) else coeffs.b0.shape[0]
    if states is None:
        states = [None] * S

    # unrolled python loop over stages: S is small & static; each stage is a
    # full parallel scan over time.
    new_states = []
    y = x
    for i in range(S):
        if systolic and i > 0:
            y = jnp.concatenate([jnp.zeros_like(y[..., :1]), y[..., :-1]], axis=-1)
        ci = (
            ModalParams(*(f[i] for f in coeffs))
            if isinstance(coeffs, ModalParams) else coeffs[i]
        )
        y, s = biquad_apply(y, ci, states[i], engine=engine)
        new_states.append(s)
    return y, new_states


def interp_trajectory(
    current: jax.Array,
    targets: jax.Array,
    mul: jax.Array,
    dec: jax.Array,
    nframes: int,
):
    """Materialise the per-sample coefficient trajectory of the reference's
    shared-controller interpolation over one block.

    Contract (ref: src/BiQuad.cpp:75-102, 379-395; src/Interpolator.h:92-96):
    ``diffs = targets - current_at_set_time``; frame ``n`` of the block uses
    ``coeffs[n] = targets - mul_n * diffs`` where ``mul_0 = mul`` (the value
    entering the block) and ``mul_{n+1} = max(mul_n - dec, 0)`` — all five
    coefficients driven by ONE scalar so they land simultaneously
    ("anti-go-bang", ref: src/Interpolator.h:92-96).  Interpolation happens
    AFTER each processed frame (ref: src/BiQuad.cpp:482-493).

    ``current`` here must be the coefficient vector from which ``diffs`` are
    measured (i.e. the value when the target was set).  Returns
    ``(coeffs[..., nframes, 5], new_mul)``.
    """
    diffs = targets - current
    n = jnp.arange(nframes, dtype=targets.dtype)
    muls = jnp.maximum(mul - dec * n, 0.0)  # mul entering frame n
    coeffs = targets[..., None, :] - muls[:, None] * diffs[..., None, :]
    new_mul = jnp.maximum(mul - dec * nframes, 0.0)
    return coeffs, new_mul
