"""Non-uniform (two-level) partitioned convolution — the throughput engine.

Level 1 (latency): the first ``2*ratio`` x ``block`` taps run at block B.
Level 2 (bandwidth): the remainder runs at ``B2 = ratio * B``.  HBM traffic
drops ~3x vs uniform partitioning (bytes/s ~ 16*C*fs*(P_head + P_tail/ratio)
instead of 16*C*fs*N/B) while output latency stays one small block.

The decisive restructuring: within one super-block of ``ratio`` small
blocks there is NO sequential dependency — the spectral delay line is just
input history, all of it known up front.  So the head is evaluated as a
batched frequency-domain FIR over the block index:

    acc[i] = sum_p  X[P + i - p] * H[p],   i = 0..ratio-1

with ONE batched rFFT for all ``ratio`` windows, ``P`` fused shifted
multiply-adds, and ONE batched irFFT — instead of a ``lax.scan`` that paid
~10 kernel launches per small block.  The head's streaming state collapses
to the last ``P`` window spectra (``xcarry``) + B input samples.

The tail convolver's output is delayed by exactly N1 = 2*B2 samples; a
2-slot pending queue re-aligns it, and with N1 >= B2 the schedule stays
causal with slack (the classic Gardner argument) — no added latency.

Click-free IR exchange: the head crossfades over the first small block of
the next super-block, the tail over that whole super-block — both
transitions continuous (golden crossfade contract).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .block import (
    ConvolverState,
    _roll_slots,
    convolver_init,
    partition_ir,
)
from .fft import (
    SpectralSpec,
    half_window_signs,
    irfft_tail_planes,
    resolve_spectral_spec,
    rfft_half_planes,
)

# (head, tail) spectral specs — the head engine runs at 2*block, the tail
# at 2*super_block; each freezes its own backend/layout/radix
Specs = tuple

__all__ = [
    "NonUniformState",
    "NonUniformConvolver",
    "nonuniform_render",
]


class NonUniformState(NamedTuple):
    xcarry: jax.Array   # [2, P_head, C, F] last P_head window spectra
                        # (oldest..newest along axis 1)
    prev: jax.Array     # [2, C, F] half-window spectrum of the previous
                        # small block (window assembly via shift theorem)
    tail: ConvolverState  # TAIL-SPECIFIC queue semantics (round 5): slot
                        # ``s`` holds the HALF-window spectrum xt of the
                        # super-block with ``step % Pt == s`` — NOT the
                        # assembled window the uniform engine stores.
                        # Windows are assembled at MAC time from xt pairs
                        # (shift theorem), which lets the grouped render
                        # carry this group's xt forward UNTOUCHED instead
                        # of writing back Pt assembled windows (473 MB per
                        # group at config #5).  ``tail.prev`` keeps its
                        # meaning: half spectrum of super ``step - 1``
                        # (== the newest queue slot; kept for O(1) access
                        # and checkpoint-migration anchoring).
    pending: jax.Array  # [2, C, B2] tail outputs awaiting their time slot


def _split_ir(ir: np.ndarray, block: int, ratio: int):
    ir = np.atleast_2d(np.asarray(ir))
    n1 = 2 * ratio * block
    head = ir[:, :n1]
    tail = ir[:, n1:] if ir.shape[1] > n1 else None
    return head, tail


def _head_spectra(prev_xt: jax.Array, x: jax.Array, B: int, ratio: int,
                  spec: SpectralSpec | None = None):
    """Window spectra for all ``ratio`` blocks of the super-block via the
    half-window shift-theorem assembly (one half-DFT per block).

    Returns ``(X [2, ratio, C, F], new_prev_xt [2, C, F])``.
    """
    C = x.shape[0]
    xb = jnp.moveaxis(x.reshape(C, ratio, B), 1, 0)   # [ratio, C, B]
    xt = rfft_half_planes(xb, 2 * B, spec=spec)       # [2, ratio, C, F]
    ext = jnp.concatenate([prev_xt[:, None], xt], axis=1)
    s = jnp.asarray(half_window_signs(2 * B, spec=spec))
    X = ext[:, :-1] + s * ext[:, 1:]
    return X, xt[:, -1]


def _head_mac(xext: jax.Array, H: jax.Array, ratio: int):
    """acc[i] = sum_p xext[P+i-p] * H[p] — P shifted complex MACs, which
    XLA fuses into one elementwise loop.

    ``xext [2, P+ratio, C, F]``, ``H [2, P, C, F]`` -> ``[2, ratio, C, F]``.
    """
    P = H.shape[1]
    acc_r = jnp.zeros_like(xext[0, :ratio])
    acc_i = jnp.zeros_like(xext[0, :ratio])
    for p in range(P):
        xr = jax.lax.slice_in_dim(xext[0], P - p, P - p + ratio, axis=0)
        xi = jax.lax.slice_in_dim(xext[1], P - p, P - p + ratio, axis=0)
        hr = H[0, p]
        hi = H[1, p]
        acc_r = acc_r + (xr * hr - xi * hi)
        acc_i = acc_i + (xr * hi + xi * hr)
    return jnp.stack([acc_r, acc_i], axis=0)


def _head_step(xcarry, prev, H_head, x, B: int, ratio: int,
               spec: SpectralSpec | None = None):
    """Batched head evaluation.  Returns (y_head [C, SB], xcarry', prev')."""
    C, SB = x.shape
    Xnew, prev_xt = _head_spectra(prev, x, B, ratio, spec)  # [2,ratio,C,F]
    xext = jnp.concatenate([xcarry, Xnew], axis=1)      # [2, P+ratio, C, F]
    acc = _head_mac(xext, H_head, ratio)                # [2, ratio, C, F]
    y2 = irfft_tail_planes(acc, 2 * B, spec=spec)       # [ratio, C, B]
    y_head = jnp.moveaxis(y2, 0, 1).reshape(C, SB)
    P = H_head.shape[1]
    return y_head, xext[:, -P:], prev_xt


def _tail_windows_from_xt(tseq: jax.Array, s: jax.Array) -> jax.Array:
    """Window spectra from consecutive half-window spectra (shift
    theorem): ``w[i] = tseq[i] + s * tseq[i+1]`` — ``tseq [2, K+1, C, F]``
    -> ``w [2, K, C, F]`` (window i ends at the block of ``tseq[i+1]``)."""
    return tseq[:, :-1] + s * tseq[:, 1:]


def _tail_step_xt(state: ConvolverState, H, x, spec: SpectralSpec | None
                  = None, H_old=None):
    """Streaming tail step under the xt-slot queue layout.

    The queue's Pt slots hold raw HALF-window spectra (slot = step % Pt);
    windows assemble at MAC time from consecutive xt pairs — ~2x the
    elementwise reads of the window-queue formulation per step, paid only
    on the latency (per-super-step) path; the throughput path
    (:func:`_render_group`) wins the whole queue writeback instead.

    With ``H_old`` the step crossfades old -> new over the block (the
    click-free IR-exchange contract of ``convolver_step_crossfade``)."""
    B2 = x.shape[-1]
    _, Pt, C, F = state.queue.shape
    xt = rfft_half_planes(x, 2 * B2, spec=spec)          # [2, C, F]
    s = jnp.asarray(half_window_signs(2 * B2, spec=spec))
    # chronological half spectra t(step-Pt) .. t(step-1) from the slots
    idx = jnp.mod(state.step + jnp.arange(Pt), Pt)
    tpast = state.queue[:, idx]
    tseq = jnp.concatenate([tpast, xt[:, None]], axis=1)  # t(step-Pt)..t(step)
    w = _tail_windows_from_xt(tseq, s)                    # W(step-Pt+1)..W(step)
    # out = sum_p W(step - p) * H[p]  ->  w index Pt-1-p
    def mac(Hs):
        acc_r = jnp.zeros_like(xt[0])
        acc_i = jnp.zeros_like(xt[0])
        for p in range(Pt):
            vr, vi = w[0, Pt - 1 - p], w[1, Pt - 1 - p]
            hr, hi = Hs[0, p], Hs[1, p]
            acc_r = acc_r + (vr * hr - vi * hi)
            acc_i = acc_i + (vr * hi + vi * hr)
        return jnp.stack([acc_r, acc_i])

    if H_old is None:
        y = irfft_tail_planes(mac(H), 2 * B2, spec=spec).astype(x.dtype)
    else:
        y_old = irfft_tail_planes(mac(H_old), 2 * B2, spec=spec)
        y_new = irfft_tail_planes(mac(H), 2 * B2, spec=spec)
        ramp = (jnp.arange(B2, dtype=x.dtype) + 1) / B2
        y = ((1 - ramp) * y_old + ramp * y_new).astype(x.dtype)
    slot = jnp.mod(state.step, Pt)
    queue = jax.lax.dynamic_update_slice(
        state.queue, xt[:, None].astype(state.queue.dtype), (0, slot, 0, 0)
    )
    return ConvolverState(queue, xt, state.step + 1), y


@partial(jax.jit, static_argnames=("block", "specs"))
def _super_step(state: NonUniformState, H_head, H_tail, x, block: int,
                specs: Specs | None = None):
    """One super-block: ``x [C, B2]`` -> ``y [C, B2]``."""
    sh, st = specs if specs is not None else (None, None)
    ratio = x.shape[-1] // block
    y_head, xcarry, prev = _head_step(
        state.xcarry, state.prev, H_head, x, block, ratio, sh
    )
    y = y_head + state.pending[0]
    tail, out_tail = _tail_step_xt(state.tail, H_tail, x, spec=st)
    pending = jnp.stack([state.pending[1], out_tail])
    return NonUniformState(xcarry, prev, tail, pending), y


@partial(jax.jit, static_argnames=("block", "specs"))
def _super_step_crossfade(
    state: NonUniformState, H_head, H_head_new, H_tail, H_tail_new, x,
    block: int, specs: Specs | None = None,
):
    """Super-block in which the IR exchange begins."""
    sh, st = specs if specs is not None else (None, None)
    B = block
    ratio = x.shape[-1] // B
    C = x.shape[0]
    Xnew, prev_xt = _head_spectra(state.prev, x, B, ratio, sh)
    xext = jnp.concatenate([state.xcarry, Xnew], axis=1)
    acc_new = _head_mac(xext, H_head_new, ratio)
    # old filter needed only for block 0 of the fade
    acc_old0 = _head_mac(xext[:, : H_head.shape[1] + 1], H_head, 1)
    y2_new = irfft_tail_planes(acc_new, 2 * B, spec=sh)  # [ratio, C, B]
    y_old0 = irfft_tail_planes(acc_old0, 2 * B, spec=sh)[0]  # [C, B]
    ramp = (jnp.arange(B, dtype=x.dtype) + 1) / B
    y0 = (1 - ramp) * y_old0 + ramp * y2_new[0]
    y2 = jnp.concatenate([y0[None], y2_new[1:]], axis=0)
    y_head = jnp.moveaxis(y2, 0, 1).reshape(C, ratio * B)

    y = y_head + state.pending[0]
    tail, out_tail = _tail_step_xt(state.tail, H_tail_new, x, spec=st,
                                   H_old=H_tail)
    pending = jnp.stack([state.pending[1], out_tail])
    P = H_head.shape[1]
    return (
        NonUniformState(xext[:, -P:], prev_xt, tail, pending),
        y,
    )


@partial(jax.jit, static_argnames=("spec",))
def _head_step_single(xcarry, prev, H_head, x,
                      spec: SpectralSpec | None = None):
    """Single small-block head step (the low-latency streaming path):
    ``x [C, B]`` -> ``y_head [C, B]``; state advances by one block."""
    B = x.shape[-1]
    Xnew, prev_xt = _head_spectra(prev, x, B, 1, spec)  # [2, 1, C, F]
    xext = jnp.concatenate([xcarry, Xnew], axis=1)
    acc = _head_mac(xext, H_head, 1)
    y = irfft_tail_planes(acc, 2 * B, spec=spec)[0]     # [C, B]
    P = H_head.shape[1]
    return y, xext[:, -P:], prev_xt


@partial(jax.jit, static_argnames=("spec",))
def _head_step_single_crossfade(xcarry, prev, H_old, H_new, x,
                                spec: SpectralSpec | None = None):
    """Small-block head step with a click-free filter crossfade."""
    B = x.shape[-1]
    Xnew, prev_xt = _head_spectra(prev, x, B, 1, spec)
    xext = jnp.concatenate([xcarry, Xnew], axis=1)
    y_old = irfft_tail_planes(_head_mac(xext, H_old, 1), 2 * B,
                              spec=spec)[0]
    y_new = irfft_tail_planes(_head_mac(xext, H_new, 1), 2 * B,
                              spec=spec)[0]
    ramp = (jnp.arange(B, dtype=x.dtype) + 1) / B
    y = (1 - ramp) * y_old + ramp * y_new
    P = H_old.shape[1]
    return y, xext[:, -P:], prev_xt


def _choose_chunk(total: int, limit: int) -> int:
    """Largest divisor of ``total`` that is <= ``limit`` (>= 1)."""
    best = 1
    for d in range(1, total + 1):
        if total % d == 0 and d <= limit:
            best = d
    return best


def _gather_supers(x: jax.Array, nsup: int) -> jax.Array:
    """``[C, nsup * B2]`` -> ``[nsup, C, B2]``: the group's super-blocks
    on the leading (batch) axis."""
    C, T = x.shape
    return jnp.moveaxis(x.reshape(C, nsup, T // nsup), 1, 0)


def _tail_group_mac(queue: jax.Array, step: jax.Array, xt: jax.Array,
                    H: jax.Array, signs: jax.Array,
                    slot0: int | None = None) -> jax.Array:
    """Whole-group tail MAC over the xt-slot queue layout.

    ``queue [2, Pt, C, F]`` holds the past Pt half spectra slot-encoded
    (slot ``s`` = super ``j`` with ``j % Pt == s``), ``xt [2, Pt, C, F]``
    this group's half spectra.  Windows assemble from consecutive half
    spectra (shift theorem, ``signs`` = :func:`half_window_signs`) and
    ``acc[j] = sum_p W(j - p) * H[p]`` for the group's Pt supers.  A
    host-known ``slot0`` (``step % Pt``) makes the queue read a static
    roll; otherwise it is a traced-index gather.  -> ``[2, Pt, C, F]``.
    """
    Pt, C = queue.shape[1], queue.shape[2]
    if slot0 is not None:
        tpast = _roll_slots(queue, slot0)
    else:
        tpast = queue[:, jnp.mod(step + jnp.arange(Pt), Pt)]
    tseq = jnp.concatenate([tpast, xt], axis=1)          # [2, 2Pt, C, F]
    w = _tail_windows_from_xt(tseq, signs)               # [2, 2Pt-1, C, F]
    # out(j) = sum_p w[Pt-1+j-p] * H[p]; _head_mac's contract is
    # acc[i] = sum_p ext[Pt+i-p], so prepend one never-referenced dummy
    # slot to shift the window indexing by one
    Xext = jnp.concatenate([jnp.zeros_like(w[:, :1]), w], axis=1)
    tc = _choose_chunk(Pt, 7 if C >= 512 else Pt)
    accs = []
    for j0 in range(0, Pt, tc):
        hist = jax.lax.slice_in_dim(Xext, j0, j0 + Pt + tc, axis=1)
        accs.append(_head_mac(hist, H, tc))
    return jnp.concatenate(accs, axis=1)


def _delayed_add(y_head: jax.Array, pending: jax.Array,
                 out_tail: jax.Array):
    """Pending-schedule output assembly: super-step ``j`` of the group adds
    the tail output of super-step ``j - 2`` (the 2-slot schedule slack).

    ``y_head [C, Pt*B2]``, ``pending [2, C, B2]``, ``out_tail [Pt, C, B2]``
    -> ``(y [C, Pt*B2], pending' [2, C, B2])``."""
    C, T = y_head.shape
    Pt = out_tail.shape[0]
    delayed = jnp.concatenate([pending, out_tail], axis=0)
    y = y_head + jnp.moveaxis(delayed[:Pt], 0, 1).reshape(C, T)
    return y, delayed[Pt:Pt + 2]


def _render_group(state: NonUniformState, xg, H_head, H_tail, block: int,
                  ratio: int, Pt: int, tail_slot0: int | None = None,
                  specs: Specs | None = None):
    """One render group of ``Pt`` super-blocks, fully BATCHED.

    Within a render the spectral delay lines are pure input history, so
    nothing forces the per-super-step cadence: the head evaluates in
    chunks of many small blocks through :func:`_head_step`, and the TAIL
    MAC batches across super-steps — ``acc[j] = sum_p Xwin[j-p] (x) H[p]``
    over the [past | new] window history, so H_tail is read once per
    chunk instead of once per super-step.
    The slot-encoded queue, ``prev`` spectra and ``pending`` alignment are
    reproduced exactly, so the result and final state are interchangeable
    with a chain of :func:`_super_step` calls.
    """
    sh, st = specs if specs is not None else (None, None)
    C = xg.shape[0]
    B = block
    B2 = B * ratio

    # ---- head: chunked batched chain of small blocks
    n_small = Pt * ratio
    hc = _choose_chunk(
        n_small, 16 if C >= 512 else (32 if C >= 128 else n_small)
    )
    xcarry, prev = state.xcarry, state.prev
    y_heads = []
    for c0 in range(0, n_small, hc):
        xch = jax.lax.slice_in_dim(xg, c0 * B, (c0 + hc) * B, axis=-1)
        yh, xcarry, prev = _head_step(xcarry, prev, H_head, xch, B, hc, sh)
        y_heads.append(yh)
    y_head = jnp.concatenate(y_heads, axis=-1)           # [C, Pt*B2]

    # ---- tail: one batched half transform + whole-group windowed MAC.
    # The queue's slots hold RAW half-window spectra (xt); windows
    # assemble inside the MAC from consecutive xt pairs, and the new
    # carry is THIS group's xt — for the group-aligned stream
    # (tail_slot0 == 0, every render) the carry is the rfft output
    # untouched, with no assembled-window writeback.
    # Each group advances the step by exactly Pt, so step % Pt is
    # invariant across the group scan and a host-known tail_slot0 keeps
    # every queue access a static roll.
    xsup = _gather_supers(xg, Pt)                        # [Pt, C, B2]
    xt = rfft_half_planes(xsup, 2 * B2, spec=st)         # [2, Pt, C, F2]
    s2 = jnp.asarray(half_window_signs(2 * B2, spec=st))
    acc = _tail_group_mac(state.tail.queue, state.tail.step, xt, H_tail,
                          s2, tail_slot0)
    out_tail = irfft_tail_planes(acc, 2 * B2,
                                 spec=st).astype(xg.dtype)  # [Pt, C, B2]
    y, pending = _delayed_add(y_head, state.pending, out_tail)

    # ---- queue carry: the new queue IS this group's xt, slot-encoded.
    # Group-aligned streams (tail_slot0 == 0 — every whole-signal render)
    # hit the roll's identity fast path: the carry aliases the rfft
    # output and nothing is written back at all.
    if tail_slot0 is not None:
        queue = _roll_slots(
            xt, (Pt - tail_slot0) % Pt
        ).astype(state.tail.queue.dtype)
    else:
        perm = jnp.mod(jnp.arange(Pt) - state.tail.step, Pt)
        queue = xt[:, perm].astype(state.tail.queue.dtype)
    tail = ConvolverState(queue, xt[:, -1], state.tail.step + Pt)
    return NonUniformState(xcarry, prev, tail, pending), y


def _render_impl(state: NonUniformState, H_head, H_tail, x, block: int,
                 tail_slot0: int | None = None,
                 specs: Specs | None = None):
    """Render ``[C, T]`` (T multiple of the super-block) on device.

    When ``nsuper`` is a multiple of the tail partition count the render
    scans over GROUPS of Pt super-blocks, each evaluated fully batched
    (:func:`_render_group` — batched head chunks + batched tail MAC).
    Otherwise it falls back to the per-super-step scan.  A host-known
    ``tail_slot0`` (``tail.step % Pt``) makes the group body's queue
    read/writeback static rolls instead of traced-index permutations —
    valid inside the group scan because every group advances the step by
    exactly ``Pt``.
    """
    C, T = x.shape
    B2 = state.pending.shape[-1]
    nsuper = T // B2
    Pt = state.tail.queue.shape[1]

    if nsuper % Pt == 0:
        ratio = B2 // block
        if nsuper == Pt:
            # single group: call the body directly (a length-1 lax.scan
            # still pays while-loop carry copies)
            return _render_group(state, x, H_head, H_tail, block, ratio, Pt,
                                 tail_slot0, specs)
        groups = jnp.moveaxis(
            x.reshape(C, nsuper // Pt, Pt * B2), 1, 0
        )

        def gbody(st, xg):
            return _render_group(st, xg, H_head, H_tail, block, ratio, Pt,
                                 tail_slot0, specs)

        state, ys = jax.lax.scan(gbody, state, groups)
        return state, jnp.moveaxis(ys, 0, 1).reshape(C, T)

    blocks = jnp.moveaxis(x.reshape(C, nsuper, B2), 1, 0)

    def body(st, xb):
        return _super_step(st, H_head, H_tail, xb, block, specs)

    state, ys = jax.lax.scan(body, state, blocks)
    return state, jnp.moveaxis(ys, 0, 1).reshape(C, T)


@partial(jax.jit, static_argnames=("block", "tail_slot0", "specs"),
         donate_argnums=(0,))
def nonuniform_render(state: NonUniformState, H_head, H_tail, x, block: int,
                      tail_slot0: int | None = None,
                      specs: Specs | None = None):
    return _render_impl(state, H_head, H_tail, x, block, tail_slot0, specs)


@partial(jax.jit, static_argnames=("block", "tail_slot0", "specs"),
         donate_argnums=(0,))
def nonuniform_render_looped(state: NonUniformState, H_head, H_tail, xs,
                             block: int,
                             tail_slot0: int | None = None,
                             specs: Specs | None = None):
    """Render a STACK of signals ``xs [R, C, T]`` back-to-back in ONE device
    program (state chained; only per-render output tails returned).

    One dispatch covers ``R`` renders, so a timing over it holds no
    per-call host overhead.  The renders must be over DISTINCT signals —
    scanning the same ``x`` repeatedly lets XLA hoist every input-dependent
    stage (the forward transforms of the whole signal) out of the loop, and
    the "throughput" then stops corresponding to streaming work."""

    def body(st, x):
        st, y = _render_impl(st, H_head, H_tail, x, block, tail_slot0,
                             specs)
        return st, y[:, -1]

    state, tails = jax.lax.scan(body, state, xs)
    return state, tails


class NonUniformConvolver:
    """Streaming two-level partitioned convolver.

    Same API family as :class:`BlockConvolver`; ``process_block`` consumes
    SUPER-blocks of ``ratio * block`` samples (internal output latency is
    still one small block within the super-block).
    """

    def __init__(self, ir, block: int, ratio: int = 8,
                 nchannels: int | None = None, dtype=jnp.float32,
                 spectral: Specs | None = None):
        ir2 = np.atleast_2d(np.asarray(ir))
        if nchannels is None:
            nchannels = ir2.shape[0]
        if ir2.shape[0] == 1 and nchannels > 1:
            ir2 = np.broadcast_to(ir2, (nchannels, ir2.shape[1]))
        self.block = int(block)
        self.ratio = int(ratio)
        self.super_block = self.block * self.ratio
        self.nchannels = nchannels
        # FREEZE both levels' spectral configurations at construction
        # (env toggles read once; a permuted-layout resolution probes that
        # its program builds, falling back to std with a warning — see
        # fft.resolve_spectral_spec).  ``spectral`` overrides with an
        # explicit (head, tail) SpectralSpec pair.
        if spectral is not None:
            self.spec_head, self.spec_tail = spectral
        else:
            self.spec_head = resolve_spectral_spec(2 * self.block)
            self.spec_tail = resolve_spectral_spec(2 * self.super_block)
        self.specs = (self.spec_head, self.spec_tail)
        head, tail = _split_ir(ir2, self.block, self.ratio)
        self.head_parts = 2 * self.ratio
        self.H_head = partition_ir(head, self.block, self.head_parts,
                                   spec=self.spec_head)
        if tail is None:
            tail = np.zeros((nchannels, 1))
        self.tail_parts = max(1, -(-tail.shape[1] // self.super_block))
        self.H_tail = partition_ir(tail, self.super_block, self.tail_parts,
                                   spec=self.spec_tail)
        from .fft import spectral_nbins
        F = spectral_nbins(2 * self.block, spec=self.spec_head)
        self.state = NonUniformState(
            xcarry=jnp.zeros((2, self.head_parts, nchannels, F), dtype),
            prev=jnp.zeros((2, nchannels, F), dtype),
            tail=convolver_init(nchannels, self.super_block, self.tail_parts,
                                dtype, spec=self.spec_tail),
            pending=jnp.zeros((2, nchannels, self.super_block), dtype),
        )
        self._pending_swap = None
        self._tail_swap = None  # small-block mode: tail crossfade pending
        self._sb_buf = jnp.zeros((nchannels, self.super_block), dtype)
        self._sb_fill = 0
        self._tail_steps = 0  # host mirror of tail.step (static-slot render)

    def set_filter(self, ir, channel: int | None = None) -> None:
        """Click-free IR exchange starting at the next (super-)block.

        ``channel=None`` replaces all channels; otherwise one channel's IR
        (parity with :class:`BlockConvolver`; the reference Convolver
        assigns IRs per channel, ref: README:43-44).
        """
        if channel is None:
            ir2 = np.atleast_2d(np.asarray(ir))
            if ir2.shape[0] == 1 and self.nchannels > 1:
                ir2 = np.broadcast_to(ir2, (self.nchannels, ir2.shape[1]))
            head, tail = _split_ir(ir2, self.block, self.ratio)
            if tail is None:
                tail = np.zeros((self.nchannels, 1))
            self._pending_swap = (
                partition_ir(head, self.block, self.head_parts,
                             spec=self.spec_head),
                partition_ir(tail, self.super_block, self.tail_parts,
                             spec=self.spec_tail),
            )
        else:
            head, tail = _split_ir(np.asarray(ir), self.block, self.ratio)
            if tail is None:
                tail = np.zeros((1, 1))
            Hh_one = partition_ir(head, self.block, self.head_parts,
                                  spec=self.spec_head)
            Ht_one = partition_ir(tail, self.super_block, self.tail_parts,
                                  spec=self.spec_tail)
            bh, bt = (self._pending_swap if self._pending_swap is not None
                      else (self.H_head, self.H_tail))
            self._pending_swap = (
                bh.at[:, :, channel, :].set(Hh_one[:, :, 0, :]),
                bt.at[:, :, channel, :].set(Ht_one[:, :, 0, :]),
            )

    def process_block(self, x: jax.Array) -> jax.Array:
        """``x [C, ratio*block]`` -> convolved super-block."""
        assert x.shape[-1] == self.super_block
        assert self._sb_fill == 0, (
            "cannot mix process_block mid-way through small-block streaming"
        )
        if self._pending_swap is not None:
            Hh, Ht = self._pending_swap
            self.state, y = _super_step_crossfade(
                self.state, self.H_head, Hh, self.H_tail, Ht, x, self.block,
                self.specs
            )
            self.H_head, self.H_tail = Hh, Ht
            self._pending_swap = None
        else:
            self.state, y = _super_step(
                self.state, self.H_head, self.H_tail, x, self.block,
                self.specs
            )
        self._tail_steps += 1
        return y

    def process(self, x: jax.Array) -> jax.Array:
        """Whole-signal on-device render (T multiple of the super-block)."""
        nsuper = x.shape[-1] // self.super_block
        slot0 = (
            self._tail_steps % self.tail_parts
            if nsuper % self.tail_parts == 0 else None
        )
        self.state, y = nonuniform_render(
            self.state, self.H_head, self.H_tail, jnp.asarray(x), self.block,
            tail_slot0=slot0, specs=self.specs,
        )
        self._tail_steps += nsuper
        return y

    def process_small_block(self, x: jax.Array) -> jax.Array:
        """Low-latency streaming: one SMALL block ``[C, block]`` in/out.

        The head runs per block; the tail convolver fires once every
        ``ratio`` blocks on the accumulated super-block (its output is
        already scheduled 2*B2 samples ahead, so the every-ratio cadence
        never stalls the stream).  Interleave freely with the batched
        ``process_block`` only at super-block boundaries.
        """
        B = self.block
        assert x.shape[-1] == B
        st = self.state
        if self._pending_swap is not None:
            # head crossfades NOW (one small block); the tail crossfades at
            # its next firing — both transitions continuous
            Hh, Ht = self._pending_swap
            y_head, xcarry, prev = _head_step_single_crossfade(
                st.xcarry, st.prev, self.H_head, Hh, x, spec=self.spec_head
            )
            self.H_head = Hh
            self._tail_swap = Ht
            self._pending_swap = None
        else:
            y_head, xcarry, prev = _head_step_single(
                st.xcarry, st.prev, self.H_head, x, spec=self.spec_head
            )
        off = self._sb_fill * B
        y = y_head + jax.lax.dynamic_slice_in_dim(
            st.pending[0], off, B, axis=-1
        )
        self._sb_buf = jax.lax.dynamic_update_slice_in_dim(
            self._sb_buf, x, off, axis=-1
        )
        self._sb_fill += 1
        if self._sb_fill == self.ratio:
            if self._tail_swap is not None:
                tail, out_tail = _tail_step_xt(
                    st.tail, self._tail_swap, self._sb_buf,
                    spec=self.spec_tail, H_old=self.H_tail
                )
                self.H_tail = self._tail_swap
                self._tail_swap = None
            else:
                tail, out_tail = _tail_step_xt(
                    st.tail, self.H_tail, self._sb_buf, spec=self.spec_tail
                )
            pending = jnp.stack([st.pending[1], out_tail])
            self._sb_fill = 0
            self._tail_steps += 1
        else:
            tail, pending = st.tail, st.pending
        self.state = NonUniformState(xcarry, prev, tail, pending)
        return y

    def reset(self) -> None:
        self._sb_buf = jnp.zeros_like(self._sb_buf)
        self._sb_fill = 0
        self._tail_steps = 0
        s = self.state
        self.state = NonUniformState(
            xcarry=jnp.zeros_like(s.xcarry),
            prev=jnp.zeros_like(s.prev),
            tail=convolver_init(self.nchannels, self.super_block,
                                self.tail_parts, s.prev.dtype,
                                spec=self.spec_tail),
            pending=jnp.zeros_like(s.pending),
        )
