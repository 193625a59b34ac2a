"""Uniformly-partitioned overlap-save block convolution with click-free IR
exchange — the framework's flagship streaming engine.

The reference's BlockConvolver/Convolver sources are documented-but-absent
(ref: README:38-44; SURVEY.md §0, §2.2, §3.7); this is a batched-array
design of that capability:

* channels are a batched leading axis (one fused kernel replaces the
  reference Convolver's thread-per-channel design, ref: README:43),
* spectra are re/im PLANE arrays (``[2, ..., F]`` float32; see
  :mod:`bbcat_dsp_tpu.convolve.fft`),
* the P-deep spectral delay line is a circular buffer indexed by step —
  written with one ``dynamic_update_slice`` per block and *gathered* in
  rotated order for the MAC (no O(P) roll/copy per block; HBM traffic per
  block is exactly one read of the queue + one read of the IR spectra),
* the spectral multiply-accumulate is elementwise float32,
* IR exchange runs old and new filters in parallel for ONE block and fades
  linearly between them (BASELINE.json "click-free via fade-in/fade-out";
  contract defined in bbcat_dsp_tpu.golden.convolve) — driven host-side, so
  the steady-state step never pays for the fade branch.

State layout: queue ``[2, P, C, F]``, previous half-window spectrum
``[2, C, F]`` (windows assemble via the shift theorem — see
``fft.rfft_half_planes``), step counter.  IR spectra ``H [2, P, C, F]``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .fft import (
    SpectralSpec,
    half_engine_layout,
    half_window_signs,
    irfft_tail_planes,
    permute_half_spectrum,
    resolve_spectral_spec,
    rfft_half_planes,
    spectral_nbins,
)

__all__ = [
    "ConvolverState",
    "partition_ir",
    "convolver_init",
    "convolver_step",
    "convolver_step_crossfade",
    "convolver_render",
    "BlockConvolver",
]


class ConvolverState(NamedTuple):
    """Streaming state (the checkpointable pytree, SURVEY.md §5): spectral
    input queue (re/im planes), the previous block's half-window spectrum,
    block counter."""

    queue: jax.Array  # [2, P, C, F] float — spectra of past input windows
    prev: jax.Array   # [2, C, F] float — half-window spectrum of the
                      # previous input block (window assembly via the
                      # shift theorem; see fft.rfft_half_planes)
    step: jax.Array   # int32 — blocks processed (queue write cursor)


def partition_ir(ir: np.ndarray, block: int, nparts: int | None = None,
                 spec: SpectralSpec | None = None) -> jax.Array:
    """Partition + transform an IR to spectra ``[2, P, C, F]``.

    ``ir`` is ``[C, N]`` (or ``[N]`` for one channel).  Each partition of
    ``block`` taps is zero-padded to ``2*block`` and rFFT'd
    (SURVEY.md §3.7).  Computed in float64 on the host, shipped float32,
    in the half-window engine's spectral layout for this size (the frozen
    ``spec`` when given, else ``fft.half_engine_layout`` — permuted bin
    order for large dftmm sizes, where it removes the four-step
    transposes).
    """
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    C, N = ir.shape
    P = max(1, -(-N // block))
    if nparts is not None:
        if nparts < P:
            raise ValueError(f"IR needs {P} partitions, got nparts={nparts}")
        P = nparts
    padded = np.zeros((C, P * block), np.float64)
    padded[:, :N] = ir
    parts = padded.reshape(C, P, block)
    sp = np.fft.rfft(np.concatenate([parts, np.zeros_like(parts)], -1), axis=-1)
    layout = spec.layout if spec else half_engine_layout(2 * block)
    if layout == "perm":
        sp = permute_half_spectrum(sp, 2 * block,
                                   radix=spec.radix if spec else None)
    sp = np.moveaxis(sp, 1, 0)  # [P, C, F]
    return jnp.asarray(
        np.stack([sp.real, sp.imag]).astype(np.float32)
    )  # [2, P, C, F]


def convolver_init(
    nchannels: int, block: int, nparts: int, dtype=jnp.float32,
    spec: SpectralSpec | None = None,
) -> ConvolverState:
    F = spectral_nbins(2 * block, spec=spec)
    return ConvolverState(
        queue=jnp.zeros((2, nparts, nchannels, F), dtype),
        prev=jnp.zeros((2, nchannels, F), dtype),
        step=jnp.zeros((), jnp.int32),
    )


def _roll_slots(a: jax.Array, shift: int, axis: int = 1) -> jax.Array:
    """Static circular roll: ``out[s] = a[(s + shift) % n]`` along ``axis``.

    Two contiguous slices + concat — never a gather, so a host-known
    cursor costs no traced-index permutation of the spectral queue."""
    n = a.shape[axis]
    shift %= n
    if shift == 0:
        return a
    lo = jax.lax.slice_in_dim(a, 0, shift, axis=axis)
    hi = jax.lax.slice_in_dim(a, shift, n, axis=axis)
    return jnp.concatenate([hi, lo], axis=axis)


def _push(state: ConvolverState, x: jax.Array,
          spec: SpectralSpec | None = None):
    """Half-window rFFT, window assembly, circular queue write, rotated
    gather.

    The window spectrum is ``Xhalf_prev + (-1)^k * Xhalf_cur`` (shift
    theorem) so only the B NEW samples are transformed.  Returns
    ``(new_queue, q_rot, xtilde)`` where ``q_rot[:, p]`` is the spectrum of
    input block ``step - p`` and ``xtilde`` the current half spectrum (the
    next state's ``prev``).
    """
    _, P, C, F = state.queue.shape
    B = x.shape[-1]
    xt = rfft_half_planes(x, 2 * B, spec=spec)  # [2, C, F]
    s = jnp.asarray(half_window_signs(2 * B, spec=spec))
    X = state.prev + s * xt
    slot = jnp.mod(state.step, P)
    queue = jax.lax.dynamic_update_slice(
        state.queue, X[:, None].astype(state.queue.dtype), (0, slot, 0, 0)
    )
    idx = jnp.mod(slot - jnp.arange(P), P)
    return queue, queue[:, idx], xt


def _mac(q_rot: jax.Array, H: jax.Array) -> jax.Array:
    """acc[c,f] = sum_p q[p,c,f] * h[p,c,f] (complex, via planes)."""
    re = jnp.sum(q_rot[0] * H[0] - q_rot[1] * H[1], axis=0)
    im = jnp.sum(q_rot[0] * H[1] + q_rot[1] * H[0], axis=0)
    return jnp.stack([re, im], axis=0)  # [2, C, F]


@partial(jax.jit, static_argnames=("spec",))
def convolver_step(state: ConvolverState, H: jax.Array, x: jax.Array,
                   spec: SpectralSpec | None = None):
    """One block: ``x [C, B]`` in, ``y [C, B]`` out (SURVEY.md §3.7 flow)."""
    B = x.shape[-1]
    queue, q_rot, xt = _push(state, x, spec)
    y = irfft_tail_planes(_mac(q_rot, H), 2 * B, spec=spec).astype(x.dtype)
    return ConvolverState(queue, xt, state.step + 1), y


@partial(jax.jit, static_argnames=("spec",))
def convolver_step_crossfade(
    state: ConvolverState, H_old: jax.Array, H_new: jax.Array, x: jax.Array,
    spec: SpectralSpec | None = None,
):
    """Filter-exchange block: both filters run on the SAME spectral queue and
    the outputs fade linearly (r[n] = (n+1)/B) — the golden-model crossfade
    contract."""
    B = x.shape[-1]
    queue, q_rot, xt = _push(state, x, spec)
    y_old = irfft_tail_planes(_mac(q_rot, H_old), 2 * B, spec=spec)
    y_new = irfft_tail_planes(_mac(q_rot, H_new), 2 * B, spec=spec)
    ramp = (jnp.arange(B, dtype=x.dtype) + 1) / B
    y = ((1 - ramp) * y_old + ramp * y_new).astype(x.dtype)
    return ConvolverState(queue, xt, state.step + 1), y


@partial(jax.jit, static_argnames=("block", "slot0", "spec"),
         donate_argnums=(0,))
def convolver_render(state: ConvolverState, H: jax.Array, x: jax.Array,
                     block: int, slot0: int | None = None,
                     spec: SpectralSpec | None = None):
    """Render a long ``[C, T]`` signal as ONE batched window FIR.

    Within a render the spectral delay line is just input history, so all
    ``n`` blocks transform in one batched rFFT and the MAC becomes P
    shifted elementwise multiply-adds over ``[n, C, F]`` — no per-block
    scan.  Replaces both the dynamic-gather scan and the unrolled
    static-slot variant (whose fully-unrolled program compiled slowly at
    large P).  State stays slot-encoded and
    interchangeable with the streaming :func:`convolver_step`.

    ``slot0`` (``state.step % P``, when the caller tracks it host-side)
    makes the queue read AND writeback static rolls — two contiguous
    slices instead of a traced-index permutation of the whole queue.
    """
    C, T = x.shape
    B = block
    n = T // B
    P = state.queue.shape[1]

    xb = jnp.moveaxis(x.reshape(C, n, B), 1, 0)           # [n, C, B]
    xt = rfft_half_planes(xb, 2 * B, spec=spec)           # [2, n, C, F]
    s = jnp.asarray(half_window_signs(2 * B, spec=spec))
    ext = jnp.concatenate([state.prev[:, None], xt], axis=1)
    X = ext[:, :-1] + s * ext[:, 1:]                      # [2, n, C, F]

    # past P window spectra in chronological order (oldest..newest):
    # the window written at step-P+k sits in slot (step+k) mod P
    if slot0 is not None:
        past = _roll_slots(state.queue, slot0)
    else:
        idx = jnp.mod(state.step + jnp.arange(P), P)
        past = state.queue[:, idx]
    Xext = jnp.concatenate([past, X], axis=1)             # [2, P+n, C, F]

    acc_r = jnp.zeros((n,) + X.shape[2:], x.dtype)
    acc_i = jnp.zeros_like(acc_r)
    for p in range(P):
        xr = jax.lax.slice_in_dim(Xext[0], P - p, P - p + n, axis=0)
        xi = jax.lax.slice_in_dim(Xext[1], P - p, P - p + n, axis=0)
        hr = H[0, p]
        hi = H[1, p]
        acc_r = acc_r + (xr * hr - xi * hi)
        acc_i = acc_i + (xr * hi + xi * hr)

    y2 = irfft_tail_planes(jnp.stack([acc_r, acc_i]), 2 * B,
                           spec=spec)                     # [n, C, B]
    y = jnp.moveaxis(y2, 0, 1).reshape(C, T).astype(x.dtype)

    # write the last P windows back in slot encoding
    if slot0 is not None:
        # lastP[j] = window at step step+n-P+j -> slot (slot0+n+j) % P
        lastP = jax.lax.slice_in_dim(Xext, n, n + P, axis=1)
        queue = _roll_slots(
            lastP, (P - (slot0 + n) % P) % P
        ).astype(state.queue.dtype)
    else:
        queue = state.queue
        for p in range(P):
            slot = jnp.mod(state.step + n - 1 - p, P)
            w = jax.lax.dynamic_slice_in_dim(Xext, P + n - 1 - p, 1, axis=1)
            queue = jax.lax.dynamic_update_slice(
                queue, w.astype(queue.dtype), (0, slot, 0, 0))
    return ConvolverState(queue, xt[:, -1], state.step + n), y


class BlockConvolver:
    """Stateful streaming wrapper: multi-channel partitioned convolver with
    host-driven click-free IR swapping.

    For one channel pass ``ir`` of shape ``[N]``; for C independent channels
    ``[C, N]`` (the reference's multi-channel Convolver orchestration,
    ref: README:43-44, collapses into this single batched kernel).
    """

    def __init__(self, ir, block: int, nchannels: int | None = None,
                 nparts: int | None = None, dtype=jnp.float32,
                 spectral: SpectralSpec | None = None):
        ir2 = np.atleast_2d(np.asarray(ir))
        if nchannels is None:
            nchannels = ir2.shape[0]
        if ir2.shape[0] == 1 and nchannels > 1:
            ir2 = np.broadcast_to(ir2, (nchannels, ir2.shape[1]))
        self.block = int(block)
        # FREEZE the spectral configuration now (backend/layout/radix/
        # cmatmul): env toggles are read exactly once, and a permuted
        # resolution probes that its program builds BEFORE sizing spectral
        # state (falls back to std with a warning if it doesn't).  A later
        # env change cannot alter this engine's traced program.
        self.spectral = (spectral if spectral is not None
                         else resolve_spectral_spec(2 * self.block))
        self.H = partition_ir(ir2, self.block, nparts, spec=self.spectral)
        self.nparts = self.H.shape[1]
        self.nchannels = nchannels
        self.state = convolver_init(nchannels, self.block, self.nparts,
                                    dtype, spec=self.spectral)
        self._pending_H = None
        self._steps = 0  # host mirror of state.step (static-slot render)

    def set_filter(self, ir, channel: int | None = None) -> None:
        """Schedule a click-free IR exchange at the next block.

        ``channel=None`` replaces all channels' IRs (``ir`` shaped like the
        constructor's); otherwise replaces one channel's IR.
        """
        if channel is None:
            ir2 = np.atleast_2d(np.asarray(ir))
            if ir2.shape[0] == 1 and self.nchannels > 1:
                ir2 = np.broadcast_to(ir2, (self.nchannels, ir2.shape[1]))
            newH = partition_ir(ir2, self.block, self.nparts,
                                spec=self.spectral)
        else:
            one = partition_ir(np.asarray(ir), self.block, self.nparts,
                               spec=self.spectral)
            base = self._pending_H if self._pending_H is not None else self.H
            newH = base.at[:, :, channel, :].set(one[:, :, 0, :])
        self._pending_H = newH

    def process_block(self, x: jax.Array) -> jax.Array:
        """``x [C, B]`` (or ``[B]`` for mono) -> convolved block."""
        self._steps += 1
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if self._pending_H is not None:
            self.state, y = convolver_step_crossfade(
                self.state, self.H, self._pending_H, x, spec=self.spectral
            )
            self.H = self._pending_H
            self._pending_H = None
        else:
            self.state, y = convolver_step(self.state, self.H, x,
                                           spec=self.spectral)
        return y[0] if squeeze else y

    def process(self, x: jax.Array) -> jax.Array:
        """Whole-signal render ``[C, T]`` (T multiple of block) on device."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        nblocks = x.shape[-1] // self.block
        slot0 = (self._steps % self.nparts
                 if nblocks % self.nparts == 0 else None)
        self.state, y = convolver_render(
            self.state, self.H, x, self.block, slot0=slot0,
            spec=self.spectral
        )
        self._steps += nblocks
        return y[0] if squeeze else y

    def reset(self) -> None:
        self._steps = 0
        self.state = convolver_init(
            self.nchannels, self.block, self.nparts, self.state.prev.dtype,
            spec=self.spectral
        )
