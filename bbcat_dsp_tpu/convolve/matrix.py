"""Matrix (MIMO / HRTF) partitioned convolution: C_in -> C_out.

Covers the reference Convolver's binaural/HRTF use case — every input
channel convolved with a per-(input, output) IR and summed into each output
(ref: README:43-44 "multi-channel parallelized convolution"; BASELINE.json
config #3: 64-in x 2-out with click-free IR swap).

The per-block mix-down  Y[o,f] = sum_{p,i} Q[p,i,f] * H[p,i,o,f]  is a
contraction over (partitions x inputs) — done as four real einsums on the
re/im planes with ``Precision.HIGHEST`` (float32 products; the operand
sizes make it bandwidth-bound, so the contraction precision is essentially
free).

Shares :class:`ConvolverState` (queue is per-INPUT-channel) and the
crossfade contract with :mod:`bbcat_dsp_tpu.convolve.block`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

from .fft import SpectralSpec, irfft_tail_planes, resolve_spectral_spec
from .block import ConvolverState, convolver_init, _push, _roll_slots

__all__ = [
    "partition_ir_matrix",
    "matrix_render",
    "matrix_step",
    "matrix_step_crossfade",
    "MatrixConvolver",
]

_PREC = jax.lax.Precision.HIGHEST


def partition_ir_matrix(ir: np.ndarray, block: int, nparts: int | None = None,
                        spec: SpectralSpec | None = None) -> jax.Array:
    """``ir [C_in, C_out, N]`` -> spectra ``[2, P, C_in, C_out, F]``."""
    ir = np.asarray(ir, np.float64)
    ci, co, N = ir.shape
    P = max(1, -(-N // block))
    if nparts is not None:
        if nparts < P:
            raise ValueError(f"IR needs {P} partitions, got nparts={nparts}")
        P = nparts
    padded = np.zeros((ci, co, P * block), np.float64)
    padded[..., :N] = ir
    parts = padded.reshape(ci, co, P, block)
    sp = np.fft.rfft(np.concatenate([parts, np.zeros_like(parts)], -1), axis=-1)
    from .fft import half_engine_layout, permute_half_spectrum
    layout = spec.layout if spec else half_engine_layout(2 * block)
    if layout == "perm":
        sp = permute_half_spectrum(sp, 2 * block,
                                   radix=spec.radix if spec else None)
    sp = np.moveaxis(sp, 2, 0)  # [P, ci, co, F]
    return jnp.asarray(np.stack([sp.real, sp.imag]).astype(np.float32))


def _mix(q_rot: jax.Array, H: jax.Array) -> jax.Array:
    """Y[o,f] = sum_{p,i} Q[p,i,f] H[p,i,o,f] on re/im planes."""
    def e(a, b):
        return jnp.einsum("pif,piof->of", a, b, precision=_PREC)

    re = e(q_rot[0], H[0]) - e(q_rot[1], H[1])
    im = e(q_rot[0], H[1]) + e(q_rot[1], H[0])
    return jnp.stack([re, im], axis=0)


@partial(jax.jit, static_argnames=("spec",))
def matrix_step(state: ConvolverState, H: jax.Array, x: jax.Array,
                spec: SpectralSpec | None = None):
    """One block: ``x [C_in, B]`` -> ``y [C_out, B]``."""
    B = x.shape[-1]
    queue, q_rot, xt = _push(state, x, spec)
    y = irfft_tail_planes(_mix(q_rot, H), 2 * B, spec=spec).astype(x.dtype)
    return ConvolverState(queue, xt, state.step + 1), y


@partial(jax.jit, static_argnames=("spec",))
def matrix_step_crossfade(
    state: ConvolverState, H_old: jax.Array, H_new: jax.Array, x: jax.Array,
    spec: SpectralSpec | None = None,
):
    B = x.shape[-1]
    queue, q_rot, xt = _push(state, x, spec)
    y_old = irfft_tail_planes(_mix(q_rot, H_old), 2 * B, spec=spec)
    y_new = irfft_tail_planes(_mix(q_rot, H_new), 2 * B, spec=spec)
    ramp = (jnp.arange(B, dtype=x.dtype) + 1) / B
    y = ((1 - ramp) * y_old + ramp * y_new).astype(x.dtype)
    return ConvolverState(queue, xt, state.step + 1), y


@partial(jax.jit, static_argnames=("block", "slot0", "spec"),
         donate_argnums=(0,))
def matrix_render(state: ConvolverState, H: jax.Array, x: jax.Array,
                  block: int, slot0: int | None = None,
                  spec: SpectralSpec | None = None):
    """Render ``[C_in, T]`` -> ``[C_out, T]`` as ONE batched window FIR.

    Within a render there is no sequential dependency — the spectral delay
    line is just input history — so all ``n`` blocks transform in one
    batched rFFT and the per-block mix-down becomes P shifted einsums:
    ``Y[j] = sum_p Xwin[j-p] (x) H[p]`` (the same restructuring as the
    non-uniform head, :mod:`bbcat_dsp_tpu.convolve.nonuniform`).  A
    per-block ``lax.scan`` pays ~20 XLA ops/block of pure dispatch at
    config #3's tiny shapes; this path is ~5x fewer ops total.
    State semantics (slot-encoded queue, prev half-spectrum, step) stay
    interchangeable with the streaming :func:`matrix_step`.
    """
    from .fft import half_window_signs, rfft_half_planes

    Ci, T = x.shape
    B = block
    n = T // B
    _, P, _, F = state.queue.shape
    xb = jnp.moveaxis(x.reshape(Ci, n, B), 1, 0)          # [n, Ci, B]
    xt = rfft_half_planes(xb, 2 * B, spec=spec)           # [2, n, Ci, F]
    s = jnp.asarray(half_window_signs(2 * B, spec=spec))
    ext = jnp.concatenate([state.prev[:, None], xt], axis=1)
    X = ext[:, :-1] + s * ext[:, 1:]                      # [2, n, Ci, F]

    # past P window spectra in chronological order (oldest..newest):
    # window written at step-P+k sits in slot (step+k) mod P; a host-known
    # slot0 (= step % P) makes the permutation a static roll (no gather)
    if slot0 is not None:
        past = _roll_slots(state.queue, slot0)            # [2, P, Ci, F]
    else:
        idx = jnp.mod(state.step + jnp.arange(P), P)
        past = state.queue[:, idx]                        # [2, P, Ci, F]
    Xext = jnp.concatenate([past, X], axis=1)             # [2, P+n, Ci, F]

    def e(a, b):
        return jnp.einsum("nif,iof->nof", a, b, precision=_PREC)

    acc_r = jnp.zeros((n, H.shape[3], F), x.dtype)
    acc_i = jnp.zeros((n, H.shape[3], F), x.dtype)
    for p in range(P):
        xr = jax.lax.slice_in_dim(Xext[0], P - p, P - p + n, axis=0)
        xi = jax.lax.slice_in_dim(Xext[1], P - p, P - p + n, axis=0)
        acc_r = acc_r + e(xr, H[0, p]) - e(xi, H[1, p])
        acc_i = acc_i + e(xr, H[1, p]) + e(xi, H[0, p])

    y2 = irfft_tail_planes(jnp.stack([acc_r, acc_i]), 2 * B,
                           spec=spec)                     # [n, Co, B]
    y = jnp.moveaxis(y2, 0, 1).reshape(-1, T).astype(x.dtype)

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


class MatrixConvolver:
    """Streaming C_in -> C_out convolver with click-free IR-matrix swap
    (BASELINE.json config #3)."""

    def __init__(self, ir_matrix, block: int, nparts: int | None = None,
                 dtype=jnp.float32, spectral: SpectralSpec | None = None):
        ir_matrix = np.asarray(ir_matrix)
        self.block = int(block)
        # freeze layout/radix/cmatmul/kernel gates at construction (env
        # read once; probes the layout builds — see fft.resolve_spectral_spec)
        self.spectral = (spectral if spectral is not None
                         else resolve_spectral_spec(2 * self.block))
        self.H = partition_ir_matrix(ir_matrix, self.block, nparts,
                                     spec=self.spectral)
        _, self.nparts, self.c_in, self.c_out, _ = self.H.shape
        self.state = convolver_init(self.c_in, self.block, self.nparts,
                                    dtype, spec=self.spectral)
        self._pending_H = None
        self._steps = 0  # host mirror of state.step (static-slot render)

    def set_filter_matrix(self, ir_matrix, in_channel: int | None = None) -> None:
        """Schedule a click-free IR-matrix exchange; ``in_channel`` limits
        the swap to one input channel's ``[C_out, N]`` IRs (per-channel IR
        assignment, ref: README:43-44)."""
        if in_channel is None:
            self._pending_H = partition_ir_matrix(
                np.asarray(ir_matrix), self.block, self.nparts,
                spec=self.spectral
            )
        else:
            one = partition_ir_matrix(
                np.asarray(ir_matrix)[None], self.block, self.nparts,
                spec=self.spectral
            )
            base = self._pending_H if self._pending_H is not None else self.H
            self._pending_H = base.at[:, :, in_channel].set(one[:, :, 0])

    def process_block(self, x: jax.Array) -> jax.Array:
        if self._pending_H is not None:
            self.state, y = matrix_step_crossfade(
                self.state, self.H, self._pending_H, x, spec=self.spectral
            )
            self.H = self._pending_H
            self._pending_H = None
        else:
            self.state, y = matrix_step(self.state, self.H, x,
                                        spec=self.spectral)
        self._steps += 1
        return y

    def process(self, x: jax.Array) -> jax.Array:
        """Whole-signal render (T multiple of block) on device."""
        nblocks = x.shape[-1] // self.block
        slot0 = (self._steps % self.nparts
                 if nblocks % self.nparts == 0 else None)
        self.state, y = matrix_render(self.state, self.H, x, self.block,
                                      slot0=slot0, spec=self.spectral)
        self._steps += nblocks
        return y

    def reset(self) -> None:
        self._steps = 0
        self.state = convolver_init(
            self.c_in, self.block, self.nparts, self.state.prev.dtype,
            spec=self.spectral
        )
