"""Composed stream pipelines for the remaining BASELINE configs.

* :class:`EQDelayPipeline` — config #2: 8-stage biquad EQ over 8-channel
  48 kHz audio + per-channel fractional delay.
* :class:`MixdownPipeline` — config #4: 128-channel stream -> format
  conversion, gain-matrix mixdown (matmul), BS.1770 loudness on the mix.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..buffers.ring import Ring, ring_init, ring_write
from ..filters.fractional import ADDITIONAL_DELAY, fractional_read, fractional_read_stream
from ..filters.iir import (
    modal_apply,
    modal_init,
    modal_params,
    parallel_cascade_apply,
    parallel_cascade_params,
)
from ..formats.device import int32_to_float, float_to_int32
from ..formats.sample_format import SampleFormat, is_sample_integer
from ..loudness import LoudnessMeter

__all__ = ["EQDelayPipeline", "MixdownPipeline"]


class EQDelayState(NamedTuple):
    eq: tuple       # per-stage ModalState
    ring: Ring      # fractional-delay ring [C, L]


class EQDelayPipeline:
    """8-stage EQ cascade + fractional delay per channel (config #2).

    The fractional delay uses the reference's exact 14x128 polyphase table
    (ref: src/FractionalSample.cpp) reading ``delay`` frames behind the
    write head; the headroom contract adds 14 frames
    (ref: FractionalSampleAdditionalDelayRequired).
    """

    def __init__(self, eq_coeffs, nchannels: int, block: int,
                 max_delay: float, fs: float = 48000.0, dtype=jnp.float32):
        eq_coeffs = np.atleast_2d(np.asarray(eq_coeffs))
        self.block = int(block)
        self.fs = fs
        # the whole static EQ cascade runs as ONE batched scan when the
        # parallel (partial-fraction) form is well-conditioned; otherwise
        # per-stage serial modal scans
        try:
            self.psos = parallel_cascade_params(eq_coeffs, dtype)
            self.params = None
        except ValueError:
            self.psos = None
            self.params = tuple(modal_params(c, dtype) for c in eq_coeffs)
        L = int(np.ceil(max_delay)) + ADDITIONAL_DELAY + self.block
        # ring length aligned up for cheap modular arithmetic
        self.length = 1 << int(np.ceil(np.log2(max(L, 2))))
        if self.params is None:
            from ..filters.iir import ParallelCascadeState
            K = self.psos.pr.shape[0]
            z = jnp.zeros((K, nchannels), dtype)
            eq0 = ParallelCascadeState(z, z)
        else:
            eq0 = tuple(modal_init(p, (nchannels,), dtype)
                        for p in self.params)
        self.state = EQDelayState(
            eq=eq0,
            ring=ring_init((nchannels,), self.length, dtype),
        )
        self._step = jax.jit(self._step_impl, static_argnames=("per_sample",))

    def _step_impl(self, state: EQDelayState, x: jax.Array,
                   delays: jax.Array, per_sample: bool):
        if self.psos is not None:
            y, new_eq = parallel_cascade_apply(x, self.psos, state.eq)
        else:
            y = x
            new_eq = []
            for p, s in zip(self.params, state.eq):
                y, s2 = modal_apply(y, p, s)
                new_eq.append(s2)
            new_eq = tuple(new_eq)
        ring = ring_write(state.ring, y)
        B = x.shape[-1]
        # ring offset of this block's first sample, reduced modulo the
        # ring in int32 BEFORE meeting the float delays: the write counter
        # grows without bound, and in float32 a large counter would round
        # away the delay's fractional part (the polyphase phase)
        wp0 = jnp.mod(ring.writepos - B, self.length)
        if per_sample:
            # per-sample delay modulation (doppler): general gather read
            wp = wp0 + jnp.arange(B)
            pos = (wp[None, :] - delays + self.length) % self.length
            out = fractional_read(ring.data, pos)
        else:
            # constant per-channel delay: gather-free fixed-phase FIR
            start = (wp0 - delays[:, 0] + 2 * self.length) % self.length
            out = fractional_read_stream(ring.data, start, B)
        return EQDelayState(eq=new_eq, ring=ring), out

    def process_block(self, x: jax.Array, delays) -> jax.Array:
        """``x [C, B]``, ``delays`` [C] (constant, fast FIR path) or
        ``[C, B]`` (per-sample modulation, gather path)."""
        delays = jnp.asarray(delays)
        per_sample = delays.ndim > 1
        if not per_sample:
            delays = delays[:, None]
        self.state, y = self._step(self.state, x, delays, per_sample)
        return y


class MixdownPipeline:
    """Format conversion + gain-matrix mixdown + loudness (config #4).

    Input: ``[C_in, B]`` samples in any normalized sample format (int32
    MSB-aligned or float); gains ``[C_out, C_in]`` mix to the output bus as
    one matmul; BS.1770 loudness runs on the mix.
    """

    def __init__(self, gains, fs: float = 48000.0,
                 in_format: SampleFormat = SampleFormat.FLOAT,
                 out_format: SampleFormat = SampleFormat.FLOAT,
                 dtype=jnp.float32):
        self.gains = jnp.asarray(gains, dtype)
        self.in_format = in_format
        self.out_format = out_format
        self.meter = LoudnessMeter(self.gains.shape[0], fs)
        self._buf = np.zeros((self.gains.shape[0], 0), np.float32)

        @jax.jit
        def step(g, x):
            if is_sample_integer(in_format):
                x = int32_to_float(x)
            y = jnp.matmul(g, x, precision=jax.lax.Precision.HIGHEST)
            if is_sample_integer(out_format):
                return float_to_int32(y)
            return y

        self._step = step

    def process_block(self, x: jax.Array) -> jax.Array:
        y = self._step(self.gains, x)
        yf = int32_to_float(y) if is_sample_integer(self.out_format) else y
        self._buf = np.concatenate(
            [self._buf, np.asarray(yf, np.float32)], -1
        )
        step = self.meter.step
        n = (self._buf.shape[-1] // step) * step
        if n:
            self.meter.process(jnp.asarray(self._buf[:, :n]))
            self._buf = self._buf[:, n:]
        return y

    def integrated_loudness(self) -> float:
        return self.meter.integrated()
