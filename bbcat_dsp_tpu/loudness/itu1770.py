"""ITU-R BS.1770-4 multichannel loudness on device.

Reference capability: ITU1770MultiChannelLoudness (documented-absent,
ref: README:65-66; required by BASELINE.json config #4 — 128-channel
streams).  Device design:

* K-weighting = the two standard biquads run through the high-precision
  modal IIR engine (:mod:`bbcat_dsp_tpu.filters.iir`), batched over
  channels; coefficients designed on host in float64
  (:func:`bbcat_dsp_tpu.golden.loudness.k_weighting_coeffs` — matches the
  BS.1770-4 Annex 1 tables at 48 kHz).
* 400 ms gating blocks with 75 % overlap via a cumulative-sum-of-squares
  difference — O(T) instead of O(T * overlap) windowing.
* Gating (absolute -70 LKFS, relative -10 LU) with fixed-shape masked
  reductions — jit-friendly, no data-dependent shapes.
* Streaming: :class:`LoudnessMeter` carries filter states, a short power
  ring for momentary/short-term, and (count, sum) accumulators per 0.1 LU
  histogram bin for gated integrated loudness over unbounded streams —
  the reference's own Histogram component (ref: src/Histogram.h) applied
  exactly where the standard needs it.

Distributed: per-channel mean-squares are local; the weighted channel sum
is a ``psum`` over a channel-sharded mesh (SURVEY.md §5).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..filters.iir import ModalState, modal_apply, modal_init, modal_params
from ..golden.loudness import (
    ABSOLUTE_GATE_LKFS,
    CHANNEL_WEIGHTS_5_1,
    RELATIVE_GATE_LU,
    k_weighting_coeffs,
)

__all__ = [
    "default_channel_weights",
    "k_weight_params",
    "k_weight",
    "block_powers",
    "integrated_loudness",
    "LoudnessMeter",
]

_OFFSET = -0.691


def default_channel_weights(nchannels: int) -> np.ndarray:
    """BS.1770-4 Table 3 weights for <=5 channels (L R C Ls Rs), unity
    beyond (multichannel bus convention)."""
    if nchannels <= 5:
        return np.asarray(CHANNEL_WEIGHTS_5_1[:nchannels])
    return np.ones(nchannels, np.float64)


def k_weight_params(fs: float, dtype=jnp.float32):
    """The two K-weighting biquads as ModalParams (shelf, RLB)."""
    shelf, rlb = k_weighting_coeffs(fs)
    return modal_params(shelf, dtype), modal_params(rlb, dtype)


def k_weight(x: jax.Array, fs: float, states=None):
    """Apply K-weighting to ``x[..., T]``.  Returns ``(y, states)``."""
    p_shelf, p_rlb = k_weight_params(fs, x.dtype)
    if states is None:
        states = (modal_init(p_shelf, x.shape[:-1], x.dtype),
                  modal_init(p_rlb, x.shape[:-1], x.dtype))
    y, s1 = modal_apply(x, p_shelf, states[0])
    y, s2 = modal_apply(y, p_rlb, states[1])
    return y, (s1, s2)


@partial(jax.jit, static_argnames=("blk", "step"))
def _block_mean_squares(y: jax.Array, blk: int, step: int) -> jax.Array:
    """Per-channel mean square over sliding gating blocks via cumsum diff.
    ``y [C, T]`` -> ``[C, nblocks]``."""
    cs = jnp.cumsum(jnp.square(y).astype(jnp.float32), axis=-1)
    cs = jnp.concatenate([jnp.zeros_like(cs[..., :1]), cs], axis=-1)
    T = y.shape[-1]
    nblocks = (T - blk) // step + 1
    starts = jnp.arange(nblocks) * step
    return (cs[..., starts + blk] - cs[..., starts]) / blk


def block_powers(x: jax.Array, fs: float, weights=None, states=None):
    """Weighted gating-block powers z_j over ``x [C, T]``.

    Returns ``(z [nblocks], states)``; loudness l_j = -0.691 + 10log10(z_j).
    """
    C = x.shape[0]
    if weights is None:
        weights = default_channel_weights(C)
    w = jnp.asarray(weights, x.dtype)
    y, states = k_weight(x, fs, states)
    blk = int(round(0.400 * fs))
    step = int(round(0.100 * fs))
    ms = _block_mean_squares(y, blk, step)  # [C, nblocks]
    return jnp.sum(w[:, None] * ms, axis=0), states


@jax.jit
def _gated_mean(z: jax.Array) -> jax.Array:
    """BS.1770-4 two-stage gated mean of block powers (masked, fixed
    shape)."""
    l = _OFFSET + 10.0 * jnp.log10(jnp.maximum(z, 1e-30))
    abs_mask = l > ABSOLUTE_GATE_LKFS
    n_abs = jnp.maximum(jnp.sum(abs_mask), 1)
    z_abs = jnp.sum(jnp.where(abs_mask, z, 0.0)) / n_abs
    rel_thresh = _OFFSET + 10.0 * jnp.log10(jnp.maximum(z_abs, 1e-30)) + RELATIVE_GATE_LU
    mask = abs_mask & (l > rel_thresh)
    n = jnp.maximum(jnp.sum(mask), 1)
    zg = jnp.sum(jnp.where(mask, z, 0.0)) / n
    return jnp.where(
        jnp.any(mask),
        _OFFSET + 10.0 * jnp.log10(jnp.maximum(zg, 1e-30)),
        -jnp.inf,
    )


def integrated_loudness(x: jax.Array, fs: float, weights=None) -> jax.Array:
    """One-shot gated integrated loudness (LKFS) of ``x [C, T]``."""
    z, _ = block_powers(x, fs, weights)
    return _gated_mean(z)


class MeterState(NamedTuple):
    """Streaming loudness state pytree (checkpointable, SURVEY.md §5)."""

    shelf: ModalState
    rlb: ModalState
    sq_tail: jax.Array    # [C, blk-step] trailing squared samples (K-weighted)
    hist_count: jax.Array  # [nbins] gating-block counts per 0.1 LU bin
    hist_sum: jax.Array    # [nbins] sum of z per bin
    momentary_z: jax.Array  # [] last gating-block power
    short_ring: jax.Array   # [30] last 3 s of 100 ms powers
    st_count: jax.Array     # [nbins] short-term loudness histogram (counts)
    st_sum: jax.Array       # [nbins] short-term power sums (for LRA gating)
    nblocks: jax.Array      # [] int32


class LoudnessMeter:
    """Streaming BS.1770-4 meter: momentary (400 ms), short-term (3 s) and
    gated integrated loudness over unbounded streams.

    Integrated gating uses per-0.1-LU (count, sum) histogram accumulators —
    the streaming-exact formulation of the two-stage gate (bin-width
    quantisation only affects which blocks sit at the threshold edge).
    """

    HIST_MIN, HIST_MAX, HIST_STEP = -90.0, 10.0, 0.1

    def __init__(self, nchannels: int, fs: float = 48000.0, weights=None,
                 dtype=jnp.float32):
        self.fs = fs
        self.nchannels = nchannels
        self.blk = int(round(0.400 * fs))
        self.step = int(round(0.100 * fs))
        self.weights = jnp.asarray(
            weights if weights is not None
            else default_channel_weights(nchannels), dtype)
        p_shelf, p_rlb = k_weight_params(fs, dtype)
        self._params = (p_shelf, p_rlb)
        nbins = int(round((self.HIST_MAX - self.HIST_MIN) / self.HIST_STEP))
        self.state = MeterState(
            shelf=modal_init(p_shelf, (nchannels,), dtype),
            rlb=modal_init(p_rlb, (nchannels,), dtype),
            sq_tail=jnp.zeros((nchannels, self.blk - self.step), dtype),
            hist_count=jnp.zeros((nbins,), jnp.int32),
            hist_sum=jnp.zeros((nbins,), jnp.float32),
            momentary_z=jnp.zeros((), jnp.float32),
            short_ring=jnp.zeros((30,), jnp.float32),
            st_count=jnp.zeros((nbins,), jnp.int32),
            st_sum=jnp.zeros((nbins,), jnp.float32),
            nblocks=jnp.zeros((), jnp.int32),
        )
        self._ingest = self._build_ingest()

    def _build_ingest(self):
        blk, step, w = self.blk, self.step, self.weights
        p_shelf, p_rlb = self._params
        hmin, hstep = self.HIST_MIN, self.HIST_STEP
        nbins = self.state.hist_count.shape[0]

        @jax.jit
        def ingest(state: MeterState, x: jax.Array) -> MeterState:
            y, s1 = modal_apply(x, p_shelf, state.shelf)
            y, s2 = modal_apply(y, p_rlb, state.rlb)
            sq = jnp.square(y).astype(jnp.float32)
            ext = jnp.concatenate([state.sq_tail.astype(jnp.float32), sq], -1)
            Text = ext.shape[-1]
            ncomplete = (Text - blk) // step + 1  # static
            cs = jnp.cumsum(ext, axis=-1)
            cs = jnp.concatenate([jnp.zeros_like(cs[..., :1]), cs], -1)
            starts = jnp.arange(ncomplete) * step
            ms = (cs[:, starts + blk] - cs[:, starts]) / blk  # [C, n]
            z = jnp.sum(w[:, None] * ms, axis=0)  # [n]
            # histogram accumulate; the first blk/step - 1 global blocks are
            # startup transients over the implicit silence prefix — excluded
            gidx = state.nblocks + jnp.arange(ncomplete)
            valid = gidx >= (blk // step - 1)
            l = _OFFSET + 10.0 * jnp.log10(jnp.maximum(z, 1e-30))
            bins = jnp.clip(((l - hmin) / hstep).astype(jnp.int32), 0, nbins - 1)
            keep = (l > ABSOLUTE_GATE_LKFS) & valid
            cnt = state.hist_count.at[bins].add(keep.astype(jnp.int32))
            sm = state.hist_sum.at[bins].add(jnp.where(keep, z, 0.0))
            # short-term (3 s) loudness per new block via a sliding mean
            # over the power history; feeds the LRA histogram (EBU R128 /
            # Tech 3342 uses the short-term distribution)
            zhist = jnp.concatenate([state.short_ring, z])
            zcs = jnp.cumsum(zhist)
            zcs = jnp.concatenate([jnp.zeros((1,), zcs.dtype), zcs])
            ends = 30 + jnp.arange(ncomplete) + 1
            st_z = (zcs[ends] - zcs[ends - 30]) / 30.0
            st_l = _OFFSET + 10.0 * jnp.log10(jnp.maximum(st_z, 1e-30))
            st_valid = (gidx >= 32) & (st_l > ABSOLUTE_GATE_LKFS)
            st_bins = jnp.clip(
                ((st_l - hmin) / hstep).astype(jnp.int32), 0, nbins - 1
            )
            st_cnt = state.st_count.at[st_bins].add(
                st_valid.astype(jnp.int32))
            st_sm = state.st_sum.at[st_bins].add(
                jnp.where(st_valid, st_z, 0.0))
            # rings for momentary / short-term
            if ncomplete >= 30:
                ring = z[-30:]
            else:
                ring = jnp.roll(state.short_ring, -ncomplete)
                ring = ring.at[-ncomplete:].set(z)
            tail_len = blk - step
            consumed = ncomplete * step
            new_tail = ext[:, consumed:consumed + tail_len]
            return MeterState(
                shelf=s1, rlb=s2, sq_tail=new_tail.astype(state.sq_tail.dtype),
                hist_count=cnt, hist_sum=sm,
                momentary_z=z[-1],
                short_ring=ring,
                st_count=st_cnt,
                st_sum=st_sm,
                nblocks=state.nblocks + ncomplete,
            )

        return ingest

    # -- feeding ---------------------------------------------------------
    def process(self, x: jax.Array) -> None:
        """Ingest ``x [C, T]``; T must be a multiple of the 100 ms step for
        streaming alignment."""
        assert x.shape[-1] % self.step == 0, "feed multiples of 100 ms"
        self.state = self._ingest(self.state, x)

    # -- readouts --------------------------------------------------------
    def momentary(self) -> float:
        """Loudness of the last 400 ms gating block (LKFS)."""
        z = float(self.state.momentary_z)
        return _OFFSET + 10.0 * np.log10(max(z, 1e-30))

    def short_term(self) -> float:
        """Loudness over the last 3 s (LKFS)."""
        ring = np.asarray(self.state.short_ring)
        z = ring.mean()
        return _OFFSET + 10.0 * np.log10(max(z, 1e-30))

    def integrated(self) -> float:
        """Gated integrated loudness since reset (LKFS)."""
        cnt = np.asarray(self.state.hist_count, np.float64)
        sm = np.asarray(self.state.hist_sum, np.float64)
        n_abs = cnt.sum()
        if n_abs == 0:
            return -np.inf
        z_abs = sm.sum() / n_abs
        rel = _OFFSET + 10.0 * np.log10(max(z_abs, 1e-30)) + RELATIVE_GATE_LU
        centers = self.HIST_MIN + (np.arange(cnt.size) + 0.5) * self.HIST_STEP
        mask = centers > rel
        n = cnt[mask].sum()
        if n == 0:
            return -np.inf
        return _OFFSET + 10.0 * np.log10(max(sm[mask].sum() / n, 1e-30))

    def loudness_range(self) -> float:
        """LRA in LU (EBU R128 / Tech 3342): p95 - p10 of the gated
        short-term loudness distribution (absolute gate -70 LUFS, relative
        gate -20 LU below the power-gated mean)."""
        cnt = np.asarray(self.state.st_count, np.float64)
        sm = np.asarray(self.state.st_sum, np.float64)
        n = cnt.sum()
        if n < 2:
            return 0.0
        z_mean = sm.sum() / n
        thresh = _OFFSET + 10.0 * np.log10(max(z_mean, 1e-30)) - 20.0
        centers = self.HIST_MIN + (np.arange(cnt.size) + 0.5) * self.HIST_STEP
        gated = np.where(centers > thresh, cnt, 0.0)
        total = gated.sum()
        if total < 2:
            return 0.0
        cum = np.cumsum(gated) / total
        lo = centers[np.searchsorted(cum, 0.10)]
        hi = centers[min(np.searchsorted(cum, 0.95), cnt.size - 1)]
        return float(hi - lo)

    def reset(self) -> None:
        z = self.state
        self.state = MeterState(
            shelf=jax.tree.map(jnp.zeros_like, z.shelf),
            rlb=jax.tree.map(jnp.zeros_like, z.rlb),
            sq_tail=jnp.zeros_like(z.sq_tail),
            hist_count=jnp.zeros_like(z.hist_count),
            hist_sum=jnp.zeros_like(z.hist_sum),
            momentary_z=jnp.zeros_like(z.momentary_z),
            short_ring=jnp.zeros_like(z.short_ring),
            st_count=jnp.zeros_like(z.st_count),
            st_sum=jnp.zeros_like(z.st_sum),
            nblocks=jnp.zeros_like(z.nblocks),
        )
