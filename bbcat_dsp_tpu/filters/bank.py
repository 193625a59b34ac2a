"""Filter-bank / cascade / block APIs over the parallel IIR engine.

Functional core (state pytrees + pure ``process`` functions) plus thin
stateful wrapper classes for host streaming loops.  Maps the reference's
class surface (ref: src/BiQuad.h:247 BiQuadFilterBank, :386 BiQuadCascade;
README:35-36 BiQuadBlock) onto the scan engine in
:mod:`bbcat_dsp_tpu.filters.iir`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dwfloat import dw_add, dw_from_f64, dw_mul
from .biquad import FilterType, biquad_coeffs, cascade_response
from .iir import (
    DWCoeffs,
    biquad_apply,
    cascade_apply,
    modal_apply,
    modal_from_df2t,
    modal_params,
)

__all__ = [
    "BankState",
    "bank_init",
    "bank_set_stage",
    "bank_process",
    "BiQuadFilterBank",
    "BiQuadCascade",
    "BiQuadBlock",
]


class BankState(NamedTuple):
    """State pytree of an S-stage, C-channel biquad filter bank.

    Mirrors exactly what the reference deep-copies as resumable state
    (SURVEY.md §5 checkpoint: w-regs per stage per channel + interpolator
    current/target/diff/mul per stage; ref: src/BiQuad.cpp:502-524).
    """

    targets: jax.Array  # [S, 5] target coefficients
    origins: jax.Array  # [S, 5] coefficients when the target was set
    mul: jax.Array      # [S] shared interpolation controller (1 -> 0)
    dec: jax.Array      # [S] controller decrement per sample
    w: jax.Array        # [S, C, 2] DF2T w registers
    # float32 residuals of the float64 designs (double-word lo planes).
    # The reference interpolates DOUBLE coefficients per sample
    # (ref: src/BiQuad.cpp:379-395); carrying hi+lo pairs lets the
    # parallel assoc_dw ramp engine reproduce that without a float64 ALU.
    targets_lo: jax.Array  # [S, 5]
    origins_lo: jax.Array  # [S, 5]


def bank_init(nstages: int, nchannels: int, dtype=jnp.float32) -> BankState:
    flat = jnp.tile(
        jnp.asarray([1.0, 0.0, 0.0, 0.0, 0.0], dtype), (nstages, 1)
    )
    return BankState(
        targets=flat,
        origins=flat,
        mul=jnp.zeros((nstages,), dtype),
        dec=jnp.zeros((nstages,), dtype),
        w=jnp.zeros((nstages, nchannels, 2), dtype),
        targets_lo=jnp.zeros_like(flat),
        origins_lo=jnp.zeros_like(flat),
    )


def bank_set_stage(
    state: BankState,
    stage: int,
    coeffs,
    interp_samples: float = 0.0,
) -> BankState:
    """Retarget one stage's coefficients, optionally click-free.

    With ``interp_samples > 0`` the stage ramps to the new coefficients over
    that many samples via the shared-controller scheme
    (ref: src/BiQuad.cpp:75-102).  The ramp measures from the stage's
    *current effective* coefficients so retargeting mid-ramp is seamless.
    """
    dtype = state.targets.dtype
    # split the (typically float64 host) design into double-word planes so
    # ramps can reproduce the reference's double-precision interpolation
    chi, clo = dw_from_f64(np.asarray(coeffs, np.float64), dtype)
    # current effective coefficients in double-word (mul/dec are exact f32)
    m = state.mul[stage]
    dh, dl = dw_add(state.targets[stage], state.targets_lo[stage],
                    -state.origins[stage], -state.origins_lo[stage])
    mh, ml = dw_mul(m, jnp.zeros_like(m), dh, dl)
    curh, curl = dw_add(state.targets[stage], state.targets_lo[stage],
                        -mh, -ml)
    if interp_samples > 0:
        mul, dec = 1.0, 1.0 / float(interp_samples)
        origin, origin_lo = curh, curl
    else:
        mul, dec = 0.0, 0.0
        origin, origin_lo = chi, clo
    return state._replace(
        targets=state.targets.at[stage].set(chi),
        origins=state.origins.at[stage].set(origin),
        mul=state.mul.at[stage].set(jnp.asarray(mul, dtype)),
        dec=state.dec.at[stage].set(jnp.asarray(dec, dtype)),
        targets_lo=state.targets_lo.at[stage].set(clo),
        origins_lo=state.origins_lo.at[stage].set(origin_lo),
    )


from functools import partial


@partial(jax.jit, static_argnums=(1,))
def _bank_trajectories(state: BankState, nframes: int):
    """Per-sample coefficient trajectories for every stage: ``[S, T, 5]``."""
    diffs = state.targets - state.origins
    n = jnp.arange(nframes, dtype=state.targets.dtype)
    muls = jnp.maximum(state.mul[:, None] - state.dec[:, None] * n, 0.0)
    coeffs = state.targets[:, None, :] - muls[..., None] * diffs[:, None, :]
    new_mul = jnp.maximum(state.mul - state.dec * nframes, 0.0)
    return coeffs, new_mul


@partial(jax.jit, static_argnums=(1,))
def _bank_trajectories_dw(state: BankState, nframes: int):
    """Double-word ``[S, T, 5]`` trajectories: reproduces the reference's
    per-sample interpolation of DOUBLE coefficients
    (ref: src/BiQuad.cpp:379-395) with hi+lo float32 planes throughout."""
    from ..utils.dwfloat import two_prod

    z5 = jnp.zeros_like(state.targets)
    dh, dl = dw_add(state.targets, state.targets_lo,
                    -state.origins, -state.origins_lo)
    n = jnp.arange(nframes, dtype=state.targets.dtype)
    # mul_n = mul - dec*n, exactly: dec, n are exact f32 (n < 2^24)
    ph, pl = two_prod(state.dec[:, None], n[None, :])
    mh, ml = dw_add(state.mul[:, None], jnp.zeros_like(ph), -ph, -pl)
    landed = mh <= 0.0  # clamp: max(mul_n, 0)  [S, T]
    mh = jnp.where(landed, 0.0, mh)
    ml = jnp.where(landed, 0.0, ml)
    th, tl = dw_mul(mh[..., None], ml[..., None],
                    dh[:, None, :], dl[:, None, :])
    ch, cl = dw_add(state.targets[:, None, :], state.targets_lo[:, None, :],
                    -th, -tl)
    new_mul = jnp.maximum(state.mul - state.dec * nframes, 0.0)
    return DWCoeffs(ch, cl), new_mul


def bank_process(
    state: BankState, x: jax.Array, engine: str = "scan"
) -> tuple[BankState, jax.Array]:
    """Process ``x[C, T]`` through all stages, stage-serial channel-parallel
    (ref: src/BiQuad.cpp:639-662), with per-sample coefficient interpolation
    folded into the scan (ref: src/BiQuad.cpp:473-494).

    ``engine="assoc_dw"`` runs the parallel double-word scan — both faster
    (O(log T) depth) and closer to the reference's double-precision ramp
    than the sequential float32 scan.
    """
    T = x.shape[-1]
    if engine == "assoc_dw":
        coeffs, new_mul = _bank_trajectories_dw(state, T)
        stage_coeffs = [
            DWCoeffs(coeffs.hi[s][None], coeffs.lo[s][None])
            for s in range(state.targets.shape[0])
        ]
    else:
        coeffs, new_mul = _bank_trajectories(state, T)
        stage_coeffs = [coeffs[s][None]
                        for s in range(state.targets.shape[0])]
    y = x
    new_w = []
    for s in range(state.targets.shape[0]):
        # [1, T, 5] broadcasts the stage coefficients over channels
        y, w = biquad_apply(y, stage_coeffs[s], state.w[s], engine=engine)
        new_w.append(w)
    return state._replace(mul=new_mul, w=jnp.stack(new_w)), y


class BiQuadFilterBank:
    """Stateful convenience wrapper: N stages x M channels, per-stage coeffs
    shared across channels (ref: src/BiQuad.h:247-348).

    Engine policy (see :mod:`bbcat_dsp_tpu.filters.iir` module doc): while a
    coefficient ramp is active the bank runs the parallel double-word scan
    (``assoc_dw``) over the per-sample interpolated double-word coefficient
    trajectory — matching the reference's double-precision interpolated tick
    (ref: src/BiQuad.cpp:473-494) to ~148 dB while staying O(log T) depth;
    once all ramps have landed, the DF2T w-registers are converted exactly
    into the modal realization (:func:`modal_from_df2t`) and steady-state
    blocks run the parallel high-precision modal engine.
    """

    def __init__(self, nstages: int, nchannels: int, engine: str = "assoc_dw",
                 dtype=jnp.float32, fs: float = 48000.0):
        self.fs = fs
        self.engine = engine  # engine used DURING ramps
        self.state = bank_init(nstages, nchannels, dtype)
        self._ramp_remaining = 0
        self._modal = None  # (params_per_stage, states_per_stage) when steady

    def set_filter(
        self,
        stage: int,
        ftype: FilterType,
        freq: float,
        gain: float = 0.0,
        bandwidth: float = 1.0,
        interp_time: float = 0.0,
    ) -> None:
        """Design + retarget a stage (ref: BiQuadCoeffs::CalcCoeffs,
        src/BiQuad.cpp:181-346; ``interp_time`` in seconds)."""
        c = biquad_coeffs(ftype, freq, self.fs, gain, bandwidth)
        self.state = bank_set_stage(self.state, stage, c, interp_time * self.fs)

    def set_coeffs(self, stage: int, coeffs, interp_samples: float = 0.0) -> None:
        if self._modal is not None:
            # fold modal streaming state back into DF2T w-registers so the
            # ramp starts from the exact current audio state
            self.state = self.state._replace(w=self._modal_to_w())
            self._modal = None
        self.state = bank_set_stage(self.state, stage, coeffs, interp_samples)
        self._ramp_remaining = max(self._ramp_remaining, int(interp_samples))

    def _modal_to_w(self) -> jax.Array:
        """Recover DF2T w-registers from modal states: w0 = Re(w) (the next
        zero-input output) and w1 = p-evolved second output minus -a1*w0."""
        params, states = self._modal
        ws = []
        for p, s in zip(params, states):
            p1 = p.p1r + 1j * p.p1i
            p2 = p.p2r + 1j * p.p2i
            w_c = s.wr + 1j * s.wi
            t_c = s.tr + 1j * s.ti
            # include remaining FIR history in the free evolution
            v0 = p.d1 * s.x1 + p.d2 * s.x2
            v1 = p.d2 * s.x1
            w_n0 = p2 * w_c + p1 * t_c + v0
            t_n0 = p1 * t_c + v0
            w_n1 = p2 * w_n0 + p1 * t_n0 + v1
            y0 = w_n0.real
            y1 = w_n1.real
            a1 = -(p1 + p2).real
            ws.append(jnp.stack([y0, y1 + a1 * y0], axis=-1))
        return jnp.stack(ws).astype(self.state.w.dtype)

    def process(self, x: jax.Array) -> jax.Array:
        T = x.shape[-1]
        if self._ramp_remaining > 0 or self._modal is None:
            self.state, y = bank_process(self.state, x, engine=self.engine)
            self._ramp_remaining = max(0, self._ramp_remaining - T)
            if self._ramp_remaining == 0:
                # ramp landed: switch to the modal engine with exact state
                # handover
                params = [
                    modal_params(np.asarray(self.state.targets[s]),
                                 self.state.targets.dtype)
                    for s in range(self.state.targets.shape[0])
                ]
                states = [
                    modal_from_df2t(p, self.state.w[s])
                    for s, p in enumerate(params)
                ]
                self._modal = (params, states)
            return y
        params, states = self._modal
        y = x
        new_states = []
        for p, s in zip(params, states):
            y, s = modal_apply(y, p, s)
            new_states.append(s)
        self._modal = (params, new_states)
        return y

    def calc_response(self, f, usetargets: bool = True) -> np.ndarray:
        """Cascade response = product of stage responses
        (ref: src/BiQuad.cpp:715-724)."""
        coeffs = np.asarray(
            self.state.targets if usetargets
            else self.state.targets - np.asarray(self.state.mul)[:, None]
            * np.asarray(self.state.targets - self.state.origins)
        )
        return cascade_response(coeffs, f, self.fs)

    def copy_audio_state(self, other: "BiQuadFilterBank") -> None:
        """ref: BiQuad::CopyAudioState, src/BiQuad.cpp:418-421."""
        self.state = self.state._replace(w=other.state.w)


class BiQuadCascade:
    """Single-channel fixed-stage cascade (ref: src/BiQuad.h:386-788).

    ``systolic=True`` reproduces the reference's vectorised formulation in
    which all stages tick in parallel on previous outputs, adding
    ``nstages-1`` samples of latency (ref: src/BiQuad.h:591-624).  The
    engine parallelises over time instead, so systolic mode exists purely
    for semantic parity.
    """

    def __init__(self, coeffs, systolic: bool = False, engine: str = "auto",
                 dtype=jnp.float32, fs: float = 48000.0):
        self.coeffs_host = np.atleast_2d(np.asarray(coeffs, np.float64))
        self.coeffs = jnp.asarray(self.coeffs_host, dtype)
        self.states = None
        self.systolic = systolic
        self.engine = engine
        self.fs = fs

    @classmethod
    def from_interleaved(cls, coefficients, **kw) -> "BiQuadCascade":
        """Load from the reference's interleaved vector
        ``(g, b1[0], b2[0], a1[0], a2[0], b1[1], ...)`` of length
        ``4*nstages + 1`` (ref: BiQuadCascade::SetCoefficients,
        src/BiQuad.h:530-555).  The global output gain ``g`` folds into
        stage 0's numerator."""
        v = np.asarray(coefficients, np.float64).reshape(-1)
        if (v.size - 1) % 4:
            raise ValueError("expected 4*nstages + 1 coefficients")
        n = (v.size - 1) // 4
        g = v[0]
        rows = []
        for i in range(n):
            b1, b2, a1, a2 = v[1 + 4 * i: 5 + 4 * i]
            b0 = g if i == 0 else 1.0
            rows.append([b0, b0 * b1, b0 * b2, a1, a2])
        return cls(np.asarray(rows), **kw)

    @classmethod
    def from_split(cls, g, b1, b2, a1, a2, **kw) -> "BiQuadCascade":
        """Load from the reference's split layout: global gain + four
        per-stage coefficient arrays (ref: src/BiQuad.h:557-587)."""
        b1, b2, a1, a2 = (np.asarray(a, np.float64).reshape(-1)
                          for a in (b1, b2, a1, a2))
        n = b1.size
        rows = []
        for i in range(n):
            b0 = float(g) if i == 0 else 1.0
            rows.append([b0, b0 * b1[i], b0 * b2[i], a1[i], a2[i]])
        return cls(np.asarray(rows), **kw)

    def process(self, x: jax.Array) -> jax.Array:
        # host float64 coefficients preserve modal pole precision
        y, self.states = cascade_apply(
            x, self.coeffs_host, self.states, engine=self.engine,
            systolic=self.systolic,
        )
        return y

    def reset(self) -> None:
        self.states = None

    def calc_response(self, f) -> np.ndarray:
        return cascade_response(np.asarray(self.coeffs, np.float64), f, self.fs)


class BiQuadBlock:
    """Block-streaming biquad processor (ref: README:35-36, BiQuadBlock —
    documented-absent in the snapshot; built from spec).

    Fixed block size, multi-channel, cascade of stages; ``step`` is a pure
    jitted function so a host streaming loop runs at full device rate.
    """

    def __init__(self, coeffs, nchannels: int, block_size: int,
                 engine: str = "auto", dtype=jnp.float32):
        coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
        self.block_size = block_size
        self.engine = engine
        self.coeffs_host = coeffs
        self.coeffs = jnp.asarray(coeffs, dtype)
        self.states = None

    def process_block(self, x: jax.Array) -> jax.Array:
        assert x.shape[-1] == self.block_size
        y, self.states = cascade_apply(
            x, self.coeffs_host, self.states, engine=self.engine
        )
        return y
