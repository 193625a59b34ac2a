"""Click-free parameter interpolators.

Functional equivalents of the reference's ``Interpolator`` /
``ComplexInterpolator`` (ref: src/Interpolator.h:12-143): tiny state
pytrees whose per-sample ramps are materialised as vectors and fused into
whatever op consumes them (mixing, filtering) — the array-program way to "interpolate
every sample" without a per-sample loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "Interpolator",
    "interpolator",
    "interp_ramp",
    "ComplexInterpolator",
    "complex_interpolator",
    "complex_interp_ramp",
]


class Interpolator(NamedTuple):
    """Clamped linear ramp current -> target
    (ref: src/Interpolator.h:12-77)."""

    current: jax.Array
    target: jax.Array

    @property
    def nonzero(self):
        """Either endpoint nonzero (ref: NonZero, src/Interpolator.h:25)."""
        return (self.current != 0) | (self.target != 0)

    @property
    def at_target(self):
        """Ramp finished (ref: AtTarget, src/Interpolator.h:73)."""
        return self.current == self.target


def interpolator(current=0.0, target=0.0, dtype=jnp.float32) -> Interpolator:
    return Interpolator(jnp.asarray(current, dtype), jnp.asarray(target, dtype))


def interp_ramp(it: Interpolator, inc, nframes: int):
    """Materialise ``nframes`` of the ramp (value BEFORE each step's
    ``operator+=(inc)``, matching the reference's use in MixSamples,
    ref: src/SoundMixing.cpp:23-52) and the advanced interpolator.

    The ramp moves ``current`` toward ``target`` by ``inc`` per frame,
    clamped at the target (ref: src/Interpolator.h:55-66).
    """
    inc = jnp.abs(jnp.asarray(inc, it.current.dtype))
    n = jnp.arange(nframes, dtype=it.current.dtype)
    up = jnp.minimum(it.current + inc * n, it.target)
    down = jnp.maximum(it.current - inc * n, it.target)
    ramp = jnp.where(it.current <= it.target, up, down)
    new_cur = jnp.where(
        it.current <= it.target,
        jnp.minimum(it.current + inc * nframes, it.target),
        jnp.maximum(it.current - inc * nframes, it.target),
    )
    return ramp, Interpolator(new_cur, it.target)


class ComplexInterpolator(NamedTuple):
    """Shared 1->0 controller scaling many values so a GROUP of parameters
    reaches its targets simultaneously — the anti-"go bang!" mechanism
    (ref: src/Interpolator.h:80-143, esp. 92-96)."""

    controller: jax.Array  # scalar in [0, 1]
    targets: jax.Array     # [...]
    diffs: jax.Array       # [...] target - value_at_set_time


def complex_interpolator(values, targets, dtype=jnp.float32) -> ComplexInterpolator:
    values = jnp.asarray(values, dtype)
    targets = jnp.asarray(targets, dtype)
    return ComplexInterpolator(
        controller=jnp.ones((), dtype),
        targets=targets,
        diffs=targets - values,
    )


def complex_interp_ramp(ci: ComplexInterpolator, dec, nframes: int):
    """Per-frame values ``[..., nframes]`` (``target - controller*diff``,
    controller decremented by ``dec`` per frame, clamped at 0) and the
    advanced interpolator."""
    dec = jnp.asarray(dec, ci.controller.dtype)
    n = jnp.arange(nframes, dtype=ci.controller.dtype)
    ctl = jnp.maximum(ci.controller - dec * n, 0.0)  # [nframes]
    vals = ci.targets[..., None] - ctl * ci.diffs[..., None]
    new_ctl = jnp.maximum(ci.controller - dec * nframes, 0.0)
    return vals, ci._replace(controller=new_ctl)
