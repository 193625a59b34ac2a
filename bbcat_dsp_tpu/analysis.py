"""Analysis / metrics components: running averages and histograms.

Batched-array redesign of ``RunningAverage<I,S>`` (ref: src/RunningAverage.h:18-142)
and ``Histogram<I,T>`` (ref: src/Histogram.h:15-250) — the reference's
"metrics layer" (SURVEY.md §5).  Per-sample incremental updates become
block-vectorised cumsum/scatter ops with explicit state pytrees.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "RunningAverageState",
    "running_average_init",
    "running_average_update",
    "RunningAverage",
    "HistogramState",
    "histogram_init",
    "histogram_update",
    "Histogram",
]


# ---------------------------------------------------------------------------
# RunningAverage


class RunningAverageState(NamedTuple):
    tail: jax.Array   # [..., window-1] most recent samples preceding a block
    count: jax.Array  # [] int32 total samples seen (for partial fill)


def running_average_init(shape, window: int, dtype=jnp.float32) -> RunningAverageState:
    return RunningAverageState(
        tail=jnp.zeros(tuple(shape) + (window - 1,), dtype),
        count=jnp.zeros((), jnp.int32),
    )


def running_average_update(
    state: RunningAverageState, x: jax.Array, window: int,
    alt_window: int | None = None,
):
    """Per-sample sliding means over ``x[..., T]``.

    Returns ``(means[..., T], state)`` — and with ``alt_window`` also the
    second, shorter-window means sharing the same sample history
    (ref: AltAverage, src/RunningAverage.h:108-119).  Partial fill divides
    by the number of samples actually seen (ref: ``wrapped`` flag,
    src/RunningAverage.h:125).
    """
    W = window
    T = x.shape[-1]
    ext = jnp.concatenate([state.tail, x], axis=-1)  # [..., W-1+T]
    cs = jnp.cumsum(ext.astype(jnp.float32), axis=-1)
    cs = jnp.concatenate([jnp.zeros_like(cs[..., :1]), cs], axis=-1)

    def win_means(w):
        # sample i of the block is position (W-1+i) in ext; window covers
        # (W-1+i-w+1 .. W-1+i)
        ends = jnp.arange(T) + W
        sums = cs[..., ends] - cs[..., ends - w]
        seen = jnp.minimum(state.count + jnp.arange(T) + 1, w)
        return sums / seen.astype(sums.dtype)

    means = win_means(W)
    new_state = RunningAverageState(
        tail=ext[..., T:], count=state.count + T
    )
    if alt_window is not None:
        return means, win_means(alt_window), new_state
    return means, new_state


class RunningAverage:
    """Stateful wrapper (ref: src/RunningAverage.h public surface)."""

    def __init__(self, window: int, shape=(), alt_window: int | None = None,
                 dtype=jnp.float32):
        self.window = int(window)
        self.alt_window = alt_window
        self.state = running_average_init(shape, self.window, dtype)
        self._last = None
        self._last_alt = None

    def write(self, x: jax.Array) -> jax.Array:
        if self.alt_window is not None:
            m, ma, self.state = running_average_update(
                self.state, x, self.window, self.alt_window
            )
            self._last_alt = ma
        else:
            m, self.state = running_average_update(self.state, x, self.window)
        self._last = m
        return m

    def average(self) -> float:
        return float(self._last[..., -1]) if self._last is not None else 0.0

    def alt_average(self) -> float:
        return float(self._last_alt[..., -1]) if self._last_alt is not None else 0.0

    def reset(self) -> None:
        self.state = running_average_init(
            self.state.tail.shape[:-1], self.window, self.state.tail.dtype
        )
        self._last = self._last_alt = None


# ---------------------------------------------------------------------------
# Histogram


class HistogramState(NamedTuple):
    count: jax.Array  # [nbins] int32
    sum: jax.Array    # [nbins] float32


def histogram_init(nbins: int) -> HistogramState:
    return HistogramState(
        count=jnp.zeros((nbins,), jnp.int32),
        sum=jnp.zeros((nbins,), jnp.float32),
    )


@jax.jit
def histogram_update(
    state: HistogramState, x: jax.Array, vmin: float, vmax: float
) -> HistogramState:
    """Accumulate (count, sum) per bin over flattened ``x`` with index
    clamping (ref: CalcIndex, src/Histogram.h:103-107)."""
    nbins = state.count.shape[0]
    xf = x.reshape(-1).astype(jnp.float32)
    idx = jnp.clip(
        ((xf - vmin) * nbins / (vmax - vmin)).astype(jnp.int32), 0, nbins - 1
    )
    return HistogramState(
        count=state.count.at[idx].add(1),
        sum=state.sum.at[idx].add(xf),
    )


class Histogram:
    """Binned (count, sum) accumulation over [vmin, vmax) with the
    reference's query surface (ref: src/Histogram.h:15-250)."""

    def __init__(self, nbins: int, vmin: float, vmax: float):
        self.nbins = int(nbins)
        self.vmin = float(vmin)
        self.vmax = float(vmax)
        self.state = histogram_init(self.nbins)

    def write(self, x) -> None:
        self.state = histogram_update(
            self.state, jnp.asarray(x), self.vmin, self.vmax
        )

    # -- queries ---------------------------------------------------------
    def bin_value(self, index: int) -> float:
        """Bin-centre inverse mapping (ref: src/Histogram.h:113-116)."""
        return self.vmin + (index + 0.5) * (self.vmax - self.vmin) / self.nbins

    def counts(self) -> np.ndarray:
        return np.asarray(self.state.count)

    def sums(self) -> np.ndarray:
        return np.asarray(self.state.sum)

    def mean_index(self, first: int = 0, last: int | None = None) -> float:
        """Count-weighted mean bin index over a range
        (ref: src/Histogram.h:122-138)."""
        c = self.counts()[first:last]
        if c.sum() == 0:
            return 0.0
        return float(np.average(np.arange(len(c)) + first, weights=c))

    def mean_data(self, first: int = 0, last: int | None = None) -> float:
        """Sum-weighted mean of accumulated data over a bin range
        (ref: src/Histogram.h:140-160)."""
        c = self.counts()[first:last]
        s = self.sums()[first:last]
        n = c.sum()
        return float(s.sum() / n) if n else 0.0

    def percentile_index(self, fraction: float) -> int:
        """Smallest bin index at which the cumulative count reaches
        ``fraction`` of the total (ref: src/Histogram.h:168-187)."""
        c = self.counts()
        total = c.sum()
        if total == 0:
            return 0
        return int(np.searchsorted(np.cumsum(c), fraction * total))

    def percentile_data(self, fraction: float) -> float:
        """Bin-centre value at the percentile index
        (ref: src/Histogram.h:189-208)."""
        return self.bin_value(self.percentile_index(fraction))

    def write_to_file(self, path: str) -> None:
        """Debug dump: bin centre, count, sum, cumulative fraction
        (ref: WriteToFile, src/Histogram.h:214-240)."""
        c = self.counts()
        s = self.sums()
        total = max(int(c.sum()), 1)
        cum = np.cumsum(c) / total
        with open(path, "w") as fp:
            for i in range(self.nbins):
                fp.write(
                    f"{i} {self.bin_value(i):.6g} {int(c[i])} "
                    f"{float(s[i]):.6g} {cum[i]:.6f}\n"
                )

    def reset(self) -> None:
        self.state = histogram_init(self.nbins)
