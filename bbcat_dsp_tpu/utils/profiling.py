"""Tracing / profiling helpers.

The reference's only observability is compile-time ``BBCDEBUG*`` printf
macros (SURVEY.md §5).  The equivalent here is structured: every
public kernel can be wrapped in a named trace scope that shows up in
``jax.profiler`` / XProf timelines, and a context manager captures a whole
trace to disk for offline inspection.
"""

from __future__ import annotations

import contextlib
import functools
import time

import jax

__all__ = ["named_scope", "trace", "Timer"]


def named_scope(name: str):
    """Decorator: run the function inside ``jax.named_scope`` so its ops are
    grouped under ``name`` in profiler timelines."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax profiler trace for the enclosed block.

    View with XProf/TensorBoard (``tensorboard --logdir ...``).
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timer that blocks on device results — the honest way to
    time jax work (dispatch is async)."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    def time(self, fn, *args, iters: int = 1, **kwargs):
        """Run ``fn`` ``iters`` times, blocking on the last result; returns
        (result, seconds_per_iter)."""
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        return out, (time.perf_counter() - t0) / iters
