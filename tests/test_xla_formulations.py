"""The plain XLA formulations the two-level render is built from, each
against a float64 numpy reference: the shifted head MAC, the whole-group
tail MAC over the xt-slot queue (both spectral layouts' sign patterns),
the super-block gather and the pending-schedule delayed add.  Plus the
single transform-backend choice and the compile-cache helper."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bbcat_dsp_tpu.convolve import fft
from bbcat_dsp_tpu.convolve.nonuniform import (
    _delayed_add,
    _gather_supers,
    _head_mac,
    _tail_group_mac,
)


def _cplx(planes):
    a = np.asarray(planes, np.float64)
    return a[0] + 1j * a[1]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("P,C,F,ratio", [
    (1, 1, 5, 1),
    (3, 5, 9, 2),        # C not a multiple of 8
    (16, 12, 33, 4),
    (4, 8, 17, 6),       # ratio > P
    (16, 7, 65, 16),     # the headline chunk shape, C odd
])
def test_head_mac_matches_float64(rng, P, C, F, ratio):
    """acc[i] = sum_p xext[P+i-p] * H[p] (complex) == numpy float64."""
    xext = _rand(rng, 2, P + ratio, C, F)
    H = _rand(rng, 2, P, C, F)
    got = _cplx(jax.jit(lambda a, h: _head_mac(a, h, ratio))(xext, H))
    X, Hc = _cplx(xext), _cplx(H)
    want = np.stack([sum(X[P + i - p] * Hc[p] for p in range(P))
                     for i in range(ratio)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _signs(layout: str, n: int):
    if layout == "std":
        return fft.half_window_signs(n, "xla")
    spec = fft.resolve_spectral_spec(n, backend="dftmm", probe=False)
    assert spec.layout == "perm"
    return fft.half_window_signs(n, spec=spec)


@pytest.mark.parametrize("layout,n", [("std", 64), ("perm", 4096)])
@pytest.mark.parametrize("slot0", [0, 1, 2, None])
def test_tail_group_mac_matches_float64(rng, layout, n, slot0):
    """Whole-group tail MAC: windows assembled from consecutive half
    spectra with the layout's sign pattern, queue read at the static
    (``slot0``) or traced (``None``) cursor, vs a float64 reference."""
    Pt, C = 3, 5
    s = _signs(layout, n)
    Fb = s.shape[0]
    q, xt, H = (_rand(rng, 2, Pt, C, Fb) for _ in range(3))
    step = 7 if slot0 is None else 3 * Pt + slot0
    got = _cplx(jax.jit(
        lambda a, b, h, st: _tail_group_mac(a, st, b, h, jnp.asarray(s),
                                            slot0))(q, xt, H,
                                                    jnp.int32(step)))
    # chronological past half spectra: slot (step + k) % Pt, k = 0..Pt-1
    Q, Xt, Hc = _cplx(q), _cplx(xt), _cplx(H)
    tseq = np.concatenate([Q[(step + np.arange(Pt)) % Pt], Xt], axis=0)
    w = tseq[:-1] + s.astype(np.float64) * tseq[1:]
    want = np.stack([sum(w[Pt - 1 + j - p] * Hc[p] for p in range(Pt))
                     for j in range(Pt)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("C,nsup,B2", [(1, 1, 8), (5, 3, 16), (16, 14, 32)])
def test_gather_supers_is_reshape_moveaxis(rng, C, nsup, B2):
    x = _rand(rng, C, nsup * B2)
    got = np.asarray(jax.jit(lambda a: _gather_supers(a, nsup))(x))
    want = np.stack([x[:, j * B2:(j + 1) * B2] for j in range(nsup)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Pt", [1, 2, 5])
def test_delayed_add_matches_schedule(rng, Pt):
    """Super-step j adds the tail output of super-step j-2; the last two
    tail outputs become the new pending pair."""
    C, B2 = 3, 8
    y_head = _rand(rng, C, Pt * B2)
    pending = _rand(rng, 2, C, B2)
    out_tail = _rand(rng, Pt, C, B2)
    y, pend = jax.jit(_delayed_add)(y_head, pending, out_tail)
    seq = np.concatenate([pending, out_tail]).astype(np.float64)
    want = y_head.astype(np.float64).copy()
    for j in range(Pt):
        want[:, j * B2:(j + 1) * B2] += seq[j]
    np.testing.assert_allclose(np.asarray(y), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(pend), seq[Pt:Pt + 2])


@pytest.mark.parametrize("platform", ["cpu", "gpu", "cuda", "rocm"])
def test_default_backend_is_one_choice(monkeypatch, platform):
    """The transform backend is not keyed on the platform name: every
    platform resolves jnp.fft, and engines built there use it."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert fft.default_backend() == "xla"
    spec = fft.resolve_spectral_spec(8192, probe=False)
    assert spec.backend == "xla" and spec.layout == "std"


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, nothing is set in code."""
    from bbcat_dsp_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert compile_cache.configure_compile_cache() == str(tmp_path / "env")
    assert calls == []


def test_compile_cache_defaults_into_checkout(monkeypatch):
    """Without the env var the cache goes to <checkout>/.jax_cache, a
    fixed path that is neither under /tmp nor built from a pid or time."""
    import os

    from bbcat_dsp_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", got)]
