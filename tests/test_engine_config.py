"""Frozen engine configuration.

Engines capture a :class:`SpectralSpec` — (backend, layout, radix, cmatmul)
— at CONSTRUCTION.  These tests prove that changing the env
toggles after an engine is built cannot change its traced program: the same
engine renders identically before and after an env flip that *would* have
changed the layout had it been read at trace time, and its state shapes
stay put.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bbcat_dsp_tpu.convolve import (
    BlockConvolver,
    MatrixConvolver,
    NonUniformConvolver,
)
from bbcat_dsp_tpu.convolve import fft
from bbcat_dsp_tpu.convolve.fft import SpectralSpec, resolve_spectral_spec

from conftest import snr_db


def test_resolve_reads_env_once(monkeypatch, rng):
    """resolve_spectral_spec honours the env at CALL time; the returned
    spec is immutable thereafter."""
    monkeypatch.setenv("BBCAT_DSP_CMATMUL", "karatsuba")
    s = resolve_spectral_spec(8192, backend="dftmm", probe=False)
    assert s.cmatmul == "karatsuba"
    assert s.layout == "perm" and s.radix in (8, 16, 32)
    monkeypatch.setenv("BBCAT_DSP_PERM_LAYOUT", "0")
    s2 = resolve_spectral_spec(8192, backend="dftmm", probe=False)
    assert s2.layout == "std" and s2.radix is None
    # the first spec is unaffected (it is a frozen NamedTuple)
    assert s.layout == "perm"


def test_resolve_layout_override(monkeypatch):
    s = resolve_spectral_spec(8192, backend="dftmm", probe=False,
                              layout="std")
    assert s.layout == "std"
    # explicit layout="std" wins even when env would say perm
    monkeypatch.setenv("BBCAT_DSP_PERM_LAYOUT", "1")
    s = resolve_spectral_spec(8192, backend="dftmm", probe=False,
                              layout="std")
    assert s.layout == "std"
    # layout="perm" engages where a radix applies, regardless of env=0
    monkeypatch.setenv("BBCAT_DSP_PERM_LAYOUT", "0")
    s = resolve_spectral_spec(8192, backend="dftmm", probe=False,
                              layout="perm")
    assert s.layout == "perm"
    # explicit layout="perm" resolves a radix BELOW the direct size too
    s = resolve_spectral_spec(1024, backend="dftmm", probe=False,
                              layout="perm")
    assert s.layout == "perm" and s.radix is not None
    # ... but still not where no radix divides the size
    s = resolve_spectral_spec(20, backend="dftmm", probe=False,
                              layout="perm")
    assert s.layout == "std"


def test_spec_size_mismatch_raises():
    s = resolve_spectral_spec(8192, backend="dftmm", probe=False)
    with pytest.raises(ValueError, match="n=8192"):
        fft.spectral_nbins(4096, spec=s)


@pytest.mark.parametrize("engine", ["block", "nonuniform", "matrix"])
def test_env_flip_cannot_change_built_engine(engine, monkeypatch, rng):
    """The acceptance test for the freeze: build an engine on a forced
    dftmm+perm configuration, render once, then flip every layout env
    toggle to values that WOULD change the trace-time resolution — the
    engine must produce the identical continuation it would have produced
    with the env untouched (compared against a twin engine that never saw
    the flip)."""
    B = 1536  # 2*B = 3072 > _MAX_DIRECT -> perm applies (radix 8, n1=384)
    C, N, T = 4, 3 * B, 2 * B

    def build():
        spec = resolve_spectral_spec(2 * B, backend="dftmm", probe=False)
        assert spec.layout == "perm"
        ir = rng_local.standard_normal((C, N)) * 0.1
        if engine == "block":
            return BlockConvolver(ir, block=B, spectral=spec)
        if engine == "matrix":
            irm = rng_local.standard_normal((C, 2, N)) * 0.1
            return MatrixConvolver(irm, block=B, spectral=spec)
        spec_h = resolve_spectral_spec(2 * (B // 4), backend="dftmm",
                                       probe=False)
        return NonUniformConvolver(ir, block=B // 4, ratio=4,
                                   spectral=(spec_h, spec))

    rng_local = np.random.default_rng(7)
    twin_a = build()
    rng_local = np.random.default_rng(7)
    twin_b = build()

    x1 = rng.standard_normal((C, T)).astype(np.float32)
    # x2 has a DIFFERENT length so processing it after the env flip forces
    # a FRESH trace — if the engine read env at trace time (the pre-freeze
    # behaviour), that retrace would resolve the std layout and crash on
    # the perm-shaped queue (or silently mis-sign the windows)
    x2 = rng.standard_normal((C, 2 * T)).astype(np.float32)

    ya1 = np.asarray(twin_a.process(jnp.asarray(x1)))

    # flip EVERY toggle the resolution reads
    monkeypatch.setenv("BBCAT_DSP_PERM_LAYOUT", "0")
    monkeypatch.setenv("BBCAT_DSP_PERM_RADIX", "4")
    monkeypatch.setenv("BBCAT_DSP_CMATMUL", "karatsuba")

    ya2 = np.asarray(twin_a.process(jnp.asarray(x2)))

    # state shapes unchanged (env flip did not re-layout anything)
    qa = (twin_a.state.queue if engine != "nonuniform"
          else twin_a.state.tail.queue)
    qb = (twin_b.state.queue if engine != "nonuniform"
          else twin_b.state.tail.queue)
    assert qa.shape == qb.shape

    monkeypatch.delenv("BBCAT_DSP_PERM_LAYOUT")
    monkeypatch.delenv("BBCAT_DSP_PERM_RADIX")
    monkeypatch.delenv("BBCAT_DSP_CMATMUL")

    yb1 = np.asarray(twin_b.process(jnp.asarray(x1)))
    yb2 = np.asarray(twin_b.process(jnp.asarray(x2)))

    np.testing.assert_array_equal(ya1, yb1)
    np.testing.assert_array_equal(ya2, yb2)  # bit-identical despite the flip


def test_spec_is_hashable_static_arg():
    s = resolve_spectral_spec(4096, backend="dftmm", probe=False)
    assert isinstance(hash(s), int)
    assert s == SpectralSpec(*s)  # plain tuple semantics


def test_probe_does_not_undo_explicit_perm_override(monkeypatch):
    """Code-review r4: with BBCAT_DSP_PERM_LAYOUT=0 in the env, an
    explicit layout="perm" request must survive probe=True — the probe
    verifies the program BUILDS, it must not re-resolve the env (an A/B
    harness exporting the env for its std arm would otherwise silently
    measure std against std)."""
    monkeypatch.setenv("BBCAT_DSP_PERM_LAYOUT", "0")
    s = resolve_spectral_spec(8192, backend="dftmm", probe=True,
                              layout="perm")
    assert s.layout == "perm" and s.radix is not None
