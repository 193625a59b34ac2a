"""Test configuration.

Tests run on CPU with 8 virtual devices so that the multi-device sharding
paths (`shard_map` / `pjit` over a Mesh) exercise the same code that runs
across cards (SURVEY.md §4: distributed tests without a cluster).

With ``BBCAT_TEST_GPU=1`` the platform is left to JAX instead, so the
tests marked ``gpu`` run on a card (``BBCAT_TEST_GPU=1 python -m pytest
tests/ -m gpu``); each of them decides in a fixture whether a GPU exists.

These env vars must be set before jax initialises its backends, which is why
they live at the top of conftest (imported before any test module).
"""

import os

ON_CARD = os.environ.get("BBCAT_TEST_GPU") == "1"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CARD:
    # a platform chosen elsewhere in the environment must not win over
    # the env var; the config update sticks.  It must run before any
    # backend is initialised.
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    # BBCAT_TEST_SEED overrides for robustness sweeps (CI default fixed)
    return np.random.default_rng(int(os.environ.get("BBCAT_TEST_SEED", "1234")))


def snr_db(ref, test) -> float:
    """Signal-to-noise ratio of `test` against reference `ref`, in dB."""
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    noise = ref - test
    p_sig = np.sum(ref**2)
    p_noise = np.sum(noise**2)
    if p_noise == 0:
        return np.inf
    return 10.0 * np.log10(p_sig / p_noise)
