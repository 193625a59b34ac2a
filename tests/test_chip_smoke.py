"""chip_smoke.py: every phase at a tiny size on the CPU (the same code the
card runs at full width), the refusal to run without a GPU, and the
on-card checks behind the ``gpu`` marker."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY = {
    "headline": dict(C=8, N=4096, block=64, ratio=4, groups=2, blocks=2),
    "config5": dict(C=16, N=8192, block=64, ratio=4),
    "config1": dict(N=512, block=64, nblocks=16),
    "config2": dict(C=2, block=256, nblocks=3, max_delay=64.0),
    "config3": dict(C_in=4, N=128, block=64, nblocks=8, stream_blocks=2),
    "config4": dict(C=4, seconds=1.0),
    "assoc_dw": dict(C=2, T=512),
    "config5_sharded_4": dict(C=16, N=8192, block=64, ratio=4, n_dev=4,
                              groups=10),
}
PHASES = dict(chip_smoke.ONE_CARD_PHASES + chip_smoke.FOUR_CARD_PHASES)


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_passes_at_tiny_size(name):
    checks, timings = PHASES[name](**TINY[name])
    assert checks, name
    bad = [c.line() for c in checks if not c.ok]
    assert not bad, bad
    json.dumps(timings)  # printable


def test_main_refuses_cpu_and_prints_no_result(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four"]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out and '"ok"' not in out


def test_run_phases_reports_failure(capsys):
    """A failing check or a raising phase fails the run, and every check
    line carries its tolerance."""
    def failing():
        """always fails"""
        return [chip_smoke.Check("x", 1.0, 2.0, True)], {}

    def raising():
        """raises"""
        raise RuntimeError("boom")

    assert chip_smoke.run_phases([("f", failing)]) is False
    assert chip_smoke.run_phases([("r", raising)]) is False
    out = capsys.readouterr().out
    assert "FAIL x: 1.0 (tolerance >= 2.0)" in out
    assert "FAIL r: RuntimeError: boom" in out


@pytest.fixture
def gpu_device():
    """A GPU device, or skip: decided here, never at import time."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: run with BBCAT_TEST_GPU=1 on a card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["assoc_dw", "config1", "config4"])
def test_phase_on_card(gpu_device, name):
    """The smoke's small phases at their full size on the card."""
    checks, _ = PHASES[name]()
    assert all(c.ok for c in checks), [c.line() for c in checks]
