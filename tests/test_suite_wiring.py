"""Wiring smoke test for benchmarks/suite.py.

The suite's configs are meant to run on the GPU, where a wiring
regression costs a chip run to discover.  This test stubs the
two-point timing loops and runs every config once at quick sizes on
the CPU mesh: construction, the compiled compute path, the f64 oracle,
and the artifact row shape are all exercised; only the timing itself
is faked.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def suite():
    spec = importlib.util.spec_from_file_location(
        "suite_under_test", os.path.join(ROOT, "benchmarks", "suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def fake_time_fori(step, x0, iters=8, reps=5, target_s=0.08,
                       max_iters=65536):
        import jax

        jax.block_until_ready(jax.jit(step)(x0))  # real compute, once
        mod.LAST_SPREAD = None
        return 1e-3

    def fake_time_host(fn, reps=3):
        fn()
        return 1.0

    mod._time_fori = fake_time_fori
    mod._time_host = fake_time_host
    return mod


@pytest.mark.parametrize("idx", [1, 2, 3, 4, 5, 6])
def test_config_runs_quick(suite, idx):
    res = suite.CONFIGS[idx](True)
    assert "value" in res and res["value"] > 0, res
    assert "unit" in res and "vs_baseline" in res, res
    # accuracy-bearing configs must stay on the BASELINE.md <=1e-5 target
    err = res.get("max_abs_err_vs_f64")
    if err is not None and idx != 6:
        # config 6's i8 whole-image path is sized for the 512^2 run; at
        # the 128^2 quick size it still lands ~1e-5-class
        assert err <= 1e-5, res
    elif err is not None:
        assert err <= 5e-5, res


def test_config1_chain_is_a_true_round_trip():
    """The config-1 oracle (and therefore the device chain it pins)
    must return the IMAGE, not img/(4n^2): an extra 1/256 in both made
    the published error read 256x too small (round-4 review)."""
    import numpy as np

    from benchmarks.suite import _block_spec_chain_np

    rng = np.random.default_rng(3)
    img = rng.random((32, 32, 3))
    out = _block_spec_chain_np(img, 8)
    np.testing.assert_allclose(out, img, atol=1e-9)
