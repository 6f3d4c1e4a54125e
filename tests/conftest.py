"""Test configuration.

Tests run on the CPU with 8 virtual devices, so multi-device sharding
paths are exercised without a GPU host, unless ``JAX_PLATFORMS`` names
another platform.  Tests marked ``gpu`` take the ``gpu`` fixture, which
skips them unless JAX's default backend is a GPU; on the card run them
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.

Must set env vars before anything imports jax.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Enable x64 so the coeff=float64 precision policy (the analogue of the
# reference's default COEFF_PRECISION=D, include/precision.h:50-57) is
# real on the CPU oracle backend.  All library code is explicit about
# dtypes, so this does not change f32-policy behaviour.
os.environ.setdefault("JAX_ENABLE_X64", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless the default JAX backend is a GPU (decided when the
    test runs, never at import: every xdist worker must collect the
    same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (JAX_PLATFORMS=cuda on the card)")
