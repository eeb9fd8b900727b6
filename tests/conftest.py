"""Shared fixtures.

Test-strategy parity with the reference suite (reference ``tests/conftest.py``):
real ERA5 frame fixture, crops, stacked 3-D/4-D variants, constant and edge
cases, standard parameter sets — plus what the reference lacks: an 8-device
virtual CPU mesh (``xla_force_host_platform_device_count``) so multi-chip
sharding is tested without a pod.
"""

import os

# Tests run on CPU with 8 virtual devices so the sharded paths are exercised
# without a multi-card machine.  Tests that need a GPU carry the ``gpu``
# marker and skip elsewhere (see README "Testing").
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# Pin the auto-router (core.routing) to the device path so the suite
# deterministically exercises the device programs regardless of probe
# noise; routing tests override this per-test via monkeypatch.
os.environ.setdefault("EBCC_LINK_MBPS", "1000000")

from pathlib import Path

import numpy as np
import pytest

_REFERENCE_ERA5 = Path("/root/reference/data/test_data.npy")


def _synthetic_era5_like(h=721, w=1440, seed=0):
    """Smooth large-scale field + small-scale noise, ERA5-temperature-like
    statistics (range ~[232, 287] K), used when the real fixture is absent."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    field = (
        260.0
        + 25.0 * np.sin(yy / h * np.pi) * np.cos(xx / w * 2 * np.pi)
        + 5.0 * np.sin(yy / 37.0) * np.sin(xx / 53.0)
    )
    field += rng.normal(scale=0.8, size=(h, w)).astype(np.float32)
    return field.astype(np.float32)


@pytest.fixture(scope="session")
def base_test_data():
    """One 721x1440 float32 ERA5 temperature frame (real when available)."""
    if _REFERENCE_ERA5.exists():
        return np.load(_REFERENCE_ERA5).astype(np.float32)
    return _synthetic_era5_like()


@pytest.fixture(scope="session")
def small_frame(base_test_data):
    return np.ascontiguousarray(base_test_data[:64, :64])


@pytest.fixture(scope="session")
def medium_frame(base_test_data):
    return np.ascontiguousarray(base_test_data[:256, :256])


@pytest.fixture(scope="session")
def stacked_3d(base_test_data):
    """(4, 181, 360) stack with per-frame perturbations."""
    crop = base_test_data[:181, :360]
    frames = [crop + 0.5 * i for i in range(4)]
    return np.stack(frames).astype(np.float32)


@pytest.fixture(scope="session")
def constant_frame():
    return np.full((1, 64, 64), 3.25, np.float32)


@pytest.fixture(params=[10, 50, 100, 200])
def base_cr(request):
    """Parity: reference CR sweep (tests/test_netcdf.py:63-80)."""
    return request.param


@pytest.fixture(params=[0.5, 0.1, 0.01])
def max_error_target(request):
    return request.param


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    The full suite compiles hundreds of program variants; with all of them
    held live, XLA:CPU's JIT eventually crashes inside a later
    ``backend_compile`` (observed as a segfault/abort compiling the
    classed-exchange program after ~175 tests, reproducible, not
    heap-corruption per MALLOC_CHECK_).  Dropping caches between modules
    keeps the compiler's live-code footprint bounded; per-module
    recompiles cost ~1 min across the suite."""
    yield
    import jax

    jax.clear_caches()
