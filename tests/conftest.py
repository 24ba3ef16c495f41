"""Test configuration: force CPU JAX with an 8-device virtual mesh.

Tests must not require a GPU; multi-device sharding is validated on a
virtual CPU mesh.  The platform is pinned via jax.config after import so
that a machine with a GPU still runs the suite on the CPU.  The
persistent compile cache is off: tests check behaviour, and several
workers share the checkout.  Tests that need the GPU carry the ``cuda``
marker and take the ``cuda_device`` fixture, which skips them elsewhere.
"""

import os

# chip_smoke.py runs the ``cuda`` tests inside its own process on the
# card; everywhere else the suite runs on the CPU.
ON_GPU = os.environ.get("POLYCHASE_TESTS_ON_GPU") == "1"

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def cuda_device():
    """The GPU for a ``cuda`` test; skips the test anywhere else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, the backend is {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# The full suite compiles several hundred XLA programs in one process;
# letting them all stay live eventually segfaults the CPU backend's
# compiler (deterministically, in whatever large program compiles last
# — observed in jaxlib 0.9.0 at ~320 tests; each half of the suite
# passes alone).  Dropping executables at module boundaries bounds the
# accumulation; cross-module cache reuse only costs recompiles of the
# small shared helpers.
_last_module = [None]


@pytest.fixture(autouse=True)
def _bound_live_executables(request):
    mod = getattr(request, "module", None)
    name = getattr(mod, "__name__", None)
    if name is not None and _last_module[0] not in (None, name):
        jax.clear_caches()
    if name is not None:
        _last_module[0] = name
    yield
