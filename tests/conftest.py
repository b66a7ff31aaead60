import os
import sys

# The suite runs on the CPU unless JAX_PLATFORMS says otherwise, with a
# virtual multi-device CPU mesh for the sharding tests (stands in for
# mpirun -n N in the reference's pmltest); must be set before jax import.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Never use the persistent compile cache on the CPU backend: cached
# XLA:CPU AOT executables embed compile-machine CPU features the cache
# key does not, and loading a mismatched one SEGFAULTED a full test run
# (jax compilation_cache.get_executable_and_time -> SIGSEGV).
os.environ["SAAMGE_NO_COMPILE_CACHE"] = "1"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The default device when it is a GPU; skips otherwise.  Tests that
    need the card carry the ``gpu`` marker and take this fixture, so the
    decision is made when the test runs, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform}); run "
                    "with JAX_PLATFORMS=cuda python -m pytest -m gpu "
                    "tests/test_gpu.py")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release jit executables/tracing caches at module boundaries.

    With ~200 tests in one process the accumulated executables reach
    GBs and XLA:CPU's native compile has been observed to SEGFAULT on
    the largest program once that much is resident (the same test
    passes in isolation)."""
    yield
    jax.clear_caches()
