"""Shared test config. NOTE: no xla_force_host_platform_device_count here —
smoke tests and benches must see 1 device; multi-device tests spawn
subprocesses with their own XLA_FLAGS (see test_distributed.py)."""
import gc

import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables():
    """Release XLA executables between test modules.

    Every jitted (shapes × static-args) combination keeps its compiled
    executable alive in the owning function's cache, and each executable
    holds several mmap'd JIT code regions. Across the full suite that
    monotonically approaches vm.max_map_count (65530 by default), at
    which point LLVM's code emitter dies with SIGSEGV mid-compile.
    Clearing per module bounds the map count at the largest single
    module's working set."""
    yield
    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: benchmarks-adjacent / subprocess-heavy tests skipped by "
        "scripts/check.sh --fast")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand-written kernels); "
        "skips without one")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
