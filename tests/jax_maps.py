"""An autouse fixture for the port's tests that run mfa_tpu beside it.

Every executable that XLA:CPU compiles, or loads from the persistent
compilation cache, maps its code into the process as three anonymous
mappings, and JAX keeps each one alive in its caches. A pytest worker that
runs a few hundred of the suite's JAX tests reaches the kernel's cap on a
process's memory maps (vm.max_map_count, 65530 by default); the next mmap
fails and XLA aborts or segfaults while it loads an executable. Before each
test, `release_jax_code` drops JAX's caches once the process holds more than
half the cap: what the next test needs is traced again and read back from
the persistent cache.

Use: `from tests.jax_maps import release_jax_code  # noqa: F401`."""

import gc

import jax
import pytest


def _read_int(path, default):
    try:
        with open(path) as f:
            return int(f.read())
    except (OSError, ValueError):
        return default


def _map_count():
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # no procfs: nothing to count
        return 0


MAP_BUDGET = _read_int("/proc/sys/vm/max_map_count", 65530) // 2


@pytest.fixture(autouse=True)
def release_jax_code():
    if _map_count() > MAP_BUDGET:
        jax.clear_caches()
        gc.collect()
    yield
