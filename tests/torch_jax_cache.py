"""Keep the port's parity tests from leaving compile-cache files behind.

The suite's conftest points JAX's persistent compilation cache at the
committed ``.test_cache`` directory and writes every compile that takes
over two seconds into it. The jitted references of the port's tests
(oracle-engine probes, one per model) would each leave a megabyte-sized
entry in the working tree on every fresh run, and under load even small
eager compiles cross the threshold. A test module that imports
``no_cache_files`` runs each of its tests with the write threshold raised
out of reach; reads of the committed entries go on as before."""

import contextlib

import jax
import pytest

_THRESHOLD = "jax_persistent_cache_min_compile_time_secs"


@contextlib.contextmanager
def no_cache_writes():
    """The write threshold out of reach for the block: for module-scoped
    fixtures, which run before the function-scoped one below."""
    before = getattr(jax.config, _THRESHOLD)
    jax.config.update(_THRESHOLD, 1e9)
    try:
        yield
    finally:
        jax.config.update(_THRESHOLD, before)


@pytest.fixture(autouse=True)
def no_cache_files():
    with no_cache_writes():
        yield
