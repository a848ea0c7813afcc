"""Fixtures shared by the port's parity tests, which run the JAX reference
beside the port in one process."""

import gc

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs a module compiled once it ends: each maps its
    code into the test process, and a worker that runs many modules would
    otherwise reach the kernel's cap on mappings (``vm.max_map_count``) in
    a later module.  A test module takes it with
    ``from _torch_jax import _release_jax_programs  # noqa: F401``."""
    yield
    jax.clear_caches()
    gc.collect()
