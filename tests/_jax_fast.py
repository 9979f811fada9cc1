"""The JAX references of the port's test modules, compiled fast.

A test's JAX side is mostly XLA compile time: one program a jit, and one
an operation where it runs eagerly. XLA's CPU backend without most of its
optimisation passes compiles them in about half the time, and the values
are the same to f32 rounding. A port test module imports `jax_fast`, an
autouse module-scoped fixture that turns JAX's
`jax_disable_most_optimizations` on and restores it after the module.
"""
import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def jax_fast():
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)
