"""The port's random generator (firefoam_torch/lagrangian/prng.py) against
jax.random, on the CPU: split, uniform (float32 and float64, with minval and
maxval) and randint (the 64-bit draws of the JAX package's x64 mode)
bitwise; normal within 1e-13 (torch.erfinv against XLA's erf_inv). Several
keys (including a seed above 2^32) and shapes (1-D, 2-D, 3-D, one longer
than a vector register's tail)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_torch.lagrangian import prng

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

SEEDS = (0, 7, 123456789, 2**40 + 5)
SHAPES = ((7,), (2, 33), (4097,), (3, 5, 7))


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    jk, tk = _keys(seed)
    assert tk.numpy().dtype == np.uint32
    assert np.array_equal(np.asarray(jk), tk.numpy())
    for n in (2, 5, 17):
        tks = prng.split(tk, n).numpy()
        assert tks.dtype == np.uint32
        assert np.array_equal(np.asarray(jax.random.split(jk, n)), tks)
    # a chain of splits (the cloud's per-step key handling)
    for _ in range(4):
        jk, _ = jax.random.split(jk)
        tk = prng.split(tk, 2)[0]
    assert np.array_equal(np.asarray(jk), tk.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ("float64", "float32"))
def test_uniform_bitwise(seed, shape, dtype):
    jk, tk = _keys(seed)
    jk, tk = jax.random.split(jk, 3)[1], prng.split(tk, 3)[1]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for lo, hi in ((0.0, 1.0), (0.25, 3.5), (-2.0, 1e-3)):
        a = np.asarray(jax.random.uniform(jk, shape, dtype=jd, minval=lo, maxval=hi))
        b = prng.uniform(tk, shape, td, lo, hi).numpy()
        assert a.dtype == b.dtype
        assert np.array_equal(a, b), (lo, hi)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_randint_bitwise(seed, shape):
    jk, tk = _keys(seed)
    for lo, hi in ((0, 4), (0, 7), (3, 100), (0, 1), (-5, 60000)):
        a = np.asarray(jax.random.randint(jk, shape, lo, hi))
        b = prng.randint(tk, shape, lo, hi).numpy()
        assert a.dtype == np.int64 and b.dtype == np.int64
        assert np.array_equal(a, b), (lo, hi)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_normal(seed, shape):
    jk, tk = _keys(seed)
    a = np.asarray(jax.random.normal(jk, shape))
    b = prng.normal(tk, shape).numpy()
    assert np.max(np.abs(a - b)) <= 1e-13
