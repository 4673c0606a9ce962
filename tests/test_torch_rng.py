"""ptsharp_tpu_torch.core.rng against jax.random (threefry, partitionable
layout as tests/conftest.py sets it).

Tolerance: bit-equal. Keys, uniforms (compared as raw float32 bits) and
randints must be identical for every seed and shape.
"""

import jax
import numpy as np
import pytest
import torch

from ptsharp_tpu_torch.core import rng

SEEDS = [0, 1, 7, 4242, 2**31 - 1]
SHAPES = [(1,), (5,), (2, 33), (4099,)]


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bit_equal(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_np(jax.random.split(kj, num)),
                                      rng.split(kt, num).numpy())
    sj, st = jax.random.split(kj, 3)[2], rng.split(kt, 3)[2]
    for data in (0, 7, 131 * 4, 70000 + 131 * 3, 2**32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(sj, data)),
                                      rng.fold_in(st, data).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_bit_equal(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    kt = rng.fold_in(rng.PRNGKey(seed), 11)
    uj = np.asarray(jax.random.uniform(kj, shape))
    ut = rng.uniform(kt, shape).numpy()
    assert ut.dtype == np.float32 and ut.shape == uj.shape
    np.testing.assert_array_equal(ut.view(np.int32), uj.view(np.int32))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 1000])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_randint_bit_equal(seed, n):
    kj = jax.random.split(jax.random.PRNGKey(seed))[1]
    kt = rng.split(rng.PRNGKey(seed))[1]
    for shape in SHAPES:
        rj = np.asarray(jax.random.randint(kj, shape, 0, n))
        rt = rng.randint(kt, shape, 0, n).numpy()
        assert rt.dtype == rj.dtype
        np.testing.assert_array_equal(rt, rj)


def test_uniform_made_on_requested_device():
    u = rng.uniform(rng.PRNGKey(0), (8,), device="cpu")
    assert u.device.type == "cpu" and u.dtype == torch.float32
    assert bool(((u >= 0) & (u < 1)).all())
