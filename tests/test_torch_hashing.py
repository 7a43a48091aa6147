"""`ops.hashing.hash_bucket` against the JAX package's, bit for bit.

The same NumPy ids go to both. JAX runs with 64-bit types off, so an
int64 id array reaches its hash as int32 (the low 32 bits, negative ids
wrapping); the port hashes the int64 tensor itself, and the two must
agree exactly (tolerance: none).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recommenders_tpu.ops import hashing as jax_hashing
from recommenders_tpu_torch.ops import hashing

EDGES = [0, 1, -1, -2, 2**31 - 1, -(2**31), 12345, -98765]
WIDE = [2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 7, -(2**33) - 3,
        2**62 + 11]


def _jax(ids: np.ndarray, num_bins, salt) -> np.ndarray:
    return np.asarray(jax_hashing.hash_bucket(jnp.asarray(ids), num_bins,
                                              salt))


@pytest.mark.parametrize("num_bins", [1, 7, 1000, 2**20 + 3, 2**31 - 1])
@pytest.mark.parametrize("salt", [0, 5, (3, 9), (2**31 - 1, 2**32 + 1),
                                  (-4, 17)])
def test_int32_ids_bit_equal(num_bins, salt):
    rng = np.random.RandomState(0)
    ids = np.concatenate([
        np.asarray(EDGES, np.int32),
        rng.randint(-(2**31), 2**31 - 1, size=500, dtype=np.int64).astype(
            np.int32),
    ])
    got = hashing.hash_bucket(torch.from_numpy(ids), num_bins, salt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax(ids, num_bins, salt))


@pytest.mark.parametrize("salt", [0, (1, 2)])
def test_int64_ids_keep_their_low_32_bits_as_jax_does(salt):
    """Values past 2³², negatives and 2³¹−1: JAX narrows int64 to int32
    (with x64 off), so only the low 32 bits count."""
    ids = np.asarray(EDGES + WIDE, np.int64)
    want = _jax(ids, 977, salt)
    got = hashing.hash_bucket(torch.from_numpy(ids), 977, salt)
    np.testing.assert_array_equal(got.numpy(), want)
    low = torch.from_numpy((ids & 0xFFFFFFFF).astype(np.int64))
    np.testing.assert_array_equal(
        hashing.hash_bucket(low, 977, salt).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.uint8])
def test_narrow_integer_ids(dtype):
    ids = torch.arange(-100, 100).to(dtype)
    want = _jax(ids.numpy(), 33, (7, 0))
    np.testing.assert_array_equal(
        hashing.hash_bucket(ids, 33, 7).numpy(), want)


def test_shape_and_device_are_the_inputs():
    ids = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    got = hashing.hash_bucket(ids, 10)
    assert got.shape == ids.shape and got.device == ids.device
    assert int(got.min()) >= 0 and int(got.max()) < 10
    np.testing.assert_array_equal(got.numpy(),
                                  _jax(ids.numpy(), 10, (0, 0)))


def test_salts_give_independent_hashes_and_float_ids_raise():
    ids = torch.arange(10_000)
    a = hashing.hash_bucket(ids, 1000, (0, 0))
    b = hashing.hash_bucket(ids, 1000, (1, 0))
    c = hashing.hash_bucket(ids, 1000, (0, 1))
    assert float((a == b).float().mean()) < 0.01
    assert float((a == c).float().mean()) < 0.01
    with pytest.raises(TypeError, match="integer ids"):
        hashing.hash_bucket(torch.zeros(3), 10)


def test_mul32_wraps_without_overflow():
    x = torch.tensor([0, 1, 2**32 - 1, 0x89ABCDEF], dtype=torch.int64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
        want = [(int(v) * c) % 2**32 for v in x]
        assert hashing.mul32(x, c).tolist() == want
