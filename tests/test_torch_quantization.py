"""Port parity for `ops/quantization.py`.

Seeded NumPy rows go through the JAX package on the CPU and through the
port with `device="cpu"`. Tolerances: scales to rtol=1e-5 (the f32 sums
in the anisotropic update run in another order); codes equal in at least
99.99% of entries, since a last-bit difference in a scale can move
`v / s` across an exact .5 and flip one code; nibble packing bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.ops import quantization as jax_quant
from recommenders_tpu_torch.ops import quantization
from torch_threads import torch_threads  # noqa: F401 (autouse)

CODE_AGREEMENT = 0.9999


def _rows(n=2000, d=128, seed=0):
    rng = np.random.RandomState(seed)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    rows[7] = 0.0  # An all-zero row keeps its floor scale.
    return rows


def _assert_close(got, want):
    (gs, gc), (ws, wc) = got, want
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=1e-5)
    agree = np.mean(np.asarray(gc) == np.asarray(wc))
    assert agree >= CODE_AGREEMENT, agree
    assert np.asarray(gc).dtype == np.int8


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("threshold", [None, 0.2])
def test_quantize_block_matches_jax(bits, threshold):
    rows = _rows()
    want = jax_quant.quantize_block(jnp.asarray(rows), threshold, bits=bits)
    got = quantization.quantize_block(
        torch.from_numpy(rows), threshold, bits=bits
    )
    _assert_close([t.numpy() for t in got], want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_rows_device_blocks_match_jax(bits):
    """Blocked quantization (a ragged last block) equals the JAX one."""
    rows = _rows(n=1000, seed=1)
    want = jax_quant.quantize_rows_device(
        jnp.asarray(rows), 0.2, chunk=256, bits=bits
    )
    got = quantization.quantize_rows_device(
        torch.from_numpy(rows), 0.2, chunk=256, bits=bits
    )
    _assert_close([t.numpy() for t in got], want)
    whole = quantization.quantize_block(torch.from_numpy(rows), 0.2, bits=bits)
    torch.testing.assert_close(got[0], whole[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], whole[1], rtol=0, atol=0)


@pytest.mark.parametrize("threshold", [None, 0.2])
def test_numpy_twin_matches_jax_package(threshold):
    rows = _rows(seed=2)
    want = jax_quant.quantize_rows(rows, threshold)
    got = quantization.quantize_rows(rows, threshold)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_pack_and_unpack_nibbles_are_bit_exact():
    """Every pair of 4-bit codes packs and unpacks as in the JAX package."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    codes = np.concatenate(
        [lo.reshape(-1, 1), hi.reshape(-1, 1)], axis=0
    ).repeat(3, axis=1).astype(np.int8)  # [512, 3]: row c pairs c + 256.
    want = np.asarray(jax_quant.pack_nibbles(jnp.asarray(codes)))
    got = quantization.pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    all_bytes = np.arange(-128, 128, dtype=np.int8).reshape(-1, 2)
    np.testing.assert_array_equal(
        quantization.unpack_nibbles(torch.from_numpy(all_bytes)).numpy(),
        np.asarray(jax_quant.unpack_nibbles(jnp.asarray(all_bytes))),
    )
    np.testing.assert_array_equal(
        quantization.unpack_nibbles(got).numpy(), codes
    )


def test_pack_nibbles_rejects_odd_rows():
    with pytest.raises(ValueError, match="even row count"):
        quantization.pack_nibbles(torch.zeros((3, 4), dtype=torch.int8))
