"""`recommenders_tpu_torch.ops.product_quantization` against the JAX
module, on the CPU; each test mirrors one of
`tests/test_product_quantization.py`.

Exact parity (bit for bit, from the same codebooks): `normalize_rows`
("max" and None), `encode`, `pack_codes` / `unpack_codes`, `query_lut`,
`score_block` and both `pq_top_k` merges, at these tests' widths (up to
16 subspaces of 16 codes, where both sum the one-hot product's few
nonzero terms in subspace order). Top-k ids are equal ties included:
rows with equal codes score equally, and both rank the lower row first
(`lax.top_k`'s order). `normalize_rows("l2")`
takes its norm in another summation order than XLA: within 2 f32 ulps.

`jax.random`'s draws cannot be reproduced, so the k-means++ seeding
differs: `lloyd` continues JAX's own seeding (`train_codebooks(...,
iterations=0)`) to JAX's codebooks within rtol 1e-4 / atol 1e-5 (the
one-hot sums run in another order; the JAX suite holds its own block
sizes to the same), and the port's own `train_codebooks` reaches a
reconstruction error within 5 % of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.ops import product_quantization as jpq
from recommenders_tpu.ops import quantization as jqz
from recommenders_tpu_torch.ops import product_quantization as pq
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _clustered(rng, n, d, num_clusters=40, spread=0.3):
    centers = rng.normal(size=(num_clusters, d)).astype(np.float32)
    x = centers[rng.randint(0, num_clusters, n)]
    return (x + spread * rng.normal(size=(n, d))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _recon_error(x, codebooks, scales=None, normalized=None):
    """Mean squared error of `x` rebuilt from the codes of `normalized`
    (default `x`) times `scales`."""
    codes = pq.encode(_t(x) if normalized is None else normalized, codebooks)
    recon = pq.decode(codes, codebooks).numpy()
    if scales is not None:
        recon = recon * scales[:, None]
    return float(np.mean(np.square(recon - x)))


def _assert_top_k_matches(got, want):
    """Scores and ids equal, ties too (rows with equal codes score
    equally; both rank the lower row first)."""
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gv), np.asarray(wv))
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))


class TestCodebooks:
    def test_exact_on_separable_data(self):
        # 16 distinct values per subspace: k-means must reach zero error.
        rng = np.random.RandomState(0)
        levels = rng.normal(size=(4, 16, 2)).astype(np.float32)
        picks = rng.randint(0, 16, size=(2000, 4))
        x = levels[np.arange(4)[None], picks].reshape(2000, 8)
        cb = pq.train_codebooks(_t(x), num_subspaces=4, iterations=15,
                                block=512)
        recon = pq.decode(pq.encode(_t(x), cb), cb).numpy()
        np.testing.assert_allclose(recon, x, atol=1e-5)

    def test_error_decreases_with_iterations(self):
        rng = np.random.RandomState(1)
        x = _clustered(rng, 4096, 16)

        def err(iters):
            cb = pq.train_codebooks(_t(x), 8, iterations=iters,
                                    generator=_gen(3), block=2048)
            return _recon_error(x, cb)

        assert err(12) <= err(1) * 1.0001

    def test_block_size_invariance(self):
        rng = np.random.RandomState(2)
        x = _clustered(rng, 3000, 8)
        cb_a = pq.train_codebooks(_t(x), 4, iterations=4, generator=_gen(7),
                                  block=512)
        cb_b = pq.train_codebooks(_t(x), 4, iterations=4, generator=_gen(7),
                                  block=3000)
        np.testing.assert_allclose(cb_a.numpy(), cb_b.numpy(), rtol=1e-4,
                                   atol=1e-5)

    def test_dim_mismatch_raises(self):
        with pytest.raises(ValueError, match="subspaces"):
            pq.train_codebooks(torch.zeros((100, 10)), 4)

    @pytest.mark.parametrize("d,s", [(16, 8), (16, 16), (32, 16)])
    def test_lloyd_from_the_jax_seeding_matches_jax(self, d, s):
        rng = np.random.RandomState(11)
        x = _clustered(rng, 4096, d)
        key = jax.random.PRNGKey(3)
        seeding = jpq.train_codebooks(x, s, iterations=0, rng=key,
                                      block=2048)
        want = jpq.train_codebooks(x, s, iterations=6, rng=key, block=2048)
        got = pq.lloyd(_t(x), _t(seeding), 6, block=2048)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)

    @pytest.mark.parametrize("d,s", [(16, 8), (32, 16)])
    def test_own_training_within_five_percent_of_jax(self, d, s):
        rng = np.random.RandomState(12)
        x = _clustered(rng, 8192, d)
        want = jpq.train_codebooks(x, s, iterations=10,
                                   rng=jax.random.PRNGKey(0), block=4096)
        err_jax = _recon_error(x, _t(np.asarray(want)))
        err = _recon_error(x, pq.train_codebooks(_t(x), s, iterations=10,
                                                 block=4096))
        assert err <= err_jax * 1.05, (err, err_jax)


class TestCodes:
    def test_pack_unpack_roundtrip(self):
        rng = np.random.RandomState(3)
        codes = rng.randint(0, 16, size=(257, 6)).astype(np.int8)
        packed = pq.pack_codes(_t(codes))
        assert packed.shape == (257, 3)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jpq.pack_codes(jnp.asarray(codes))))
        np.testing.assert_array_equal(pq.unpack_codes(packed).numpy(), codes)

    def test_pack_odd_subspaces_raises(self):
        with pytest.raises(ValueError, match="even"):
            pq.pack_codes(torch.zeros((4, 3), dtype=torch.int8))

    def test_encode_chunked_matches_unchunked_and_jax(self):
        rng = np.random.RandomState(4)
        x = _clustered(rng, 1030, 8)
        cb = np.asarray(jpq.train_codebooks(x, 4, iterations=3, block=512))
        a = pq.encode(_t(x), _t(cb), chunk=256)
        b = pq.encode(_t(x), _t(cb), chunk=4096)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(jpq.encode(x, cb)))
        np.testing.assert_array_equal(
            pq.decode(a, _t(cb)).numpy(),
            np.asarray(jpq.decode(jnp.asarray(a.numpy()), cb)))


class TestScoring:
    def test_score_block_matches_decode_matmul_and_jax(self):
        rng = np.random.RandomState(5)
        x = _clustered(rng, 512, 16)
        q = rng.normal(size=(8, 16)).astype(np.float32)
        cb = np.asarray(jpq.train_codebooks(x, 8, iterations=4, block=512))
        codes = pq.encode(_t(x), _t(cb))
        lut = pq.query_lut(_t(q), _t(cb))
        np.testing.assert_array_equal(lut.numpy(),
                                      np.asarray(jpq.query_lut(q, cb)))
        packed = pq.pack_codes(codes)
        got = pq.score_block(lut, packed).numpy()
        np.testing.assert_array_equal(got, np.asarray(jpq.score_block(
            jnp.asarray(lut.numpy()), jnp.asarray(packed.numpy()))))
        want = q @ pq.decode(codes, _t(cb)).numpy().T
        # bf16 rounding on the LUT side: |err| ≤ S · 2⁻⁸ · max|lut|.
        tol = 8 * 2.0 ** -8 * float(lut.abs().max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)

    def test_top_k_exact_merge_matches_reconstructed_search_and_jax(self):
        rng = np.random.RandomState(6)
        n, d, k = 2048, 16, 8
        x = _clustered(rng, n, d)
        q = _clustered(rng, 16, d)
        cb = np.asarray(jpq.train_codebooks(x, 8, iterations=5, block=1024))
        packed = pq.pack_codes(pq.encode(_t(x), _t(cb)))
        got = pq.pq_top_k(_t(q), packed, _t(cb), k, chunk=512,
                          exact_merge=True)
        want = jpq.pq_top_k(jnp.asarray(q), jnp.asarray(packed.numpy()),
                            jnp.asarray(cb), k, chunk=512, exact_merge=True)
        _assert_top_k_matches(got, want)
        # The data holds such ties among the returned scores.
        scores = pq.score_block(pq.query_lut(_t(q), _t(cb)), packed).numpy()
        assert any(np.sum(scores[r] == v) > 1
                   for r, row in enumerate(got[0].numpy()) for v in row)
        # The reference search of the JAX test (its `lax.top_k` keeps the
        # lower row of rows with equal codes, an exact tie).
        recon = pq.decode(pq.unpack_codes(packed), _t(cb)).numpy()
        ev, ei = jax.lax.top_k(jnp.asarray(q) @ jnp.asarray(recon).T, k)
        assert pq.recall(got[1], np.asarray(ei)) >= 0.99
        np.testing.assert_allclose(np.sort(got[0].numpy()),
                                   np.sort(np.asarray(ev)), rtol=0,
                                   atol=6e-2)

    def test_top_k_bucketed_padding_and_scales_and_jax(self):
        rng = np.random.RandomState(7)
        n, d, k = 1500, 16, 10
        x = _clustered(rng, n, d)
        q = _clustered(rng, 12, d)
        scales, xn = pq.normalize_rows(_t(x), "max")
        cb = np.asarray(jpq.train_codebooks(xn.numpy(), 8, iterations=5,
                                            block=1024))
        codes = pq.encode(xn, _t(cb))
        pad = (-n) % 512
        packed = torch.nn.functional.pad(pq.pack_codes(codes), (0, 0, 0, pad))
        scales_p = torch.nn.functional.pad(scales, (0, pad))
        got = pq.pq_top_k(_t(q), packed, _t(cb), k, row_scales=scales_p,
                          valid_rows=n, buckets=256, chunk=512)
        assert int(got[1].max()) < n
        want = jpq.pq_top_k(jnp.asarray(q), jnp.asarray(packed.numpy()),
                            jnp.asarray(cb), k,
                            row_scales=jnp.asarray(scales_p.numpy()),
                            valid_rows=n, buckets=256, chunk=512)
        _assert_top_k_matches(got, want)
        recon = pq.decode(codes, _t(cb)) * scales[:, None]
        _, ei = torch.topk(_t(q) @ recon.T, k)
        # Bucketed selection loses only top-k items colliding in a bucket.
        assert pq.recall(got[1], ei) >= 0.9

    def test_normalize_rows_modes_match_jax(self):
        rng = np.random.RandomState(8)
        x = rng.normal(size=(64, 8)).astype(np.float32) * 5
        for mode in ("max", "l2", None):
            s, xn = pq.normalize_rows(_t(x), mode)
            np.testing.assert_allclose((xn * s[:, None]).numpy(), x,
                                       rtol=1e-5)
            js, jxn = jpq.normalize_rows(x, mode)
            if mode == "l2":
                np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js),
                                                maxulp=2)
            else:
                np.testing.assert_array_equal(s.numpy(), np.asarray(js))
                np.testing.assert_array_equal(xn.numpy(), np.asarray(jxn))
        with pytest.raises(ValueError, match="normalize"):
            pq.normalize_rows(_t(x), "bogus")


class TestVsScalarInt4:
    def test_learned_grids_beat_uniform_at_matched_bits(self):
        """ds=1 PQ on max-normalized rows vs scalar int4: same storage
        (a row scale + 4 bits a dimension), learned cells; the
        reconstruction must not be worse."""
        rng = np.random.RandomState(9)
        x = _clustered(rng, 8192, 16)
        i4_scales, i4_codes = jqz.quantize_rows(x, None, bits=4)
        err_i4 = float(np.mean(np.square(
            i4_codes.astype(np.float32) * i4_scales[:, None] - x)))
        scales, xn = pq.normalize_rows(_t(x), "max")
        cb = pq.train_codebooks(xn, 16, iterations=20, block=4096)
        err_pq = _recon_error(x, cb, scales.numpy(), xn)
        assert err_pq <= err_i4 * 1.05, (err_pq, err_i4)

    def test_half_bit_config_recall_with_reorder_budget(self):
        """ds=2 (2 bits a dimension): its top-R candidates must still hold
        most of the exact top-k."""
        rng = np.random.RandomState(10)
        n, d, k, r = 4096, 32, 10, 100
        x = _clustered(rng, n, d)
        q = _clustered(rng, 32, d)
        _, ei = torch.topk(_t(q) @ _t(x).T, k)
        scales, xn = pq.normalize_rows(_t(x), "max")
        cb = pq.train_codebooks(xn, 16, iterations=10, block=2048)
        packed = pq.pack_codes(pq.encode(xn, cb))
        _, pi = pq.pq_top_k(_t(q), packed, cb, r, row_scales=scales,
                            buckets=512, chunk=1024)
        assert pq.recall(pi, ei) >= 0.85
