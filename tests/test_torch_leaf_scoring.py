"""Port parity for K4 and K5, the probed leaf-scoring ops
(`ops/leaf_scoring.py`).

The same seeded NumPy leaves, probes and queries go through the JAX
package on the CPU — its Pallas kernels in interpret mode (as
tests/test_leaf_scoring.py runs them) and its jnp twins — and through the
port with `device="cpu"`, where each wrapper runs its plain PyTorch twin.
The CUDA kernels are held against those twins on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py).

Tolerance: both sides take the same products in f32 in another order
(the query rounded to bf16 for int8 and int4, the scale after the dot), so
a score agrees to D·2⁻²³·Σ|q||c||s| plus two roundings of the scale
multiply. A K5 bucket's row must be equal wherever the winner beats the
bucket's best candidate of another row by more than twice that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.ops import leaf_scoring as jax_leaf
from recommenders_tpu.ops import quantization as jax_quant
from recommenders_tpu_torch.ops import leaf_scoring
from recommenders_tpu_torch.ops import quantization
from torch_threads import torch_threads  # noqa: F401 (autouse)

D = 128
F32_EPS = 2.0 ** -23
FORMATS = ("f32", "bf16", "int8", "int4")


def _leaves(fmt, num_leaves, cap, seed=0):
    """Stored leaves of one format as (jax leaves, jax scales, torch
    leaves, torch scales, packed4, |dequantized| f32 torch leaves)."""
    rng = np.random.RandomState(seed)
    embs = rng.normal(size=(num_leaves, cap, D)).astype(np.float32)
    if fmt in ("f32", "bf16"):
        t = torch.from_numpy(embs)
        if fmt == "bf16":
            t = t.to(torch.bfloat16)
            j = jnp.asarray(t.float().numpy(), jnp.bfloat16)
        else:
            j = jnp.asarray(embs)
        return j, None, t, None, False, t.float().abs()
    bits = 4 if fmt == "int4" else 8
    scales, codes = jax_quant.quantize_rows(embs, 0.2, bits=bits)
    deq = torch.from_numpy(
        np.abs(codes.astype(np.float32) * scales[..., None]))
    t_codes = torch.from_numpy(codes)
    j_codes = jnp.asarray(codes)
    if bits == 4:
        j_codes = jax_quant.pack_nibbles(j_codes)
        t_codes = quantization.pack_nibbles(t_codes)
        np.testing.assert_array_equal(np.asarray(j_codes), t_codes.numpy())
    return (j_codes, jnp.asarray(scales), t_codes, torch.from_numpy(scales),
            bits == 4, deq)


def _rows(num_leaves, cap, seed=1, pad=5):
    rng = np.random.RandomState(seed)
    rows = rng.permutation(num_leaves * cap).astype(np.int32)
    rows = rows.reshape(num_leaves, cap)
    rows[:, -pad:] = -1
    return rows


def _scored(queries: np.ndarray, quantized: bool) -> torch.Tensor:
    q = torch.from_numpy(queries)
    return q.to(torch.bfloat16).float() if quantized else q


@pytest.mark.parametrize("fmt", FORMATS)
def test_probed_leaf_scores_match_jax(fmt):
    j_leaves, j_scales, t_leaves, t_scales, packed4, deq = _leaves(
        fmt, 8, 256)
    rng = np.random.RandomState(2)
    queries = rng.normal(size=(12, D)).astype(np.float32)
    probes = rng.randint(0, 8, size=(12, 3)).astype(np.int32)
    probes[0, 1] = probes[0, 0]                       # a repeated probe
    got = leaf_scoring.probed_leaf_scores(
        torch.from_numpy(queries), t_leaves, t_scales,
        torch.from_numpy(probes), packed4=packed4,
    ).numpy()
    twin = np.asarray(jax_leaf.probed_scores_reference(
        jnp.asarray(queries), j_leaves, j_scales, jnp.asarray(probes),
        packed4=packed4,
    ))
    abs_dot = leaf_scoring.probed_scores_reference(
        _scored(queries, t_scales is not None).abs(), deq, None,
        torch.from_numpy(probes)).numpy()
    tol = D * F32_EPS * abs_dot + 2 * F32_EPS * np.abs(twin)
    assert got.shape == twin.shape == (12, 3 * 256)
    assert (np.abs(got - twin) <= tol).all()
    kernel = np.asarray(jax_leaf.probed_leaf_scores(
        jnp.asarray(queries), j_leaves, j_scales, jnp.asarray(probes),
        interpret=True, packed4=packed4,
    ))
    assert (np.abs(got - kernel) <= tol).all()


def _assert_buckets_match(got, want, queries, t_leaves, t_scales, deq, rows,
                          probes, buckets, tile, packed4):
    """Scores within the bound at the winner; rows equal wherever the
    winner is separated from the bucket's best other row."""
    gv, gr = (np.asarray(x) for x in got)
    wv, wr = (np.asarray(x) for x in want)
    q = torch.from_numpy(queries)
    cand, cand_rows = leaf_scoring.probed_bucket_candidates(
        q, t_leaves, t_scales, rows, probes, buckets, tile, packed4)
    abs_cand, _ = leaf_scoring.probed_bucket_candidates(
        _scored(queries, t_scales is not None).abs(), deq, None, rows,
        probes, buckets, tile)
    best = cand.argmax(dim=1, keepdim=True)
    abs_dot = torch.gather(abs_cand, 1, best).squeeze(1).clamp(min=0)
    tol = (D * F32_EPS * abs_dot).numpy() + 2 * F32_EPS * np.abs(wv)
    empty = wv <= leaf_scoring.MIN_FLOAT
    assert (gv[empty] == leaf_scoring.MIN_FLOAT).all()
    assert (gr[empty] == -1).all() and (wr[empty] == -1).all()
    assert (np.abs(gv - wv)[~empty] <= tol[~empty]).all()
    win_row = torch.gather(cand_rows, 1, best)
    runner_up = cand.masked_fill(cand_rows == win_row,
                                 leaf_scoring.MIN_FLOAT).amax(dim=1).numpy()
    separated = (wv - runner_up > 2 * tol) & ~empty
    assert separated.sum() >= 0.9 * (~empty).sum()
    np.testing.assert_array_equal(gr[separated], wr[separated])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("query_tile", [1, 8])
def test_probed_bucketed_scores_match_jax(fmt, query_tile):
    """Padding rows (-1), adjacent duplicate probes and an empty probed
    leaf, against JAX's interpreted kernel and its twin."""
    num_leaves, cap, buckets = 8, 256, 128
    j_leaves, j_scales, t_leaves, t_scales, packed4, deq = _leaves(
        fmt, num_leaves, cap, seed=3)
    rows = _rows(num_leaves, cap)
    rows[5] = -1                                      # an empty leaf
    rng = np.random.RandomState(4)
    queries = rng.normal(size=(16, D)).astype(np.float32)
    probes = rng.randint(0, num_leaves, size=(16 // query_tile, 4))
    probes[0, 1] = probes[0, 0]
    probes[-1, 2] = 5
    probes = np.sort(probes, axis=1).astype(np.int32)
    t_rows, t_probes = torch.from_numpy(rows), torch.from_numpy(probes)
    got = leaf_scoring.probed_bucketed_scores(
        torch.from_numpy(queries), t_leaves, t_scales, t_rows, t_probes,
        buckets, query_tile=query_tile, packed4=packed4,
    )
    args = (jnp.asarray(queries), j_leaves, j_scales, jnp.asarray(rows),
            jnp.asarray(probes), buckets)
    twin = jax_leaf.probed_bucketed_reference(
        *args, query_tile=query_tile, packed4=packed4)
    check = (queries, t_leaves, t_scales, deq, t_rows, t_probes, buckets,
             query_tile, packed4)
    _assert_buckets_match(got, twin, *check)
    kernel = jax_leaf.probed_bucketed_scores(
        *args, query_tile=query_tile, interpret=True, packed4=packed4)
    _assert_buckets_match(got, kernel, *check)


@pytest.mark.parametrize("fmt", ["f32", "int8"])
def test_probed_bucketed_partial_tail_group_matches_jax(fmt):
    num_leaves, cap, buckets = 8, 384, 256
    j_leaves, j_scales, t_leaves, t_scales, packed4, deq = _leaves(
        fmt, num_leaves, cap, seed=5)
    rows = _rows(num_leaves, cap, pad=3)
    rng = np.random.RandomState(6)
    queries = rng.normal(size=(8, D)).astype(np.float32)
    probes = rng.randint(0, num_leaves, size=(8, 4)).astype(np.int32)
    t_rows, t_probes = torch.from_numpy(rows), torch.from_numpy(probes)
    got = leaf_scoring.probed_bucketed_scores(
        torch.from_numpy(queries), t_leaves, t_scales, t_rows, t_probes,
        buckets, query_tile=1)
    kernel = jax_leaf.probed_bucketed_scores(
        jnp.asarray(queries), j_leaves, j_scales, jnp.asarray(rows),
        jnp.asarray(probes), buckets, query_tile=1, interpret=True)
    _assert_buckets_match(got, kernel, queries, t_leaves, t_scales, deq,
                          t_rows, t_probes, buckets, 1, packed4)


def test_twins_chunk_without_changing_results(monkeypatch):
    _, _, t_leaves, t_scales, _, _ = _leaves("int8", 6, 128, seed=7)
    rows = torch.from_numpy(_rows(6, 128))
    rng = np.random.RandomState(8)
    queries = torch.from_numpy(rng.normal(size=(12, D)).astype(np.float32))
    probes = torch.from_numpy(rng.randint(0, 6, size=(12, 3)))
    tiles = torch.from_numpy(rng.randint(0, 6, size=(3, 3)))
    whole = leaf_scoring.probed_scores_reference(queries, t_leaves, t_scales,
                                                 probes)
    whole_b = leaf_scoring.probed_bucketed_reference(
        queries, t_leaves, t_scales, rows, tiles, 128, query_tile=4)
    # One query (one tile) a chunk.
    monkeypatch.setattr(leaf_scoring, "_TWIN_CHUNK_ELEMENTS", 1)
    assert leaf_scoring._chunk(3, 128, D, 4) == 1
    torch.testing.assert_close(
        leaf_scoring.probed_scores_reference(queries, t_leaves, t_scales,
                                             probes), whole, rtol=0, atol=0)
    chunked = leaf_scoring.probed_bucketed_reference(
        queries, t_leaves, t_scales, rows, tiles, 128, query_tile=4)
    for a, b in zip(chunked, whole_b):
        assert torch.equal(a, b)


def test_wrappers_refuse_bad_arguments():
    _, _, leaves, scales, _, _ = _leaves("int8", 4, 128)
    rows = torch.from_numpy(_rows(4, 128))
    q = torch.zeros((8, D))
    probes = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed4 requires per-row scales"):
        leaf_scoring.probed_leaf_scores(q, leaves, None, probes, packed4=True)
    with pytest.raises(ValueError, match="packed4 requires per-row scales"):
        leaf_scoring.probed_bucketed_scores(q, leaves, None, rows, probes,
                                            128, query_tile=4, packed4=True)
    with pytest.raises(ValueError, match="queries rows"):
        leaf_scoring.probed_bucketed_scores(q, leaves, scales, rows,
                                            probes, 128, query_tile=3)
    with pytest.raises(ValueError, match="buckets <= cap"):
        leaf_scoring.probed_bucketed_scores(q, leaves, scales, rows,
                                            probes[:2], 256, query_tile=4)
    with pytest.raises(ValueError, match="query dim"):
        leaf_scoring.probed_leaf_scores(q[:, :64], leaves, scales, probes)
    with pytest.raises(ValueError, match="probes rows"):
        leaf_scoring.probed_leaf_scores(q, leaves, scales, probes[:3])
    with pytest.raises(ValueError, match="scales"):
        leaf_scoring.probed_leaf_scores(q, leaves, scales[:, :64], probes)


def test_cpu_tensors_run_the_twin_and_launch_nothing():
    _, _, leaves, scales, _, _ = _leaves("f32", 4, 256)
    scales = torch.ones((4, 256))
    packed = quantization.pack_nibbles(
        torch.zeros((4, 256, D), dtype=torch.int8))
    q = torch.randn(4, D)
    probes = torch.tensor([[0, 1], [2, 3], [1, 1], [3, 0]])
    before = (leaf_scoring.probed_leaf_scores.launches,
              leaf_scoring.probed_bucketed_scores.launches)
    out = leaf_scoring.probed_leaf_scores(q, packed, scales, probes,
                                          packed4=True)
    assert torch.equal(out, torch.zeros((4, 512)))
    vals, rows = leaf_scoring.probed_bucketed_scores(
        q, leaves, None, torch.from_numpy(_rows(4, 256)),
        probes[:1], 128, query_tile=4)
    assert vals.shape == rows.shape == (4, 128)
    assert rows.dtype == torch.int32
    assert (leaf_scoring.probed_leaf_scores.launches,
            leaf_scoring.probed_bucketed_scores.launches) == before
