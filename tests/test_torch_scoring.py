"""Port parity for K3, the bucketed scoring op (`ops/scoring.py`).

The same seeded NumPy inputs go through the JAX package on the CPU — its
Pallas kernel in interpret mode (as tests/test_scoring_ops.py runs it)
and its jnp reference — and through the port with `device="cpu"`, where
`bucketed_scores` runs its plain PyTorch twin. The CUDA kernel itself is
held against that twin on the card (tests/test_torch_cuda_kernels.py and
chip_smoke.py).

Tolerances: row ids must be equal; scores agree to rtol=atol=1e-5, the
room the f32 sum order leaves at D=128. Equal ids need every bucket's
winner to be separated from its runner-up by more than that, so
`_assert_separated` checks a gap ≥ 1e-4 (ten times the tolerance) in
every bucket before a test compares ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.ops import quantization as jax_quant
from recommenders_tpu.ops import scoring as jax_scoring
from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring

TOL = dict(rtol=1e-5, atol=1e-5)
D = 128
FORMATS = ("f32", "bf16", "int8", "int4")


def _bf16(x: np.ndarray) -> np.ndarray:
    """Rounds to bf16 (half to even) and returns f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _corpus(fmt, n, q, seed, buckets):
    """Seeded queries and the stored corpus of one format, as NumPy.

    Returns (queries, stored, scales, packed4, dequantized) where
    `dequantized` is the f32 matrix whose dot products the op scores.
    """
    rng = np.random.RandomState(seed)
    corpus = rng.normal(size=(n, D)).astype(np.float32)
    queries = rng.normal(size=(q, D)).astype(np.float32)
    if fmt == "f32":
        return queries, corpus, None, False, corpus
    if fmt == "bf16":
        return _bf16(queries), _bf16(corpus), None, False, _bf16(corpus)
    bits = 4 if fmt == "int4" else 8
    scales, codes = jax_quant.quantize_rows(corpus, 0.2, bits=bits)
    deq = codes.astype(np.float32) * scales[:, None]
    stored = (
        np.array(jax_quant.pack_nibbles(jnp.asarray(codes)))
        if bits == 4 else codes
    )
    return queries, stored, scales, bits == 4, deq


def _assert_separated(queries, deq, fmt, buckets, valid_rows):
    """Every bucket's best row beats its runner-up by ≥ 1e-4."""
    q = _bf16(queries) if fmt in ("int8", "int4") else queries
    scores = q.astype(np.float64) @ deq.astype(np.float64).T
    scores[:, valid_rows:] = -np.inf
    n = scores.shape[1]
    grouped = np.sort(scores.reshape(len(q), n // buckets, buckets), axis=1)
    top, second = grouped[:, -1], grouped[:, -2]
    live = np.isfinite(top)
    gap = np.where(np.isfinite(second), top - second, np.inf)[live]
    assert gap.min() >= 1e-4, "seeded data has a near-tie; pick another seed"


def _to_torch(queries, stored, scales, fmt):
    q = torch.from_numpy(queries)
    c = torch.from_numpy(stored)
    if fmt == "bf16":
        q, c = q.to(torch.bfloat16), c.to(torch.bfloat16)
    s = None if scales is None else torch.from_numpy(scales)
    return q, c, s


def _to_jax(queries, stored, scales, fmt):
    q, c = jnp.asarray(queries), jnp.asarray(stored)
    if fmt == "bf16":
        q, c = q.astype(jnp.bfloat16), c.astype(jnp.bfloat16)
    return q, c, None if scales is None else jnp.asarray(scales)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("valid_rows", [4096, 3001])
def test_bucketed_scores_matches_jax_kernel(fmt, valid_rows):
    """Per-bucket state equals the Pallas kernel's (interpret mode)."""
    buckets, chunk = 256, 512
    queries, stored, scales, packed4, deq = _corpus(
        fmt, 4096, 16, seed=1, buckets=buckets
    )
    _assert_separated(queries, deq, fmt, buckets, valid_rows)
    want_v, want_r = jax_scoring.bucketed_scores(
        *_to_jax(queries, stored, scales, fmt), buckets=buckets,
        chunk=chunk, query_tile=16, interpret=True, valid_rows=valid_rows,
        packed4=packed4,
    )
    got_v, got_r = scoring.bucketed_scores(
        *_to_torch(queries, stored, scales, fmt), buckets=buckets,
        chunk=chunk, query_tile=16, valid_rows=valid_rows, packed4=packed4,
    )
    assert got_v.dtype == torch.float32 and got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,q", [(8192, 32), (3000, 20)])
def test_bucketed_top_k_matches_jax_reference(fmt, n, q):
    """The port's top-k (ragged corpus and query count) equals the JAX
    reference, fed the f32 forms the JAX `Bucketed` feeds it on the CPU."""
    buckets, chunk, k = 512, 1024, 50
    if fmt == "int4":
        n = ((n + chunk - 1) // chunk) * chunk  # int4 packs a padded corpus.
    queries, stored, scales, packed4, deq = _corpus(
        fmt, n, q, seed=2, buckets=buckets
    )
    valid_rows = n if fmt != "int4" else n - 100
    padded = ((n + buckets - 1) // buckets) * buckets
    deq_padded = np.pad(deq, ((0, padded - n), (0, 0)))
    _assert_separated(queries, deq_padded, fmt, buckets, valid_rows)
    jq, jc, js = _to_jax(queries, stored, scales, fmt)
    want_v, want_r = jax_scoring.bucketed_top_k_reference(
        jq.astype(jnp.float32), jc if scales is not None
        else jc.astype(jnp.float32), k, buckets=buckets, scales=js,
        packed4=packed4, valid_rows=valid_rows,
    )
    tq, tc, ts = _to_torch(queries, stored, scales, fmt)
    got_v, got_r = scoring.bucketed_top_k(
        tq, tc, k, buckets=buckets, chunk=chunk, query_tile=256, scales=ts,
        packed4=packed4, valid_rows=valid_rows,
    )
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    ref_v, ref_r = scoring.bucketed_top_k_reference(
        tq, tc, k, buckets=buckets, scales=ts, packed4=packed4,
        valid_rows=valid_rows,
    )
    np.testing.assert_array_equal(ref_r.numpy(), got_r.numpy())
    np.testing.assert_allclose(ref_v.numpy(), got_v.numpy(), **TOL)


def test_empty_buckets_and_padding_never_returned():
    """With fewer valid rows than buckets the empty buckets hold
    MIN_FLOAT and their first row (the JAX kernel keeps row 0 there);
    the non-empty buckets agree, and top-k never returns padding."""
    queries, stored, _, _, _ = _corpus("f32", 512, 8, seed=3, buckets=512)
    valid_rows = 300
    got_v, got_r = scoring.bucketed_scores(
        torch.from_numpy(queries), torch.from_numpy(stored), buckets=512,
        chunk=512, valid_rows=valid_rows,
    )
    want_v, want_r = jax_scoring.bucketed_scores(
        jnp.asarray(queries), jnp.asarray(stored), buckets=512, chunk=512,
        interpret=True, valid_rows=valid_rows,
    )
    live = slice(0, valid_rows)
    np.testing.assert_array_equal(
        got_r.numpy()[:, live], np.asarray(want_r)[:, live]
    )
    np.testing.assert_allclose(
        got_v.numpy(), np.asarray(want_v), **TOL
    )
    assert (got_v.numpy()[:, valid_rows:] == scoring.MIN_FLOAT).all()
    np.testing.assert_array_equal(
        got_r.numpy()[:, valid_rows:],
        np.broadcast_to(np.arange(valid_rows, 512), (8, 512 - valid_rows)),
    )
    _, rows = scoring.bucketed_top_k(
        torch.from_numpy(queries), torch.from_numpy(stored[:valid_rows]),
        1000, buckets=512, chunk=512,
    )
    assert rows.shape == (8, valid_rows)
    assert int(rows.max()) < valid_rows


def test_exact_top_k_matches_jax():
    queries, corpus, _, _, _ = _corpus("f32", 500, 32, seed=4, buckets=1)
    valid = np.arange(500) < 480
    want_v, want_i = jax_scoring.exact_top_k(
        jnp.asarray(queries), jnp.asarray(corpus), 10, jnp.asarray(valid)
    )
    got_v, got_i = scoring.exact_top_k(
        torch.from_numpy(queries), torch.from_numpy(corpus), 10,
        torch.from_numpy(valid),
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(n=512, buckets=512, chunk=256), "multiple of buckets"),
        (dict(n=1000, buckets=256, chunk=512), "not a multiple of chunk"),
        (dict(n=512, buckets=256, chunk=512, d=100), "embedding dim"),
        (dict(n=512, buckets=256, chunk=512, q=12, query_tile=8),
         "not a multiple of tile"),
        (dict(n=512, buckets=512, chunk=512, packed4=True,
              valid_rows=512), "divide chunk/2"),
        (dict(n=512, buckets=128, chunk=512, packed4=True), "valid_rows"),
        (dict(n=512, buckets=128, chunk=512, packed4=True,
              valid_rows=512), "per-row scales"),
    ],
)
def test_shape_validation_matches_jax(kwargs, match):
    """The port refuses what the JAX package refuses, with its message."""
    n, d, q = kwargs.pop("n"), kwargs.pop("d", D), kwargs.pop("q", 8)
    rows = n // 2 if kwargs.get("packed4") else n
    tq = torch.zeros((q, d))
    tc = torch.zeros((rows, d), dtype=torch.int8 if kwargs.get("packed4")
                     else torch.float32)
    with pytest.raises(ValueError, match=match):
        jax_scoring.bucketed_scores(
            jnp.asarray(tq.numpy()), jnp.asarray(tc.numpy()), **kwargs
        )
    with pytest.raises(ValueError, match=match):
        scoring.bucketed_scores(tq, tc, **kwargs)


def test_cpu_tensors_use_the_twin_and_count_no_launch():
    queries, stored, _, _, _ = _corpus("f32", 512, 8, seed=5, buckets=256)
    before = scoring.bucketed_scores.launches
    v, r = scoring.bucketed_scores(
        torch.from_numpy(queries), torch.from_numpy(stored), buckets=256,
        chunk=512,
    )
    rv, rr = scoring.bucketed_scores_reference(
        torch.from_numpy(queries), torch.from_numpy(stored), buckets=256,
    )
    assert scoring.bucketed_scores.launches == before
    torch.testing.assert_close(v, rv, rtol=0, atol=0)
    torch.testing.assert_close(r, rr, rtol=0, atol=0)
