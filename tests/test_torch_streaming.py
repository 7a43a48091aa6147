"""The port's `Streaming` index and `ops.topk.streaming_top_k` against the
JAX package, on the CPU.

Mirrors `tests/test_topk_parity_grid.py` for the streaming index: a grid
over k × num_queries × num_candidates in both modes (a corpus on the
device, and host batches streamed through `index_from_dataset`), the
exclusion and string-identifier cases (including string exclusions as
the first query of a host-streamed index), plus streams without ids,
with string ids, mixed (an error) and empty (an error).

The same NumPy inputs go to the JAX index and to the port's. Gaussian
scores do not tie, so ids must be equal (and equal to a NumPy argsort
oracle); scores agree to rtol 1e-5 and atol 1e-5 (f32 dot products of
128 terms summed in another order).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import factorized_top_k as jax_ftk
from recommenders_tpu.ops import topk as jax_topk
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.ops import topk
from torch_threads import torch_threads  # noqa: F401 (autouse)

DIM = 128
CPU = "cpu"


def _oracle(queries, candidates, identifiers, k, exclusions=None):
    scores = queries @ candidates.T
    if exclusions is not None:
        for r in range(queries.shape[0]):
            for ex in exclusions[r]:
                scores[r, identifiers == ex] = -np.inf
    order = np.argsort(-scores, axis=1)[:, :k]
    return identifiers[order]


def _data(seed, n, q):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(n, DIM)).astype(np.float32),
            rng.normal(size=(q, DIM)).astype(np.float32))


def _chunks(candidates, ids=None, rows=128):
    """A batch factory over row blocks: embeddings, or (ids, embeddings)."""
    def factory():
        for i in range(0, candidates.shape[0], rows):
            block = candidates[i:i + rows]
            yield block if ids is None else (ids[i:i + rows], block)
    return factory


def _pair(mode, k, candidates, identifiers=None):
    """The JAX and the port index over the same corpus, in `mode`. String
    identifiers go to both as the NumPy array."""
    numeric = identifiers is not None and identifiers.dtype.kind in "iu"
    jids = jnp.asarray(identifiers) if numeric else identifiers
    tids = torch.from_numpy(identifiers) if numeric else identifiers
    jidx = jax_ftk.Streaming(k=k, chunk_size=128)
    tidx = factorized_top_k.Streaming(k=k, chunk_size=128, device=CPU)
    if mode == "device":
        jidx.index(jnp.asarray(candidates), jids)
        tidx.index(torch.from_numpy(candidates), tids)
    else:
        jidx.index_from_dataset(_chunks(candidates, jids))
        tidx.index_from_dataset(_chunks(torch.from_numpy(candidates), tids))
    return jidx, tidx


GRID = list(itertools.product(
    ("device", "host"),
    (1, 5, 33),              # k
    (3, 16),                 # num_queries
    (200, 512, 1000),        # num_candidates (incl. ragged sizes)
))


@pytest.mark.parametrize("mode,k,num_queries,num_candidates", GRID)
def test_index_matches_jax_and_the_numpy_oracle(mode, k, num_queries,
                                               num_candidates):
    candidates, queries = _data(k * 1000 + num_queries + num_candidates,
                                num_candidates, num_queries)
    identifiers = np.arange(num_candidates, dtype=np.int64) * 3 + 11
    jidx, tidx = _pair(mode, k, candidates, identifiers)
    want_scores, want_ids = jidx(jnp.asarray(queries))
    scores, ids = tidx(torch.from_numpy(queries))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(
        ids.numpy(), _oracle(queries, candidates, identifiers, k))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5, atol=1e-5)
    assert tidx.is_exact()


@pytest.mark.parametrize("chunk_size", [128, 256, 4096])
def test_streaming_top_k_op_matches_jax(chunk_size):
    candidates, queries = _data(4, 1000, 7)
    jc, jids, jvalid = jax_topk.pad_corpus(jnp.asarray(candidates), None,
                                           min(chunk_size, 1024))
    want = jax_topk.streaming_top_k(jnp.asarray(queries), jc, jids, jvalid,
                                    k=50, chunk_size=min(chunk_size, 1024))
    tc, tids, tvalid = topk.pad_corpus(torch.from_numpy(candidates), None,
                                       min(chunk_size, 1024))
    got = topk.streaming_top_k(torch.from_numpy(queries), tc, tids, tvalid,
                               k=50, chunk_size=min(chunk_size, 1024))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        topk.streaming_top_k(torch.from_numpy(queries), tc[:-1], tids[:-1],
                             tvalid[:-1], k=5, chunk_size=128)


def test_k_beyond_the_corpus_returns_the_corpus():
    candidates, queries = _data(5, 40, 3)
    jidx, tidx = _pair("device", 100, candidates)
    scores, ids = tidx(torch.from_numpy(queries))
    want_scores, want_ids = jidx(jnp.asarray(queries))
    assert ids.shape == (3, 40)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))


@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("num_exclusions", (1, 4))
def test_query_with_exclusions_matches_jax(mode, num_exclusions):
    candidates, queries = _data(7 + num_exclusions, 300, 8)
    identifiers = np.arange(300, dtype=np.int64) + 5
    jidx, tidx = _pair(mode, 10, candidates, identifiers)
    _, base = tidx(torch.from_numpy(queries))
    exclusions = base.numpy()[:, :num_exclusions]
    _, want = jidx.query_with_exclusions(jnp.asarray(queries),
                                         jnp.asarray(exclusions))
    _, ids = tidx.query_with_exclusions(torch.from_numpy(queries),
                                        torch.from_numpy(exclusions))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ids.numpy(), _oracle(queries, candidates, identifiers, 10,
                             exclusions=exclusions))


@pytest.mark.parametrize("k,num_candidates",
                         list(itertools.product((1, 5), (200, 512))))
def test_string_identifiers_match_jax(k, num_candidates):
    candidates, queries = _data(k * 100 + num_candidates, num_candidates, 5)
    names = np.asarray([f"item-{i * 3 + 11}" for i in range(num_candidates)])
    for mode in ("device", "host"):
        jidx, tidx = _pair(mode, k, candidates, names)
        _, want = jidx(jnp.asarray(queries))
        _, ids = tidx(torch.from_numpy(queries))
        assert isinstance(ids, np.ndarray) and ids.dtype.kind == "U"
        np.testing.assert_array_equal(ids, np.asarray(want))
        np.testing.assert_array_equal(
            ids, _oracle(queries, candidates, names, k))


@pytest.mark.parametrize("mode", ["device", "host"])
def test_string_exclusions_match_jax(mode):
    candidates, queries = _data(23, 300, 6)
    names = np.asarray([f"m{i}" for i in range(300)])
    jidx, tidx = _pair(mode, 10, candidates, names)
    # The first query of the host-streamed index carries the string
    # exclusions: the id table is found during that very stream.
    exclusions = _oracle(queries, candidates, names, 3)
    _, want = jidx.query_with_exclusions(jnp.asarray(queries), exclusions)
    _, ids = tidx.query_with_exclusions(torch.from_numpy(queries),
                                        exclusions)
    np.testing.assert_array_equal(ids, np.asarray(want))
    np.testing.assert_array_equal(
        ids, _oracle(queries, candidates, names, 10, exclusions=exclusions))


def test_host_stream_without_ids_enumerates_rows():
    candidates, queries = _data(3, 700, 6)
    index = factorized_top_k.Streaming(k=25, device=CPU)
    # A list of batches (not a factory) streams on every query too.
    index.index_from_dataset([torch.from_numpy(candidates[i:i + 128])
                              for i in range(0, 700, 128)])
    for _ in range(2):
        _, ids = index(torch.from_numpy(queries))
        np.testing.assert_array_equal(
            ids.numpy(),
            _oracle(queries, candidates, np.arange(700, dtype=np.int32), 25))
    assert ids.dtype == torch.int32


def test_host_stream_of_numpy_batches_with_string_ids():
    candidates, queries = _data(5, 700, 4)
    names = np.asarray([f"movie/{i}" for i in range(700)])
    index = factorized_top_k.Streaming(k=15, device=CPU)
    index.index_from_dataset(_chunks(candidates, names))
    _, ids = index(torch.from_numpy(queries))
    np.testing.assert_array_equal(ids, _oracle(queries, candidates, names,
                                               15))


def test_mixed_string_and_numeric_stream_raises():
    candidates, queries = _data(6, 256, 2)
    batches = [(np.asarray([f"a{i}" for i in range(128)]), candidates[:128]),
               (np.arange(128, 256), candidates[128:])]
    index = factorized_top_k.Streaming(k=5, device=CPU)
    index.index_from_dataset(batches)
    with pytest.raises(ValueError, match="mixed string and non-string"):
        index(torch.from_numpy(queries))


def test_empty_stream_raises_and_unindexed_raises():
    index = factorized_top_k.Streaming(k=5, device=CPU)
    with pytest.raises(ValueError, match="index"):
        index(torch.zeros(2, DIM))
    index.index_from_dataset(lambda: iter(()))
    with pytest.raises(ValueError, match="must not be empty"):
        index(torch.zeros(2, DIM))


def test_query_fn_and_reindex_switches_mode():
    candidates, queries = _data(9, 300, 4)
    index = factorized_top_k.Streaming(query_fn=lambda x: x * 2.0, k=7,
                                       device=CPU)
    index.index_from_dataset(_chunks(torch.from_numpy(candidates)))
    streamed = index(torch.from_numpy(queries))
    index.index(torch.from_numpy(candidates))
    on_device = index(torch.from_numpy(queries))
    np.testing.assert_array_equal(streamed[1].numpy(), on_device[1].numpy())
    np.testing.assert_allclose(streamed[0].numpy(), on_device[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        on_device[0].numpy(),
        np.sort(2 * queries @ candidates.T, axis=1)[:, ::-1][:, :7],
        rtol=1e-5, atol=1e-5)
