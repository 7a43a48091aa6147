"""Port parity for the retrieval index layers (`layers/factorized_top_k.py`).

`BruteForce` and `Bucketed` (f32, bf16, int8, int4; built by `index` and
by `index_streamed`; numeric, string and no identifiers) are built from
the same seeded NumPy corpus in the JAX package on the CPU — where the
JAX `Bucketed` runs its jnp reference — and in the port with
`device="cpu"`, where it runs the kernel's plain twin.

Tolerances: ids equal (the seeded corpus has no near-tie at the top-k
boundary or inside a bucket at these sizes); scores to rtol=atol=1e-5,
the room the f32 sum order leaves at D=128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import factorized_top_k as jax_ftk
from recommenders_tpu_torch.layers import factorized_top_k as ftk
from torch_threads import torch_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
N, D, Q, K = 3000, 128, 16, 20
BUCKETED = dict(buckets=256, chunk=512, query_tile=16)
MODES = {
    "f32": {},
    "bf16": {"corpus_dtype": (jnp.bfloat16, torch.bfloat16)},
    "int8": {"quantize": "int8"},
    "int4": {"quantize": "int4"},
}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    corpus = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    return queries, corpus


def _identifiers(kind):
    if kind == "numeric":
        return np.arange(N, dtype=np.int32) * 7 + 3
    if kind == "string":
        return np.array([f"item_{i}" for i in range(N)])
    return None


def _pair(mode):
    """A (JAX, port) pair of Bucketed indexes with the same settings."""
    kw = dict(MODES[mode])
    jax_kw, torch_kw = dict(kw), dict(kw)
    if "corpus_dtype" in kw:
        jax_kw["corpus_dtype"], torch_kw["corpus_dtype"] = kw["corpus_dtype"]
    return (
        jax_ftk.Bucketed(k=K, **BUCKETED, **jax_kw),
        ftk.Bucketed(k=K, **BUCKETED, **torch_kw, device="cpu"),
    )


def _assert_same(got, want):
    got_s, got_i = got
    want_s, want_i = want
    np.testing.assert_allclose(
        got_s.numpy(), np.asarray(want_s, np.float32), **TOL
    )
    got_i = got_i.numpy() if isinstance(got_i, torch.Tensor) else got_i
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("ids", [None, "numeric", "string"])
def test_brute_force_matches_jax(ids):
    queries, corpus = _data()
    identifiers = _identifiers(ids)
    want = jax_ftk.BruteForce(k=K).index(
        jnp.asarray(corpus),
        jnp.asarray(identifiers) if ids == "numeric" else identifiers,
    )(jnp.asarray(queries))
    got = ftk.BruteForce(k=K, device="cpu").index(
        torch.from_numpy(corpus),
        torch.from_numpy(identifiers) if ids == "numeric" else identifiers,
    )(torch.from_numpy(queries))
    _assert_same(got, want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("build", ["index", "index_streamed"])
@pytest.mark.parametrize("ids", [None, "numeric", "string"])
def test_bucketed_matches_jax(mode, build, ids):
    queries, corpus = _data(seed=1)
    identifiers = _identifiers(ids)
    jax_index, index = _pair(mode)
    if build == "index":
        jax_index.index(
            jnp.asarray(corpus),
            jnp.asarray(identifiers) if ids == "numeric" else identifiers,
        )
        index.index(
            torch.from_numpy(corpus),
            torch.from_numpy(identifiers) if ids == "numeric"
            else identifiers,
        )
    else:
        # Uneven batches; for int4 one straddles the nibble boundary.
        cuts = [0, 700, 1536, 1700, N]
        jax_index.index_streamed(
            [jnp.asarray(corpus[a:b]) for a, b in zip(cuts, cuts[1:])], N,
            jnp.asarray(identifiers) if ids == "numeric" else identifiers,
        )
        index.index_streamed(
            lambda: (torch.from_numpy(corpus[a:b])
                     for a, b in zip(cuts, cuts[1:])), N,
            torch.from_numpy(identifiers) if ids == "numeric"
            else identifiers,
        )
    np.testing.assert_array_equal(
        index._candidates.float().numpy(),
        np.asarray(jax_index._candidates, np.float32),
    )
    _assert_same(index(torch.from_numpy(queries)),
                 jax_index(jnp.asarray(queries)))


@pytest.mark.parametrize("layer", ["brute_force", "bucketed"])
@pytest.mark.parametrize("ids", ["numeric", "string"])
def test_query_with_exclusions_matches_jax(layer, ids):
    queries, corpus = _data(seed=2)
    identifiers = _identifiers(ids)
    if layer == "brute_force":
        jax_index = jax_ftk.BruteForce(k=K)
        index = ftk.BruteForce(k=K, device="cpu")
    else:
        jax_index, index = _pair("f32")
    jax_index.index(
        jnp.asarray(corpus),
        jnp.asarray(identifiers) if ids == "numeric" else identifiers,
    )
    index.index(
        torch.from_numpy(corpus),
        torch.from_numpy(identifiers) if ids == "numeric" else identifiers,
    )
    # Exclude each query's current results 0, 2, 4, ... plus an unknown id.
    _, top = jax_index(jnp.asarray(queries))
    exclusions = np.asarray(top)[:, ::2]
    unknown = "nope" if ids == "string" else -5
    exclusions = np.concatenate(
        [exclusions, np.full((Q, 1), unknown, exclusions.dtype)], axis=1
    )
    want = jax_index.query_with_exclusions(
        jnp.asarray(queries),
        exclusions if ids == "string" else jnp.asarray(exclusions),
    )
    got = index.query_with_exclusions(
        torch.from_numpy(queries),
        exclusions if ids == "string" else torch.from_numpy(exclusions),
    )
    _assert_same(got, want)
    got_ids = np.asarray(got[1])
    for row, excl in zip(got_ids, exclusions):
        assert not set(row.tolist()) & set(excl.tolist())


def test_index_from_dataset_with_string_batches():
    queries, corpus = _data(seed=3)
    strings = _identifiers("string")
    cuts = [0, 1000, 2000, N]
    jax_batches = [(strings[a:b], jnp.asarray(corpus[a:b]))
                   for a, b in zip(cuts, cuts[1:])]
    batches = [(strings[a:b], torch.from_numpy(corpus[a:b]))
               for a, b in zip(cuts, cuts[1:])]
    want = jax_ftk.BruteForce(k=K).index_from_dataset(jax_batches)(
        jnp.asarray(queries)
    )
    got = ftk.BruteForce(k=K, device="cpu").index_from_dataset(batches)(
        torch.from_numpy(queries)
    )
    _assert_same(got, want)
    plain = ftk.BruteForce(k=K, device="cpu").index_from_dataset(
        [b for _, b in batches]
    )(torch.from_numpy(queries))
    np.testing.assert_array_equal(
        strings[plain[1].numpy()], np.asarray(want[1])
    )


def test_padding_rows_decode_to_a_sentinel_not_row_zero():
    """The JAX `_decode` clips row -1 to row 0's string (`mode="clip"`);
    the port decodes any row outside the index to the empty identifier."""
    strings = _identifiers("string")
    corpus = _data()[1]
    rows = np.array([[-1, 0, 2, N]])
    jax_index = jax_ftk.BruteForce(k=K).index(jnp.asarray(corpus), strings)
    index = ftk.BruteForce(k=K, device="cpu").index(
        torch.from_numpy(corpus), strings
    )
    _, want = jax_index._decode(None, rows)
    _, got = index._decode(None, torch.from_numpy(rows))
    assert want[0, 0] == "item_0"  # The reference defect the port avoids.
    assert got.tolist() == [["", "item_0", "item_2", ""]]
    valid = (rows >= 0) & (rows < N)
    np.testing.assert_array_equal(got[valid], want[valid])


def test_bucketed_settings_are_validated_like_jax():
    for kw in (dict(quantize="int5"),
               dict(quantize="int8", corpus_dtype=torch.bfloat16),
               dict(quantize="int4", buckets=512, chunk=512)):
        with pytest.raises(ValueError):
            ftk.Bucketed(device="cpu", **kw)
    index = ftk.Bucketed(device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        index.index(torch.zeros((10, 100)))
    with pytest.raises(ValueError, match="index` method"):
        index(torch.zeros((2, 128)))


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; this checks the CPU-only behaviour")
    for make in (ftk.BruteForce, ftk.Bucketed):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
