"""`recommenders_tpu_torch.utils.export` against the JAX package's
`utils/export.py`, on the CPU; each test mirrors one of
`tests/test_export.py`.

Every index is built in both packages from the same NumPy corpus
(ScaNN's arrays cross from the JAX build through `utils.convert`, so
both query the same leaves), exported, loaded, and served:
  - the port's `load_index` returns exactly what the port's index
    returns (the export runs the index's own ops);
  - against the JAX package's `load_index`: ids equal (the data are
    untied), scores to the tolerances `tests/test_torch_scoring.py`
    (rtol = atol = 1e-5) and `tests/test_torch_approximate.py` (1e-4)
    hold those indexes to; bf16 corpora to rtol 1e-2, as the JAX test.
On the CPU an export traces the kernels' plain twins; the CUDA path
(the dispatcher ops) is exported and checked on the card
(`chip_smoke.py` phase 35).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import approximate as jax_approx
from recommenders_tpu.layers import factorized_top_k as jax_topk
from recommenders_tpu.utils import export as jax_export
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.utils import convert
from recommenders_tpu_torch.utils import export as export_lib
from recommenders_tpu_torch.utils import native_serving as ns
from torch_threads import torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
SCANN_TOL = dict(rtol=1e-4, atol=1e-4)


def _data(n, d, q, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _serve_both(tmp_path, jax_index, port_index, queries, k):
    """(port load_index result, JAX load_index result), after holding the
    port's to the port index's own result bit for bit."""
    jax_export.export_index(str(tmp_path / "jax"), jax_index,
                            jnp.asarray(queries), k=k)
    export_lib.export_index(str(tmp_path / "port"), port_index,
                            torch.from_numpy(queries), k=k)
    got = export_lib.load_index(str(tmp_path / "port"))(
        torch.from_numpy(queries))
    eager = port_index(torch.from_numpy(queries), k=k)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    want = jax_export.load_index(str(tmp_path / "jax"))(jnp.asarray(queries))
    return ([np.asarray(x, np.float32) if x.dtype.is_floating_point
             else np.asarray(x) for x in got],
            [np.asarray(x) for x in want])


def _assert_same(got, want, tol=TOL):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], np.asarray(want[0], np.float32),
                               **tol)


def _scann_pair(corpus, **settings):
    """A JAX ScaNN built over `corpus` and the port's over its arrays."""
    jax_settings = dict(settings)
    port_settings = dict(settings)
    for key in ("leaf_dtype", "reorder_dtype"):
        if key in settings:
            jax_settings[key] = jnp.bfloat16
            port_settings[key] = torch.bfloat16
    jax_index = jax_approx.ScaNN(**jax_settings)
    jax_index.index(jnp.asarray(corpus))
    arrays = {name: (None if getattr(jax_index, name) is None
                     else np.asarray(getattr(jax_index, name)))
              for name in convert.SCANN_ARRAYS}
    arrays["_num_candidates"] = jax_index._num_candidates
    port = convert.scann_state_from_numpy(
        approximate.ScaNN(device="cpu", **port_settings), arrays)
    return jax_index, port


def test_fn_roundtrip(tmp_path):
    def score(q, c):
        return q @ c.T

    queries, corpus = _data(64, 16, 8)
    q, c = torch.from_numpy(queries), torch.from_numpy(corpus)
    export_lib.export_fn(str(tmp_path / "fn"), score, q, c)
    served = export_lib.load_fn(str(tmp_path / "fn"))
    assert torch.equal(served(q, c), score(q, c))
    jax_export.export_fn(str(tmp_path / "jfn"), score, jnp.asarray(queries),
                         jnp.asarray(corpus))
    want = jax_export.load_fn(str(tmp_path / "jfn"))(queries, corpus)
    np.testing.assert_allclose(served(q, c).numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("n", [512, 500])  # A padded corpus too.
def test_brute_force_index_roundtrip(tmp_path, n):
    queries, corpus = _data(n, 32, 8)
    ids = np.arange(n, dtype=np.int64) * 7
    jax_index = jax_topk.BruteForce(k=10).index(jnp.asarray(corpus),
                                                jnp.asarray(ids))
    port = factorized_top_k.BruteForce(k=10, device="cpu").index(
        torch.from_numpy(corpus), torch.from_numpy(ids))
    _assert_same(*_serve_both(tmp_path, jax_index, port, queries, 10))


def test_bucketed_index_roundtrip(tmp_path):
    queries, corpus = _data(1024, 128, 8, seed=1)
    jax_index = jax_topk.Bucketed(k=10, buckets=512, chunk=512).index(
        jnp.asarray(corpus))
    port = factorized_top_k.Bucketed(k=10, buckets=512, chunk=512,
                                     device="cpu").index(
        torch.from_numpy(corpus))
    _assert_same(*_serve_both(tmp_path, jax_index, port, queries, 10))


def test_bucketed_index_export_keeps_serving_config(tmp_path):
    """A non-default query tile and a bf16 corpus survive into the
    export: it scores in bf16 as the index does."""
    queries, corpus = _data(1024, 128, 8, seed=5)
    jax_index = jax_topk.Bucketed(
        k=10, buckets=512, chunk=512, query_tile=128,
        corpus_dtype=jnp.bfloat16).index(jnp.asarray(corpus))
    port = factorized_top_k.Bucketed(
        k=10, buckets=512, chunk=512, query_tile=128,
        corpus_dtype=torch.bfloat16, device="cpu").index(
        torch.from_numpy(corpus))
    got, want = _serve_both(tmp_path, jax_index, port, queries, 10)
    assert export_lib._load_arrays(str(tmp_path / "port"))[
        "candidates"].dtype == torch.bfloat16
    _assert_same(got, want, dict(rtol=1e-2))


def test_export_unbuilt_raises(tmp_path):
    with pytest.raises(ValueError, match="built"):
        export_lib.export_index(str(tmp_path / "x"),
                                factorized_top_k.BruteForce(k=5,
                                                            device="cpu"),
                                torch.zeros((2, 8)), k=5)
    with pytest.raises(ValueError, match="built"):
        export_lib.export_index(str(tmp_path / "y"),
                                approximate.ScaNN(k=5, device="cpu"),
                                torch.zeros((2, 8)), k=5)


def test_export_model_forward(tmp_path):
    """A trained model's query tower, its weights carried from JAX,
    exports and serves standalone."""
    import optax

    from recommenders_tpu import data as jax_data
    from recommenders_tpu import models as jax_models
    from recommenders_tpu_torch import models

    ds = jax_data.synthetic_movielens(num_users=50, num_movies=80,
                                      num_interactions=2000, seed=2)
    model = jax_models.TwoTowerRetrieval(
        query_tower=lambda: jax_models.EmbeddingTower(50, 16, (16,)),
        candidate_tower=lambda: jax_models.EmbeddingTower(80, 16))
    trainer = jax_models.Trainer(model, optax.adagrad(0.1))
    sample = next(jax_data.batched(ds.as_dict(), 128)())
    state = trainer.init(jax.random.PRNGKey(0), sample)
    state, _ = trainer.train_step(state, sample)
    params = jax.device_get(state.params)

    port = models.TwoTowerRetrieval(
        query_tower=models.EmbeddingTower(50, 16, (16,), device="cpu"),
        candidate_tower=models.EmbeddingTower(80, 16, device="cpu"))
    convert.load_flax_params(port, jax.tree.map(np.asarray, params))
    port.eval()

    def query_tower(user_ids):
        return port.query_embeddings({"user_id": user_ids})

    user_ids = torch.tensor([1, 2, 3], dtype=torch.int32)
    export_lib.export_fn(str(tmp_path / "tower"), query_tower, user_ids)
    served = export_lib.load_fn(str(tmp_path / "tower"))
    with torch.no_grad():
        got = served(user_ids)
        assert torch.equal(got, query_tower(user_ids))
    want = model.apply({"params": params},
                       {"user_id": jnp.asarray([1, 2, 3], jnp.int32)},
                       method="query_embeddings")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scann_index_roundtrip(tmp_path):
    queries, corpus = _data(2000, 64, 8, seed=3)
    pair = _scann_pair(corpus, k=10, num_leaves=16, num_leaves_to_search=4,
                       quantize=True)
    _assert_same(*_serve_both(tmp_path, *pair, queries, 10), SCANN_TOL)


def test_scann_unquantized_roundtrip(tmp_path):
    queries, corpus = _data(800, 32, 4, seed=4)
    pair = _scann_pair(corpus, k=5, num_leaves=8, num_leaves_to_search=8)
    _assert_same(*_serve_both(tmp_path, *pair, queries, 5), SCANN_TOL)


def test_bucketed_quantized_index_roundtrip(tmp_path):
    queries, corpus = _data(1024, 128, 8, seed=9)
    jax_index = jax_topk.Bucketed(k=10, buckets=512, chunk=512,
                                  quantize=True).index(jnp.asarray(corpus))
    port = factorized_top_k.Bucketed(k=10, buckets=512, chunk=512,
                                     quantize=True, device="cpu").index(
        torch.from_numpy(corpus))
    got, want = _serve_both(tmp_path, jax_index, port, queries, 10)
    data = np.load(str(tmp_path / "port" / "arrays.npz"))
    assert data["candidates"].dtype == np.int8
    assert "scales" in data.files
    _assert_same(got, want)


def test_scann_reorder_roundtrip(tmp_path):
    """The exported program carries the exact-reorder pass."""
    queries, corpus = _data(2000, 64, 8, seed=21)
    pair = _scann_pair(corpus, k=10, num_leaves=16, num_leaves_to_search=8,
                       quantize=True, num_reordering_candidates=50)
    _assert_same(*_serve_both(tmp_path, *pair, queries, 10), SCANN_TOL)


def test_scann_bf16_leaves_roundtrip(tmp_path):
    """bf16 leaf and reorder arrays are stored as uint16 bits and come
    back bf16: the served program takes bf16 arguments directly."""
    queries, corpus = _data(1500, 64, 8, seed=22)
    pair = _scann_pair(corpus, k=10, num_leaves=8, num_leaves_to_search=8,
                       leaf_dtype="bf16", reorder_dtype="bf16",
                       num_reordering_candidates=40)
    got, want = _serve_both(tmp_path, *pair, queries, 10)
    raw = np.load(str(tmp_path / "port" / "arrays.npz"))
    assert raw["leaf_embs"].dtype == np.uint16
    assert raw["corpus"].dtype == np.uint16
    back = export_lib._load_arrays(str(tmp_path / "port"))
    assert back["leaf_embs"].dtype == back["corpus"].dtype == torch.bfloat16
    _assert_same(got, want, SCANN_TOL)


def test_scann_soar_roundtrip(tmp_path):
    """SOAR indexes export with the duplicate-removal search path."""
    queries, corpus = _data(2000, 64, 8, seed=23)
    pair = _scann_pair(corpus, k=10, num_leaves=16, num_leaves_to_search=4,
                       soar_lambda=1.5, quantize=True,
                       num_reordering_candidates=40)
    _assert_same(*_serve_both(tmp_path, *pair, queries, 10), SCANN_TOL)


def test_scann_bucketed_tile_roundtrip(tmp_path):
    """scoring_buckets + probe_tile indexes export with the bucketed
    search path, the queries padded to the tile width."""
    queries, corpus = _data(3000, 128, 8, seed=24)
    pair = _scann_pair(corpus, k=10, num_leaves=16, num_leaves_to_search=8,
                       scoring_buckets=512, probe_tile=4, quantize=True)
    _assert_same(*_serve_both(tmp_path, *pair, queries, 10), SCANN_TOL)


def test_bucketed_int4_index_roundtrip(tmp_path):
    queries, corpus = _data(1000, 128, 8, seed=33)
    jax_index = jax_topk.Bucketed(k=10, buckets=256, chunk=512,
                                  quantize="int4").index(jnp.asarray(corpus))
    port = factorized_top_k.Bucketed(k=10, buckets=256, chunk=512,
                                     quantize="int4", device="cpu").index(
        torch.from_numpy(corpus))
    got, want = _serve_both(tmp_path, jax_index, port, queries, 10)
    data = np.load(str(tmp_path / "port" / "arrays.npz"))
    # Packed: 1024 padded rows → 512 stored rows of bytes.
    assert data["candidates"].dtype == np.int8
    assert data["candidates"].shape[0] == 512
    assert data["scales"].shape[0] == 1024
    _assert_same(got, want)


def test_scann_int4_reorder_roundtrip(tmp_path):
    queries, corpus = _data(2000, 128, 8, seed=34)
    pair = _scann_pair(corpus, k=10, num_leaves=16, num_leaves_to_search=8,
                       quantize="int4", num_reordering_candidates=50)
    got, want = _serve_both(tmp_path, *pair, queries, 10)
    data = np.load(str(tmp_path / "port" / "arrays.npz"))
    assert data["leaf_embs"].dtype == np.int8
    assert data["leaf_scales"].shape[1] == data["leaf_embs"].shape[1] * 2
    _assert_same(got, want, SCANN_TOL)


def test_export_keeps_every_argument(tmp_path):
    """`jax.export` drops arguments the function never reads, and its
    host must feed only the kept ones (`kept_args.json`). `torch.export`
    keeps them all, so the arguments the manifest lists are the
    program's, in order: the gather path of a ScaNN export, which never
    reads `flat_ids` or the reorder corpus, takes every array it lists,
    `leaf_ids` and `leaf_valid` included."""
    def fn(queries, used, unused):
        return queries @ used.T

    q = torch.ones((4, 8))
    used, unused = torch.ones((6, 8)), torch.ones((5,), dtype=torch.int32)
    program = export_lib.export_fn(str(tmp_path / "fn"), fn, q, used,
                                   unused, arguments=["used", "unused"])
    assert len(program.graph_signature.user_inputs) == 3
    assert export_lib.read_manifest(str(tmp_path / "fn"))["arguments"] == [
        "used", "unused"]
    served = export_lib.load_fn(str(tmp_path / "fn"))
    assert torch.equal(served(q, used, unused), fn(q, used, unused))

    queries, corpus = _data(800, 32, 4, seed=4)
    _, port = _scann_pair(corpus, k=5, num_leaves=8, num_leaves_to_search=2,
                          quantize=True)
    path = str(tmp_path / "scann")
    export_lib.export_index(path, port, torch.from_numpy(queries), k=5)
    names = export_lib.read_manifest(path)["arguments"]
    assert names == ["centroids", "leaf_embs", "leaf_scales", "leaf_ids",
                     "leaf_rows", "leaf_valid"]
    program = export_lib.load_program(path)
    assert len(program.graph_signature.user_inputs) == 1 + len(names)
    args = ns.host_arguments(path)
    assert [a.shape for a in args] == [tuple(getattr(port, f"_{n}").shape)
                                       for n in names]


def test_bf16_export_arrays_restore_for_native_host(tmp_path):
    """A bf16 corpus reaches the native host as real bf16 tensors: the
    npz holds uint16 bits and a key manifest, the loader restores bf16
    through torch (no ml_dtypes), and the host's container carries bf16
    (code 3)."""
    rng = np.random.RandomState(0)
    corpus = rng.normal(size=(2048, 128)).astype(np.float32)
    queries = rng.normal(size=(8, 128)).astype(np.float32)
    index = factorized_top_k.Bucketed(k=5, buckets=512, chunk=512,
                                      corpus_dtype=torch.bfloat16,
                                      device="cpu").index(
        torch.from_numpy(corpus))
    path = str(tmp_path / "bf16idx")
    export_lib.export_index(path, index, torch.from_numpy(queries), k=5)
    data = export_lib._load_arrays(path)
    assert data["candidates"].dtype == torch.bfloat16
    assert torch.equal(data["candidates"], index._candidates)
    tpath = str(tmp_path / "t.bin")
    ns.write_tensors(tpath, [data["candidates"][:4]])
    (back,) = ns.read_tensors(tpath)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, data["candidates"][:4])
    s, ids = export_lib.load_index(path)(torch.from_numpy(queries))
    want_s, want_i = index(torch.from_numpy(queries))
    assert torch.equal(ids, want_i) and torch.equal(s, want_s)


def test_padding_rows_decode_to_a_sentinel_not_row_zero(tmp_path):
    """String identifiers decode through `identifiers.json`; an empty
    result slot (row -1: k beyond the valid slots of the probed leaves)
    decodes to "", where the JAX loader's `mode="clip"` gives row 0's
    string (a reference defect the port does not copy)."""
    queries, corpus = _data(300, 16, 4, seed=7)
    strings = np.asarray([f"item-{i}" for i in range(300)])
    index = approximate.ScaNN(k=5, num_leaves=16, num_leaves_to_search=1,
                              device="cpu").index(torch.from_numpy(corpus),
                                                  strings)
    path = str(tmp_path / "strings")
    k = 60   # more than one leaf holds
    export_lib.export_index(path, index, torch.from_numpy(queries), k=k)
    with open(tmp_path / "strings" / "identifiers.json") as f:
        assert json.load(f) == strings.tolist()
    scores, ids = export_lib.load_index(path)(torch.from_numpy(queries))
    want_scores, want_ids = index(torch.from_numpy(queries), k=k)
    assert torch.equal(scores, want_scores)
    np.testing.assert_array_equal(ids, want_ids)
    empty = scores.numpy() <= approximate.MIN_FLOAT / 2
    assert empty.any() and (~empty).any()
    assert (ids[empty] == "").all()
    assert "item-0" not in set(ids[empty].tolist())
    assert all(s.startswith("item-") for s in ids[~empty])
