"""The ScaNN serving slice against the JAX package, end to end, on the CPU.

For each configuration a JAX `ScaNN` is built on the CPU over a clustered
corpus (N = 8,192, D = 128, 32 leaves, k = 10). Its arrays cross to a
port `ScaNN` of the same settings through
`utils.convert.scann_state_from_numpy`, so both packages query the same
leaves; the same queries then go through both query paths (JAX through
its jnp twins, the port through its PyTorch twins). Separately the port
builds its own index from the same NumPy corpus and seed.

Tolerances:
  - Scores of the valid results (row ≥ 0) agree to D·2⁻²³·‖q‖·max‖c‖,
    which bounds D·2⁻²³·Σ|q||c||s| (Cauchy–Schwarz) for every stored row
    c, dequantized, and every reorder row. Id sets per query are equal,
    or where they differ the scores agree position by position within
    that bound (a tie at the k-th place).
  - The port's own build: the same initial centroids, bit for bit (the
    same NumPy draws); ≥ 99 % of rows in the same leaf as JAX's build
    (Lloyd sums in another order move near-ties); recall@10 within 0.01
    of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from recommenders_tpu.layers import approximate as jax_approx
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

N, D, LEAVES, K, Q = 8192, 128, 32, 10, 64
F32_EPS = 2.0 ** -23

CONFIGS = {
    "gather_f32": dict(),
    "gather_bf16": dict(leaf_dtype="bf16"),
    "gather_int8": dict(quantize="int8"),
    "gather_int4": dict(quantize="int4"),
    "int8_reorder": dict(quantize="int8", num_reordering_candidates=40),
    # cap 384 over B = 256: a partial tail group.
    "bucketed_int8_T1": dict(quantize="int8", scoring_buckets=256),
    "bucketed_int8_T8": dict(quantize="int8", scoring_buckets=256,
                             probe_tile=8, num_leaves_to_search=16),
    "int4_bucketed_bf16_reorder": dict(
        quantize="int4", scoring_buckets=256, num_reordering_candidates=40,
        reorder_dtype="bf16"),
    "soar": dict(soar_lambda=1.5),
}


def _settings(name, framework):
    kw = dict(k=K, num_leaves=LEAVES, num_leaves_to_search=4,
              training_iterations=8, seed=0)
    kw.update(CONFIGS[name])
    bf16 = jnp.bfloat16 if framework == "jax" else torch.bfloat16
    for key in ("leaf_dtype", "reorder_dtype"):
        if key in kw:
            kw[key] = bf16
    return kw


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    centers = rng.normal(scale=3.0, size=(64, D)).astype(np.float32)
    corpus = (centers[rng.randint(0, 64, N)]
              + rng.normal(size=(N, D)).astype(np.float32))
    queries = (centers[rng.randint(0, 64, Q)]
               + rng.normal(size=(Q, D)).astype(np.float32))
    exact = np.argsort(-(queries @ corpus.T), axis=1, kind="stable")[:, :K]
    return corpus, queries, exact


def _jax_state(index) -> dict:
    arrays = {name: (None if getattr(index, name) is None
                     else np.asarray(getattr(index, name)))
              for name in convert.SCANN_ARRAYS}
    arrays["_num_candidates"] = index._num_candidates
    return arrays


def _recall(ids, exact):
    ids = np.asarray(ids)
    return np.mean([len(np.intersect1d(exact[i], ids[i])) / K
                    for i in range(exact.shape[0])])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_query_path_matches_jax_on_the_same_leaves(data, name):
    corpus, queries, _ = data
    jax_index = jax_approx.ScaNN(**_settings(name, "jax")).index(
        jnp.asarray(corpus))
    port = convert.scann_state_from_numpy(
        approximate.ScaNN(device="cpu", **_settings(name, "torch")),
        _jax_state(jax_index))
    js, ji = (np.asarray(x) for x in jax_index(jnp.asarray(queries)))
    ps, pi = (x.numpy() for x in port(torch.from_numpy(queries)))
    assert ps.shape == pi.shape == js.shape == (Q, K)
    tol = (D * F32_EPS * np.linalg.norm(queries, axis=1)[:, None]
           * chip_smoke.max_row_norm(port))
    # Every result here is a valid row: each query probes far more than
    # k valid rows.
    assert (ps > approximate.MIN_FLOAT / 2).all()
    assert (np.abs(ps - js) <= tol).all()
    for q in range(Q):
        if set(ji[q].tolist()) != set(pi[q].tolist()):
            assert (np.abs(np.sort(ps[q]) - np.sort(js[q])) <= tol[q]).all()


def test_state_round_trips_and_rejects_misshaped_arrays(data):
    corpus, _, _ = data
    jax_index = jax_approx.ScaNN(**_settings("int4_bucketed_bf16_reorder",
                                             "jax")).index(
        jnp.asarray(corpus[:2000]))
    arrays = _jax_state(jax_index)
    port = convert.scann_state_from_numpy(
        approximate.ScaNN(device="cpu",
                          **_settings("int4_bucketed_bf16_reorder", "torch")),
        arrays)
    assert port._corpus.dtype == torch.bfloat16
    back = convert.scann_state_to_numpy(port)
    for name in convert.SCANN_ARRAYS:
        want = arrays[name]
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        np.testing.assert_array_equal(back[name], want)
    fresh = approximate.ScaNN(device="cpu", **_settings(
        "int4_bucketed_bf16_reorder", "torch"))
    with pytest.raises(ValueError, match="_leaf_embs"):
        convert.scann_state_from_numpy(
            fresh, dict(arrays, _leaf_embs=arrays["_leaf_embs"][:, :-1]))
    with pytest.raises(ValueError, match="lacks"):
        convert.scann_state_from_numpy(
            fresh, {k: v for k, v in arrays.items() if k != "_flat_ids"})
    with pytest.raises(ValueError, match="_leaf_scales"):
        convert.scann_state_from_numpy(
            approximate.ScaNN(device="cpu", scoring_buckets=256),
            dict(arrays, _leaf_embs=np.zeros(
                arrays["_leaf_rows"].shape + (D,), np.float32)))


@pytest.mark.parametrize("name", ["gather_int8", "bucketed_int8_T8",
                                  "soar"])
def test_port_build_matches_jax_build(data, name):
    corpus, queries, exact = data
    kw_jax, kw_port = _settings(name, "jax"), _settings(name, "torch")
    # The same initial centroids: the NumPy draws of k-means.
    np.testing.assert_array_equal(
        approximate.kmeans_device(torch.from_numpy(corpus), LEAVES,
                                  iterations=0, seed=0).numpy(),
        np.asarray(jax_approx.kmeans_device(jnp.asarray(corpus), LEAVES,
                                            iterations=0, seed=0)))
    jax_index = jax_approx.ScaNN(**kw_jax).index(jnp.asarray(corpus))
    port = approximate.ScaNN(device="cpu", **kw_port).index(
        torch.from_numpy(corpus))

    def leaf_of_rows(rows):
        rows = np.asarray(rows)
        leaf = np.broadcast_to(np.arange(rows.shape[0])[:, None], rows.shape)
        out = {}
        for r, leaf_id in zip(rows[rows >= 0], leaf[rows >= 0]):
            out.setdefault(int(r), set()).add(int(leaf_id))
        return out

    want = leaf_of_rows(jax_index._leaf_rows)
    got = leaf_of_rows(port._leaf_rows.numpy())
    assert set(got) == set(want) == set(range(N))
    agree = np.mean([got[r] == want[r] for r in range(N)])
    assert agree >= 0.99, agree
    r_jax = _recall(jax_index(jnp.asarray(queries))[1], exact)
    r_port = _recall(port(torch.from_numpy(queries))[1], exact)
    assert abs(r_port - r_jax) <= 0.01, (r_jax, r_port)
