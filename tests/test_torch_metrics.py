"""The port's `metrics/` against the JAX package, on the CPU.

Every metric of `metrics/base.py` streams the same NumPy batches through
the JAX metric and the port's, and `FactorizedTopK` runs score- and
id-based over the same corpus (padding slots included). Tolerance: rtol
1e-6 and atol 1e-7 on the results (f32 sums in another order); the
states of the counting metrics (accuracies, AUC's buffers) are sums of
exact small integers times weights and agree to the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu import metrics as jax_metrics
from recommenders_tpu.layers import factorized_top_k as jax_ftk
from recommenders_tpu_torch import metrics
from recommenders_tpu_torch.layers import factorized_top_k
from torch_threads import torch_threads  # noqa: F401 (autouse)

CPU = "cpu"
TOL = dict(rtol=1e-6, atol=1e-7)


def _stream(jmetric, tmetric, batches):
    """Feeds `(args, kwargs)` batches to both metrics; returns both
    results and states."""
    js, ts = jmetric.init(), tmetric.init()
    for args, kwargs in batches:
        js = jmetric.update(js, *[jnp.asarray(a) for a in args],
                            **{k: jnp.asarray(v) for k, v in kwargs.items()})
        ts = tmetric.update(ts, *[torch.from_numpy(a) for a in args],
                            **{k: torch.from_numpy(v)
                               for k, v in kwargs.items()})
    return jmetric.result(js), tmetric.result(ts), js, ts


def _assert_states(js, ts):
    assert set(js) == set(ts)
    for k in js:
        assert ts[k].dtype == torch.float32
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL)


def _weights(rng, n):
    return rng.uniform(0.1, 2.0, n).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_mean_and_sum(weighted):
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        values = rng.normal(size=(8, 3)).astype(np.float32)
        kw = {"sample_weight": _weights(rng, 8)} if weighted else {}
        batches.append(((values,), kw))
    for name in ("Mean", "Sum"):
        want, got, js, ts = _stream(getattr(jax_metrics, name)(),
                                    getattr(metrics, name)(), batches)
        # Sums of 24 values of magnitude ~1 that cancel: atol of 24 f32
        # roundings of such values.
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=2e-6)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("name", ["RootMeanSquaredError",
                                  "MeanAbsoluteError", "BinaryAccuracy"])
def test_pointwise_metrics(name):
    rng = np.random.RandomState(1)
    batches = []
    for i in range(3):
        labels = (rng.rand(16) < 0.4).astype(np.float32)
        preds = rng.rand(16).astype(np.float32)
        kw = {"sample_weight": _weights(rng, 16)} if i else {}
        batches.append(((labels, preds), kw))
    want, got, js, ts = _stream(getattr(jax_metrics, name)(),
                                getattr(metrics, name)(), batches)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _assert_states(js, ts)


def test_categorical_accuracies_with_ties():
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(3):
        labels = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 32)]
        # Scores on a coarse grid: many ties, at the target too.
        preds = rng.randint(0, 4, (32, 10)).astype(np.float32)
        batches.append(((labels, preds), {"sample_weight": _weights(rng, 32)}))
    cases = [(jax_metrics.CategoricalAccuracy(),
              metrics.CategoricalAccuracy())]
    cases += [(jax_metrics.TopKCategoricalAccuracy(k=k),
               metrics.TopKCategoricalAccuracy(k=k)) for k in (1, 3, 5)]
    for jm, tm in cases:
        want, got, js, ts = _stream(jm, tm, batches)
        np.testing.assert_allclose(float(got), float(want), **TOL)
        _assert_states(js, ts)


@pytest.mark.parametrize("curve", ["ROC", "PR"])
@pytest.mark.parametrize("weighted", [False, True])
def test_auc(curve, weighted):
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(3):
        labels = (rng.rand(64) < 0.3).astype(np.float32)
        preds = np.clip(labels * 0.3 + rng.rand(64) * 0.7, 0, 1).astype(
            np.float32)
        kw = {"sample_weight": _weights(rng, 64)} if weighted else {}
        batches.append(((labels, preds), kw))
    jm = jax_metrics.AUC(curve=curve)
    tm = metrics.AUC(curve=curve)
    want, got, js, ts = _stream(jm, tm, batches)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _assert_states(js, ts)
    fresh = tm.init()
    # Four distinct buffers.
    assert len({v.data_ptr() for v in fresh.values()}) == 4
    with pytest.raises(ValueError, match="curve"):
        metrics.AUC(curve="XY").result(fresh)


@pytest.mark.parametrize("k", [None, 3])
def test_ndcg_with_mask_and_ties(k):
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(2):
        labels = rng.randint(0, 4, (8, 6)).astype(np.float32)
        preds = rng.randint(0, 3, (8, 6)).astype(np.float32)   # ties
        mask = rng.rand(8, 6) < 0.8
        mask[0] = False                                        # empty list
        batches.append(((labels, preds), {"mask": mask,
                                          "sample_weight": _weights(rng, 8)}))
    want, got, js, ts = _stream(jax_metrics.NDCG(k=k), metrics.NDCG(k=k),
                                batches)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _assert_states(js, ts)


def test_init_all_result_all_and_merge_states():
    rng = np.random.RandomState(5)
    objs = {"mean": metrics.Mean(), "auc": metrics.AUC(num_thresholds=20),
            "top2": metrics.TopKCategoricalAccuracy(k=2)}
    jobjs = {"mean": jax_metrics.Mean(),
             "auc": jax_metrics.AUC(num_thresholds=20),
             "top2": jax_metrics.TopKCategoricalAccuracy(k=2)}
    halves = []
    for part in range(2):
        states = metrics.init_all(objs)
        jstates = jax_metrics.init_all(jobjs)
        labels = (rng.rand(16) < 0.5).astype(np.float32)
        preds = rng.rand(16).astype(np.float32)
        onehot = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 16)]
        logits = rng.normal(size=(16, 4)).astype(np.float32)
        states["mean"] = objs["mean"].update(states["mean"],
                                             torch.from_numpy(preds))
        states["auc"] = objs["auc"].update(
            states["auc"], torch.from_numpy(labels), torch.from_numpy(preds))
        states["top2"] = objs["top2"].update(
            states["top2"], torch.from_numpy(onehot),
            torch.from_numpy(logits))
        jstates["mean"] = jobjs["mean"].update(jstates["mean"],
                                               jnp.asarray(preds))
        jstates["auc"] = jobjs["auc"].update(
            jstates["auc"], jnp.asarray(labels), jnp.asarray(preds))
        jstates["top2"] = jobjs["top2"].update(
            jstates["top2"], jnp.asarray(onehot), jnp.asarray(logits))
        halves.append((states, jstates))
    merged = metrics.merge_states(halves[0][0], halves[1][0])
    jmerged = jax_metrics.merge_states(halves[0][1], halves[1][1])
    got = metrics.result_all(objs, merged)
    want = jax_metrics.result_all(jobjs, jmerged)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-6, err_msg=name)


def _corpus(seed, n=300, q=32, d=16):
    rng = np.random.RandomState(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    true_ids = rng.randint(0, n, q)
    # Half the queries' true candidate is their best match.
    true_ids[::2] = np.argmax(queries @ corpus.T, axis=1)[::2]
    return corpus, queries, true_ids.astype(np.int32)


KS = (1, 5, 10, 50)


def _positives(corpus, true_ids):
    """The true candidates' embeddings for score-based accounting: each
    corpus row 2⁻⁶ longer, so the positive is not itself a corpus row."""
    return corpus[true_ids] * np.float32(1 + 2 ** -6)


def _clear_of_rounding(queries, corpus, positives):
    """Whether every corpus row's score lies further from its query's
    positive score than both f32 sums may round, d·2⁻²³·Σ|q·c| each:
    then no summation order reorders them."""
    q = queries.astype(np.float64)
    c = corpus.astype(np.float64)
    p = positives.astype(np.float64)
    gap = np.abs(q @ c.T - (q * p).sum(1)[:, None])
    bound = queries.shape[1] * 2.0 ** -23 * (
        np.abs(q) @ np.abs(c).T + np.abs(q * p).sum(1)[:, None])
    return bool((gap > bound).all())


def _oracle(queries, corpus, positive, weights, ks):
    """Top-k accuracy in float64: strictly fewer than k corpus rows score
    above each query's `positive` score."""
    scores = queries.astype(np.float64) @ corpus.astype(np.float64).T
    higher = (scores > positive[:, None]).sum(1)
    return [float((weights * (higher < k)).sum() / weights.sum())
            for k in ks]


def _positive_scores(queries, embeddings):
    return (queries.astype(np.float64) * embeddings.astype(np.float64)).sum(1)


def _row_scores(queries, corpus, ids):
    """Float64 scores of corpus rows `ids`, summed as the oracle's matmul
    sums them, so a row never scores above itself."""
    scores = queries.astype(np.float64) @ corpus.astype(np.float64).T
    return scores[np.arange(len(ids)), ids]


@pytest.mark.parametrize("by_ids", [False, True], ids=["scores", "ids"])
def test_factorized_top_k_against_brute_force(by_ids):
    """Equal to the JAX metric, and to a float64 count. Score-based, the
    positives lie off the corpus and clear of f32 rounding of every
    retrieved score; a positive that is itself a corpus row may outrank
    itself by a rounding in either package, each differently
    (`ROADMAP.md` Queue C)."""
    corpus, queries, true_ids = _corpus(6)
    positives = _positives(corpus, true_ids) if not by_ids else (
        corpus[true_ids])
    assert _clear_of_rounding(queries, corpus, _positives(corpus, true_ids))
    weights = _weights(np.random.RandomState(7), queries.shape[0])
    weights[:16] = 1.0
    jm = jax_metrics.FactorizedTopK(
        jax_ftk.BruteForce().index(jnp.asarray(corpus)), ks=KS)
    tm = metrics.FactorizedTopK(
        factorized_top_k.BruteForce(device=CPU).index(
            torch.from_numpy(corpus)), ks=KS)
    halves = []
    for rows in (slice(0, 16), slice(16, 32)):
        kw = {"sample_weight": weights[rows]} if rows.start else {}
        if by_ids:
            kw["true_candidate_ids"] = true_ids[rows]
        halves.append(((queries[rows], positives[rows]), kw))
    want, got, js, ts = _stream(jm, tm, halves)
    assert list(got) == [f"factorized_top_k/top_{k}_categorical_accuracy"
                         for k in KS]
    _assert_states({k: js[k]["total"] for k in KS},
                   {k: ts[k]["total"] for k in KS})
    positive = (_row_scores(queries, corpus, true_ids) if by_ids
                else _positive_scores(queries, positives))
    oracle = _oracle(queries, corpus, positive, weights, KS)
    for (name, value), exact in zip(got.items(), oracle):
        np.testing.assert_allclose(float(value), float(want[name]), **TOL)
        np.testing.assert_allclose(float(value), exact, **TOL)
    assert 0.5 < oracle[0] < oracle[-1] < 1


def test_raw_corpus_and_iterables_wrap_in_streaming():
    corpus, queries, true_ids = _corpus(8)
    positives = _positives(corpus, true_ids)
    assert _clear_of_rounding(queries, corpus, positives)
    tensor = torch.from_numpy(corpus)
    by_tensor = metrics.FactorizedTopK(tensor, ks=KS)
    by_batches = metrics.FactorizedTopK(
        [tensor[i:i + 64] for i in range(0, 300, 64)], ks=KS, device=CPU)
    oracle = _oracle(queries, corpus, _positive_scores(queries, positives),
                     np.ones(len(true_ids)), KS)
    jm = jax_metrics.FactorizedTopK(jnp.asarray(corpus), ks=KS)
    for tm in (by_tensor, by_batches):
        assert isinstance(tm.candidates, factorized_top_k.Streaming)
        assert tm.candidates.k == max(KS)
        # Score-based and id-based through the wrapped index: the JAX
        # metric's numbers (and, score-based, the float64 count).
        want, got, _, _ = _stream(jm, tm, [((queries, positives), {})])
        for (name, value), exact in zip(got.items(), oracle):
            np.testing.assert_allclose(float(value), float(want[name]),
                                       **TOL)
            np.testing.assert_allclose(float(value), exact, **TOL)
        want, got, _, _ = _stream(jm, tm, [(
            (queries, corpus[true_ids]), {"true_candidate_ids": true_ids})])
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       **TOL)


def test_id_based_accounting_ignores_padding_slots():
    """A host-streamed index over fewer rows than max(ks) pads its
    results with MIN_FLOAT scores and id 0; a true id 0 must not match
    those slots."""
    rng = np.random.RandomState(9)
    corpus = rng.normal(size=(20, 8)).astype(np.float32)
    queries = np.abs(rng.normal(size=(6, 8))).astype(np.float32)
    # True id 0 for every query, and corpus row 0 far below the rest for
    # these positive queries, so it ranks last among the 20 real rows.
    corpus[0] = -10.0
    true_ids = np.zeros(6, np.int32)

    jst = jax_ftk.Streaming(k=50).index_from_dataset(
        lambda: iter([jnp.asarray(corpus[:10]), jnp.asarray(corpus[10:])]))
    tst = factorized_top_k.Streaming(k=50, device=CPU).index_from_dataset(
        lambda: iter([torch.from_numpy(corpus[:10]),
                      torch.from_numpy(corpus[10:])]))
    jm = jax_metrics.FactorizedTopK(jst, ks=(1, 10, 50))
    tm = metrics.FactorizedTopK(tst, ks=(1, 10, 50))
    scores, ids = tst(torch.from_numpy(queries), k=50)
    assert bool((ids[:, 20:] == 0).all())
    assert bool((scores[:, 20:] == factorized_top_k.MIN_FLOAT).all())
    want, got, js, ts = _stream(
        jm, tm, [((queries, corpus[true_ids]),
                  {"true_candidate_ids": true_ids})])
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   **TOL)
    # Row 0 is found at k = 50 (it is one of the 20 real rows) and not
    # at 1 or 10; each query counts once.
    results = list(got.values())
    assert float(results[0]) == float(results[1]) == 0.0
    assert float(results[2]) == 1.0


def test_approximate_index_needs_true_ids():
    corpus, queries, true_ids = _corpus(10, n=512, d=128)
    index = factorized_top_k.Bucketed(buckets=256, chunk=256,
                                      device=CPU).index(
        torch.from_numpy(corpus))
    tm = metrics.FactorizedTopK(index, ks=(1, 10))
    with pytest.raises(ValueError, match="true_candidate_ids"):
        tm.update(tm.init(), torch.from_numpy(queries),
                  torch.from_numpy(corpus[true_ids]))
    jm = jax_metrics.FactorizedTopK(
        jax_ftk.Bucketed(buckets=256, chunk=256).index(jnp.asarray(corpus)),
        ks=(1, 10))
    want, got, _, _ = _stream(jm, tm, [((queries, corpus[true_ids]),
                                        {"true_candidate_ids": true_ids})])
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   **TOL)
