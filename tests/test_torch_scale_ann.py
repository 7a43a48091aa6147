"""The 100M × 128 streamed catalog (`chip_smoke.py` phase 38), scaled down
to the CPU, against the JAX package.

Phase 38's own functions run at a tiny size: the streamed generator, the
streamed exact ground truth, and the chunked K3 twin (against
`bucketed_scores_reference` over the whole corpus, with a last slice that
is not a multiple of B). Then the 100M settings, scaled down, build
through both packages' `index_streamed` from the same NumPy batches:
N = 20,000, L = 16, P = 3, T = 32, spill 8, 16 balanced Lloyd iterations
(balance 0.0625), the capacity 1.05 × N / L on the 128-row grid (1,408)
and B = 1,024, so each probed leaf folds as a group of 1,024 slots and a
ragged group of 384, as cap 12,928 over B = 8,192 does at 100M.

Tolerances: ids equal where both packages score the same stored leaves
(their f32 sums differ in order only, and no two of these rows tie); the
port's own build in the same leaf as JAX's for ≥ 0.99 of the slots (Lloyd
sums in another order move near-ties) and recall@20 within 0.01 of
JAX's. JAX's kernels (Pallas, interpret mode) are held to the port's
twins under the smoke's rules: D·2⁻²³·Σ|q||c|·|s| on scores, rows equal
in every bucket whose winner is clear of its runner-up by twice that.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from recommenders_tpu.layers import approximate as jax_approx
from recommenders_tpu.layers import factorized_top_k as jax_topk
from recommenders_tpu.ops import leaf_scoring as jax_leaf
from recommenders_tpu.ops import scoring as jax_scoring
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
D, K = 128, 20
# The 100M settings, scaled down (module docstring).
SIZE = chip_smoke.ScaleSize(
    rows=20_000, batch=5_000, queries=64, requests=2, leaves=16, probes=3,
    scoring_buckets=1024)
CAP = 1408


def _numpy_corpus(size=SIZE, seed=0):
    """The catalog's rows drawn with NumPy (256 centres, 0.6 noise), and
    64 queries drawn the same way."""
    rng = np.random.RandomState(seed)
    centers = rng.normal(size=(size.centers, D)).astype(np.float32)

    def draw(n):
        return (centers[rng.randint(0, size.centers, n)]
                + chip_smoke.SCALE_NOISE
                * rng.normal(size=(n, D)).astype(np.float32))

    return draw(size.rows), draw(size.queries)


@pytest.fixture(scope="module")
def data():
    corpus, queries = _numpy_corpus()
    exact = np.argsort(-(queries @ corpus.T), axis=1, kind="stable")[:, :K]
    return corpus, queries, exact


def _batches(corpus, size=SIZE):
    return [corpus[i:i + size.batch] for i in range(0, len(corpus),
                                                    size.batch)]


def _recall(ids, exact):
    ids = np.asarray(ids)
    return np.mean([len(np.intersect1d(exact[i], ids[i])) / exact.shape[1]
                    for i in range(exact.shape[0])])


@pytest.fixture(scope="module")
def jax_scann(data):
    corpus, _, _ = data
    settings = chip_smoke.scale_scann_settings(SIZE)
    index = jax_approx.ScaNN(k=K, **settings)
    return index.index_streamed(
        [jnp.asarray(b) for b in _batches(corpus)], num_rows=SIZE.rows)


def test_scaled_settings_fold_a_ragged_group():
    settings = chip_smoke.scale_scann_settings(SIZE)
    assert settings["leaf_capacity"] == chip_smoke.scale_capacity(SIZE) == CAP
    assert CAP > SIZE.scoring_buckets and CAP % SIZE.scoring_buckets == 384
    assert SIZE.probe_tile < 64        # below the kernel's query block
    assert chip_smoke.scale_capacity(chip_smoke.ScaleSize()) == 12_928
    assert chip_smoke.full_scale(chip_smoke.ScaleSize(requests=3))
    assert not chip_smoke.full_scale(SIZE)


def test_generator_regenerates_the_same_batches():
    batches, draw = chip_smoke.scale_stream(SIZE, 0, CPU)
    first, second = list(batches()), list(batches())
    assert [b.shape for b in first] == [(SIZE.batch, D)] * 4
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert not torch.equal(first[0], first[1])
    assert torch.equal(draw(8, 3), draw(8, 3))
    assert not torch.equal(draw(8, 3), draw(8, 4))
    other, _ = chip_smoke.scale_stream(SIZE, 1, CPU)
    assert not torch.equal(next(other()), first[0])


def test_streamed_truth_equals_topk_of_the_whole_corpus():
    size = dataclasses.replace(SIZE, rows=7_000, batch=3_000)
    batches, draw = chip_smoke.scale_stream(size, 0, CPU)
    queries = draw(16, chip_smoke.SCALE_QUERY_SALT)
    scores, rows = chip_smoke.streamed_truth(queries, batches, 100)
    corpus = torch.cat(list(batches()))
    want_s, want_r = torch.topk(queries @ corpus.T, 100, dim=1)
    torch.testing.assert_close(scores, want_s, rtol=0, atol=0)
    assert torch.equal(rows, want_r)


@pytest.mark.parametrize("n, valid", [(20_480, 20_000), (12_288, 12_288)])
def test_chunked_k3_twin_equals_the_whole_corpus_twin(n, valid):
    """Slices of 8,192 rows over 20,480 (a last slice of 4,096) and over
    12,288 rows; int8 codes, padding masked by `valid_rows`."""
    rng = np.random.RandomState(2)
    corpus = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
    corpus[valid:] = 0
    queries = torch.from_numpy(rng.normal(size=(32, D)).astype(np.float32))
    scales, codes = chip_smoke.quantization.quantize_rows_device(corpus,
                                                                  0.2)
    scales[valid:] = 0
    got = chip_smoke.chunked_bucketed_twin(queries, codes, scales, 4096,
                                           valid, 8192)
    want = scoring.bucketed_scores_reference(queries, codes, scales,
                                             buckets=4096, valid_rows=valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    table = scoring.reference_scores(queries, codes, scales, valid)
    second = table.view(32, -1, 4096).topk(2, dim=1).values[:, 1]
    assert torch.equal(chip_smoke.chunked_runner_up(
        queries, codes, scales, 4096, valid, 8192), second)
    with pytest.raises(ValueError, match="multiple of B"):
        chip_smoke.chunked_bucketed_twin(queries, codes, scales, 4096,
                                         valid, 6000)


def test_phase_38_passes_on_cpu_at_a_tiny_size(capsys):
    report = chip_smoke.scale_ann(CPU, SIZE, 0)
    assert [r["name"] for r in report] == [
        "probed_bucketed_scores[int8, 100M]", "bucketed_scores[int8, 100M]"]
    for row in report:
        assert {"ms", "launches", "bound_ms", "bound_by", "plain_ms",
                "library_ms", "max_abs_err", "graph_ms"} <= set(row)
        assert row["bound_ms"] > 0 and row["max_abs_err"] == 0
    out = capsys.readouterr().out
    assert "phase 38 100M catalog: ok" in out
    assert f"cap {CAP}, B {SIZE.scoring_buckets}" in out
    assert "sample + k-means" in out and "0 rows unplaced" in out


def test_jax_index_carried_into_the_port_serves_equal_ids(data, jax_scann):
    _, queries, _ = data
    arrays = {n: (None if getattr(jax_scann, n) is None
                  else np.asarray(getattr(jax_scann, n)))
              for n in convert.SCANN_ARRAYS}
    arrays["_num_candidates"] = jax_scann._num_candidates
    port = convert.scann_state_from_numpy(approximate.ScaNN(
        k=K, device=CPU, **chip_smoke.scale_scann_settings(SIZE)), arrays)
    assert port._leaf_rows.shape == (SIZE.leaves, CAP)
    _, want = jax_scann(jnp.asarray(queries), K)
    _, got = port(torch.from_numpy(queries), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_build_agrees_with_jax(data, jax_scann):
    corpus, queries, exact = data
    port = approximate.ScaNN(k=K, device=CPU,
                             **chip_smoke.scale_scann_settings(SIZE))
    port.index_streamed([torch.from_numpy(b) for b in _batches(corpus)],
                        num_rows=SIZE.rows)
    assert int(port._leaf_valid.sum()) == SIZE.rows
    agree = np.mean(port._leaf_rows.numpy()
                    == np.asarray(jax_scann._leaf_rows))
    assert agree >= 0.99, agree
    mine = _recall(port(torch.from_numpy(queries), K)[1].numpy(), exact)
    theirs = _recall(np.asarray(jax_scann(jnp.asarray(queries), K)[1]),
                     exact)
    assert abs(mine - theirs) <= 0.01, (mine, theirs)


def test_jax_k5_interpreted_holds_to_the_port_twin(data, jax_scann):
    """JAX's Pallas K5 on its own index, at the request's probes, against
    the port's twin (the smoke's K5 rule): the ragged fold included."""
    _, queries, _ = data
    port = convert.scann_state_from_numpy(approximate.ScaNN(
        k=K, device=CPU, **chip_smoke.scale_scann_settings(SIZE)),
        {**{n: (None if getattr(jax_scann, n) is None
                else np.asarray(getattr(jax_scann, n)))
            for n in convert.SCANN_ARRAYS},
         "_num_candidates": jax_scann._num_candidates})
    call = chip_smoke.leaf_call(port, "K5", torch.from_numpy(queries))
    assert call.buckets == SIZE.scoring_buckets and call.tile == 32
    vals, rows = jax_leaf.probed_bucketed_scores(
        jnp.asarray(call.queries.numpy()), jnp.asarray(call.leaves.numpy()),
        jnp.asarray(call.scales.numpy()), jnp.asarray(call.rows.numpy()),
        jnp.asarray(call.probes.numpy()), call.buckets,
        query_tile=call.tile, interpret=True)
    for tile in range(call.probes.shape[0]):
        sub = chip_smoke.leaf_subset(call, tile)
        part = slice(tile * call.tile, (tile + 1) * call.tile)
        err, share = chip_smoke.k5_against_twin(
            sub, torch.tensor(np.asarray(vals[part])),
            torch.tensor(np.asarray(rows[part])), sub.leaves.abs(),
            sub.scales.abs(), chip_smoke.scann_scored(port, sub.queries),
            f"tile {tile}")
        assert share >= 0.9


def test_bucketed_streamed_int8_equals_jax(data):
    corpus, queries, _ = data
    kw = dict(k=K, buckets=4096, chunk=4096, query_tile=128,
              quantize="int8")
    jax_index = jax_topk.Bucketed(**kw).index_streamed(
        [jnp.asarray(b) for b in _batches(corpus)], num_rows=SIZE.rows)
    port = factorized_top_k.Bucketed(device=CPU, **kw).index_streamed(
        [torch.from_numpy(b) for b in _batches(corpus)], num_rows=SIZE.rows)
    _, want = jax_index(jnp.asarray(queries), K)
    _, got = port(torch.from_numpy(queries), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # JAX's Pallas K3 (interpret mode) against the smoke's chunked twin on
    # JAX's own codes, under phase 7's rule.
    held = factorized_top_k.Bucketed(device=CPU, **kw)
    held._candidates = torch.tensor(np.asarray(jax_index._candidates))
    held._scales = torch.tensor(np.asarray(jax_index._scales))
    codes, scales, q = held._candidates, held._scales, torch.tensor(queries)
    vals, rows = jax_scoring.bucketed_scores(
        jnp.asarray(queries), jax_index._candidates, jax_index._scales,
        buckets=4096, chunk=4096, query_tile=64, interpret=True,
        valid_rows=SIZE.rows)
    vals, rows = torch.tensor(np.asarray(vals)), torch.tensor(np.asarray(rows))
    want_v, want_r = chip_smoke.chunked_bucketed_twin(q, codes, scales, 4096,
                                                      SIZE.rows, 8192)
    tol = chip_smoke.score_tolerance(held, q, want_r, want_v)
    assert bool(((vals - want_v).abs() <= tol).all())
    second = chip_smoke.chunked_runner_up(q, codes, scales, 4096, SIZE.rows,
                                          8192)
    separated = (want_v - second) > 2 * tol
    assert float(separated.float().mean()) >= 0.9
    assert torch.equal(rows[separated], want_r[separated])


def test_bucketed_query_passes_the_stored_scales_without_a_copy(
        data, monkeypatch):
    """An index on the chunk grid hands its own scales to the kernel: a
    copy would move 400 MB a request at 100M rows."""
    corpus, queries, _ = data
    index = factorized_top_k.Bucketed(
        k=K, buckets=4096, chunk=4096, quantize="int8",
        device=CPU).index_streamed([torch.from_numpy(corpus)], SIZE.rows)
    seen = []
    real = scoring.bucketed_scores_padded

    def spy(queries, candidates, scales, *args):
        seen.append(scales)
        return real(queries, candidates, scales, *args)

    monkeypatch.setattr(scoring, "bucketed_scores_padded", spy)
    index(torch.from_numpy(queries))
    assert seen[0].data_ptr() == index._scales.data_ptr()
    # A corpus off the grid is still padded.
    scores, rows = scoring.bucketed_top_k(
        torch.from_numpy(queries), index._candidates[:10_000], K,
        buckets=4096, chunk=4096, scales=index._scales[:10_000])
    assert seen[1].shape == (12_288,) and int(rows.max()) < 10_000
