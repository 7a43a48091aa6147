"""The reference against the port at a small size on the CPU, where the
port runs its plain twins."""

import pytest
import torch

from portbench import compare
from portbench import generator
from portbench.reference import quantize
from portbench.reference import search
from portbench.runners import index_serving
from recommenders_tpu_torch.ops import quantization

CPU = torch.device("cpu")
CATALOG = {"rows": 12000, "dim": 128, "batch": 5000, "centers": 16,
           "noise": 0.6}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("threshold", [None, 0.2])
def test_quantize_is_the_ports(bits, threshold):
    rows = generator.Catalog(CATALOG, 5, CPU).draw(3000, 0)
    s, c = quantize.quantize(rows, threshold, bits)
    ps, pc = quantization.quantize_block(rows, threshold, bits=bits)
    assert torch.equal(c, pc) and torch.equal(s, ps)


def _config(kind: str) -> dict:
    if kind == "ScaNN":
        settings = {"num_leaves": 16, "num_leaves_to_search": 6,
                    "quantize": "int8",
                    "anisotropic_quantization_threshold": 0.2,
                    "leaf_capacity": 1024, "scoring_buckets": 384,
                    "probe_tile": 4, "query_batch": 64,
                    "kmeans_sample_size": 4096,
                    "kmeans_balance_fraction": 0.0625,
                    "training_iterations": 4, "spill_rounds": 8,
                    "assign_chunk": 4096, "seed": 0}
    else:
        settings = {"buckets": 256, "chunk": 512, "query_tile": 32,
                    "quantize": "int8",
                    "anisotropic_quantization_threshold": 0.2}
    return {"catalog": CATALOG, "index": kind, "settings": settings}


@pytest.mark.parametrize("kind", ["ScaNN", "Bucketed"])
def test_reference_answers_what_the_port_answers(kind):
    config = _config(kind)
    catalog = generator.Catalog(config["catalog"], 7, CPU)
    index = index_serving.build_index(config, catalog, CPU)
    queries = catalog.requests(1, 32, generator.REQUEST_SALT)[0]
    scores, ids = index(queries, 50)
    state = index_serving.take_state(index, config, catalog, 2048, 7)
    assert index_serving.misstored(state, catalog.rows) == 0
    table = index_serving.reference_table(config, catalog, 8)
    ref_scores, ref_rows, exact = index_serving.judge(
        config, state, table, queries, 50)
    assert torch.equal(ids.long(), ref_rows)
    torch.testing.assert_close(scores, ref_scores, rtol=1e-6, atol=1e-5)
    got = index_serving.numbers([(queries, scores, ids)],
                                (state.rows, state.codes, state.scales),
                                table, [(ref_scores, ref_rows, exact)])
    assert got["code_gap"] == 0.0
    assert got["score_gap"] < 1e-5 and got["rank_gap"] < 1e-5
    assert got["recall_loss"] == compare.missed(ids, exact) / exact.numel()


def test_exact_top_k_is_a_full_sort():
    catalog = generator.Catalog(CATALOG, 3, CPU)
    codes, scales = quantize.quantize_catalog(catalog(), catalog.rows, 128,
                                              0.2, 8, CPU)
    queries = catalog.requests(1, 8, generator.REQUEST_SALT)[0]
    got_v, got_r = search.exact_top_k(queries, codes, scales, 20,
                                      block_rows=1000)
    want_v, want_r = torch.topk(search.scores(queries, codes, scales), 20,
                                dim=1)
    assert torch.equal(got_r, want_r) and torch.equal(got_v, want_v)


def test_rank_gap_sees_a_missing_row_whatever_replaced_it():
    ref_top = torch.tensor([[10.0, 9.0, 8.0, 7.0]])
    # The row scoring 9 is replaced by one scoring 7.5: every returned
    # row still ties or beats the reference's k-th, yet a row is missing.
    got = torch.tensor([[10.0, 8.0, 7.5, 7.0]])
    gaps = compare.result_gaps(got, got, ref_top)
    assert gaps["score_gap"] == 0.0
    assert gaps["rank_gap"] == pytest.approx(0.1)
    assert compare.result_gaps(ref_top, ref_top, ref_top)["rank_gap"] == 0
    assert compare.missed(torch.tensor([[1, 2, 5]]),
                          torch.tensor([[1, 2, 3]])) == 1


def test_misstored_counts_a_row_held_twice_or_never():
    leaf_rows = torch.tensor([[0, 1, -1], [2, 2, -1]], dtype=torch.int32)
    state = index_serving.State(torch.zeros(2, 4), leaf_rows,
                                torch.zeros(0, dtype=torch.long),
                                torch.zeros(0, 4), torch.zeros(0))
    # Row 2 twice, row 3 never.
    assert index_serving.misstored(state, 4) == 2


def test_malformed_results():
    scores = torch.tensor([[3.0, 2.0, 1.0]])
    ids = torch.tensor([[4, 5, 6]])
    assert not compare.malformed(scores, ids, 1, 3, 10)
    assert compare.malformed(scores, torch.tensor([[4, 4, 6]]), 1, 3, 10)
    assert compare.malformed(scores, torch.tensor([[4, 5, 10]]), 1, 3, 10)
    assert compare.malformed(torch.tensor([[1.0, 2.0, 3.0]]), ids, 1, 3, 10)
    assert compare.malformed(scores, ids, 2, 3, 10)


def test_tile_probes_by_hand():
    cscores = torch.tensor([[9.0, 1.0, 5.0, 0.0],
                            [0.0, 8.0, 1.0, 7.0],
                            [8.0, 0.0, 7.0, 1.0],
                            [1.0, 9.0, 0.0, 2.0]])
    order, tiles = search.tile_probes(cscores, 2, 2)
    # Sorted by nearest centroid: queries 0, 2 (leaf 0), then 1, 3.
    assert order.tolist() == [0, 2, 1, 3]
    assert [t.tolist() for t in tiles] == [[0], [1]]
    order, tiles = search.tile_probes(cscores, 4, 2)
    assert [t.tolist() for t in tiles] == [[0, 2], [1, 3]]
