"""The DLRM-DCNv2 cell's own pieces: `ranking_work`'s counts against hand
counts, each ranking metric on a hand-made trace (and nothing from an
empty one), the requests' draw, and a traced run at the CPU sizes."""

import importlib.util
import json

import pytest
import torch

from portbench import ranking_work
from portbench import run
from portbench import tracing
from portbench.reference import ranking as ref
from portbench.runners import ranking_serving
from portbench.tests import shared
from portbench.tests.shared import ROOT

CELL = "dlrm-dcnv2-criteo1tb-fp16.pairs100-700"
CONFIG = "dlrm-dcnv2-criteo1tb-fp16"
METRICS = ("pool_roofline", "ranking.mfu", "ranking.dense_ms",
           "ranking.launches", "ranking.host_ms", "pool.launch_us",
           "ranking.idle_share")


def _config():
    return shared.config_file(CONFIG)


def test_dense_flops_by_hand():
    # Bottom 13-512-256-128, three cross layers of two 3,456 x 512
    # products, top 3,456-1024-1024-512-256-1: 16,030,464 multiply-adds.
    assert ranking_work.dense_flops_per_pair(_config()) == 32_060_928
    tiny = dict(_config(), vocab_sizes=[5, 7], embedding_dim=4,
                dense_features=3, bottom_mlp=[4], cross_layers=1,
                cross_rank=2, top_mlp=[1])
    # x0 = 2 x 4 + 4 = 12: bottom 3·4, cross 2·12·2, top 12·1.
    assert ranking_work.dense_flops_per_pair(tiny) == 2 * (12 + 48 + 12)


def test_pool_bytes_count_distinct_rows_by_hand():
    config = dict(_config(), embedding_dim=4)
    ids = [torch.tensor([[3, 3], [3, 5]]),            # rows {3, 5}
           torch.tensor([[0], [-1]], dtype=torch.int32)]   # {0}; a pad
    # ids 4 x 8 B + 2 x 4 B; 3 distinct rows of 4 fp16; [2, 2, 4] f32.
    want = 4 * 8 + 2 * 4 + 3 * 4 * 2 + 2 * 2 * 4 * 4
    assert ranking_work.pool_bytes(config, ids) == want
    work = ranking_work.request_work(config, ids)
    assert work["pool_least_s"] == pytest.approx(want / 3.35e12)
    assert work["flops"] == 2 * ranking_work.dense_flops_per_pair(config)


def test_the_pool_kernel_symbol():
    assert ranking_work.is_pool_kernel(
        "void (anonymous namespace)::pooled_lookup_kernel<__half, 16, 1>"
        "((anonymous namespace)::Plan)")
    assert not ranking_work.is_pool_kernel("my_pooled_lookup_kernel")
    assert not ranking_work.is_pool_kernel("ampere_sgemm_128x64_tn")


def _events():
    span = {"ph": "X", "cat": "user_annotation",
            "name": tracing.REQUEST_SPAN}

    def kernel(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur}

    def mark(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur}

    return [
        dict(span, ts=0.0, dur=100.0), dict(span, ts=100.0, dur=100.0),
        mark("ranking.forward", 1.0, 60.0), mark("pool.launch", 2.0, 8.0),
        mark("ranking.forward", 101.0, 70.0), mark("pool.launch", 103.0, 12.0),
        kernel("void pooled_lookup_kernel<__half, 16, 1>(Plan)", 10.0, 20.0),
        kernel("sm90_xmma_gemm_f32f32", 30.0, 40.0),
        kernel("void pooled_lookup_kernel<__half, 16, 1>(Plan)", 110.0,
               20.0),
        kernel("sm90_xmma_gemm_f32f32", 130.0, 40.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 180.0,
         "dur": 10.0},
    ]


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), ROOT / "portbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_metrics_by_hand():
    trace = tracing.read(_events())
    reading = ranking_serving.Reading(
        trace, {"pool_bytes": 1, "pool_least_s": 10e-6,
                "flops": 67e12 * 50e-6}, {})
    assert _metric("pool_roofline")(reading) == pytest.approx(25.0)
    assert _metric("ranking.mfu")(reading) == pytest.approx(25.0)
    # Outside the pooled kernel: 2 x 40 us of products and a 10 us copy.
    assert _metric("ranking.dense_ms")(reading) == pytest.approx(0.045)
    assert _metric("ranking.launches")(reading) == pytest.approx(2.0)
    assert _metric("ranking.host_ms")(reading) == pytest.approx(0.065)
    assert _metric("pool.launch_us")(reading) == pytest.approx(10.0)
    # Kernels and the copy fill 130 us of the 200 us window.
    assert _metric("ranking.idle_share")(reading) == pytest.approx(35.0)


@pytest.mark.parametrize("name", METRICS)
def test_metrics_read_nothing_from_an_empty_reading(name):
    assert _metric(name)(None) is None
    empty = ranking_serving.Reading(tracing.read([]), {}, {})
    assert _metric(name)(empty) is None


def test_every_ranking_metric_is_listed_for_the_cell_alone():
    listed = {m["name"]: m for m in shared.manifest()["per_layer"]}
    for name in METRICS:
        assert listed[name]["workloads"] == [CELL]
    assert set(shared.applied("per_layer", CELL)) == set(METRICS)


def test_requests_repeat_from_their_seed_and_follow_the_traffic():
    config = dict(_config(), **shared.tiny(CELL)["config"])
    traffic = dict(shared.load(ROOT / "portbench" / "traffic"
                               / "pairs100-700.json"),
                   **shared.tiny(CELL)["traffic"])
    cpu = torch.device("cpu")
    a = ranking_serving.draw_requests(config, traffic, 2**31 + 11, 5, 3, cpu)
    b = ranking_serving.draw_requests(config, traffic, 2**31 + 11, 5, 3, cpu)
    c = ranking_serving.draw_requests(config, traffic, 2**31 + 11, 6, 3, cpu)
    assert a.pairs == b.pairs and all(torch.equal(x, y)
                                      for x, y in zip(a.ids, b.ids))
    assert not all(torch.equal(x, y) for x, y in zip(a.ids, c.ids))
    # Sizes stratified over the range: every seed's pool asks the same.
    assert sorted(a.pairs) == [21, 32, 43]
    assert sorted(ranking_serving.draw_requests(
        config, traffic, 7, 5, 3, cpu).pairs) == [21, 32, 43]
    for x, vocab, bag in zip(a.ids, config["vocab_sizes"],
                             config["multi_hot_sizes"]):
        assert x.shape == (sum(a.pairs), bag) and x.dtype == torch.int64
        assert int(x.min()) >= 0 and int(x.max()) < vocab
    assert bool((a.dense >= 0).all())


def test_zipf_rows_favour_a_few_rows():
    u = torch.rand(20000, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    rows = ranking_serving.zipf_rows(u, 1000, 1.05, a=7, b=3)
    counts = torch.bincount(rows, minlength=1000)
    # Rank 0 sits at row 3: the most drawn, by far.
    assert int(counts.argmax()) == 3
    assert int(counts[3]) > 10 * int(counts.float().median())


def test_the_program_holds_the_references_weights():
    # The tables the runner builds are the reference's draw, stored in
    # the configuration's dtype; the dense layers its draw too.
    config = dict(_config(), **shared.tiny(CELL)["config"])
    cpu = torch.device("cpu")
    model = ranking_serving.build_model(config, 7, cpu)
    seeded = ranking_serving.seeded_by(7, cpu)
    for t, vocab in enumerate(config["vocab_sizes"]):
        table = dict(model.embedding.named_parameters())[
            ("sharded_embedding" if vocab > 10_000 else "dense_embedding")
            + f".t_cat_{t}"]
        assert table.dtype == torch.float16
        assert torch.equal(table[:vocab],
                           ref.table_block(seeded, config, t, 0, cpu))
        assert not bool(table[vocab:].any())
    drawn = ref.dense_weights(seeded, config, cpu)
    params = ranking_serving._dense_parameters(model, config)
    assert all(torch.equal(params[n], drawn[n]) for n in drawn)


def test_a_traced_cpu_run_reads_the_host_span(capsys):
    rc = run.main(["--workload", CELL, "--seed", "3000000019", "--seconds",
                   "0.6", "--trace", "1"], device=torch.device("cpu"),
                  sizes=shared.tiny(CELL))
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"ranking.host_ms"}
    assert result["metrics"]["ranking.host_ms"]["value"] > 0
