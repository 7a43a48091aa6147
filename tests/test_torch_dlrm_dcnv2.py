"""DLRM-DCNv2 at MLPerf's widths through the port's serving path
(`Ranking` → `PartialEmbedding` → `TpuEmbedding` → `ops.pooled_lookup`),
on the CPU with every vocabulary cut to at most 4,096 rows (the
benchmark cell's CPU sizes, `portbench/tiny/`), against two plain
references on the seeded block-drawn weights: `tests/plain/dlrm_dcnv2.py`
and the benchmark's own, `portbench/reference/ranking.py`.

Tolerance: the program, the two references and the controls all compute
in f32 from the same fp16 rows and f32 weights; they differ only in the
order of f32 sums (the pooled bags, the products' accumulation, the bias
adds), which moves a logit by a few f32 ulps of the largest one. 1e-5 of
the largest |logit| is ~80 ulps; the cell's limit is 2e-5, and pooling
in fp16 has to exceed that.
"""

import json
from pathlib import Path

import pytest
import torch

from plain import dlrm_dcnv2 as plain
from portbench.reference import ranking as ref
from portbench.runners import ranking_serving
from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.models import ranking
from recommenders_tpu_torch.ops import pooled_lookup
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELL = "dlrm-dcnv2-criteo1tb-fp16.pairs100-700"
GAP = 1e-5


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cell():
    """(config at the CPU sizes, traffic at the CPU sizes, limits)."""
    tiny = _load(ROOT / "portbench" / "tiny" / "dlrm-dcnv2-criteo1tb-fp16.json")
    config = dict(_load(ROOT / "portbench" / "configs"
                        / "dlrm-dcnv2-criteo1tb-fp16.json"), **tiny["config"])
    traffic = dict(_load(ROOT / "portbench" / "traffic"
                         / "pairs100-700.json"), **tiny["traffic"])
    limits = _load(ROOT / "portbench" / "workloads" / f"{CELL}.json")[
        "limits"]
    return config, traffic, limits


@pytest.fixture(scope="module")
def served(cell):
    """The model, two requests and their logits through `Ranking.logits`,
    and the benchmark reference over them."""
    config, traffic, _ = cell
    seed = 2**31 + 7
    model = ranking_serving.build_model(config, seed, CPU)
    pool = ranking_serving.draw_requests(config, traffic, seed, 11, 2, CPU)
    batches = pool.batches(ranking_serving.feature_names(config))
    with torch.inference_mode():
        got = [model.logits(b) for b in batches]
        reference = ref.Reference(
            config, ranking_serving.seeded_by(seed, CPU),
            [pool.parts(j) for j in range(len(pool))], CPU)
    tables = [ref.table_block(ranking_serving.seeded_by(seed, CPU), config,
                              t, 0, CPU)
              for t in range(len(config["vocab_sizes"]))]
    return model, pool, batches, got, reference, tables


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def test_ranking_at_mlperf_widths_matches_the_plain_reference(cell, served):
    config, _, _ = cell
    model, pool, _, got, reference, tables = served
    assert model.interaction_width == 27 * 128
    for j, logits in enumerate(got):
        ids, dense = pool.parts(j)
        want = plain.logits(tables, reference.weights, ids, dense,
                            len(config["bottom_mlp"]),
                            config["cross_layers"], len(config["top_mlp"]))
        assert logits.shape == (pool.pairs[j],)
        assert logits.dtype == torch.float32
        assert _gap(logits, want) <= GAP


def test_the_two_references_give_equal_logits(cell, served):
    config, _, _ = cell
    _, pool, _, _, reference, tables = served
    for j in range(len(pool)):
        ids, dense = pool.parts(j)
        want = plain.logits(tables, reference.weights, ids, dense,
                            len(config["bottom_mlp"]),
                            config["cross_layers"], len(config["top_mlp"]))
        assert _gap(reference.logits(ids, dense), want) <= GAP


def test_fp16_pooling_exceeds_the_cells_limit(cell, served):
    _, _, limits = cell
    _, pool, _, got, reference, _ = served
    gaps = []
    for j, logits in enumerate(got):
        ids, dense = pool.parts(j)
        want = reference.logits(ids, dense)
        assert _gap(logits, want) <= limits["logit_gap"]
        gaps.append(_gap(reference.logits(ids, dense,
                                          accumulate=torch.float16), want))
    assert max(gaps) > limits["logit_gap"], gaps


def test_x0_is_pooled_by_one_call_into_its_sparse_columns(served,
                                                          monkeypatch):
    model, _, batches, got, _, _ = served
    calls = []
    original = pooled_lookup.pooled_lookup

    def counted(*args, **kwargs):
        calls.append(len(args[0]))
        return original(*args, **kwargs)

    monkeypatch.setattr(pooled_lookup, "pooled_lookup", counted)
    with torch.inference_mode():
        again = model.logits(batches[0])
        # The generic path: each feature's lookup, then x0 by `cat`.
        names = [fc.name for fc in model.feature_configs]
        embedded = model.embedding({n: batches[0][n] for n in names})
        x0 = torch.cat([embedded[n] for n in names]
                       + [model.bottom(batches[0]["dense_features"])], 1)
        generic = model.top.logits(model.interaction(x0))[:, 0]
    assert calls == [26, 26]
    assert torch.equal(again, got[0])
    assert torch.equal(again, generic)


def test_a_block_drawn_table_equals_the_whole_draw_cast(cell, monkeypatch):
    config, _, _ = cell
    monkeypatch.setattr(ref, "BLOCK_ROWS", 1000)
    config = dict(config, vocab_sizes=[2500])
    seeded = ranking_serving.seeded_by(5, CPU)
    table = ranking_serving._table_initializer(config, 5, 0)(
        None, (2560, 128), torch.float16, CPU)
    blocks = []
    for block, rows in enumerate((1000, 1000, 500)):
        drawn = torch.empty((rows, 128))
        torch.nn.init.trunc_normal_(
            drawn, std=1.0, a=-2.0, b=2.0,
            generator=seeded(ref.TABLE_SALT + block))
        blocks.append(drawn)
    whole = (torch.cat(blocks) / 128 ** 0.5).half()
    assert table.dtype == torch.float16 and table.shape == (2560, 128)
    assert torch.equal(table[:2500], whole)
    assert not bool(table[2500:].any())


def _small_ranking(**kwargs):
    tables = [config_lib.TableConfig(300, 8, name=f"t{i}", combiner="sum")
              for i in range(3)]
    features = [config_lib.FeatureConfig(t, name=f"f{i}")
                for i, t in enumerate(tables)]
    model = ranking.Ranking(
        features, 5, bottom_stack=ranking.mlp_stack((16, 8), "relu"),
        top_stack=ranking.mlp_stack((8, 1), "sigmoid"), device="cpu",
        generator=torch.Generator().manual_seed(0), **kwargs)
    g = torch.Generator().manual_seed(1)
    batch = {f"f{i}": torch.randint(-1, 300, (6, 4), generator=g)
             for i in range(3)}
    batch["dense_features"] = torch.rand(6, 5, generator=g)
    return model, batch


def test_logits_are_the_probabilities_before_the_sigmoid():
    model, batch = _small_ranking()
    with torch.no_grad():
        probabilities = model(batch)
        logits = model.logits(batch)
    assert torch.equal(torch.sigmoid(logits), probabilities)
    assert not torch.equal(logits, probabilities)


def test_the_table_dtype_comes_through():
    model, batch = _small_ranking(table_dtype=torch.float16)
    tables = dict(model.embedding.named_parameters())
    assert tables and all(t.dtype == torch.float16 for t in tables.values())
    with torch.no_grad():
        assert model.logits(batch).dtype == torch.float32


def test_capture_takes_a_dcn_model_on_the_card(served):
    model = _small_ranking()[0]
    with pytest.raises(ValueError, match="DCN-style"):
        model.capture([4])
    with pytest.raises(ValueError, match="CUDA"):
        served[0].capture([16, 32])
