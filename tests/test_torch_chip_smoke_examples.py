"""`chip_smoke.py` phase 37 (the user examples) rehearsed on the CPU at a
tiny size: the kernel-bearing examples' entry points (the distributed
ones on a one-rank gloo group), their kernels held against their twins
at the examples' shapes, and the runner's subprocess; then the phase's
checks against planted faults (a wrong kernel count, a K2 launch, a
recall under its floor). On the card the launches and the floors are
checked as well."""

import importlib
from pathlib import Path

import pytest
import torch

import chip_smoke
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TINY_RUNS = (
    ("efficient_serving", "efficient_serving",
     {"corpus_size": 2_000, "full": False}),
    ("sharded_ann_serving", "sharded_ann_serving", {"num_rows": 4_096}),
    ("hybrid_dlrm", "hybrid_dlrm", {"steps": 3}),
    ("tpu_embedding", "tpu_embedding", {"steps": 3}),
)


def test_examples_phase_passes_on_cpu_at_a_tiny_size(capsys):
    paths = chip_smoke.examples_phase(torch.device("cpu"), 0, TINY_RUNS,
                                      floors=False)
    out = capsys.readouterr().out
    assert "phase 37 examples: ok" in out
    assert "4 runs in" in out and "runner exit 0" in out
    for _, label, _ in TINY_RUNS:
        line = next(x for x in out.splitlines()
                    if x.startswith(f"  example {label}: "))
        assert "kernels vs twins max |err|" in line, line
    assert "exit 0" in next(x for x in out.splitlines()
                            if x.startswith("  runner: "))
    assert "recall@10" in out and "engine steps" in out
    # The CPU runs the twins: no kernel launched, none counted.
    assert paths == {}


def test_every_example_runs_in_the_phase():
    names = {name for name, _, _ in chip_smoke.EXAMPLE_RUNS}
    jax = {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert names == jax
    for name in names:
        importlib.import_module(f"recommenders_tpu_torch.examples.{name}")
    rows = {"bucketed_scores[f32]", "bucketed_scores[int8]",
            "probed_leaf_scores[int8]", "probed_bucketed_scores[int8]",
            chip_smoke.K1_DLRM_ROW}
    for kernels in chip_smoke.EXAMPLE_KERNELS.values():
        assert set(kernels) <= rows


@pytest.mark.parametrize("name,counts,out", [
    ("hybrid_dlrm", {chip_smoke.K1_DLRM_ROW: 59},
     {"engine_steps": 30, "tables": 2}),
    ("tpu_embedding", {chip_smoke.K1_DLRM_ROW: 20},
     {"engine_steps": 20, "tables": 2}),
    ("efficient_serving", {"bucketed_scores[f32]": 4}, {}),
    ("sharded_ann_serving", {"bucketed_scores[int8]": 1,
                             "probed_bucketed_scores[int8]": 0}, {}),
    ("quickstart", {"fused_retrieval_fwd[f32 scores]": 1}, {}),
])
def test_a_planted_wrong_kernel_count_fails(name, counts, out):
    with pytest.raises(SystemExit, match="phase 37"):
        chip_smoke.check_example_launches(name, counts, out)


def test_the_right_kernel_counts_pass():
    chip_smoke.check_example_launches(
        "hybrid_dlrm", {chip_smoke.K1_DLRM_ROW: 60},
        {"engine_steps": 30, "tables": 2})
    chip_smoke.check_example_launches(
        "efficient_serving", {"bucketed_scores[f32]": 4,
                              "probed_leaf_scores[int8]": 4}, {})


def test_a_recall_under_its_floor_fails():
    out = {"k": 10, "buckets": 2048, "bucketed_recall": 0.97,
           "scann_recall": chip_smoke.JAX_FULL_SCANN_RECALL}
    numbers = chip_smoke.example_numbers(out)
    with pytest.raises(SystemExit, match="Bucketed recall"):
        chip_smoke.check_example_numbers("efficient_serving", "e", out,
                                         numbers, floors=True)
    out = dict(out, bucketed_recall=0.995,
               scann_recall=chip_smoke.JAX_FULL_SCANN_RECALL - 0.03)
    with pytest.raises(SystemExit, match="ScaNN recall"):
        chip_smoke.check_example_numbers("efficient_serving", "e", out,
                                         numbers, floors=True)
    with pytest.raises(SystemExit, match="numbers"):
        chip_smoke.check_example_numbers(
            "basic_ranking", "b", {"rmse": float("nan")},
            {"rmse": float("nan")}, floors=False)
