"""`chip_smoke.py` rehearsed on the CPU at a tiny size.

The script's `main()` runs only where CUDA is; its phases take a device,
so here they run with `device="cpu"` (where each kernel's wrapper runs
its plain twin) on a small model and a small training step. Every check
of the script must pass, and the kernels' report must carry every key
the script promises. The serving and ScaNN phases are checked in
`tests/test_torch_chip_smoke_export.py`, which runs them once for the
export and quantization phases that take what they keep.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
REPORT_KEYS = {
    "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
    "plain_ms", "bound_ms", "bound_by", "library_ms",
}


TRAIN_KERNELS = {
    "sorted_block_apply[adagrad bf16+SR]": "def _kernel(",
    "fused_retrieval_fwd[f32 scores]": "def _fwd_kernel(",
    "fused_retrieval_dq[f32 scores]": "def _dq_kernel(",
    "fused_retrieval_dc[f32 scores]": "def _dc_kernel(",
    "fused_retrieval_fwd[bf16 scores]": "def _fwd_kernel(",
    "fused_retrieval_dq[bf16 scores]": "def _dq_kernel(",
    "fused_retrieval_dc[bf16 scores]": "def _dc_kernel(",
}


def test_training_phases_pass_on_cpu_at_a_tiny_size(capsys):
    size = chip_smoke.TrainSize(users=512, items=1024, dim=16, batch=64,
                                steps=3, timed_steps=2, parity_steps=2)
    report = chip_smoke.train(torch.device("cpu"), size, seed=0)
    assert [r["name"] for r in report] == list(TRAIN_KERNELS)
    for row in report:
        assert REPORT_KEYS <= set(row)
        assert row["route"] == "cuda"
        assert (ROOT / row["source"]).is_file()
        path, line = row["replaces"].split(":")
        assert (ROOT / path).read_text().splitlines()[
            int(line) - 1
        ].startswith(TRAIN_KERNELS[row["name"]])
        assert row["bound_by"] in ("bytes", "operations")
        assert row["bound_ms"] > 0
        assert row["max_abs_err"] == 0.0   # the twin against itself
    assert report[0]["library_ms"] is None
    assert report[0]["floor_ms"] > 0
    assert all(r["library_ms"] > 0 for r in report[1:])
    # K2's bound is the largest of its products on the bf16 tensor cores
    # (six split-precision passes for f32 scores), its exps at the SFU
    # rate and its bytes; each
    # term is printed on the kernel's own line, and the row carries the
    # largest as `bound_ms`.
    out = capsys.readouterr().out
    for row in report[1:]:
        name = row["name"].split("_")[-1].split("[")[0]
        label = row["name"].split("[")[1].split()[0]
        line = re.search(
            rf"K2 {label} {name}: kernel .* bound (\S+) ms \((\w+); products "
            rf"(\S+), exp (\S+), bytes (\S+)\)", out)
        assert line is not None
        terms = dict(zip(("products", "exp", "bytes"),
                         map(float, line.groups()[2:])))
        assert all(v > 0 for v in terms.values())
        assert line[2] == max(terms, key=terms.get)
        assert float(line[1]) == terms[line[2]]
        assert row["bound_ms"] == pytest.approx(terms[line[2]], rel=1e-3)
        assert row["bound_by"] == ("bytes" if line[2] == "bytes"
                                   else "operations")
        if label == "f32":   # The replaced CUDA-core design's bound beside.
            cuda_core = re.search(rf"K2 f32 {name}: kernel .*\); f32 "
                                  rf"CUDA-core bound (\S+) ms", out)
            assert float(cuda_core[1]) == pytest.approx(
                terms["products"] / 6 * 989 / 67, rel=1e-3)
    q, c = torch.zeros(4096, 64), torch.zeros(4096, 64)
    fwd, dq, dc = (chip_smoke.k2_bound_terms(n, q, c, 132, 1.98e9)
                   for n in ("fwd", "dq", "dc"))
    assert set(fwd) == {"products", "exp", "bytes"}
    assert dq["products"] == dc["products"] == pytest.approx(
        2 * fwd["products"])
    assert dq["exp"] == dc["exp"] == fwd["exp"]
    f32_fwd = chip_smoke.k2_bound_terms("fwd", q, c, 132, 1.98e9)
    bf16_fwd = chip_smoke.k2_bound_terms("fwd", q.bfloat16(), c.bfloat16(),
                                         132, 1.98e9)
    assert f32_fwd["products"] == pytest.approx(
        bf16_fwd["products"] * chip_smoke.K2_PASSES[torch.float32])
    assert chip_smoke.K2_PASSES[torch.float32] == chip_smoke.K3_PASSES["f32"]
    assert fwd["exp"] == pytest.approx(4096 * 4096 / (16 * 132 * 1.98e9)
                                       * 1e3)
    for name in ("train", "parity", "train kernels", "train timing"):
        assert f"phase {name}: ok" in out
    for kind in chip_smoke.KINDS:
        assert f"K1 {kind} bf16+SR" in out and f"K1 {kind} f32" in out
    assert "step pipelined fused" in out
    assert re.search(r"K1 timing: .* floor \(one run of 32 ids, graph "
                     r"replay\) \S+ ms", out)


def test_train_state_loads_through_convert_as_bf16():
    size = chip_smoke.TrainSize(users=256, items=512, dim=8, batch=16)
    engine = chip_smoke.train_engine(size, "cpu")
    state = chip_smoke.convert.engine_state_from_logical(
        engine, chip_smoke.logical_state(size, 0))
    assert state.tables["item"].shape == (512, 8)
    assert state.tables["item"].dtype == torch.bfloat16
    assert state.slots["user"]["accumulator"].dtype == torch.bfloat16


def test_main_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; this checks the CPU-only refusal")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_the_pooled_lookup_phase_alone_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; this checks the CPU-only refusal")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--pooled-lookup"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"kernels"' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("what", ["k2-parts", "k2-f32", "k3-f32", "k1",
                                  "leaf", "k5-splits"])
def test_kernel_ab_fails_without_cuda(what):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; this checks the CPU-only refusal")
    proc = subprocess.run(
        [sys.executable,
         str(ROOT / "recommenders_tpu_torch" / "tools" / "kernel_ab.py"),
         what],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_kernel_ab_leaf_modes_time_every_format_on_cpu():
    """`kernel_ab.py leaf` and `k5-splits` at a tiny size on the CPU (the
    twins run): every K4 / K5 format is timed, on the calls
    `chip_smoke.leaf_call` makes; K5's split target is restored."""
    from recommenders_tpu_torch.ops import leaf_scoring
    from recommenders_tpu_torch.tools import kernel_ab

    size = chip_smoke.ScannSize(items=4000, centers=16, batch=64, requests=1,
                                leaves=16, leaves_2000=8, users=64)
    cpu = torch.device("cpu")
    leaf = kernel_ab.leaf(chip_smoke, cpu, size)["leaf_ms"]
    assert sorted(leaf) == sorted(f"{k} {f}" for k in ("K4", "K5")
                                  for f in ("f32", "bf16", "int8", "int4"))
    assert all(len(r["call_ms"]) == kernel_ab.READS and r["graph_ms"] > 0
               for r in leaf.values())
    default = leaf_scoring._K5_BLOCKS_PER_SM
    splits = kernel_ab.k5_splits(chip_smoke, cpu, [3, 12], size)["k5_splits"]
    assert sorted(splits) == ["K5 bf16", "K5 int4", "K5 int8"]
    assert all([r["blocks_per_sm"] for r in v] == [3, 12]
               for v in splits.values())
    assert leaf_scoring._K5_BLOCKS_PER_SM == default


def test_k1_floor_call_is_one_run_of_one_row():
    """The floor call updates exactly one row of every state, as one run
    of `K1_FLOOR_IDS` ids."""
    size = chip_smoke.TrainSize(users=64, items=256, dim=16, batch=64)
    spec = chip_smoke.emb_config.OptimizerSpec(kind="adagrad",
                                               learning_rate=0.05)
    _, scalars, rule, _ = chip_smoke.sparse_optimizer._kernel_rule(spec, 7)
    states, ids, grads = chip_smoke.k1_problem(
        "adagrad", torch.bfloat16, size.items, size.dim, size.batch, "cpu", 0)
    before = [s.clone() for s in states]
    _, floor = chip_smoke.k1_calls(states, ids, grads, rule, scalars)
    floor()
    for s, b in zip(states, before):
        changed = (s != b).any(dim=1).nonzero().flatten().tolist()
        assert changed == [int(ids[0])]


def test_kernel_ab_times_the_root_package_with_this_checkouts_script(
        tmp_path):
    """`kernel_ab.load(root)`: the package comes from `root`, the set-up
    and timing code from this checkout's `chip_smoke.py`."""
    other = tmp_path / "other"
    shutil.copytree(ROOT / "recommenders_tpu_torch",
                    other / "recommenders_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    script = (
        "import importlib.util, sys\n"
        "from pathlib import Path\n"
        "spec = importlib.util.spec_from_file_location('kernel_ab', "
        "sys.argv[1])\n"
        "ab = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(ab)\n"
        "cs = ab.load(Path(sys.argv[2]))\n"
        "print(cs.__file__)\n"
        "print(cs.leaf_scoring.__file__)\n"
        "print(cs.approximate.__file__)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script,
         str(ROOT / "recommenders_tpu_torch" / "tools" / "kernel_ab.py"),
         str(other)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    smoke, leaf, approx = proc.stdout.split()
    assert Path(smoke) == ROOT / "chip_smoke.py"
    assert Path(leaf).is_relative_to(other)
    assert Path(approx).is_relative_to(other)


def test_trainer_slice_phases_pass_on_cpu_at_a_tiny_size(capsys):
    """Phases 18-23 at a tiny size: the stacked engine (bit-equal to the
    unstacked one, the bf16 + SR parity), `Trainer.fit` / `evaluate` /
    card-vs-CPU parity / the trace, and the corpus evaluation over the
    four indexes. Off the card no kernel launches, so every path's
    count is 0."""
    cpu = torch.device("cpu")
    stacked = chip_smoke.stacked_engine(
        cpu, chip_smoke.StackSize(tables=5, min_rows=200, max_rows=3000,
                                  dim=8, batch=64, steps=3, sr_steps=2), 0)
    trained = chip_smoke.trainer(
        cpu, chip_smoke.TrainerSize(users=256, items=512, dim=16, batch=64,
                                    batches=4, eval_batches=2,
                                    parity_steps=2, traced_steps=2), 0)
    evaluated = chip_smoke.corpus_eval(
        cpu, chip_smoke.CorpusSize(users=256, items=20_000, queries=256,
                                   batch=64, chunk=4096), 0)
    (row,) = stacked
    assert REPORT_KEYS <= set(row)
    assert row["name"] == chip_smoke.K1_STACKED_ROW
    assert row["max_abs_err"] == 0
    assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert "n=320 " in row["shape"] and "5 tables stacked" in row["shape"]
    path, line = row["replaces"].split(":")
    assert (ROOT / path).read_text().splitlines()[
        int(line) - 1].startswith("def _kernel")
    assert set(trained) == set(chip_smoke.K2_ROWS.values())
    assert set(evaluated) == {"bucketed_scores[f32]"}
    for counts in (trained, evaluated, {row["name"]: row["path_launches"]}):
        assert all(n == 0 for by_path in counts.values()
                   for n in by_path.values())
    out = capsys.readouterr().out
    for name in ("stacked engine", "stacked sr parity", "trainer",
                 "trainer parity", "trainer trace", "corpus eval"):
        assert f"phase {name}: ok" in out
    assert re.search(r"stacked: \S+ ms/step over steps 2-3", out)
    assert re.search(r"unstacked: \S+ ms/step over steps 2-3", out)
    assert "K1 stacked: bit-equal to its twin" in out
    assert "2 planted faults rejected" in out
    assert re.search(r"parity fused: .* parameter gap \(limit \S+\) card "
                     r"0, lr 1 % high \S+, dc 1 % high \S+", out)
    assert re.search(r"fit unfused: .* examples/s, .* "
                     r"batch_top_1_categorical_accuracy", out)
    assert re.search(r"evaluate unfused: batch_top_10_categorical_accuracy",
                     out)
    assert re.search(r"device busy \S+ ms = \S+, idle \S+", out)
    for name in ("BruteForce", "Streaming.index",
                 "Streaming.index_from_dataset", "Bucketed f32"):
        assert re.search(rf"  {re.escape(name)}: \S+ queries/s", out)


def test_ranking_slice_phases_pass_on_cpu_at_a_tiny_size(capsys):
    """Phases 24-28 at a tiny size: the prebuilt Ranking fit / evaluate
    and its card-vs-CPU parity (dot and DCN), the hybrid DLRM plain and
    pipelined with the engine held to K1's twin, `Multitask` unfused and
    fused, and the listwise functions. Off the card no kernel launches,
    so every path's count is 0; the AUC floor holds only at the full
    size."""
    size = chip_smoke.RankingSize(tables=4, min_rows=200, max_rows=3000,
                                  batch=128, batches=3, epochs=1,
                                  eval_batches=2, parity_steps=2, users=256,
                                  items=512, lists=64)
    assert not chip_smoke.full_ranking(size)
    assert chip_smoke.full_ranking(chip_smoke.RankingSize())
    row, k2 = chip_smoke.ranking_slice(torch.device("cpu"), size, 0)
    assert REPORT_KEYS <= set(row)
    assert row["name"] == chip_smoke.K1_DLRM_ROW
    assert row["max_abs_err"] == 0
    assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert "D=16 n=512 " in row["shape"] and "4 tables stacked" in row["shape"]
    assert row["path_launches"] == {"hybrid DLRM, plain": 0,
                                    "hybrid DLRM, pipelined": 0}
    path, line = row["replaces"].split(":")
    assert (ROOT / path).read_text().splitlines()[
        int(line) - 1].startswith("def _kernel")
    assert k2 == {name: {"multitask, fused fit": 0}
                  for name in chip_smoke.K2_F32_ROWS.values()}
    out = capsys.readouterr().out
    for name in ("prebuilt dlrm", "ranking parity", "hybrid dlrm",
                 "hybrid parity", "multitask", "multitask parity",
                 "listwise"):
        assert f"phase {name}: ok" in out
    for form in ("dot", "dcn"):
        assert re.search(rf"fit {form}: 1 x 3 x 128, examples/s by epoch "
                         rf"\[\d+\], held-out auc by epoch \[\S+\], .* "
                         rf"peak device memory .* evaluate accuracy \S+, "
                         rf"auc \S+", out)
        confined = chip_smoke.CONFINED_FAULT[form]
        groups = "tables 0 \\(\\S+\\), bottom 0 \\(\\S+\\), " + (
            "interaction 0 \\(\\S+\\), " if form == "dcn" else "")
        assert re.search(rf"parity ranking {form}: .* relu flips 0; "
                         rf"parameter gap by group \(limit\): {groups}"
                         rf"top 0 \(\S+\), all 0; lr 1 % high: tables \S+, "
                         rf".*; {confined} 1 % overstep: .*{confined} "
                         rf"0\.\d*[1-9]", out)
    for form in ("plain", "pipelined"):
        assert re.search(rf"hybrid {form}: \S+ ms/step", out)
        assert re.search(rf"parity hybrid {form}: .* relu flips 0; "
                         rf"parameter gap by group \(limit\): bottom 0 "
                         rf"\(\S+\), top 0 \(\S+\), all 0; lr 1 % high: "
                         rf".*; bottom 1 % overstep: bottom 0\.\d*[1-9]",
                         out)
    assert "K1 DLRM: bit-equal to its twin" in out
    for name in ("ranking_dot", "ranking_dcn", "hybrid",
                 "multitask_unfused", "multitask_fused"):
        assert re.search(rf"{name} traced window \S+ ms .* device busy "
                         rf"\S+ ms = \S+, idle \S+", out)
    for form in ("unfused", "fused"):
        assert re.search(rf"multitask {form}: .* examples/s, .* "
                         rf"rating_rmse \S+", out)
        assert re.search(rf"parity multitask {form}: .* relu flips 0; "
                         rf"parameter gap by group \(limit\): query 0 "
                         rf"\(\S+\), candidate 0 \(\S+\), rating 0 "
                         rf"\(\S+\), all 0; lr 1 % high: ", out)
    for name in chip_smoke.LISTWISE_LOSSES:
        assert f"{name} 0/0" in out
    for name in chip_smoke.LISTWISE_WEIGHTS:
        assert f"{name} 0" in out


def test_device_share_takes_the_union_of_kernel_intervals(tmp_path):
    """Busy time is the union of kernel intervals (overlaps counted
    once) over the span of every complete event; ops sum by name."""
    import json

    events = [
        {"ph": "X", "cat": "cpu_op", "name": "step", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 80, "dur": 30},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "trace_1.json"
    path.write_text(json.dumps({"traceEvents": events}))
    window, busy, n, top = chip_smoke.device_share(path)
    assert window == pytest.approx(0.110)        # 0 .. 110 us
    assert busy == pytest.approx(0.040)          # 10-40 and 60-70 us
    assert n == 3
    assert top[0] == ("a", (pytest.approx(0.030), 2))


def test_data_phases_pass_on_cpu_at_a_tiny_size(capsys):
    """Phases 29-32 at a tiny size: the pipeline (ratings.dat written and
    read back, vocabularies, the native batcher, fused fit, corpus eval
    over BruteForce and the padded Bucketed index, checkpoint with a
    bit-exact resume and a CPU restore, decoded top movies), the
    featurization towers card-vs-CPU (here CPU against CPU), and the
    quality-parity runs. Off the card no kernel launches; the bounds
    against the JAX package's recorded means hold only at the tool's
    defaults."""
    from recommenders_tpu_torch.tools import quality_parity

    args = quality_parity.parse_args([
        "--device", "cpu", "--interactions", "10000", "--epochs", "1",
        "--batch", "1024", "--examples", "8000", "--uet-epochs", "1",
        "--dlrm-epochs", "1"])
    assert not chip_smoke.full_quality(args)
    assert chip_smoke.full_quality(quality_parity.parse_args([
        "--device", "cuda:0"]))
    counts = chip_smoke.data_slice(
        torch.device("cpu"),
        chip_smoke.PipelineSize(users=300, movies=400, ratings=30_000,
                                dim=16, batch=1024, threads=2),
        chip_smoke.FeaturizationSize(interactions=10_000, batch=1024,
                                     steps=2),
        args, 0)
    assert counts == [
        {**{name: {"pipeline, fused fit": 0}
            for name in chip_smoke.K2_ROWS.values()},
         "bucketed_scores[f32]": {"pipeline eval, Bucketed f32": 0}},
        {name: {"quality parity, fused retrieval": 0}
         for name in chip_smoke.K2_F32_ROWS.values()},
    ]
    out = capsys.readouterr().out
    for name in ("pipeline", "featurization", "quality parity",
                 "unified embedding"):
        assert f"phase {name}: ok" in out
    assert re.search(r"pipeline data: 30000 ratings written as ratings.dat "
                     r"in \S+ s, read back equal in \S+ s; vocabularies 301 "
                     r"users, 401 movies built .* \(vocab \S+ s\)", out)
    assert re.search(r"pipeline fit: native batcher \d+ rows/s alone \(2 "
                     r"threads\); 23 x 1024, \d+ examples/s", out)
    for name in ("BruteForce", "Bucketed f32"):
        assert re.search(rf"pipeline eval {name}: \d+ queries/s, top-\[10, "
                         rf"100\] accuracy \[0\.\d+, 0\.\d+\]", out)
    assert re.search(r"pipeline checkpoint: \S+ MB, save \S+ s, restore \S+ "
                     r"s; 5 resumed steps bit-equal .* restored on the CPU "
                     r"equal", out)
    assert re.search(r"top 5 for user_\d+: \['movie_\d+'", out)
    assert re.search(r"featurization: .* \(relative gaps \[0\.0, 0\.0\]\); "
                     r"\d+ hash buckets and discretized ids bit-equal", out)
    for run in ("retrieval", "retrieval fused"):
        assert re.search(rf"  {run}: top_10 0\.\d+ \(JAX 0.1926\), top_50 "
                         rf"\S+ \(JAX 0.665\), top_100 \S+ \(JAX 0.8589\)",
                         out)
    assert re.search(r"ranking: rmse 0\.\d+ \(JAX 0.8662\)", out)
    assert re.search(r"dlrm: dlrm_auc 0\.\d+ \(JAX 0.6625\); epoch losses "
                     r"\[\S+\], fit \S+ s", out)
    # The fused run against the unfused one, and K2 (here its twin) on
    # the fused run's own embeddings at the path's shapes.
    assert re.search(r"quality fused retrieval: K2 launches .*; against "
                     r"unfused, epoch losses within \S+ relative \(limit "
                     r"1e-05\), top-k within \S+ \(limit 0\.001\); K2 f32 "
                     r"on the trained embeddings of a batch \(B=C=1024 "
                     r"D=32\): loss \S+ vs twin \S+ \(\|err\| 0\)", out)
    assert re.search(r"uet AUC: collisionless 0\.\d+ \(JAX 0.7279\), hash "
                     r"\S+ \(JAX 0.5841\), unified \S+ \(JAX 0.7376\)", out)


def test_featurization_drift_prints_each_steps_gap(capsys):
    """`--featurization-drift`'s report: one JSON line of both runs'
    losses and their relative gaps, here CPU against CPU (equal)."""
    chip_smoke.featurization_drift(
        torch.device("cpu"), chip_smoke.FeaturizationSize(
            interactions=5_000, batch=512, steps=3), 1)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["seed"] == 1 and report["steps"] == 3
    assert report["card"] == report["cpu"] and len(report["cpu"]) == 3
    assert report["gap"] == [0.0, 0.0, 0.0]


def test_ratings_dat_round_trips_through_load_movielens(tmp_path):
    from recommenders_tpu_torch import data

    ds = data.synthetic_movielens(num_users=50, num_movies=60,
                                  num_interactions=700, seed=3)
    path = tmp_path / "ratings.dat"
    chip_smoke.write_ratings_dat(path, ds)
    assert path.read_text().splitlines()[0].count("::") == 3
    back = data.load_movielens(str(path), 50, 60)
    for name in ("user_ids", "movie_ids", "ratings", "timestamps"):
        np.testing.assert_array_equal(getattr(back, name), getattr(ds, name))


def test_padded_bucketed_scores_as_bruteforce_on_narrow_embeddings():
    gen = torch.Generator().manual_seed(0)
    corpus = torch.randn(700, 64, generator=gen)
    queries = torch.randn(8, 64, generator=gen)
    index = chip_smoke.PaddedBucketed(k=5, device="cpu",
                                      **chip_smoke.BUCKETED["f32"])
    index.index(corpus)
    scores, ids = index(queries)
    want_scores, want_ids = torch.topk(queries @ corpus.T, 5)
    torch.testing.assert_close(scores, want_scores, rtol=1e-6, atol=1e-5)
    assert torch.equal(ids.sort(1).values, want_ids.sort(1).values)


def test_alias_probe_phase_passes_on_cpu_at_a_tiny_size(capsys):
    """Phase 39 at a tiny size: the copy step against its twin (in place,
    out of place, into unaligned buffers) at the probe's and a ragged
    shape for both table types, the probe's four measurements, the rate
    past the L2, a kernel row per table type. Off the card the twin runs
    and nothing launches."""
    from recommenders_tpu_torch.tools import alias_probe

    size = chip_smoke.ProbeSize(
        shape=alias_probe.Shape(rows=512, dim=16, ids=64, steps=2),
        ragged=(131, 7), past_l2=(1000, 8), past_l2_steps=2)
    report = chip_smoke.alias_probe_phase(torch.device("cpu"), size, 0)
    assert [r["name"] for r in report] == [
        "copy_step[f32 table]", "copy_step[bf16 table]"]
    for row, dtype in zip(report, (torch.float32, torch.bfloat16)):
        assert REPORT_KEYS <= set(row)
        assert (row["route"], row["bound_by"]) == ("cuda", "bytes")
        assert (ROOT / row["source"]).is_file()
        path, line = row["replaces"].split(":")
        assert "copy_kernel" in (ROOT / path).read_text().splitlines()[
            int(line) - 1]
        assert row["launches"] == 0 and row["path_launches"] == {}
        assert row["bound_ms"] == pytest.approx(
            alias_probe.floor_us(512, 16, dtype) / 1e3)
        assert all(row[k] > 0 for k in ("ms", "plain_ms", "library_ms"))
    out = capsys.readouterr().out
    assert "phase 39 alias probe: ok" in out
    for fmt in ("f32", "bf16"):
        for name in alias_probe.MEASUREMENTS:
            assert re.search(rf"{fmt} table {name}: \S+ us/step \(\S+x "
                             rf"floor of \S+ us\)", out)
        for rows, dim in ((512, 16), (131, 7)):
            table = {"f32": "float32", "bf16": "bfloat16"}[fmt]
            assert (f"copy step {rows} x {dim} {table} table: bit-equal to "
                    "its twin in place, out of place and unaligned") in out
    assert re.search(r"past the L2: copy step in place on 1000 x 8 f32 \+ "
                     r"f32 \(128000 B a step, bound \S+ us\): \S+ us, \S+ "
                     r"TB/s, \S+ of 3.35 TB/s", out)


def test_alias_probe_phase_defaults_are_the_probes_shapes():
    from recommenders_tpu_torch.tools import alias_probe

    size = chip_smoke.ProbeSize()
    shape = size.shape
    assert (shape.rows, shape.dim, shape.ids) == (131_072, 64, 4096)
    assert (shape.rows * shape.dim) % 8 == 0
    rows, dim = size.ragged
    assert (rows * dim) % 8 != 0
    # Phase 18's stacked storage, f32 + f32: 2,323,578,880 B a step,
    # 693.6 us at 3.35 TB/s; 40 times the L2.
    assert size.past_l2 == (4_538_240, 32)
    moved = alias_probe.traffic_bytes(*size.past_l2, torch.float32)
    assert moved == 2_323_578_880
    assert alias_probe.floor_us(*size.past_l2, torch.float32) == (
        pytest.approx(693.6, abs=0.05))
    assert moved / 2 > 20 * 50e6


def test_pooled_lookup_phase_passes_on_cpu_at_a_tiny_size(capsys):
    size = chip_smoke.PooledSize(
        vocabs=(50, 3, 4096, 20_000), bags=(3, 1, 100, 7), dense=5,
        bottom=(32, 16), cross_layers=2, cross_rank=8, top=(16, 1), dim=16,
        pairs=9, block_rows=1000)
    [row] = chip_smoke.pooled_phase(torch.device("cpu"), size,
                                    seed=2**33 + 3)
    assert REPORT_KEYS <= set(row) and row["max_abs_err"] == 0.0
    assert (ROOT / row["source"]).is_file()
    path, line = row["replaces"].split(":")
    assert (ROOT / path).read_text().splitlines()[
        int(line) - 1].startswith("def combine(")
    assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert row["path_launches"] == {}        # no launch off the card
    assert "phase 40 pooled lookup: ok" in capsys.readouterr().out


def test_pooled_lookup_phase_defaults_are_mlperfs_widths():
    size = chip_smoke.PooledSize()
    assert len(size.vocabs) == len(size.bags) == 26
    assert sum(size.vocabs) == 204_184_588 and sum(size.bags) == 214
    assert sum(-(-v // 128) * 128 for v in size.vocabs) == 204_186_368
