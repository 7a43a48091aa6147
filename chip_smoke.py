#!/usr/bin/env python3
"""Runs the PyTorch port's retrieval serving, ScaNN serving, training,
trainer, ranking, data and distribution slices on one NVIDIA GPU and
checks them.

    python3 chip_smoke.py [--seed 0] [--requests 3]

Serving: one two-tower retrieval model at full width, a query tower of
65,536 users (embedding 128, MLP (256, 128)) and a candidate tower of
1,000,000 items (embedding 128). Its weights are random, drawn with NumPy
from `--seed` in the flax layout and loaded through `utils.convert`.
Phases, each fatal when it fails:

  1. build every CUDA kernel of the port (`ops/cuda_build.py`), one
     `nvcc` a source, all at once;
  2. build the towers;
  3. embed the corpus;
  4. index it five ways (BruteForce, and Bucketed f32, bf16, int8, int4);
  5. serve `--requests` requests of 1024 user ids through every index,
     and one through `query_with_exclusions` with 10 excluded ids a row;
     the kernels' launch counts are zeroed before phase 2 and read right
     after this phase, and every kernel must have launched;
  6. check the served results (shapes, finite descending scores, exact
     scores of the returned ids, the exclusions);
  7. hold each format of the bucketed-scoring kernel against its plain
     PyTorch twin at the served shapes (two launches must agree bit for
     bit), and time the kernel, the twin and the library call that serves
     the same request exactly; the bound counts f32 rows' six bf16 passes;
  8. hold recall@100 of the f32 and bf16 indexes against BruteForce (and,
     at seed 0 and the full size, f32's within 0.001 of its reading with
     exact f32 products).

ScaNN probed serving: a clustered corpus of 1,000,000 × 128 rows drawn as
`benchmarks/serving.py:339-348` draws it (1,024 Gaussian centres at scale
3.0 plus unit noise, NumPy from `--seed`), 1024-query requests drawn the
same way, and six `ScaNN` indexes at k=100, built on the device: the main
path `int8_bucketed` (L=1024, P=256, int8, B=4096, probe tile 64;
`benchmarks/serving.py:190-197`), `int8_reorder` (L=2000, P=40, reorder
400; `benchmarks/serving.py:403-410`), `bf16_gather`,
`int4_gather_reorder` and `int4_bucketed_reorder` (`benchmarks/ann.py:374-
388` at L=1024), and `bf16_bucketed`. Phases, each fatal when it fails:

 13. build every index; print build seconds and index bytes;
 14. serve `--requests` requests through every index, one more through
     `query_with_exclusions` and one through `ScaNN(query_fn=...)` with
     the serving slice's query tower; the launch counts of K4 and K5
     (`csrc/leaf_scoring.cu`) are zeroed just before and read just after,
     and each format on a served path must have launched as often as its
     chunks say;
 15. check the served results (shapes, finite descending scores, ids in
     the corpus, each score against the stored row of its id, the
     exclusions);
 16. hold K4 and K5 against their plain twins at the served shapes, for
     f32 and bf16 rows, int8 and int4 (f32 by direct calls on the bf16
     indexes' leaves cast to f32; two launches must agree bit for bit),
     and time the kernels (as eager wrapper calls between CUDA events, and
     by CUDA-graph replay of the wrapper, its plan included), the twins
     and the gather +
     matmul formulation (at the full shape, in chunks of at most 4 GB of
     gather, and on the twins' subset); bf16 rows' bound counts three
     bf16 passes;
 17. recall@100 of every index against BruteForce, each above its floor
     (`SCANN_RECALL_FLOORS`), and the kernel path against the twin path
     (the index copied to the CPU) on 64 queries.

Training: `bench.py`'s step at its full width. An embedding engine with
tables `user` 65,536 × 64 and `item` 131,072 × 64, bf16 tables and bf16
adagrad slots (lr 0.1) written with stochastic rounding, unstacked, and
`Retrieval(score_dtype=bf16)` over batches of 4,096 uniform (user, item)
ids drawn with NumPy from `--seed`. The initial state is drawn with NumPy
in the logical layout and loaded through `utils.convert`. Phases, each
fatal when it fails:

  9. train: 20 pipelined steps + `flush` with the unfused task,
     then as many with `fused=True`; the launch counts of K1
     (`csrc/sparse_apply.cu`) and K2 (`csrc/fused_retrieval.cu`) are
     zeroed just before and read just after, and every kernel must have
     launched; the losses must be finite;
 10. step parity: 3 plain steps from one copied state, on the card and on
     the CPU (where the kernels' plain twins run), unfused and fused;
     the same check must reject faults planted on the CPU side (another
     stochastic-rounding stream, a learning rate 1 % high);
 11. hold K1 (all five rules, f32 states and bf16 states with stochastic
     rounding) and K2 (forward, dq, dc; f32 and bf16 scores) against
     their plain twins at the step's shapes, K2's two launches bit for
     bit, and time them (K1 also on one run of 32 ids, its launch floor;
     K2 at both score types, a report row each); K2's bound is the
     largest of its products on the bf16 tensor cores (six passes for f32
     scores, which the kernels take in split precision; the f32 CUDA-core
     figure is printed beside it), its exps at the SFU's rate (the SM
     clock from `nvidia-smi`) and its bytes, each printed;
 12. time the four step forms (plain and pipelined, unfused and fused).

The trainer slice: the stacked engine, `Trainer.fit` and corpus-level
evaluation, at full width. Phases, each fatal when it fails:

 18. stacked engine: `benchmarks/multi_table.py`'s 26 tables
     (`np.geomspace(2_000, 1_000_000, 26)` rows, 4,536,387 in all, × 32,
     f32, adagrad at lr 0.05), stacked and unstacked from one `init`,
     5 steps each of 4,096 uniform ids a table and that file's loss; K1's
     count is zeroed before each and read after: one launch a step
     stacked, one a table a step unstacked; the logical state must be
     bit-equal; ms/step (steps 2-5) and peak memory printed; the stacked
     steps again through K1's twin (a CPU engine from the same init fed
     the same ids and the card's activation grads), bit-equal to the
     card; K1 at the stacked shape (f32 adagrad, 4,538,240 × 32, 26 ×
     4,096 ids) held bit for bit against its twin and timed: its own
     report row, which carries the path's launches;
 19. 2 steps of the stacked engine with bf16 tables and slots written
     with stochastic rounding, card against the CPU (K1's twin): within
     `parity_holds`' limits;
 20. trainer: the quickstart's model (`examples/quickstart.py:18-25`, two
     `EmbeddingTower`s of width 64, Adagrad 0.5) at `bench.py`'s vocab
     (65,536 users, 131,072 items), `Trainer.fit` for one epoch of 30
     host batches of 4,096 uniform ids (after a 2-batch warm-up epoch),
     unfused and then `fused=True`
     with bf16 scores (K2's count zeroed before, read after: 30 launches
     of each kernel fused, none unfused), then `evaluate` on 8 batches;
 21. 3 train steps on the card and on the CPU from the same weights,
     both forms: losses to rtol 1e-4, and the parameters' change on the
     card within `TRAINER_GAP` of the CPU's (relative), a limit that a
     learning rate 1 % high and a dc 1 % high, planted on the CPU side,
     must exceed; the largest parameter |Δ| printed;
 22. 10 fused steps of `fit` under `utils.profiling.trace`: the device's
     busy and idle shares of the traced window (the union of kernel
     intervals over the span of all events) and the five longest
     device ops;
 23. corpus eval: the serving model's query tower and 1M × 128 corpus,
     8,192 queries in batches of 1,024 (`benchmarks/corpus_eval.py:177-
     182`), true ids the BruteForce top-1 row of every other query and a
     uniform row for the rest; `FactorizedTopK(ks=(1, 5, 10, 50, 100))`
     through `make_corpus_eval_step` over BruteForce, `Streaming.index`
     (chunks of 131,072 rows), `Streaming.index_from_dataset` (the same
     corpus as 8 pinned host chunks) and Bucketed f32 (K3, B = 2048,
     count zeroed before, one launch a batch): both Streaming indexes'
     accuracies equal BruteForce's at every k, and their top-100 id sets
     on the first 1,024 queries; Bucketed's top-100 accuracy within 0.03;
     BruteForce's step states equal to the hits counted from the ids
     BruteForce returns; queries/s and peak memory printed.

The ranking slice, at full width with data and weights drawn with NumPy
(or a generator) from `--seed`: the Criteo layout of 26 sparse features
over `benchmarks/multi_table.py`'s vocabs (4,536,387 rows × 16, f32), 13
dense features and clicks from a planted logit as
`examples/prebuilt_dlrm.py:20-33` draws them, batches of 4,096. Phases,
each fatal when it fails:

 24. prebuilt DLRM: `models.Ranking` at the reference's defaults
     (bottom (256, 64, 16) relu, `DotInteraction(skip_gather=True)`,
     `concat_dense`, top (512, 256, 1) sigmoid) under Adagrad 0.05, then
     with `multi_layer_dcn_interaction()` under ClippyAdagrad 0.05 on the
     tables + Adam 1e-3 on the rest (`examples/prebuilt_dlrm.py:42-49`):
     `Trainer.fit` for 3 epochs of 30 batches after a 2-batch warm-up,
     `evaluate` on 8 held-out batches after each epoch, the last AUC
     above 0.6 (at the full size); examples/s and peak memory printed;
 25. ranking parity: 3 steps of each form on the card and on the CPU from
     one weight set (carried through `utils.convert`): losses to rtol
     1e-4, each parameter group's change (tables, bottom, interaction,
     top) within its limit in `RANKING_GAP` of the CPU's, limits that
     faults planted on the CPU side must exceed: a learning rate 1 %
     high in every group, and an update 1 % too large confined to one
     dense group in that group; the relu inputs whose sign card and CPU
     disagree on are counted;
 26. hybrid DLRM: `HybridTrainer` over `EmbeddingEngine(stack_tables=
     True)` of the same 26 tables (f32 adagrad, lr 0.1;
     `examples/hybrid_dlrm.py:57-82`) under the phase-24 DLRM stack with
     the BCE task and Adam 1e-2: 30 steps plain, then 30 pipelined and
     `finalize`, K1's count zeroed before each and read after (one launch
     a step); ms/step and peak memory printed; then 3 steps card against
     CPU, plain and pipelined: losses to rtol 1e-4, the engine's logical
     state bit-equal to K1's twin (a CPU engine fed the card's ids and
     activation grads), each head group's change within `HYBRID_GAP`,
     planted faults rejected as in phase 25; K1 at the hybrid shape (f32
     adagrad, the 4,538,240 × 16 stacked storage, 26 × 4,096 ids) held
     bit for bit against its twin and timed: the K1 DLRM report row;
 27. multitask: `models.Multitask` at `bench.py`'s vocab (towers of width
     64, the rating head (256, 128, 1), Adagrad 0.2 as
     `examples/multitask.py:27`), `fit` for 30 batches unfused and then
     `fused=True` (K2 with f32 scores: 30 launches of each kernel fused,
     none unfused, none with bf16 scores, as the wrapper counts them by
     kernel and score dtype), 5 steps of each form under
     `utils.profiling.trace` (the device's busy and idle shares, as in
     phase 22), then 3 steps card against CPU as in phase 25, with the
     learning-rate fault;
 28. listwise: the seven functions of `tasks/listwise.py` on 4,096 lists
     of 8 (`examples/listwise_ranking.py:59`), half of them ragged by
     `mask`: values and score grads, card against CPU.

The data slice (the README's user journey, `examples/full_pipeline.py:
24-77`, and the quality-parity acceptance):
 29. pipeline at MovieLens-1M's published size (6,040 users, 3,706
     movies, 1,000,209 ratings): `synthetic_movielens` written as an
     ML-1M `ratings.dat` and read back equal by `load_movielens`; string
     ids → `build_vocabulary` / `encode`; a 0.8 split; one epoch of
     `NativeBatcher` (B = 4,096, shuffled, 4 threads; `native/loader.cc`
     built with g++, the phase fails if it does not build) →
     `TwoTowerRetrieval(fused=True)` at width 64 with bf16 scores under
     Adagrad 0.5 → `Trainer.fit` (K2 a launch of each kernel a batch);
     corpus eval at k = 10 and 100 over BruteForce and Bucketed f32
     (K3 a launch a batch; the width-64 embeddings zero-padded to 128);
     a checkpoint saved and restored on the card, 5 resumed steps
     bit-equal to 5 uninterrupted ones, the file restored on the CPU
     equal; one user's top 5 decoded back to movie strings; vocab s,
     native rows/s, examples/s, eval queries/s, checkpoint MB and save /
     restore s printed;
 30. featurization: `examples/featurization.py`'s towers (`Normalizer`
     and a 100-bin `Discretizer` on the device, `TextVectorizer` with 64
     tokens, `hash_bucket` into 2,048 bins, `masked_mean`), 3 Adagrad
     steps of 8,192 on the card and the CPU from one weight set: losses
     to rtol 1e-4, hash buckets and discretized ids bit-equal;
 31. quality parity: `recommenders_tpu_torch/tools/quality_parity.py`
     at `tools/reference_parity.py`'s defaults (100,000 interactions,
     split 0.8, 3 epochs, width 32, batch 8,192, Adagrad 0.1, seed 42):
     retrieval unfused and `fused=True` (K2 with f32 scores), each
     top-100 within 0.003 of the JAX package's recorded 0.8589 and
     top-10 / top-50 within 0.01 of 0.1926 / 0.6650; the rating model's
     RMSE within 0.003 of 0.8662 (`docs/PARITY_HEAD_TO_HEAD.md:7-11`);
 32. unified embedding: the tool's three-way study at the recorded
     run's size (200,000 examples, 8 epochs, batch 8,192, Adam 0.01):
     each AUC within 0.015 of the JAX means (collisionless 0.7279,
     unified 0.7376, hash 0.5841; `docs/PARITY_HEAD_TO_HEAD.md:33-35`),
     and collisionless − hash and unified − hash both above 0.10.

Distribution (`recommenders_tpu_torch/parallel/`), at the widths above:
 33. a one-rank group (NCCL, from a `FileStore`): `ShardedBucketed` in
     the four formats over the serving corpus (1,024-query request,
     k = 100), `ShardedScaNN` (`int8_reorder`, K4, and `int8_bucketed`,
     K5) built over the clustered corpus, the meshed engine
     (`bench.py`'s, 3 steps), one pooled-negatives step (the quickstart
     towers, fused: K2 with f32 scores) and 3 `Trainer(mesh)` steps,
     each bit-equal to its unsharded counterpart (results, and states
     after the steps); each path's kernels must launch;
 34. four ranks share the card (`parallel.launch.run_ranks`, gloo, so
     collectives stage through host memory): the same indexes on a
     `(4,)` model axis (each rank holds its shard and launches its own
     kernels; every rank's results equal), held against phase 33's
     one-device results: ShardedBucketed recall@100 against BruteForce
     at least the one-device index's; the gather path's ids equal except
     inside score ties (counted) and its reorder scores bit-equal; the
     bucketed path's recall at least one device's; the partition equal
     to the one-device build's; the meshed engine's f32 states (sgd,
     adagrad, rowwise_adagrad, adam) bit-equal to unsharded (else within
     rtol 1e-5 / atol 5e-7, and said which), its bf16 + SR state
     bit-equal to the same four ranks on the CPU (K1's twin); on a
     `(2, 2)` data × model mesh, `benchmarks/id_exchange.py`'s exchange
     (2²⁰ × 128, batch 8,192) equal to the dense gather and scatter-add,
     the pooled-negatives step's loss and change to rtol 1e-5 and 1e-4 /
     1e-6 of the global-batch step, and `Trainer(mesh)`'s to those of one
     device. Each rank prints its request and step times, its time in
     collectives and its launches, labelled as four ranks on one card.

The phases run in the order serving, ScaNN, training, trainer slice,
ranking slice, data slice, distribution. Each kernel's row in the
`{"kernels": [...]}` line carries `path_launches`, its launches on the
later slices' paths (phases 18, 20, 23, 26, 27, 29, 31, 33, 34). It prints the card's
name and power limit, one `{"kernels": [...]}` line
and, last, `{"ok": true, "device": {...}}`. Without CUDA, or run outside
a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from recommenders_tpu_torch import data  # noqa: E402
from recommenders_tpu_torch import metrics  # noqa: E402
from recommenders_tpu_torch import models  # noqa: E402
from recommenders_tpu_torch import optimizers  # noqa: E402
from recommenders_tpu_torch import tasks  # noqa: E402
from recommenders_tpu_torch.data import native_loader  # noqa: E402
from recommenders_tpu_torch.data import preprocessing  # noqa: E402
from recommenders_tpu_torch.data import vocab  # noqa: E402
from recommenders_tpu_torch.embedding import config as emb_config  # noqa: E402
from recommenders_tpu_torch.embedding import engine as emb_engine  # noqa: E402
from recommenders_tpu_torch.embedding import sparse_optimizer  # noqa: E402
from recommenders_tpu_torch.layers import approximate  # noqa: E402
from recommenders_tpu_torch.layers import blocks  # noqa: E402
from recommenders_tpu_torch.layers import factorized_top_k  # noqa: E402
from recommenders_tpu_torch.layers.feature_interaction import (  # noqa: E402
    dot_interaction,
)
from recommenders_tpu_torch.models import ranking  # noqa: E402
from recommenders_tpu_torch.models import retrieval  # noqa: E402
from recommenders_tpu_torch.ops import cuda_build  # noqa: E402
from recommenders_tpu_torch.ops import fused_retrieval  # noqa: E402
from recommenders_tpu_torch.ops import hashing  # noqa: E402
from recommenders_tpu_torch.ops import leaf_scoring  # noqa: E402
from recommenders_tpu_torch.ops import quantization  # noqa: E402
from recommenders_tpu_torch.ops import scoring  # noqa: E402
from recommenders_tpu_torch.ops import sparse_apply  # noqa: E402
from recommenders_tpu_torch.parallel import ann as ann_lib  # noqa: E402
from recommenders_tpu_torch.parallel import corpus as corpus_lib  # noqa: E402
from recommenders_tpu_torch.parallel import mesh as parallel_mesh  # noqa: E402
from recommenders_tpu_torch.tasks import listwise  # noqa: E402
from recommenders_tpu_torch.tools import quality_parity  # noqa: E402
from recommenders_tpu_torch.utils import checkpoint  # noqa: E402
from recommenders_tpu_torch.utils import convert  # noqa: E402
from recommenders_tpu_torch.utils import profiling  # noqa: E402

DIM = 128
MLP_UNITS = (256, 128)
K = 100
EXCLUDED = 10
# Queries the plain twin scores at once: its [Q, N] f32 matrix stays
# about 1 GB at N = 1M.
TWIN_QUERIES = 256

# The Bucketed indexes the smoke serves, with their settings.
BUCKETED = {
    "f32": dict(buckets=2048, chunk=2048, query_tile=256),
    "bf16": dict(corpus_dtype=torch.bfloat16, buckets=4096, chunk=4096,
                 query_tile=128),
    "int8": dict(quantize="int8", buckets=4096, chunk=4096),
    "int4": dict(quantize="int4", buckets=2048, chunk=4096),
}
RECALL_FLOORS = {"f32": 0.95, "bf16": 0.97}
# Recall@100 of the f32 index at seed 0 and the full size, read on the H100
# with the exact f32 CUDA-core body (PERF.md): the split-precision body's
# scores are within the same tolerance, so its recall must stay within
# 0.001 of that reading.
F32_RECALL_SEED0 = 0.9763

SOURCE = "recommenders_tpu_torch/csrc/bucketed_scores.cu"
REPLACES = {
    "f32": "recommenders_tpu/ops/scoring.py:59",
    "bf16": "recommenders_tpu/ops/scoring.py:59",
    "int8": "recommenders_tpu/ops/scoring.py:108",
    "int4": "recommenders_tpu/ops/scoring.py:154",
}

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# operations/s for the type the products are taken in. The quantized
# formats multiply a bf16 query by codes that are exact in bf16.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 989e12,
                  "int4": 989e12}
# bf16 tensor-core passes K3 takes a product in: f32 rows split both
# operands into three bf16 terms and take six of the nine term products.
K3_PASSES = {"f32": 6, "bf16": 1, "int8": 1, "int4": 1}
# The same for each of K2's products: f32 scores split as K3's f32 rows.
K2_PASSES = {torch.float32: 6, torch.bfloat16: 1}
# The SFU's exponentials a clock an SM (Hopper: 16), and the H100 SXM's
# SMs and maximum SM clock, which stand in off the card (the card's own
# are read from it).
SFU_EXP_PER_CLOCK = 16
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9
F32_EPS = 2.0 ** -23


@dataclasses.dataclass(frozen=True)
class Size:
    users: int = 65_536
    items: int = 1_000_000
    batch: int = 1024
    requests: int = 3


def check(ok, message: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, device: torch.device, iters: int) -> float:
    """Mean time of `fn()` over `iters` runs after one warm-up, from CUDA
    events around the whole run."""
    fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - start) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def graph_ms(fn, device: torch.device, launches: int = 20,
             replays: int = 5) -> float:
    """Device time of one `fn()` call: `launches` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events, so the
    host's launch overhead drops out. Off the card, `device_ms`."""
    if device.type != "cuda":
        return device_ms(fn, device, iters=launches)
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return device_ms(graph.replay, device, iters=replays) / launches


def phase(name: str, started: float, detail: str = "") -> None:
    print(f"phase {name}: ok {time.perf_counter() - started:.3f} s"
          + (f" ({detail})" if detail else ""), flush=True)


def flax_params(size: Size, seed: int) -> dict:
    """Random `TwoTowerRetrieval` weights in the flax layout, from NumPy:
    each matrix normal with standard deviation 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            fan_in ** -0.5
        )

    widths = (DIM,) + MLP_UNITS
    mlp = {
        f"Dense_{i}": {"kernel": normal((a, b), a),
                       "bias": normal((b,), a) * np.float32(0.1)}
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))
    }
    return {
        "_query": {"Embed_0": {"embedding": normal((size.users, DIM), DIM)},
                   "MLP_0": mlp},
        "_candidate": {
            "Embed_0": {"embedding": normal((size.items, DIM), DIM)}
        },
    }


def serving_model(size: Size, seed: int, device: torch.device):
    """(the serving slice's `TwoTowerRetrieval` with `flax_params`'
    weights, frozen, on `device`; those weights)."""
    params = flax_params(size, seed)
    model = retrieval.TwoTowerRetrieval(
        retrieval.EmbeddingTower(size.users, DIM, MLP_UNITS, device=device),
        retrieval.EmbeddingTower(size.items, DIM, device=device),
    )
    convert.load_flax_params(model, params)
    model.eval().requires_grad_(False)
    return model, params


def numpy_query_tower(params: dict, ids: np.ndarray) -> np.ndarray:
    """The query tower in float64 NumPy, from the flax weights."""
    x = params["_query"]["Embed_0"]["embedding"][np.maximum(ids, 0)]
    x = x.astype(np.float64)
    mlp = params["_query"]["MLP_0"]
    for i in range(len(MLP_UNITS)):
        dense = mlp[f"Dense_{i}"]
        x = x @ dense["kernel"].astype(np.float64) + dense["bias"]
        if i < len(MLP_UNITS) - 1:
            x = np.maximum(x, 0.0)
    return x


def scored_query(index, queries: torch.Tensor) -> torch.Tensor:
    """The queries as the index scores them, in f32: rounded to bf16 for
    a bf16 or quantized index."""
    if index._quantize or index._candidates.dtype == torch.bfloat16:
        return queries.to(torch.bfloat16).to(torch.float32)
    return queries.to(torch.float32)


def stored_rows(index, rows: torch.Tensor):
    """(f32 values, f32 scales) of the index's stored rows `rows`: the
    rows themselves and scales of 1, or the integer codes and their
    per-row scales."""
    rows = rows.long()
    stored = index._candidates
    if index._quantize == "int4":
        stored = quantization.unpack_nibbles(stored)
    values = stored[rows].to(torch.float32)
    if index._scales is None:
        return values, torch.ones(rows.shape, device=rows.device)
    return values, index._scales[rows]


def score_tolerance(index, queries, rows, values):
    """The a-priori bound of an f32 dot over D products taken in another
    order, D·ε·Σ|q||c|·|s|, plus one rounding of the scale multiply."""
    codes, scales = stored_rows(index, rows)
    abs_dot = (scored_query(index, queries).abs()[:, None, :]
               * codes.abs()).sum(-1) * scales.abs()
    return DIM * F32_EPS * abs_dot + 2 * F32_EPS * values.abs()


def stored_bytes(index) -> int:
    """Bytes of the index's stored corpus (rows or codes, and scales)."""
    scales = getattr(index, "_scales", None)
    return index._candidates.nbytes + (0 if scales is None else scales.nbytes)


def reset_counts() -> None:
    scoring.bucketed_scores.launches = 0
    for fmt in scoring.bucketed_scores.launches_by_format:
        scoring.bucketed_scores.launches_by_format[fmt] = 0


def recall(got: torch.Tensor, want: torch.Tensor) -> float:
    hits = (got[:, :, None] == want[:, None, :]).any(-1)
    return float(hits.float().mean())


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def card_rates(device: torch.device):
    """(SMs, maximum SM clock in Hz) of the card, from the device and
    `nvidia-smi --query-gpu=clocks.max.sm`; the H100 SXM's off the card."""
    if device.type != "cuda":
        return H100_SMS, H100_MAX_SM_CLOCK_HZ
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[0]
    return cuda_build.sm_count(device), float(mhz) * 1e6


def run(device: torch.device, size: Size, seed: int) -> list:
    """Drives the slice on `device`; returns the kernels' report."""
    # 1. Build.
    started = time.perf_counter()
    if device.type == "cuda":
        logs = cuda_build.build()
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  nvcc {name}: {line.strip()}")
    phase("build", started, f"{len(cuda_build.SOURCES)} source(s)")

    reset_counts()
    with torch.no_grad():
        # 2. Towers.
        started = time.perf_counter()
        model, params = serving_model(size, seed, device)
        probe = np.array([0, 1, size.users - 1, -1, 12345 % size.users])
        got = model.query_embeddings(
            {"user_id": torch.from_numpy(probe).to(device)}
        ).double().cpu().numpy()
        want = numpy_query_tower(params, probe)
        check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
              "query tower disagrees with its NumPy reference")
        del params
        sync(device)
        phase("towers", started, f"{size.users} users, {size.items} items")

        # 3. Embed the corpus.
        started = time.perf_counter()
        corpus = model.candidate_embeddings(
            {"movie_id": torch.arange(size.items, device=device)}
        )
        check(corpus.shape == (size.items, DIM)
              and bool(torch.isfinite(corpus).all()),
              f"corpus embeddings {tuple(corpus.shape)} not finite/shaped")
        sync(device)
        phase("embed", started, f"{tuple(corpus.shape)} f32")

        # 4. Index five ways.
        query_fn = model.query_embeddings
        indexes = {}
        started = time.perf_counter()
        indexes["brute_force"] = factorized_top_k.BruteForce(
            query_fn, k=K, device=device
        ).index(corpus)
        for fmt, settings in BUCKETED.items():
            indexes[fmt] = factorized_top_k.Bucketed(
                query_fn, k=K, device=device, **settings
            ).index(corpus)
        sync(device)
        phase("index", started, ", ".join(
            f"{name} {stored_bytes(index) / 1e6:.1f} MB"
            for name, index in indexes.items()
        ))

        # 5. Serve.
        started = time.perf_counter()
        rng = np.random.default_rng(seed + 1)
        requests = [
            {"user_id": torch.from_numpy(
                rng.integers(0, size.users, size.batch)).to(device)}
            for _ in range(size.requests)
        ]
        results, latency_ms, peak_mb = {}, {}, {}
        for name, index in indexes.items():
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            results[name], latency_ms[name] = [], []
            for request in requests:
                t = time.perf_counter()
                results[name].append(index(request))
                sync(device)
                latency_ms[name].append((time.perf_counter() - t) * 1e3)
            if device.type == "cuda":
                peak_mb[name] = torch.cuda.max_memory_allocated(device) / 1e6
        excluded = results["f32"][0][1][:, 0:2 * EXCLUDED:2]
        _, excl_ids = indexes["f32"].query_with_exclusions(
            requests[0], excluded
        )
        sync(device)
        counts = dict(scoring.bucketed_scores.launches_by_format)
        total = scoring.bucketed_scores.launches
        phase("serve", started, f"launches {counts}")
        for name in indexes:
            lat = sorted(latency_ms[name])
            print(f"  serve {name}: {size.requests} x {size.batch} queries, "
                  f"request ms {[round(x, 3) for x in latency_ms[name]]} "
                  f"(median {lat[len(lat) // 2]:.3f})"
                  + (f", peak device memory {peak_mb[name]:.1f} MB"
                     if name in peak_mb else ""))
        if device.type == "cuda":
            check(total == len(BUCKETED) * size.requests + 1,
                  f"{total} kernel launches, expected one per Bucketed call")
            for fmt in BUCKETED:
                check(counts[fmt] > 0, f"kernel format {fmt} never launched")

        # 6. The served results.
        started = time.perf_counter()
        queries = [query_fn(r) for r in requests]
        for name, index in indexes.items():
            for q, (scores, ids) in zip(queries, results[name]):
                check(scores.shape == (size.batch, K)
                      and ids.shape == (size.batch, K),
                      f"{name}: result shapes {scores.shape}, {ids.shape}")
                check(bool(torch.isfinite(scores).all()),
                      f"{name}: non-finite scores")
                check(bool(((ids >= 0) & (ids < size.items)).all()),
                      f"{name}: ids outside the corpus")
                check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
                      f"{name}: scores not descending")
                sorted_ids = ids.sort(dim=1).values
                check(bool((sorted_ids[:, 1:] != sorted_ids[:, :-1]).all()),
                      f"{name}: an id repeats within a row")
                if name == "brute_force":
                    exact = (q[:, None, :] * corpus[ids.long()]).sum(-1)
                    tol = DIM * F32_EPS * (
                        q.abs()[:, None, :] * corpus[ids.long()].abs()
                    ).sum(-1)
                else:
                    codes, scales = stored_rows(index, ids)
                    exact = (scored_query(index, q)[:, None, :]
                             * codes).sum(-1) * scales
                    tol = score_tolerance(index, q, ids, exact)
                check(bool(((scores - exact).abs() <= tol).all()),
                      f"{name}: returned scores are not the exact dot "
                      f"products of the returned ids")
        _, over_ids = indexes["f32"](requests[0], k=K + EXCLUDED)
        hit = (over_ids[:, :, None] == excluded[:, None, :]).any(-1)
        check(bool((hit.sum(1) == EXCLUDED).all()),
              "over-fetch lost an excluded id")
        kept = over_ids[~hit].view(size.batch, K)
        check(excl_ids.shape == (size.batch, K)
              and not bool((excl_ids[:, :, None]
                            == excluded[:, None, :]).any()),
              "query_with_exclusions returned an excluded id")
        check(torch.equal(kept.sort(1).values, excl_ids.sort(1).values),
              "query_with_exclusions is not the over-fetch minus exclusions")
        phase("outputs", started, "shapes, exact scores, exclusions")

        # 7. Each kernel format against its plain twin, and its times.
        started = time.perf_counter()
        report = []
        q_full = queries[0]
        tower_ms = device_ms(lambda: query_fn(requests[0]), device, iters=10)
        print(f"  query tower: {tower_ms:.3f} ms for {size.batch} queries")
        for fmt in BUCKETED:
            index = indexes[fmt]
            q = q_full if index._quantize else q_full.to(
                index._candidates.dtype
            )
            packed4 = fmt == "int4"
            kw = dict(buckets=index._buckets, chunk=index._chunk,
                      query_tile=index._query_tile, valid_rows=size.items,
                      packed4=packed4)

            def kernel():
                return scoring.bucketed_scores(
                    q, index._candidates, index._scales, **kw
                )

            def twin(sub):
                return scoring.bucketed_scores_reference(
                    sub, index._candidates, index._scales,
                    buckets=kw["buckets"], valid_rows=size.items,
                    packed4=packed4,
                )

            vals, rows = kernel()
            again = kernel()
            check(torch.equal(vals, again[0]) and torch.equal(rows, again[1]),
                  f"kernel {fmt}: two launches differ")
            del again
            nq = min(TWIN_QUERIES, size.batch)
            twin_vals, twin_rows = twin(q[:nq])
            err = (vals[:nq] - twin_vals).abs()
            tol = score_tolerance(index, q[:nq], twin_rows, twin_vals)
            check(bool((err <= tol).all()),
                  f"kernel {fmt}: scores off the twin by {float(err.max())}")
            # Ids must agree wherever the twin's bucket winner beats its
            # runner-up by more than twice the score tolerance.
            stored = index._candidates
            if packed4:
                stored = quantization.unpack_nibbles(stored)
            table = scoring.reference_scores(
                q[:nq], stored, index._scales, size.items
            ).view(nq, -1, kw["buckets"])
            del stored
            top2 = table.topk(2, dim=1).values
            del table
            separated = (top2[:, 0] - top2[:, 1]) > 2 * tol
            share = float(separated.float().mean())
            check(share >= 0.9,
                  f"kernel {fmt}: only {share:.4f} of buckets separated")
            check(torch.equal(rows[:nq][separated], twin_rows[separated]),
                  f"kernel {fmt}: ids differ from the twin's in a "
                  f"separated bucket")

            ms = device_ms(kernel, device, iters=10)
            plain_ms = device_ms(
                lambda: [twin(q[i:i + nq]) for i in range(0, size.batch, nq)],
                device, iters=3,
            )
            library_ms = library_time(index, q_full, device)
            select_ms = device_ms(lambda: torch.topk(vals, K, dim=1), device,
                                  iters=10)
            q_bytes = q.numel() * (2 if index._quantize else q.element_size())
            in_bytes = q_bytes + stored_bytes(index)
            out_bytes = vals.nbytes + rows.nbytes
            ops = 2.0 * size.batch * size.items * DIM
            bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            ops_ms = K3_PASSES[fmt] * ops / PEAK_OPS_PER_S["bf16"] * 1e3
            cuda_core = ""
            if fmt == "f32":
                cuda_core = (f" (f32 CUDA-core bound "
                             f"{ops / PEAK_OPS_PER_S['f32'] * 1e3:.4g} ms)")
            report.append({
                "name": f"bucketed_scores[{fmt}]",
                "route": "cuda",
                "source": SOURCE,
                "replaces": REPLACES[fmt],
                "launches": counts[fmt],
                "max_abs_err": float(err.max()),
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                "library_ms": library_ms,
                "shape": f"Q={size.batch} N={index._candidates.shape[0]}"
                         f"{'x2' if packed4 else ''} D={DIM} "
                         f"B={kw['buckets']}",
            })
            print(f"  kernel {fmt}: max |err| {float(err.max()):.3g}, ids "
                  f"equal in every separated bucket ({share:.4f} of all "
                  f"buckets); kernel "
                  f"{ms:.3f} ms, twin {plain_ms:.3f} ms, library "
                  f"{library_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.3f} "
                  f"ms ({K3_PASSES[fmt]} bf16 pass(es)){cuda_core}; top-{K} "
                  f"over [Q, B] {select_ms:.3f} ms", flush=True)
        phase("kernels", started, "every format held against its twin")

        # 8. Recall@100 against BruteForce.
        started = time.perf_counter()
        exact_ids = [ids for _, ids in results["brute_force"]]
        for fmt in BUCKETED:
            value = float(np.mean([
                recall(ids, want)
                for (_, ids), want in zip(results[fmt], exact_ids)
            ]))
            floor = RECALL_FLOORS.get(fmt)
            print(f"  recall@{K} {fmt}: {value:.4f}"
                  + (f" (floor {floor})" if floor else ""))
            if floor is not None:
                check(value >= floor,
                      f"recall@{K} of {fmt} is {value:.4f} < {floor}")
            if (fmt == "f32" and seed == 0
                    and size == Size(requests=size.requests)):
                check(abs(value - F32_RECALL_SEED0) <= 0.001,
                      f"recall@{K} of f32 is {value:.4f}, not within 0.001 "
                      f"of {F32_RECALL_SEED0}")
        phase("recall", started)
    return report


def library_time(index, queries: torch.Tensor, device: torch.device) -> float:
    """Time of the library call that serves the same request exactly
    (the BruteForce path): `torch.matmul` of the queries with the stored
    corpus in its compute type, then `torch.topk`. Integer codes are cast
    to bf16 (exact) before the timing and their scales multiply after."""
    stored, scales = index._candidates, index._scales
    if index._quantize == "int4":
        stored = quantization.unpack_nibbles(stored)
    if index._quantize:
        stored = stored.to(torch.bfloat16)
    q = queries.to(stored.dtype)

    def call():
        scores = torch.matmul(q, stored.T)
        if scales is not None:
            scores = scores * scales
        return torch.topk(scores, K, dim=1)

    return device_ms(call, device, iters=5)


# --- Training: the `bench.py` step -----------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainSize:
    users: int = 65_536      # bench.py:67
    items: int = 131_072     # bench.py:68
    dim: int = 64            # bench.py:66
    batch: int = 4096        # bench.py:65
    steps: int = 20          # pipelined steps per task form (main path)
    timed_steps: int = 30    # steps per step form in the timing phase
    parity_steps: int = 3


TRAIN_LR = 0.1
KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam", "ftrl")
K1_SOURCE = "recommenders_tpu_torch/csrc/sparse_apply.cu"
K1_REPLACES = "recommenders_tpu/ops/sparse_apply.py:134"
K1_SR_SEED = 123457
# Ids of K1's floor call: one run, so one warp updates one row.
K1_FLOOR_IDS = 32
K2_SOURCE = "recommenders_tpu_torch/csrc/fused_retrieval.cu"
K2_REPLACES = {
    "fwd": "recommenders_tpu/ops/fused_retrieval.py:97",
    "dq": "recommenders_tpu/ops/fused_retrieval.py:130",
    "dc": "recommenders_tpu/ops/fused_retrieval.py:160",
}
# Step parity, card against the CPU's twins over 3 steps, taken over the
# rows either side changed. Losses to rtol 1e-4 (f32 sums of 16.8M scores
# in another order). State within 2 bf16 ulps of the largest of the
# value, the value before and the largest change in its row: an
# activation grad that rounds to bf16 one ulp apart changes its row's
# update by an ulp of the row's grads, which stochastic rounding may
# carry one ulp further. And a least bit-equal share, lower fused, where
# the kernel rounds its backward's probability coefficients to bf16 (as
# the TPU kernel does) and the twin keeps them f32, so more activation
# grads round apart. On the H100 at seed 0 the card read 2 ulps and
# 0.99998 (unfused) / 0.983 (fused) bit-equal, the planted faults below
# 3-4 ulps and 0.45-0.66; each share limit sits near the geometric mean of
# the differing shares on either side (PERF.md, section 6).
PARITY_ULPS = 2.0
PARITY_SHARE = {False: 0.997, True: 0.92}
# Faults planted on the CPU side, each of which the limits must reject:
# (label, shift of the step counter, learning rate). A shifted step draws
# the stochastic rounding bits of another step.
PARITY_FAULTS = (("SR stream of the next step", 1, TRAIN_LR),
                 ("lr 1 % high", 0, TRAIN_LR * 1.01))


def parity_holds(fused: bool, ulps: float, share: float) -> bool:
    return ulps <= PARITY_ULPS and share >= PARITY_SHARE[fused]


# The K2 check's knobs: every one the fused loss takes.
K2_TEMPERATURE = 0.2
K2_ID_RANGE = 1024


def check_k2_counts(label: str, counts: dict, want,
                    scores: str) -> None:
    """Each K2 kernel launched `want` times (an int, or a dict by kernel
    name) with `scores` scores (the wrapper's count by kernel and score
    dtype) and never with the other."""
    for (name, kind), count in counts.items():
        expected = 0
        if kind == scores:
            expected = want[name] if isinstance(want, dict) else want
        check(count == expected, f"{label}: {count} K2 {name} launches with "
              f"{kind} scores, expected {expected}")


def k2_text(counts: dict) -> str:
    """K2's launch counts as `fwd/dq/dc bf16 a/b/c, f32 d/e/f`."""
    return "fwd/dq/dc " + ", ".join(
        f"{scores} " + "/".join(str(counts[name, scores])
                               for name in ("fwd", "dq", "dc"))
        for scores in ("bf16", "f32"))


def reset_train_counts() -> None:
    sparse_apply.sorted_block_apply.launches = 0
    fused_retrieval.fused_retrieval_loss.launches = 0
    for name in fused_retrieval.fused_retrieval_loss.launches_by_kernel:
        fused_retrieval.fused_retrieval_loss.launches_by_kernel[name] = 0


def train_engine(size: TrainSize, device,
                 lr: float = TRAIN_LR) -> emb_engine.EmbeddingEngine:
    """`bench.py`'s engine: two unstacked bf16 tables, bf16 adagrad slots
    written with stochastic rounding."""
    return emb_engine.EmbeddingEngine(
        (
            emb_config.FeatureConfig(
                emb_config.TableConfig(size.users, size.dim, name="user"),
                name="user_id"),
            emb_config.FeatureConfig(
                emb_config.TableConfig(size.items, size.dim, name="item"),
                name="item_id"),
        ),
        optimizer=emb_config.OptimizerSpec(kind="adagrad", learning_rate=lr),
        dtype=torch.bfloat16, slot_dtype=torch.bfloat16, device=device,
    )


def logical_state(size: TrainSize, seed: int) -> dict:
    """A random initial state in the engine's logical layout, from NumPy:
    tables normal cut at ±2, over sqrt(dim); accumulators at adagrad's
    initial value 0.1."""
    rng = np.random.default_rng(seed + 2)
    tables, slots = {}, {}
    for name, rows in (("user", size.users), ("item", size.items)):
        x = rng.standard_normal((rows, size.dim), dtype=np.float32)
        tables[name] = np.clip(x, -2, 2) * np.float32(size.dim ** -0.5)
        slots[name] = {"accumulator": np.full((rows, size.dim), 0.1,
                                              np.float32)}
    return {"tables": tables, "slots": slots, "step": 0}


def train_batches(size: TrainSize, seed: int, count: int, device) -> list:
    """`count` batches of uniform (user, item) ids, as `bench.py:139-148`
    draws them (NumPy `RandomState.randint`), moved to `device`."""
    rng = np.random.RandomState(seed)
    return [
        {"user_id": torch.from_numpy(rng.randint(
            0, size.users, size.batch).astype(np.int32)).to(device),
         "item_id": torch.from_numpy(rng.randint(
             0, size.items, size.batch).astype(np.int32)).to(device)}
        for _ in range(count)
    ]


def train_loss(fused: bool):
    task = tasks.Retrieval(score_dtype=torch.bfloat16, fused=fused)
    return lambda acts: task(acts["user_id"], acts["item_id"]).loss


def run_steps(engine, state, batches, fused: bool, pipelined: bool):
    """Runs one step per batch (and the final `flush`); returns the new
    state and the losses (device tensors)."""
    loss_fn = train_loss(fused)
    losses, pending = [], None
    for batch in batches:
        if pipelined:
            state, pending, loss, _ = engine.pipelined_grad_and_update(
                state, pending, batch, loss_fn)
        else:
            state, loss, _ = engine.grad_and_update(state, batch, loss_fn)
        losses.append(loss)
    if pipelined:
        state = engine.flush(state, pending)
    return state, losses


def clone_state(state, device=None) -> emb_engine.EngineState:
    return emb_engine.EngineState(
        tables={k: v.to(device).clone() for k, v in state.tables.items()},
        slots={k: {s: t.to(device).clone() for s, t in v.items()}
               for k, v in state.slots.items()},
        step=state.step,
    )


def ulp_report(got: torch.Tensor, want: torch.Tensor, before=None,
               row_scale: bool = False):
    """(max |got − want|, largest distance in ulps of the largest of the
    two values, the value before the update and the update itself (with
    `row_scale`, the largest update in the element's row), share
    bit-equal); ulps of got's dtype."""
    g, w = got.float(), want.float()
    scale = torch.maximum(g.abs(), w.abs())
    if before is not None:
        b = before.float()
        change = (w - b).abs()
        if row_scale:
            change = change.amax(dim=1, keepdim=True).expand_as(change)
        scale = torch.maximum(scale, torch.maximum(b.abs(), change))
    mant = 7 if got.dtype == torch.bfloat16 else 23
    exp = torch.floor(torch.log2(scale.clamp(min=2.0**-126)))
    ulp = torch.pow(2.0, exp - mant)
    diff = (g - w).abs()
    return (float(diff.max()), float((diff / ulp).max()),
            float((g == w).float().mean()))


def state_parity(got, want, start):
    """(largest distance in ulps at its row's scale, least bit-equal share)
    over every state plane of two engine states that began at `start`.
    Both are taken over the rows that either side changed: rows no step
    touched are equal by construction and would dilute the share."""
    worst = (0.0, 1.0)
    for name in got.tables:
        pairs = [(got.tables[name], want.tables[name], start.tables[name])]
        pairs += [(got.slots[name][k], want.slots[name][k],
                   start.slots[name][k]) for k in got.slots[name]]
        for g, w, b in pairs:
            g, w, b = g.cpu(), w.cpu(), b.cpu()
            changed = ((g != b) | (w != b)).any(dim=1)
            if bool(changed.any()):
                _, ulps, eq = ulp_report(g[changed], w[changed], b[changed],
                                         row_scale=True)
                worst = (max(worst[0], ulps), min(worst[1], eq))
    return worst


def k1_problem(rule_kind, dtype, v, d, n, device, seed):
    """States, sorted ids (duplicates and padding) and grads for one K1
    check, drawn on the device from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn(v, d, device=device, generator=gen)
    widths = {"sgd": [], "adagrad": [d], "rowwise_adagrad": [1],
              "adam": [d, d], "ftrl": [d, d]}[rule_kind]
    slots = [torch.rand(v, w, device=device, generator=gen) * 2 + 0.05
             for w in widths]
    if rule_kind == "ftrl":
        slots[1] = torch.randn(v, d, device=device, generator=gen)
    states = [table] + slots
    states = [s.to(dtype).contiguous() for s in states]
    ids = torch.randint(0, v, (n,), device=device, generator=gen)
    dup = torch.randint(0, n, (n // 4,), device=device, generator=gen)
    ids[: n // 4] = ids[dup]
    ids[-8:] = v                                   # padding
    ids = torch.sort(ids, stable=True).values.to(torch.int32)
    grads = torch.randn(n, d, device=device, generator=gen)
    return states, ids, grads


def k1_bound_ms(states, ids) -> float:
    """Bytes K1 must move: every touched row of every state read and
    written once, the grads and ids read once."""
    v = states[0].shape[0]
    touched = int(torch.unique(ids[ids < v]).numel())
    row_bytes = sum(s.shape[1] * s.element_size() for s in states)
    n, d = ids.shape[0], states[0].shape[1]
    total = 2 * touched * row_bytes + n * d * 4 + n * 4
    return total / HBM_BYTES_PER_S * 1e3


def k1_calls(states, ids, grads, rule, scalars):
    """(step call, floor call): K1 with the main path's stochastic
    rounding on `ids`, and on `K1_FLOOR_IDS` copies of their first id (one
    run, one row: K1's floor); both update `states` in place."""
    on_device = scalars.to(ids.device)

    def call(run_ids, run_grads):
        return lambda: sparse_apply.sorted_block_apply(
            states, run_ids, run_grads, rule, scalars=on_device,
            stochastic_round_seed=K1_SR_SEED)

    return (call(ids, grads),
            call(ids[:1].repeat(K1_FLOOR_IDS),
                 grads[:K1_FLOOR_IDS].contiguous()))


def check_k1(size: TrainSize, device, launches: int, seed: int) -> dict:
    """K1 against its twin for every rule, f32 and bf16 + SR states, at
    V = items, D = dim, n = batch; the report row is the main path's
    rule (adagrad, bf16 + SR)."""
    v, d, n = size.items, size.dim, size.batch
    row = None
    for kind in KINDS:
        spec = emb_config.OptimizerSpec(kind=kind, learning_rate=0.05)
        _, scalars, rule, _ = sparse_optimizer._kernel_rule(spec, 7)
        for dtype, sr_seed in ((torch.float32, None),
                               (torch.bfloat16, K1_SR_SEED)):
            states, ids, grads = k1_problem(kind, dtype, v, d, n, device,
                                            seed)
            got = [s.clone() for s in states]
            want = [s.clone() for s in states]
            sparse_apply.sorted_block_apply(
                got, ids, grads, rule, scalars=scalars,
                stochastic_round_seed=sr_seed)
            sparse_apply.sorted_block_apply_reference(
                want, ids, grads, rule, scalars=scalars,
                stochastic_round_seed=sr_seed)
            sync(device)
            # Tolerance: 2 ulps of the largest of the result, the value
            # before and the update (f32), 1 ulp (bf16). The kernel takes
            # the twin's IEEE operations in its order; only rowwise
            # adagrad's row mean (a warp tree sum) and ftrl's pow may
            # round differently.
            max_ulp = 1 if dtype == torch.bfloat16 else 2
            worst_err, worst_ulp, equal = 0.0, 0.0, 1.0
            for g, w, b in zip(got, want, states):
                err, ulps, eq = ulp_report(g, w, b)
                worst_err = max(worst_err, err)
                worst_ulp = max(worst_ulp, ulps)
                equal = min(equal, eq)
            label = f"{kind} {'bf16+SR' if sr_seed else 'f32'}"
            check(worst_ulp <= max_ulp,
                  f"K1 {label}: {worst_ulp} ulps from its twin")
            print(f"  K1 {label}: max |err| {worst_err:.3g}, "
                  f"{worst_ulp:.2f} ulp, bit-equal share {equal:.6f}")
            if kind == "adagrad" and sr_seed is not None:
                kernel, floor = k1_calls(got, ids, grads, rule, scalars)

                def twin():
                    sparse_apply.sorted_block_apply_reference(
                        want, ids, grads, rule, scalars=scalars,
                        stochastic_round_seed=sr_seed)

                row = {
                    "name": "sorted_block_apply[adagrad bf16+SR]",
                    "route": "cuda",
                    "source": K1_SOURCE,
                    "replaces": K1_REPLACES,
                    "launches": launches,
                    "max_abs_err": worst_err,
                    "ms": graph_ms(kernel, device),
                    "call_ms": device_ms(kernel, device, iters=50),
                    "plain_ms": device_ms(twin, device, iters=5),
                    "bound_ms": k1_bound_ms(states, ids),
                    "bound_by": "bytes",
                    # One run of K1_FLOOR_IDS ids, one row: the least
                    # a launch that sums a run takes.
                    "floor_ms": graph_ms(floor, device),
                    # No single PyTorch call computes this function.
                    "library_ms": None,
                    "shape": f"V={v} D={d} n={n} bf16 table + bf16 slot",
                }
                print(f"  K1 timing: kernel {row['ms']:.4f} ms (graph "
                      f"replay), {row['call_ms']:.4f} ms a wrapper call, "
                      f"twin {row['plain_ms']:.3f} ms, bound "
                      f"{row['bound_ms']:.4f} ms, floor (one run of "
                      f"{K1_FLOOR_IDS} ids, graph replay) "
                      f"{row['floor_ms']:.4f} ms", flush=True)
    return row


def k2_inputs(size: TrainSize, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    b = c = size.batch
    std = size.dim ** -0.25        # scores of standard deviation ~1
    q = torch.randn(b, size.dim, device=device, generator=gen) * std
    cand = torch.randn(c, size.dim, device=device, generator=gen) * std
    ids = torch.randint(0, K2_ID_RANGE, (c,), device=device, generator=gen)
    probs = torch.rand(c, device=device, generator=gen) * 0.99 + 0.01
    w = torch.rand(b, device=device, generator=gen) * 1.9 + 0.1
    return q, cand, dict(sample_weight=w,
                         candidate_sampling_probability=probs,
                         candidate_ids=ids)


def value_and_grads(fn, q, cand, kwargs):
    q = q.detach().clone().requires_grad_(True)
    cand = cand.detach().clone().requires_grad_(True)
    loss = fn(q, cand, **kwargs)
    loss.backward()
    return loss.detach(), q.grad, cand.grad


def k2_bound_terms(name: str, q, c, sms: int, clock_hz: float) -> dict:
    """The three least times (ms) of one K2 kernel: its products on the
    bf16 tensor cores (fwd one [B, C, D] product, dq and dc two, the
    recomputed scores and the coefficient product; f32 scores take each
    in `K2_PASSES` split-precision passes), its B·C exps at the SFU's
    rate, and its bytes at the HBM rate (the operands, the [C] log-q and
    ids, the [B] lse and weights it reads, and its f32 outputs, each
    once)."""
    b, d = q.shape
    cn = c.shape[0]
    products = (1 if name == "fwd" else 2) * 2.0 * b * cn * d
    reads = q.nbytes + c.nbytes + cn * 8 + {"fwd": 0, "dq": b * 4,
                                            "dc": b * 8}[name]
    writes = {"fwd": b * 8, "dq": b * d * 4, "dc": cn * d * 4}[name]
    return {
        "products": K2_PASSES[q.dtype] * products / PEAK_OPS_PER_S["bf16"]
        * 1e3,
        "exp": b * cn / (SFU_EXP_PER_CLOCK * sms * clock_hz) * 1e3,
        "bytes": (reads + writes) / HBM_BYTES_PER_S * 1e3,
    }


def k2_against_twin(q, cand, fkw: dict, label: str) -> tuple:
    """K2's loss and grads (`fused_retrieval_loss`, launching the kernels
    on the card) against its twin's on the same inputs and knobs `fkw`;
    fails past the score dtype's tolerance. Returns (loss, twin loss,
    loss |err|, max |err| of dq and dc)."""
    loss, dq, dc = value_and_grads(
        fused_retrieval.fused_retrieval_loss, q, cand, fkw)
    tloss, tdq, tdc = value_and_grads(
        fused_retrieval.fused_retrieval_loss_reference, q, cand, fkw)
    sync(q.device)
    # Tolerance. f32 scores: the loss to rtol 1e-5, the grads (sums of C
    # terms in another order) to 1e-4 of their largest magnitude. bf16
    # scores: the kernel rounds the backward's probability coefficients
    # to bf16 before each product, as the TPU kernel does, where the
    # twin's autograd keeps them f32: grads to 2e-2 relative plus 2e-3 of
    # their largest magnitude.
    bf16 = fkw.get("score_dtype") == torch.bfloat16
    loss_err = float((loss - tloss).abs())
    check(loss_err <= 1e-5 * float(tloss.abs()),
          f"{label}: loss {float(loss)} vs twin {float(tloss)}")
    errs = {}
    for name, g, t in (("dq", dq, tdq), ("dc", dc, tdc)):
        scale = float(t.abs().max())
        err = (g - t).abs()
        tol = ((2e-2 * t.abs() + 2e-3 * scale) if bf16
               else (1e-5 * t.abs() + 1e-4 * scale))
        check(bool((err <= tol).all()),
              f"{label} {name}: max |err| {float(err.max())}")
        errs[name] = float(err.max())
    return loss, tloss, loss_err, errs


def check_k2(size: TrainSize, device, launches: dict, seed: int) -> list:
    """K2 (forward, dq, dc) against its twin with temperature, log-q,
    accidental hits and weights, f32 and bf16 scores, at B = C = batch;
    a report row each: bf16 scores are the main path's, f32 scores
    (split precision) the multitask path's."""
    q, cand, kw = k2_inputs(size, device, seed)
    b, d = q.shape
    rows = []
    for score_dtype in (torch.float32, torch.bfloat16):
        fkw = dict(kw, temperature=K2_TEMPERATURE,
                   remove_accidental_hits=True, score_dtype=score_dtype)
        bf16 = score_dtype == torch.bfloat16
        label = "bf16" if bf16 else "f32"
        loss, tloss, loss_err, errs = k2_against_twin(q, cand, fkw,
                                                      f"K2 {label}")
        print(f"  K2 {label} scores: loss "
              f"{float(loss):.6f} vs twin {float(tloss):.6f}, max |err| "
              f"dq {errs['dq']:.3g}, dc {errs['dc']:.3g}")
        # Times, on the operands the kernels take (with bf16 scores,
        # rounded to bf16 once, as the wrapper does).
        config = (1.0 / K2_TEMPERATURE, bf16)
        qb = q.to(score_dtype).contiguous()
        cb = cand.to(score_dtype).contiguous()
        logq = torch.log(torch.clamp(kw["candidate_sampling_probability"],
                                     1e-6, 1.0)).float().contiguous()
        ids32 = kw["candidate_ids"].to(torch.int32).contiguous()
        w = kw["sample_weight"].float().contiguous()
        task = tasks.Retrieval(temperature=K2_TEMPERATURE,
                               remove_accidental_hits=True,
                               score_dtype=torch.bfloat16 if bf16 else None)
        no_grad_twin = lambda: fused_retrieval.fused_retrieval_loss_reference(
            q, cand, **fkw)
        grad_twin = lambda: value_and_grads(
            fused_retrieval.fused_retrieval_loss_reference, q, cand, fkw)
        library_value = lambda: task(q, cand, **kw).loss
        library_grads = lambda: value_and_grads(
            lambda a, c_, **k: task(a, c_, **k).loss, q, cand, kw)
        if device.type == "cuda":
            lse, _ = fused_retrieval.forward_kernel(qb, cb, logq, ids32,
                                                    config)
            kernels = {
                "fwd": lambda: fused_retrieval.forward_kernel(
                    qb, cb, logq, ids32, config),
                "dq": lambda: fused_retrieval.backward_kernel(
                    "dq", qb, cb, logq, ids32, w, lse, config),
                "dc": lambda: fused_retrieval.backward_kernel(
                    "dc", qb, cb, logq, ids32, w, lse, config),
            }
            for name, fn in kernels.items():
                first, second = fn(), fn()
                same = (all(torch.equal(x, y) for x, y in zip(first, second))
                        if name == "fwd" else torch.equal(first, second))
                check(same, f"K2 {name}: two launches differ")
        else:   # The CPU rehearsal has no kernel; its twin stands in.
            kernels = {"fwd": no_grad_twin, "dq": grad_twin,
                       "dc": grad_twin}
        with torch.no_grad():
            plain_fwd = device_ms(no_grad_twin, device, iters=3)
            lib_fwd = device_ms(library_value, device, iters=3)
        plain_grad = device_ms(grad_twin, device, iters=3)
        lib_grad = device_ms(library_grads, device, iters=3)
        sms, clock_hz = card_rates(device)
        print(f"  K2 bound: {sms} SMs at {clock_hz / 1e9:.3f} GHz "
              f"(nvidia-smi clocks.max.sm), {SFU_EXP_PER_CLOCK} exp a clock "
              f"an SM", flush=True)
        for name in ("fwd", "dq", "dc"):
            terms = k2_bound_terms(name, qb, cb, sms, clock_hz)
            bound_term = max(terms, key=terms.get)
            cuda_core = ""
            if not bf16:   # The products' bound on the f32 CUDA cores.
                f32_ms = (terms["products"] / K2_PASSES[qb.dtype]
                          * PEAK_OPS_PER_S["bf16"] / PEAK_OPS_PER_S["f32"])
                cuda_core = f"; f32 CUDA-core bound {f32_ms:.4g} ms"
            ms = graph_ms(kernels[name], device)
            rows.append({
                "name": f"fused_retrieval_{name}[{label} scores]",
                "route": "cuda",
                "source": K2_SOURCE,
                "replaces": K2_REPLACES[name],
                # Phase 9's count: it runs bf16 scores; f32 scores run
                # on the multitask path (phase 27, its `path_launches`).
                "launches": launches[name, label],
                "max_abs_err": loss_err if name == "fwd" else errs[name],
                "ms": ms,
                "plain_ms": plain_fwd if name == "fwd" else plain_grad,
                "bound_ms": terms[bound_term],
                "bound_by": "bytes" if bound_term == "bytes" else "operations",
                "library_ms": lib_fwd if name == "fwd" else lib_grad,
                "call_ms": device_ms(kernels[name], device, iters=20),
                "shape": f"B=C={b} D={d}",
            })
            print(f"  K2 {label} {name}: kernel {ms:.4f} ms (graph replay), "
                  f"{rows[-1]['call_ms']:.4f} ms a call, twin "
                  f"{rows[-1]['plain_ms']:.3f} ms, library "
                  f"{rows[-1]['library_ms']:.3f} ms; bound "
                  f"{terms[bound_term]:.4g} ms ({bound_term}; products "
                  f"{terms['products']:.4g}, exp {terms['exp']:.4g}, bytes "
                  f"{terms['bytes']:.4g})" + cuda_core, flush=True)
    return rows


def train(device: torch.device, size: TrainSize, seed: int) -> list:
    """Drives the training slice on `device`; returns K1's and K2's
    report rows."""
    engine = train_engine(size, device)
    initial = logical_state(size, seed)
    batches = train_batches(size, seed, 2 * size.steps, device)

    # 9. Train: the main path, pipelined, unfused then fused.
    started = time.perf_counter()
    state = convert.engine_state_from_logical(engine, initial)
    sync(device)
    reset_train_counts()
    losses = {}
    for fused, part in ((False, batches[:size.steps]),
                        (True, batches[size.steps:])):
        state, got = run_steps(engine, state, part, fused, pipelined=True)
        losses[fused] = torch.stack(got).float().cpu()
    sync(device)
    k1_launches = sparse_apply.sorted_block_apply.launches
    k2_launches = dict(fused_retrieval.fused_retrieval_loss.launches_by_kernel)
    phase("train", started,
          f"K1 launches {k1_launches}, K2 launches {k2_text(k2_launches)}")
    for fused, vals in losses.items():
        check(bool(torch.isfinite(vals).all()),
              f"non-finite training loss (fused={fused})")
        print(f"  losses {'fused' if fused else 'unfused'}: first "
              f"{float(vals[0]):.4f}, last {float(vals[-1]):.4f}")
    check(state.step == 2 * size.steps, f"engine step {state.step}")
    if device.type == "cuda":
        check(k1_launches == 2 * 2 * size.steps,
              f"{k1_launches} K1 launches, expected one a table an update")
        check_k2_counts("train", k2_launches, size.steps, "bf16")

    # 10. Step parity: the card against the CPU's twins, and the same
    # check against planted faults on the CPU side, which it must reject.
    started = time.perf_counter()
    cpu_engines = {lr: train_engine(size, "cpu", lr)
                   for lr in {TRAIN_LR} | {f[2] for f in PARITY_FAULTS}}
    start = clone_state(state)
    parity = train_batches(size, seed + 3, size.parity_steps, device)
    cpu_batches = [{k: v.cpu() for k, v in b.items()} for b in parity]

    def host_run(fused, step_shift=0, lr=TRAIN_LR):
        begin = clone_state(start, "cpu")
        begin.step += step_shift
        return run_steps(cpu_engines[lr], begin, cpu_batches, fused,
                         pipelined=False)

    for fused in (False, True):
        form = "fused" if fused else "unfused"
        card, card_losses = run_steps(engine, clone_state(start), parity,
                                      fused, pipelined=False)
        host, host_losses = host_run(fused)
        card_l = torch.stack(card_losses).float().cpu()
        host_l = torch.stack(host_losses).float()
        readings = {"card": state_parity(card, host, start)}
        for label, step_shift, lr in PARITY_FAULTS:
            readings[label] = state_parity(host_run(fused, step_shift, lr)[0],
                                           host, start)
        print(f"  parity {form}: losses "
              f"{[round(x, 4) for x in card_l.tolist()]} vs CPU "
              f"{[round(x, 4) for x in host_l.tolist()]}; state over the "
              f"changed rows (ulps at the row's scale, bit-equal share): "
              + ", ".join(f"{k} {u:.2f} / {eq:.6f}"
                          for k, (u, eq) in readings.items()),
              flush=True)
        check(bool(torch.allclose(card_l, host_l, rtol=1e-4, atol=0)),
              f"step losses {card_l.tolist()} vs CPU {host_l.tolist()}")
        ulps, eq = readings.pop("card")
        check(parity_holds(fused, ulps, eq),
              f"card state vs CPU ({form}): {ulps} ulps, {eq} bit-equal")
        for label, (ulps, eq) in readings.items():
            check(not parity_holds(fused, ulps, eq),
                  f"the {form} parity limits pass a planted fault "
                  f"({label}: {ulps} ulps, {eq} bit-equal)")
    del start, card, host
    phase("parity", started, f"{size.parity_steps} steps, card vs CPU, "
          f"{len(PARITY_FAULTS)} planted faults rejected")

    # 11. Kernels against their twins, and their times.
    started = time.perf_counter()
    report = [check_k1(size, device, k1_launches, seed)]
    report += check_k2(size, device, k2_launches, seed)
    phase("train kernels", started, "K1 and K2 held against their twins")

    # 12. Step timings.
    started = time.perf_counter()
    for pipelined in (False, True):
        for fused in (False, True):
            steps = train_batches(size, seed + 5, size.timed_steps + 2,
                                  device)
            state, _ = run_steps(engine, state, steps[:2], fused, pipelined)
            sync(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t = time.perf_counter()
            state, _ = run_steps(engine, state, steps[2:], fused, pipelined)
            sync(device)
            ms = (time.perf_counter() - t) * 1e3 / size.timed_steps
            peak = (torch.cuda.max_memory_allocated(device) / 1e6
                    if device.type == "cuda" else float("nan"))
            print(f"  step {'pipelined' if pipelined else 'plain'} "
                  f"{'fused' if fused else 'unfused'}: {ms:.3f} ms/step, "
                  f"{size.batch / ms * 1e3:.0f} examples/s, peak device "
                  f"memory {peak:.1f} MB", flush=True)
    phase("train timing", started, f"{size.timed_steps} steps a form")
    return report


# --- ScaNN probed serving ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScannSize:
    items: int = 1_000_000     # benchmarks/serving.py's clustered corpus
    centers: int = 1024        # benchmarks/serving.py:339
    batch: int = 1024
    requests: int = 3
    leaves: int = 1024         # benchmarks/serving.py:190, ann.py:374
    leaves_2000: int = 2000    # benchmarks/serving.py:405
    users: int = 65_536        # the composed request's query tower


# Queries (K4) and query tiles (K5) the twins score against the kernels.
K4_TWIN_QUERIES = 16
K5_TWIN_TILES = 2
# Bytes of the gather (and its casts) one chunk of the full-shape gather +
# matmul yardstick may form.
GATHER_CHUNK_BYTES = 4 * 2**30
# Queries that both the kernel path and the twin path serve.
PATH_QUERIES = 64
# Recall@100 floors; they hold for the full corpus (`full_corpus`) only.
# int8_reorder's is the JAX package's recorded 0.939 less its margin. The
# L=1024 indexes read 0.850-0.855 on the H100 at seed 0 (PERF.md §6):
# at cap 1280 = 1.31 × the mean leaf, 17.6 % of the rows find no space in
# their 8 nearest leaves and fill far ones that no probe reaches (phase 17
# prints that share; tests/test_torch_scann_spill.py finds the JAX build
# in the same regime). Each of their floors is 0.02 below that first
# reading.
SCANN_RECALL_FLOORS = {
    "int8_reorder": 0.92,
    "int8_bucketed": 0.83,
    "bf16_gather": 0.83,
    "int4_gather_reorder": 0.83,
    "int4_bucketed_reorder": 0.83,
    "bf16_bucketed": 0.83,
}
MAIN_INDEX = "int8_bucketed"
LEAF_SOURCE = "recommenders_tpu_torch/csrc/leaf_scoring.cu"
LEAF_REPLACES = {
    ("K4", "f32"): "recommenders_tpu/ops/leaf_scoring.py:56",
    ("K4", "bf16"): "recommenders_tpu/ops/leaf_scoring.py:56",
    ("K4", "int8"): "recommenders_tpu/ops/leaf_scoring.py:66",
    ("K4", "int4"): "recommenders_tpu/ops/leaf_scoring.py:102",
    ("K5", "f32"): "recommenders_tpu/ops/leaf_scoring.py:248",
    ("K5", "bf16"): "recommenders_tpu/ops/leaf_scoring.py:248",
    ("K5", "int8"): "recommenders_tpu/ops/leaf_scoring.py:268",
    ("K5", "int4"): "recommenders_tpu/ops/leaf_scoring.py:288",
}
KERNEL_FNS = {"K4": leaf_scoring.probed_leaf_scores,
              "K5": leaf_scoring.probed_bucketed_scores}


def full_corpus(size: ScannSize) -> bool:
    """Whether `size` has the full corpus and partitions, the shape the
    recall floors were set on (the request count does not matter)."""
    full = ScannSize()
    return ((size.items, size.centers, size.leaves, size.leaves_2000)
            == (full.items, full.centers, full.leaves, full.leaves_2000))


def scann_configs(size: ScannSize) -> dict:
    """name → (ScaNN settings, kernel, leaf format), as their sources set
    them (k = 100 for all)."""
    n_leaves, n_2000 = size.leaves, size.leaves_2000
    main = dict(num_leaves=n_leaves, num_leaves_to_search=n_leaves // 4,
                quantize="int8", scoring_buckets=4096, probe_tile=64,
                query_batch=1024, kmeans_sample_size=2**21,
                training_iterations=8)
    ann = dict(kmeans_sample_size=min(size.items, 2**21),
               training_iterations=8, query_batch=256)
    return {
        MAIN_INDEX: (main, "K5", "int8"),
        "int8_reorder": (dict(
            num_leaves=n_2000, num_leaves_to_search=max(1, n_2000 // 50),
            quantize=True, num_reordering_candidates=4 * K,
            query_batch=128), "K4", "int8"),
        "bf16_gather": (dict(
            ann, num_leaves=n_leaves, num_leaves_to_search=n_leaves // 8,
            leaf_dtype=torch.bfloat16), "K4", "bf16"),
        "int4_gather_reorder": (dict(
            ann, num_leaves=n_leaves, num_leaves_to_search=n_leaves // 8,
            quantize="int4", num_reordering_candidates=4 * K,
            reorder_dtype=torch.bfloat16), "K4", "int4"),
        "int4_bucketed_reorder": (dict(
            ann, num_leaves=n_leaves, num_leaves_to_search=n_leaves // 4,
            quantize="int4", num_reordering_candidates=4 * K,
            reorder_dtype=torch.bfloat16, scoring_buckets=4096,
            probe_tile=64), "K5", "int4"),
        "bf16_bucketed": (dict(main, quantize=False,
                               leaf_dtype=torch.bfloat16), "K5", "bf16"),
    }


def clustered_data(size: ScannSize, seed: int):
    """The corpus and the requests as `benchmarks/serving.py:339-348`
    draws them: Gaussian centres at scale 3.0 plus unit noise, NumPy
    `RandomState(seed)`, the corpus first."""
    rng = np.random.RandomState(seed)
    centers = rng.normal(scale=3.0, size=(size.centers, DIM)).astype(
        np.float32)

    def draw(n):
        return (centers[rng.randint(0, size.centers, n)]
                + rng.normal(size=(n, DIM)).astype(np.float32))

    corpus = draw(size.items)
    return corpus, [draw(size.batch) for _ in range(size.requests)]


def query_tower(users: int, seed: int, device: torch.device):
    """The serving slice's query tower (random weights from `seed`, the
    same draws as `run`'s) as a ScaNN `query_fn`."""
    return serving_model(Size(users=users, items=1), seed,
                         device)[0].query_embeddings


def reset_leaf_counts() -> None:
    for fn in KERNEL_FNS.values():
        fn.launches = 0
        for fmt in fn.launches_by_format:
            fn.launches_by_format[fmt] = 0


def index_bytes(index) -> int:
    return sum(getattr(index, name).nbytes
               for name in convert.SCANN_ARRAYS
               if getattr(index, name) is not None)


def leaf_rows_f32(index) -> torch.Tensor:
    """The index's stored leaves as f32 `[L, cap, D]` values (codes
    unpacked and scaled)."""
    leaves = index._leaf_embs
    if index._quantize == "int4":
        leaves = quantization.unpack_nibbles(leaves)
    rows = leaves.to(torch.float32)
    if index._leaf_scales is not None:
        rows *= index._leaf_scales[..., None]
    return rows


def max_row_norm(index) -> float:
    """Largest norm of a stored row (dequantized) or of a reorder row."""
    norm = float(leaf_rows_f32(index)[index._leaf_valid].norm(dim=1).max())
    if index._corpus is not None:
        norm = max(norm, float(index._corpus.float().norm(dim=1).max()))
    return norm


def scann_scored(index, queries: torch.Tensor) -> torch.Tensor:
    """The queries as the leaves score them: bf16-rounded for codes."""
    q = queries.to(torch.float32)
    return q.to(torch.bfloat16).to(torch.float32) if index._quantize else q


def slot_of_rows(leaf_rows: torch.Tensor, n: int) -> torch.Tensor:
    """`[n]` flat slot (leaf · cap + slot) of each corpus row in a
    `[L, cap]` table of global rows (-1 = padding); -1 for a row stored
    nowhere. A row stored twice keeps one of its slots."""
    flat = leaf_rows.reshape(-1)
    where = torch.full((n,), -1, dtype=torch.long, device=flat.device)
    live = flat >= 0
    where[flat[live].long()] = torch.nonzero(live).squeeze(1)
    return where


def near_share(leaf_rows: torch.Tensor, centroids: torch.Tensor,
               corpus: torch.Tensor, rounds: int) -> float:
    """Share of the corpus's rows stored in one of their `rounds` nearest
    leaves, the leaves the packing's rounds offer them; the rest went to
    the global pool of free slots, in leaves that may lie far from them."""
    leaf_of = slot_of_rows(leaf_rows, corpus.shape[0]) // leaf_rows.shape[1]
    near = approximate._topr_assign_device(corpus, centroids, rounds, 16384)
    return float((near.long() == leaf_of[:, None]).any(1).float().mean())


def stored_scores(index, queries: torch.Tensor, ids: torch.Tensor):
    """(exact f32 scores, tolerance) of the returned ids from what the
    index stores: the reorder corpus where it re-ranks, else each id's
    leaf slot (codes decoded, scale after the dot). Tolerance
    D·ε·Σ|q||c|·|s| plus two roundings of the scale multiply."""
    ids = ids.long()
    ones = torch.ones(ids.shape, device=ids.device)
    if index._reorder_n:
        q, rows, scale = queries.to(torch.float32), index._corpus[ids], ones
        rows = rows.to(torch.float32)
    else:
        cap = index._leaf_rows.shape[1]
        slot = slot_of_rows(index._leaf_rows, index._num_candidates)[ids]
        leaf, s = slot // cap, slot % cap
        if index._quantize == "int4":
            half = cap // 2
            # Packed row s % half holds slots (s % half, s % half + half).
            pair = quantization.unpack_nibbles(
                index._leaf_embs[leaf, s % half][..., None, :])
            rows = torch.where((s >= half)[..., None], pair[..., 1, :],
                               pair[..., 0, :])
        else:
            rows = index._leaf_embs[leaf, s]
        rows = rows.to(torch.float32)
        scale = (ones if index._leaf_scales is None
                 else index._leaf_scales[leaf, s])
        q = scann_scored(index, queries)
    exact = (q[:, None, :] * rows).sum(-1) * scale
    tol = (DIM * F32_EPS * (q.abs()[:, None, :] * rows.abs()).sum(-1)
           * scale.abs() + 2 * F32_EPS * exact.abs())
    return exact, tol


def leaf_inputs(index, fmt: str):
    """(leaves, scales, packed4) of `index` as the kernel of `fmt` reads
    them; "f32" is the bf16 index's leaves cast to f32."""
    if fmt == "f32":
        return index._leaf_embs.to(torch.float32), None, False
    return index._leaf_embs, index._leaf_scales, index._quantize == "int4"


def gather_matmul(qt, leaves, scales, probes, packed4):
    """The gather + `torch.matmul` formulation of the same scores, for
    query tiles `qt [t, T, D]` and probes `[t, P]` (not one call: a
    gather, a cast and a batched matmul)."""
    emb = leaves[probes.long()]
    if packed4:
        emb = quantization.unpack_nibbles(emb)
    t, p, cap, d = emb.shape
    if scales is not None:
        out = torch.matmul(qt.to(torch.bfloat16), emb.to(torch.bfloat16)
                           .view(t, p * cap, d).transpose(1, 2))
        return out.float() * scales[probes.long()].view(t, 1, p * cap)
    return torch.matmul(qt.to(torch.float32), emb.to(torch.float32)
                        .view(t, p * cap, d).transpose(1, 2))


def gather_matmul_chunks(qt, leaves, scales, probes, packed4):
    """`gather_matmul` over all of `qt [t, T, D]`, in chunks of tiles whose
    gather and casts stay within GATHER_CHUNK_BYTES; returns the call."""
    t, num_probes = probes.shape
    elems = num_probes * leaves[0].numel() * (2 if packed4 else 1)
    stored = leaves.element_size() / (2 if packed4 else 1)
    per_tile = elems * (stored + (1 if packed4 else 0)
                        + (2 if scales is not None else 4))
    step = max(1, int(GATHER_CHUNK_BYTES // per_tile))
    return lambda: [gather_matmul(qt[i:i + step], leaves, scales,
                                  probes[i:i + step], packed4)
                    for i in range(0, t, step)]


def leaf_bytes(leaves, scales, cap: int, with_rows: bool) -> int:
    """Bytes of one stored leaf of `cap` slots: rows or codes, scales,
    and (K5) the slots' global rows."""
    per = leaves[0].numel() * leaves.element_size()
    if scales is not None:
        per += cap * 4
    if with_rows:
        per += cap * 4
    return per


def leaf_passes(fmt: str) -> int:
    """bf16 products per product: bf16 rows meet the f32 query as three
    exact bf16 terms (h + m + l); codes meet it rounded once."""
    return 3 if fmt == "bf16" else 1


def leaf_ops_ms(fmt: str, products: float) -> float:
    """Least time of `products` multiply-adds: f32 rows at the f32 peak
    (CUDA cores), the others' bf16 passes at the bf16 tensor-core peak."""
    if fmt == "f32":
        return 2.0 * products / PEAK_OPS_PER_S["f32"] * 1e3
    return 2.0 * leaf_passes(fmt) * products / PEAK_OPS_PER_S["bf16"] * 1e3


def leaf_bound_terms(fmt: str, bytes_ms: float, ops_ms: float) -> str:
    passes = ("f32" if fmt == "f32"
              else f"{leaf_passes(fmt)} bf16 pass(es)")
    return f"bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms ({passes})"


@dataclasses.dataclass(frozen=True)
class LeafCall:
    """K4's or K5's call on an index's leaves in one format for a served
    chunk, with the inputs the index's search gives the kernel; calling it
    runs the wrapper on `queries` and `probes`, or on other ones."""
    kernel: str                 # "K4" or "K5"
    leaves: torch.Tensor
    scales: torch.Tensor | None
    packed4: bool
    rows: torch.Tensor          # [L, cap] global row of each slot
    tile: int                   # K5: queries a probe tile
    buckets: int                # K5: buckets, clamped to cap
    queries: torch.Tensor       # K4: the chunk; K5: in tile order
    probes: torch.Tensor        # K4: [Q, P]; K5: [tiles, P]

    def __call__(self, queries=None, probes=None):
        q = self.queries if queries is None else queries
        p = self.probes if probes is None else probes
        if self.kernel == "K4":
            return leaf_scoring.probed_leaf_scores(
                q, self.leaves, self.scales, p, packed4=self.packed4)
        return leaf_scoring.probed_bucketed_scores(
            q, self.leaves, self.scales, self.rows, p, self.buckets,
            query_tile=self.tile, packed4=self.packed4)


def leaf_call(index, kernel: str, fmt: str, chunk) -> LeafCall:
    """`kernel`'s call in format `fmt` on `index`'s leaves for `chunk`
    [query_batch, D], its probes taken as the index's search takes them
    (K4: each query's top centroids; K5: `_tile_probes`)."""
    leaves, scales, packed4 = leaf_inputs(index, fmt)
    rows = index._leaf_rows
    with scoring._full_f32_matmul():
        cscores = chunk @ index._centroids.T
    tile, buckets = index._probe_tile, 0
    if kernel == "K4":
        queries = chunk
        probes = torch.topk(cscores, index._num_probes,
                            dim=1).indices.to(torch.int32)
    else:
        queries, probes, _ = approximate._tile_probes(
            chunk, cscores, index._num_probes, tile)
        buckets = min(index._scoring_buckets, rows.shape[1])
    return LeafCall(kernel, leaves, scales, packed4, rows, tile, buckets,
                    queries, probes)


def check_k4(index, fmt, chunk, launches, device) -> dict:
    """K4 of format `fmt` against its twin on `index`'s leaves, at the
    served chunk `chunk` [query_batch, D]; times and bound."""
    kernel = leaf_call(index, "K4", fmt, chunk)
    leaves, scales, packed4 = kernel.leaves, kernel.scales, kernel.packed4
    probes = kernel.probes
    cap = index._leaf_rows.shape[1]

    out = kernel()
    check(torch.equal(out, kernel()), f"K4 {fmt}: two launches differ")
    nq = min(K4_TWIN_QUERIES, chunk.shape[0])
    sub_q, sub_p = chunk[:nq], probes[:nq]

    def twin():
        return leaf_scoring.probed_scores_reference(sub_q, leaves, scales,
                                                    sub_p, packed4=packed4)

    want = twin()
    # |values| of the stored rows (the f32 leaves are the bf16 ones).
    abs_rows = leaf_rows_f32(index).abs()
    abs_dot = leaf_scoring.probed_scores_reference(
        scann_scored(index, sub_q).abs(), abs_rows, None, sub_p)
    del abs_rows
    tol = DIM * F32_EPS * abs_dot + 2 * F32_EPS * want.abs()
    err = (out[:nq] - want).abs()
    check(bool((err <= tol).all()),
          f"K4 {fmt}: scores off the twin by {float(err.max())}")
    qn, p = probes.shape
    ms = device_ms(kernel, device, iters=10)
    replay_ms = graph_ms(kernel, device, launches=10, replays=3)
    sub_ms = device_ms(lambda: kernel(sub_q, sub_p), device, iters=10)
    plain_ms = device_ms(twin, device, iters=3)
    gm_sub_ms = device_ms(lambda: gather_matmul(
        sub_q[:, None], leaves, scales, sub_p, packed4), device, iters=3)
    gm_ms = device_ms(gather_matmul_chunks(chunk[:, None], leaves, scales,
                                           probes, packed4), device, iters=2)
    unique = int(torch.unique(probes).numel())
    in_bytes = (unique * leaf_bytes(leaves, scales, cap, False)
                + chunk.numel() * 4 + probes.numel() * 4)
    bytes_ms = (in_bytes + out.nbytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = leaf_ops_ms(fmt, qn * p * cap * DIM)
    # JAX's cost estimate (`leaf_scoring.py:188-197`) reads the probed
    # leaf once per (query, probe); printed beside the bound, not a bound.
    jax_bytes = (qn * p * leaves[0].numel() * leaves.element_size()
                 + qn * DIM * 4 + qn * p * cap * 4)
    row = {
        "name": f"probed_leaf_scores[{fmt}]",
        "route": "cuda",
        "source": LEAF_SOURCE,
        "replaces": LEAF_REPLACES[("K4", fmt)],
        "launches": launches,
        "max_abs_err": float(err.max()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        # No single PyTorch call computes this function.
        "library_ms": None,
        # The f32 body runs by a direct call only.
        "on_main_path": fmt != "f32",
        "graph_ms": replay_ms,
        "gather_matmul_ms": gm_ms,
        "gather_matmul_subset_ms": gm_sub_ms,
        "subset_ms": sub_ms,
        "shape": f"Q={qn} P={p} cap={cap} D={DIM} L={leaves.shape[0]}"
                 f" ({unique} leaves probed); gather+matmul at full shape "
                 f"and on {nq} queries; twin and subset on {nq} queries",
    }
    print(f"  K4 {fmt}: max |err| {float(err.max()):.3g}, two launches "
          f"bit-identical; kernel {ms:.3f} ms a wrapper call at Q={qn} "
          f"({replay_ms:.3f} by graph replay), {sub_ms:.3f} ms at Q={nq}; "
          f"gather+matmul {gm_ms:.3f} ms at Q={qn}, {gm_sub_ms:.3f} "
          f"ms at Q={nq}; twin {plain_ms:.3f} ms at Q={nq}; bound "
          f"{row['bound_ms']:.4f} ms "
          f"({leaf_bound_terms(fmt, bytes_ms, ops_ms)}); JAX's cost "
          f"estimate counts {jax_bytes / 1e9:.4f} GB", flush=True)
    return row


def check_k5(index, fmt, chunk, launches, device) -> dict:
    """K5 of format `fmt` against its twin on `index`'s leaves, at the
    served chunk; rows equal wherever the twin's winner beats the
    bucket's best other row by more than twice the score bound."""
    kernel = leaf_call(index, "K5", fmt, chunk)
    leaves, scales, packed4 = kernel.leaves, kernel.scales, kernel.packed4
    rows_tbl, tile, buckets = kernel.rows, kernel.tile, kernel.buckets
    qs, probes = kernel.queries, kernel.probes
    cap = rows_tbl.shape[1]

    vals, rows = kernel()
    again = kernel()
    check(torch.equal(vals, again[0]) and torch.equal(rows, again[1]),
          f"K5 {fmt}: two launches differ")
    del again
    nt = min(K5_TWIN_TILES, probes.shape[0])
    sub_q, sub_p = qs[:nt * tile], probes[:nt]

    def twin():
        return leaf_scoring.probed_bucketed_reference(
            sub_q, leaves, scales, rows_tbl, sub_p, buckets, query_tile=tile,
            packed4=packed4)

    want_v, want_r = twin()
    cand, cand_rows = leaf_scoring.probed_bucket_candidates(
        sub_q, leaves, scales, rows_tbl, sub_p, buckets, tile, packed4)
    abs_rows = leaf_rows_f32(index).abs()
    abs_cand, _ = leaf_scoring.probed_bucket_candidates(
        scann_scored(index, sub_q).abs(), abs_rows, None, rows_tbl, sub_p,
        buckets, tile)
    del abs_rows
    best = cand.argmax(dim=1, keepdim=True)
    abs_dot = torch.gather(abs_cand, 1, best).squeeze(1).clamp(min=0)
    tol = DIM * F32_EPS * abs_dot + 2 * F32_EPS * want_v.abs()
    runner_up = cand.masked_fill(cand_rows == torch.gather(cand_rows, 1, best),
                                 leaf_scoring.MIN_FLOAT).amax(dim=1)
    del cand, cand_rows, abs_cand
    got_v, got_r = vals[:nt * tile], rows[:nt * tile]
    empty = want_v <= leaf_scoring.MIN_FLOAT
    err = (got_v - want_v).abs().masked_fill(empty, 0)
    check(bool((got_v[empty] == leaf_scoring.MIN_FLOAT).all()
               and (got_r[empty] == -1).all()),
          f"K5 {fmt}: an empty bucket is not MIN_FLOAT / -1")
    check(bool((err <= tol).all()),
          f"K5 {fmt}: scores off the twin by {float(err.max())}")
    separated = (want_v - runner_up > 2 * tol) & ~empty
    share = float(separated.sum()) / max(1, int((~empty).sum()))
    check(share >= 0.9, f"K5 {fmt}: only {share:.4f} of buckets separated")
    check(torch.equal(got_r[separated], want_r[separated]),
          f"K5 {fmt}: rows differ from the twin's in a separated bucket")
    qn = qs.shape[0]
    ms = device_ms(kernel, device, iters=10)
    replay_ms = graph_ms(kernel, device, launches=10, replays=3)
    sub_ms = device_ms(lambda: kernel(sub_q, sub_p), device, iters=10)
    plain_ms = device_ms(twin, device, iters=3)
    gm_sub_ms = device_ms(lambda: gather_matmul(
        sub_q.view(nt, tile, DIM), leaves, scales, sub_p, packed4),
        device, iters=3)
    gm_ms = device_ms(gather_matmul_chunks(
        qs.view(-1, tile, DIM), leaves, scales, probes, packed4),
        device, iters=2)
    # Least work: each tile scores each distinct probed leaf once.
    sp = torch.sort(probes.long(), dim=1).values
    pairs = int(probes.shape[0] + (sp[:, 1:] != sp[:, :-1]).sum())
    unique = int(torch.unique(probes).numel())
    in_bytes = (unique * leaf_bytes(leaves, scales, cap, True)
                + qs.numel() * 4 + probes.numel() * 4)
    bytes_ms = (in_bytes + vals.nbytes + rows.nbytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = leaf_ops_ms(fmt, tile * pairs * cap * DIM)
    tiles, p = probes.shape
    splits = leaf_scoring.bucketed_splits(
        tiles, tile, buckets, p,
        cuda_build.sm_count(device) if device.type == "cuda"
        else H100_SMS)
    # JAX's cost estimate (`leaf_scoring.py:439-449`): each tile reads each
    # of its probed leaves, duplicates too.
    jax_bytes = (tiles * p * (leaf_bytes(leaves, scales, cap, True))
                 + qn * DIM * 4 + 2 * qn * buckets * 4)
    row = {
        "name": f"probed_bucketed_scores[{fmt}]",
        "route": "cuda",
        "source": LEAF_SOURCE,
        "replaces": LEAF_REPLACES[("K5", fmt)],
        "launches": launches,
        "max_abs_err": float(err.max()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,
        "on_main_path": fmt != "f32",
        "graph_ms": replay_ms,
        "gather_matmul_ms": gm_ms,
        "gather_matmul_subset_ms": gm_sub_ms,
        "subset_ms": sub_ms,
        "shape": f"Q={qn} T={tile} P={p} cap={cap} B={buckets} D={DIM} "
                 f"L={leaves.shape[0]} ({pairs} distinct tile-leaf pairs); "
                 f"gather+matmul at full shape and on {nt} tiles; twin and "
                 f"subset on {nt} tiles",
    }
    print(f"  K5 {fmt}: max |err| {float(err.max()):.3g}, rows equal in "
          f"every separated bucket ({share:.4f} of all), two launches "
          f"bit-identical; kernel {ms:.3f} ms a wrapper call at Q={qn} "
          f"({replay_ms:.3f} by graph replay; {splits} splits), "
          f"{sub_ms:.3f} ms on {nt} tiles; gather+matmul {gm_ms:.3f} ms at "
          f"Q={qn}, {gm_sub_ms:.3f} ms on {nt} tiles; twin {plain_ms:.3f} "
          f"ms on {nt} tiles; bound {row['bound_ms']:.4f} ms "
          f"({leaf_bound_terms(fmt, bytes_ms, ops_ms)}); JAX's cost "
          f"estimate counts {jax_bytes / 1e9:.4f} GB", flush=True)
    return row


def path_parity(index, settings, queries, device) -> int:
    """Serves `queries` through the kernel path on `device` and through
    the twin path on a CPU copy of the index; returns the queries whose id
    sets differ beyond a tie within D·ε·‖q‖·max‖c‖."""
    card_s, card_i = index(queries)
    host = convert.scann_state_from_numpy(
        approximate.ScaNN(device="cpu", k=K, **settings),
        convert.scann_state_to_numpy(index))
    host_s, host_i = host(queries.cpu())
    card_s, card_i = card_s.cpu(), card_i.cpu()
    tol = (DIM * F32_EPS * queries.float().norm(dim=1).cpu()
           * max_row_norm(index))
    bad = 0
    for q in range(queries.shape[0]):
        if set(card_i[q].tolist()) == set(host_i[q].tolist()):
            continue
        diff = (card_s[q].sort().values - host_s[q].sort().values).abs()
        bad += int(bool((diff > tol[q]).any()))
    return bad


def scann(device: torch.device, size: ScannSize, seed: int) -> list:
    """Drives ScaNN probed serving on `device`; returns K4's and K5's
    report rows."""
    configs = scann_configs(size)
    started = time.perf_counter()
    corpus_np, requests_np = clustered_data(size, seed)
    corpus = torch.from_numpy(corpus_np).to(device)
    requests = [torch.from_numpy(r).to(device) for r in requests_np]
    del corpus_np, requests_np
    sync(device)
    phase("scann data", started, f"corpus {tuple(corpus.shape)}, "
          f"{size.requests} requests of {size.batch}")

    # 13. Build each index on the device.
    started = time.perf_counter()
    indexes, build_s = {}, {}
    for name, (settings, _, _) in configs.items():
        t = time.perf_counter()
        indexes[name] = approximate.ScaNN(k=K, device=device,
                                          **settings).index(corpus)
        sync(device)
        build_s[name] = time.perf_counter() - t
    phase("scann build", started, ", ".join(
        f"{name} {build_s[name]:.2f} s {index_bytes(index) / 1e6:.1f} MB"
        for name, index in indexes.items()))

    # 14. Serve; the main path's launch counts.
    tower = query_tower(size.users, seed, device)
    user_ids = torch.from_numpy(np.random.default_rng(seed + 4).integers(
        0, size.users, size.batch)).to(device)
    started = time.perf_counter()
    reset_leaf_counts()
    results, latency_ms, peak_mb = {}, {}, {}
    for name, index in indexes.items():
        if device.type == "cuda":
            sync(device)
            resident = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        results[name], latency_ms[name] = [], []
        for request in requests:
            t = time.perf_counter()
            results[name].append(index(request))
            sync(device)
            latency_ms[name].append((time.perf_counter() - t) * 1e3)
        if device.type == "cuda":
            peak_mb[name] = (torch.cuda.max_memory_allocated(device)
                             - resident) / 1e6
    main = indexes[MAIN_INDEX]
    excluded = results[MAIN_INDEX][0][1][:, 0:2 * EXCLUDED:2]
    _, excl_ids = main.query_with_exclusions(requests[0], excluded)
    composed = copy.copy(main)
    composed.query_fn = tower
    composed_s, composed_i = composed({"user_id": user_ids})
    sync(device)
    counts = {kernel: dict(fn.launches_by_format)
              for kernel, fn in KERNEL_FNS.items()}
    phase("scann serve", started, f"launches {counts}")
    for name in indexes:
        lat = sorted(latency_ms[name])
        print(f"  scann {name}: request ms "
              f"{[round(x, 3) for x in latency_ms[name]]} (median "
              f"{lat[len(lat) // 2]:.3f})"
              + (f", peak device memory above the resident "
                 f"{peak_mb[name]:.1f} MB" if name in peak_mb else ""))
    if device.type == "cuda":
        expected = {("K4", f): 0 for f in ("f32", "bf16", "int8", "int4")}
        expected.update({("K5", f): 0 for f in ("f32", "bf16", "int8",
                                                "int4")})
        for name, (settings, kernel, fmt) in configs.items():
            chunks = -(-size.batch // settings["query_batch"])
            expected[(kernel, fmt)] += size.requests * chunks + (
                2 if name == MAIN_INDEX else 0)
        for (kernel, fmt), want in expected.items():
            check(counts[kernel][fmt] == want,
                  f"{counts[kernel][fmt]} {kernel} {fmt} launches, "
                  f"expected {want}")
            if fmt != "f32":
                check(want > 0, f"{kernel} {fmt} is on no served path")

    # 15. The served results.
    started = time.perf_counter()
    for name, index in indexes.items():
        for q, (scores, ids) in zip(requests, results[name]):
            check(scores.shape == (size.batch, K)
                  and ids.shape == (size.batch, K),
                  f"{name}: result shapes {scores.shape}, {ids.shape}")
            check(bool(torch.isfinite(scores).all()),
                  f"{name}: non-finite scores")
            check(bool(((ids >= 0) & (ids < size.items)).all()),
                  f"{name}: ids outside the corpus")
            check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
                  f"{name}: scores not descending")
            sorted_ids = ids.sort(dim=1).values
            check(bool((sorted_ids[:, 1:] != sorted_ids[:, :-1]).all()),
                  f"{name}: an id repeats within a row")
            exact, tol = stored_scores(index, q, ids)
            check(bool(((scores - exact).abs() <= tol).all()),
                  f"{name}: returned scores are not the stored rows' "
                  f"scores of the returned ids")
    _, over_ids = main(requests[0], k=K + EXCLUDED)
    hit = (over_ids[:, :, None] == excluded[:, None, :]).any(-1)
    check(bool((hit.sum(1) == EXCLUDED).all()),
          "over-fetch lost an excluded id")
    kept = over_ids[~hit].view(size.batch, K)
    check(not bool((excl_ids[:, :, None] == excluded[:, None, :]).any()),
          "query_with_exclusions returned an excluded id")
    check(torch.equal(kept.sort(1).values, excl_ids.sort(1).values),
          "query_with_exclusions is not the over-fetch minus exclusions")
    check(composed_s.shape == (size.batch, K)
          and bool(torch.isfinite(composed_s).all())
          and bool(((composed_i >= 0) & (composed_i < size.items)).all()),
          "ScaNN(query_fn=query tower) gave bad results")
    phase("scann outputs", started,
          "shapes, stored scores, exclusions, query_fn")

    # 16. Each kernel format against its twin, and its times.
    started = time.perf_counter()
    report = []
    direct = {"K4": "bf16_gather", "K5": "bf16_bucketed"}
    for kernel, check_fn in (("K4", check_k4), ("K5", check_k5)):
        for fmt in ("f32", "bf16", "int8", "int4"):
            name = direct[kernel] if fmt == "f32" else next(
                n for n, (_, kn, f) in configs.items()
                if kn == kernel and f == fmt)
            qb = configs[name][0]["query_batch"]
            chunk = requests[0][:qb]
            report.append(check_fn(indexes[name], fmt, chunk,
                                   counts[kernel][fmt], device))
    phase("scann kernels", started, "K4 and K5, every format, held against "
          "their twins")

    # 17. Recall@100 against BruteForce; the kernel path against the twin
    # path.
    started = time.perf_counter()
    exact_ids = factorized_top_k.BruteForce(k=K, device=device).index(
        corpus)(requests[0])[1]
    floors = SCANN_RECALL_FLOORS if full_corpus(size) else {}
    for name, index in indexes.items():
        value = recall(results[name][0][1], exact_ids)
        floor = floors.get(name)
        near = near_share(index._leaf_rows, index._centroids, corpus,
                          index._spill_rounds)
        bad = path_parity(index, configs[name][0], requests[0][:PATH_QUERIES],
                          device)
        print(f"  recall@{K} {name}: {value:.4f}"
              + (f" (floor {floor})" if floor else "")
              + f"; rows in their {index._spill_rounds} nearest leaves "
                f"{near:.4f}; kernel path vs twin path on {PATH_QUERIES} "
                f"queries: {bad} differ beyond a tie", flush=True)
        if floor is not None:
            check(value >= floor,
                  f"recall@{K} of {name} is {value:.4f} < {floor}")
        check(bad == 0, f"{name}: {bad} queries differ between the kernel "
              f"path and the twin path")
    del indexes
    phase("scann recall", started)
    return report


# --- The trainer slice: stacked tables, Trainer.fit, corpus evaluation -----


@dataclasses.dataclass(frozen=True)
class StackSize:
    tables: int = 26              # benchmarks/multi_table.py:38
    min_rows: int = 2_000         # np.geomspace(2_000, 1_000_000, 26),
    max_rows: int = 1_000_000     # benchmarks/multi_table.py:64-68
    dim: int = 32                 # benchmarks/multi_table.py:39
    batch: int = 4096             # benchmarks/multi_table.py:28
    steps: int = 5
    sr_steps: int = 2


STACK_LR = 0.05                   # benchmarks/multi_table.py:80
K1_STACKED_ROW = "sorted_block_apply[adagrad f32, stacked]"


def stack_vocabs(size: StackSize) -> list:
    return [int(v) for v in np.geomspace(size.min_rows, size.max_rows,
                                         size.tables).round()]


def stack_engine(size: StackSize, device, stacked: bool,
                 dtype=torch.float32) -> emb_engine.EmbeddingEngine:
    """`benchmarks/multi_table.py`'s engine: 26 tables of width 32,
    adagrad at lr 0.05; f32 state, or bf16 tables and slots written with
    stochastic rounding."""
    fcs = tuple(
        emb_config.FeatureConfig(
            emb_config.TableConfig(v, size.dim, name=f"t{i:02d}"),
            name=f"f{i:02d}")
        for i, v in enumerate(stack_vocabs(size)))
    return emb_engine.EmbeddingEngine(
        fcs,
        optimizer=emb_config.OptimizerSpec(kind="adagrad",
                                           learning_rate=STACK_LR),
        dtype=dtype, slot_dtype=None if dtype == torch.float32 else dtype,
        stack_tables=stacked, device=device)


def stack_batches(size: StackSize, seed: int, count: int, device) -> list:
    """`count` steps of `batch` uniform ids a table, from NumPy."""
    rng = np.random.RandomState(seed)
    vocabs = stack_vocabs(size)
    return [{f"f{i:02d}": torch.from_numpy(
                 rng.randint(0, v, size.batch).astype(np.int32)).to(device)
             for i, v in enumerate(vocabs)}
            for _ in range(count)]


def stack_loss(acts):
    """`benchmarks/multi_table.py`'s `loss_of`: the features' first half
    (by name) summed, scored against the second half's sum, in-batch
    softmax. The sums are rounded to bf16 as there; the scores and the
    softmax are taken in float64 (the JAX file takes them in bf16), so
    the card and the CPU derive the same activation gradients up to
    their rounding to the tables' dtype, and a card-vs-CPU comparison
    reads the engine, not the order of a matmul's f32 sums."""
    names = sorted(acts)
    half = len(names) // 2
    q = sum(acts[n] for n in names[:half]).to(torch.bfloat16).double()
    c = sum(acts[n] for n in names[half:]).to(torch.bfloat16).double()
    return -torch.log_softmax(q @ c.T, dim=-1).diagonal().sum().float()


def tapped(loss_of, sink: list):
    """`loss_of`, appending each step's activation grads (by feature) to
    `sink`: the grads the engine's `update` then applies."""
    def loss(acts):
        grads = {}
        sink.append(grads)
        for name, act in acts.items():
            act.register_hook(lambda g, n=name: grads.__setitem__(n, g))
        return loss_of(acts)
    return loss


def stacked_k1_row(engine, state, batch, act_grads, device, name: str,
                   label: str, path_launches: dict) -> dict:
    """K1 at a stacked path's shape: the one update of the stacked
    storage from a step's ids and activation grads, as `update` hands it
    to the kernel (ids sorted stably, grads in their order). Kernel and
    twin must agree bit for bit; the row `name` carries the kernel's and
    twin's times, the bound and the path's launches (`path_launches`,
    the first entry's also as `launches`); its line starts with
    `label`."""
    row_name = name
    ((name, (ids, grads)),) = engine._storage_grads(batch, act_grads).items()
    spec = engine._spec(engine._tables[engine._storage_members[name][0]])
    slot_names, scalars, rule, _ = sparse_optimizer._kernel_rule(
        spec, state.step)
    ids, order = torch.sort(ids, stable=True)
    ids = ids.to(torch.int32)
    grads = grads[order].to(torch.float32).contiguous()
    states = [state.tables[name]] + [state.slots[name][s]
                                     for s in slot_names]
    got = [t.clone() for t in states]
    want = [t.clone() for t in states]
    on_device = scalars.to(device)
    sparse_apply.sorted_block_apply(got, ids, grads, rule, scalars=on_device)
    sparse_apply.sorted_block_apply_reference(want, ids, grads, rule,
                                              scalars=scalars)
    sync(device)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"K1 at the stacked shape: max |err| {err} from its twin")

    def kernel():
        sparse_apply.sorted_block_apply(got, ids, grads, rule,
                                        scalars=on_device)

    def twin():
        sparse_apply.sorted_block_apply_reference(want, ids, grads, rule,
                                                  scalars=scalars)

    v, d = states[0].shape
    row = {
        "name": row_name,
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": next(iter(path_launches.values())),
        "max_abs_err": err,
        "ms": graph_ms(kernel, device),
        "call_ms": device_ms(kernel, device, iters=50),
        "plain_ms": device_ms(twin, device, iters=5),
        "bound_ms": k1_bound_ms(states, ids),
        "bound_by": "bytes",
        # No single PyTorch call computes this function.
        "library_ms": None,
        "shape": f"V={v} D={d} n={ids.shape[0]} f32 table + f32 slot, "
                 f"{len(engine._storage_members[name])} tables stacked",
        "path_launches": dict(path_launches),
    }
    print(f"  {label}: bit-equal to its twin; kernel {row['ms']:.4f} ms "
          f"(graph replay), {row['call_ms']:.4f} ms a wrapper call, twin "
          f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['shape']})", flush=True)
    return row


def device_peak_mb(device) -> float:
    return (torch.cuda.max_memory_allocated(device) / 1e6
            if device.type == "cuda" else float("nan"))


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def stacked_engine(device: torch.device, size: StackSize, seed: int) -> list:
    """Drives the stacked and the unstacked engine from one `init`, and
    the stacked steps again through K1's twin; returns the report row of
    K1 at the stacked shape."""
    # 18. Five steps each: K1 once a step stacked, once a table unstacked;
    # the logical state bit-equal (f32), and equal to K1's twin's.
    started = time.perf_counter()
    engines = {form: stack_engine(size, device, form == "stacked")
               for form in ("stacked", "unstacked")}
    states = {form: engine.init(torch.Generator(device).manual_seed(seed))
              for form, engine in engines.items()}
    host_state = clone_state(states["stacked"], "cpu")
    rows = sum(engines["stacked"]._storage_rows.values())
    for name, table in engines["stacked"].logical_tables(
            states["stacked"]).items():
        check(torch.equal(table, engines["unstacked"].logical_tables(
            states["unstacked"])[name]), f"init of {name} differs stacked")
    batches = stack_batches(size, seed + 7, size.steps, device)
    launches, ms, peak, losses = {}, {}, {}, {}
    taps = {form: [] for form in engines}
    for form, engine in engines.items():
        state = states[form]
        loss_of = tapped(stack_loss, taps[form])
        sync(device)
        reset_peak(device)
        sparse_apply.sorted_block_apply.launches = 0
        got = []
        for i, batch in enumerate(batches):
            if i == 1:
                sync(device)
                t = time.perf_counter()
            state, loss, _ = engine.grad_and_update(state, batch, loss_of)
            got.append(loss)
        sync(device)
        ms[form] = (time.perf_counter() - t) * 1e3 / (size.steps - 1)
        launches[form] = sparse_apply.sorted_block_apply.launches
        peak[form] = device_peak_mb(device)
        losses[form] = torch.stack(got).cpu()
        states[form] = state
        check(bool(torch.isfinite(losses[form]).all()),
              f"non-finite {form} losses")
    check(torch.equal(losses["stacked"], losses["unstacked"]),
          f"losses {losses}")
    want = engines["unstacked"].logical_state(states["unstacked"])
    got = engines["stacked"].logical_state(states["stacked"])
    for name in want["tables"]:
        check(torch.equal(got["tables"][name], want["tables"][name]),
              f"table {name}: stacked != unstacked after {size.steps} steps")
        for slot, plane in want["slots"][name].items():
            check(torch.equal(got["slots"][name][slot], plane),
                  f"slot {name}/{slot}: stacked != unstacked")
    # The stacked steps through K1's twin: a CPU engine from the same
    # init, fed the same ids and the card's activation grads.
    host = stack_engine(size, "cpu", True)
    for batch, grads in zip(batches, taps["stacked"]):
        host_state = host.update(
            host_state, {k: v.cpu() for k, v in batch.items()},
            {k: g.cpu() for k, g in grads.items()})
    twin = host.logical_state(host_state)
    for name in twin["tables"]:
        check(torch.equal(got["tables"][name].cpu(), twin["tables"][name]),
              f"table {name}: stacked on {device} != K1's twin")
        for slot, plane in twin["slots"][name].items():
            check(torch.equal(got["slots"][name][slot].cpu(), plane),
                  f"slot {name}/{slot}: stacked on {device} != K1's twin")
    if device.type == "cuda":
        check(launches["stacked"] == size.steps,
              f"{launches['stacked']} K1 launches stacked, expected one a "
              "step")
        check(launches["unstacked"] == size.steps * size.tables,
              f"{launches['unstacked']} K1 launches unstacked, expected "
              "one a table a step")
    phase("stacked engine", started,
          f"{size.tables} tables, {rows} rows x {size.dim} f32, K1 "
          f"launches stacked {launches['stacked']}, unstacked "
          f"{launches['unstacked']}; logical state bit-equal, and to "
          "K1's twin's stacked")
    for form in engines:
        print(f"  {form}: {ms[form]:.3f} ms/step over steps 2-{size.steps} "
              f"({size.tables} x {size.batch} ids a step), peak device "
              f"memory {peak[form]:.1f} MB, losses "
              f"{[round(x, 4) for x in losses[form].tolist()]}", flush=True)
    row = stacked_k1_row(
        engines["stacked"], states["stacked"], batches[-1],
        taps["stacked"][-1], device, K1_STACKED_ROW, "K1 stacked",
        {"stacked engine, stacked": launches["stacked"],
         "stacked engine, unstacked": launches["unstacked"]})
    del engines, states, want, got, host, host_state, twin, taps

    # 19. bf16 tables and slots with stochastic rounding, stacked: the
    # card against the CPU, where K1's twin runs.
    started = time.perf_counter()
    card = stack_engine(size, device, True, torch.bfloat16)
    host = stack_engine(size, "cpu", True, torch.bfloat16)
    state = card.init(torch.Generator(device).manual_seed(seed + 1))
    start = clone_state(state)
    host_state = clone_state(state, "cpu")
    for batch in stack_batches(size, seed + 8, size.sr_steps, device):
        state, card_loss, _ = card.grad_and_update(state, batch, stack_loss)
        host_state, host_loss, _ = host.grad_and_update(
            host_state, {k: v.cpu() for k, v in batch.items()}, stack_loss)
        check(bool(torch.allclose(card_loss.cpu(), host_loss, rtol=1e-4,
                                  atol=0)),
              f"SR step loss {float(card_loss)} vs CPU {float(host_loss)}")
    ulps, eq = state_parity(state, host_state, start)
    check(parity_holds(False, ulps, eq),
          f"stacked bf16 + SR, card vs CPU: {ulps} ulps, {eq} bit-equal")
    phase("stacked sr parity", started,
          f"{size.sr_steps} steps, card vs CPU: {ulps:.2f} bf16 ulps, "
          f"bit-equal share {eq:.6f} over the changed rows")
    del card, host, state, start, host_state
    return [row]


@dataclasses.dataclass(frozen=True)
class TrainerSize:
    users: int = 65_536           # bench.py:67
    items: int = 131_072          # bench.py:68
    dim: int = 64                 # examples/quickstart.py:20-21
    batch: int = 4096             # examples/quickstart.py:16
    batches: int = 30             # one epoch
    eval_batches: int = 8
    parity_steps: int = 3
    traced_steps: int = 10


TRAINER_LR = 0.5                  # examples/quickstart.py:25
# Trainer parity, card against CPU over 3 steps from the same weights:
# losses to rtol 1e-4, and the parameters' gap (`param_gap`: the card's
# change against the CPU's, relative to it) under a limit a form's
# planted faults must exceed. Near random init the loss barely moves, so
# the gap is what reads a wrong gradient or update. Fused, the kernel
# rounds its backward's probability coefficients to bf16 and the twin
# keeps them f32, so the gap is larger there. On the H100 at seed 0 the
# card read 4.0e-7 (unfused) and 1.37e-3 (fused), the planted faults
# below 5.4e-3 (dc) and 1.06e-2 (lr) in both forms; each limit sits near
# the geometric mean of the card's reading and the nearer fault's
# (PERF.md, section 6).
TRAINER_GAP = {False: 5e-5, True: 2.7e-3}
# Faults planted on the CPU side: (label, learning-rate scale, scale of
# the candidate tower's output gradient, i.e. of dc).
TRAINER_FAULTS = (("lr 1 % high", 1.01, 1.0), ("dc 1 % high", 1.0, 1.01))
K2_ROWS = {name: f"fused_retrieval_{name}[bf16 scores]"
           for name in ("fwd", "dq", "dc")}


def trainer_model(size: TrainerSize, device, fused: bool, seed: int):
    """The quickstart's model: two `EmbeddingTower`s of width 64, random
    weights from `seed`; fused with bf16 scores, or unfused."""
    gen = torch.Generator(device).manual_seed(seed)
    return models.TwoTowerRetrieval(
        models.EmbeddingTower(size.users, size.dim, device=device,
                              generator=gen),
        models.EmbeddingTower(size.items, size.dim, device=device,
                              generator=gen),
        query_key="user_id", candidate_key="movie_id", fused=fused,
        score_dtype=torch.bfloat16 if fused else None)


def quickstart_adagrad(params, lr: float = TRAINER_LR):
    """`optax.adagrad(lr)`'s counterpart (0.5 in the quickstart):
    accumulators from 0.1 and no epsilon (optax's 1e-7 under the root
    moves an update by ≤ 5e-7)."""
    return torch.optim.Adagrad(params, lr=lr,
                               initial_accumulator_value=0.1, eps=0.0)


def scaled_grad(scale: float):
    """A forward hook that scales the gradient of its module's output."""
    def hook(module, args, out):
        if out.requires_grad:
            out.register_hook(lambda g: g * scale)
    return hook


def cpu_params(model: nn.Module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.named_parameters()}


def faulty_step(step, model: nn.Module, overstep=None):
    """Runs `step()` and returns what it returns. With `overstep` =
    (name prefix, scale), the parameters under the prefix then move
    `scale` times as far as the step moved them: a fault planted in one
    group, whatever optimizer rules it."""
    if overstep is None:
        return step()
    prefix, scale = overstep
    params = [p for n, p in model.named_parameters() if n.startswith(prefix)]
    before = [p.detach().clone() for p in params]
    out = step()
    with torch.no_grad():
        for p, b in zip(params, before):
            p.add_(p - b, alpha=scale - 1.0)
    return out


def trainer_steps(model, optimizer, batches: list, overstep=None):
    """`Trainer` steps from the model's weights, with a planted fault
    when `overstep` is given (`faulty_step`); returns (final weights on
    the CPU, losses)."""
    run = models.Trainer(model, optimizer)
    state, losses = run.init(), []
    for batch in batches:
        state, loss = faulty_step(lambda: run.train_step(state, batch),
                                  model, overstep)
        losses.append(float(loss))
    return cpu_params(model), losses


def parity_run(size: TrainerSize, device, fused: bool, start: dict,
               batches: list, lr_scale: float = 1.0,
               dc_scale: float = 1.0):
    """`len(batches)` `Trainer` steps from the weights `start`; returns
    (final parameters on the CPU, losses)."""
    model = trainer_model(size, device, fused, 0)
    model.load_state_dict(start)
    if dc_scale != 1.0:
        model.candidate_tower.register_forward_hook(scaled_grad(dc_scale))
    return trainer_steps(model, lambda params: quickstart_adagrad(
        params, TRAINER_LR * lr_scale), batches)


def param_gap(got: dict, want: dict, start: dict) -> float:
    """‖got − want‖ / ‖want − start‖ over every parameter, in float64:
    how far one run's change departs from another's, relative to it."""
    num = sum(float((got[k].double() - want[k].double()).square().sum())
              for k in want)
    den = sum(float((want[k].double() - start[k].double()).square().sum())
              for k in want)
    return (num / den) ** 0.5


def squared_gaps(a: dict, b: dict) -> dict:
    """‖a[k] − b[k]‖² for each parameter k of `b`: the difference in
    f32 (exact where the two lie within a factor 2 of each other), its
    squares summed in float64."""
    return {k: float(torch.sum(torch.square(a[k] - b[k]),
                               dtype=torch.float64)) for k in b}


def group_gaps(got: dict, want: dict, change: dict, groups: dict) -> dict:
    """`param_gap` over each group of `groups` (label → parameter name
    prefix) that holds parameters, and over every parameter (`"all"`);
    `change` is `squared_gaps(want, start)`."""
    diff = squared_gaps(got, want)
    out = {}
    for label, prefix in {**groups, "all": ""}.items():
        keys = [k for k in change if k.startswith(prefix)]
        if keys:
            out[label] = (sum(diff[k] for k in keys)
                          / sum(change[k] for k in keys)) ** 0.5
    return out


@contextlib.contextmanager
def relu_signs(model: nn.Module):
    """Yields a list to which each training forward of `model` appends,
    for each layer of its MLPs that a relu follows, the signs of the
    layer's outputs (on the CPU)."""
    sink, handles = [], []

    def hook(module, args, out):
        if torch.is_grad_enabled():
            sink.append((out > 0).cpu())

    for mlp in model.modules():
        if isinstance(mlp, blocks.MLP):
            last = len(mlp.layers) - 1
            for i, layer in enumerate(mlp.layers):
                act = mlp.final_activation if i == last else mlp.activation
                if act is F.relu:
                    handles.append(layer.register_forward_hook(hook))
    try:
        yield sink
    finally:
        for handle in handles:
            handle.remove()


def relu_flips(card: list, host: list) -> int:
    """Relu inputs whose sign the card and the CPU disagree on."""
    return sum(int((a != b).sum()) for a, b in zip(card, host))


def trainer_batches(size: TrainerSize, seed: int, count: int) -> list:
    """Host (NumPy) batches of uniform user and movie ids."""
    rng = np.random.RandomState(seed)
    return [{"user_id": rng.randint(0, size.users, size.batch).astype(
                np.int32),
             "movie_id": rng.randint(0, size.items, size.batch).astype(
                 np.int32)}
            for _ in range(count)]


def device_share(trace_path: Path):
    """(window ms, device busy ms, five longest device ops) of a Chrome
    trace: the window spans every complete event, host and device; busy
    is the union of the kernel intervals in it; ops are kernels summed by
    name as (name, total ms, count)."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    check(events, f"no events in {trace_path}")
    begin = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("cat") == "kernel")
    busy, covered = 0.0, begin
    for lo, hi in kernels:
        lo = max(lo, covered)
        if hi > lo:
            busy += hi - lo
            covered = hi
    totals = {}
    for e in events:
        if e.get("cat") == "kernel":
            total, count = totals.get(e["name"], (0.0, 0))
            totals[e["name"]] = (total + float(e["dur"]) / 1e3, count + 1)
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:5]
    return (end - begin) / 1e3, busy / 1e3, len(kernels), top


def traced_window(name: str, run, steps: int, device) -> None:
    """Runs `run()` (`steps` steps) under `utils.profiling.trace` into
    `build/<name>_trace/`, and prints the device's busy and idle shares
    of the window and the five longest device ops."""
    trace_dir = (Path(__file__).resolve().parent / "build"
                 / f"{name}_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profiling.trace(str(trace_dir)):
        run()
    (trace_path,) = trace_dir.glob("trace_*.json")
    window, busy, n, top = device_share(trace_path)
    if device.type == "cuda":
        check(n > 0, f"the {name} trace holds no kernel")
    print(f"  {name} traced window {window:.3f} ms ({window / steps:.3f} "
          f"ms/step under the profiler): {n} kernels, device busy "
          f"{busy:.3f} ms = {busy / window:.4f}, idle "
          f"{1 - busy / window:.4f}", flush=True)
    for op, (total, count) in top:
        print(f"  {name} device op {total:.3f} ms x{count}: {op[:100]}")


def trainer(device: torch.device, size: TrainerSize, seed: int) -> dict:
    """Drives `Trainer.fit` / `evaluate` unfused and fused; returns K2's
    launches on the fused fit."""
    # 20. One epoch each form, then evaluate.
    started = time.perf_counter()
    train_set = trainer_batches(size, seed + 11, size.batches)
    eval_set = trainer_batches(size, seed + 12, size.eval_batches)
    k2 = {}
    for fused in (False, True):
        form = "fused" if fused else "unfused"
        model = trainer_model(size, device, fused, seed)
        fit_trainer = models.Trainer(model, quickstart_adagrad)
        state = fit_trainer.init(torch.Generator(device).manual_seed(seed),
                                 train_set[0])
        # A warm-up pass over two batches: a kernel's first launch in the
        # process loads its module, which the timed epoch must not pay.
        state, _ = fit_trainer.fit(state, lambda: iter(train_set[:2]),
                                   verbose=False)
        sync(device)
        reset_peak(device)
        reset_train_counts()
        state, history = fit_trainer.fit(state, lambda: iter(train_set),
                                         verbose=False)
        sync(device)
        counts = dict(fused_retrieval.fused_retrieval_loss.launches_by_kernel)
        fit_peak = device_peak_mb(device)
        results = history["epochs"][0]
        evaluated = fit_trainer.evaluate(state, lambda: iter(eval_set))
        check(np.isfinite(results["loss"]) and np.isfinite(
            evaluated["total_loss"]), f"{form}: non-finite losses")
        print(f"  fit {form}: {size.batches} x {size.batch}, "
              f"{results['examples_per_sec']:.0f} examples/s, loss "
              f"{results['loss']:.4f}, total_loss {results['total_loss']:.4f}"
              + "".join(f", {k} {results[k]:.4f}" for k in sorted(results)
                        if k.startswith("batch_top"))
              + f", peak device memory {fit_peak:.1f} MB; K2 launches "
              f"{k2_text(counts)}", flush=True)
        print(f"  evaluate {form}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(evaluated.items())))
        if not fused:
            for k in (1, 10):
                check(f"batch_top_{k}_categorical_accuracy" in evaluated,
                      f"evaluate lacks batch top-{k} accuracy")
        if device.type == "cuda":
            check_k2_counts(f"{form} fit", counts,
                            size.batches if fused else 0, "bf16")
        if fused:
            k2 = counts
            fused_trainer, fused_state = fit_trainer, state
    phase("trainer", started, f"fit {size.batches} batches unfused and "
          f"fused, evaluate {size.eval_batches}")

    # 21. The card against the CPU from the same weights; the same limits
    # must reject faults planted on the CPU side.
    started = time.perf_counter()
    steps = trainer_batches(size, seed + 13, size.parity_steps)
    for fused in (False, True):
        form = "fused" if fused else "unfused"
        start = {k: v.detach().cpu().clone() for k, v in trainer_model(
            size, "cpu", fused, seed).state_dict().items()}
        card, card_losses = parity_run(size, device, fused, start, steps)
        host, host_losses = parity_run(size, "cpu", fused, start, steps)
        gaps = {"card": param_gap(card, host, start)}
        for label, lr_scale, dc_scale in TRAINER_FAULTS:
            gaps[label] = param_gap(parity_run(
                size, "cpu", fused, start, steps, lr_scale, dc_scale)[0],
                host, start)
        delta = max(float((card[k] - host[k]).abs().max()) for k in host)
        print(f"  parity {form}: losses "
              f"{[round(x, 5) for x in card_losses]} vs CPU "
              f"{[round(x, 5) for x in host_losses]}, largest parameter "
              f"|delta| {delta:.3g}; parameter gap (limit "
              f"{TRAINER_GAP[fused]:.3g}) " + ", ".join(
                  f"{k} {v:.4g}" for k, v in gaps.items()), flush=True)
        check(np.allclose(card_losses, host_losses, rtol=1e-4, atol=0),
              f"trainer losses {card_losses} vs CPU {host_losses}")
        check(gaps.pop("card") <= TRAINER_GAP[fused],
              f"{form} trainer parameters, card vs CPU: gap above "
              f"{TRAINER_GAP[fused]}")
        for label, gap in gaps.items():
            check(gap > TRAINER_GAP[fused],
                  f"the {form} trainer gap limit passes a planted fault "
                  f"({label}: {gap})")
    phase("trainer parity", started, f"{size.parity_steps} steps, card vs "
          f"CPU, unfused and fused, {len(TRAINER_FAULTS)} planted faults "
          "rejected")

    # 22. A trace of fused steps: the device's busy and idle shares.
    started = time.perf_counter()
    traced = trainer_batches(size, seed + 14, size.traced_steps)
    traced_window("trainer", lambda: fused_trainer.fit(
        fused_state, lambda: iter(traced), verbose=False), size.traced_steps,
        device)
    phase("trainer trace", started, f"{size.traced_steps} fused steps")
    return {K2_ROWS[name]: {"trainer, fused fit": k2.get((name, "bf16"), 0)}
            for name in K2_ROWS}


@dataclasses.dataclass(frozen=True)
class CorpusSize:
    users: int = 65_536           # the serving slice's query tower
    items: int = 1_000_000        # benchmarks/corpus_eval.py:177
    queries: int = 8192           # benchmarks/corpus_eval.py:180
    batch: int = 1024             # benchmarks/corpus_eval.py:181
    chunk: int = 1 << 17          # benchmarks/corpus_eval.py:182
    # The host-streamed corpus: corpus_eval.py's 10M host corpus cut to
    # the 1M corpus, as 8 pinned chunks of 131,072 rows.


CORPUS_KS = (1, 5, 10, 50, 100)
# Bucketed (K3, f32, B = 2048) may lose a true id that collides in its
# bucket with a higher one (recall ≈ 1 − (k−1)/2B ≈ 0.976 at k = 100).
BUCKETED_ACCURACY_MARGIN = 0.03


def corpus_eval(device: torch.device, size: CorpusSize, seed: int) -> dict:
    """Drives `FactorizedTopK` over four indexes through
    `make_corpus_eval_step`; returns K3's launches on the Bucketed eval."""
    # 23. Corpus-level evaluation of the serving model.
    started = time.perf_counter()
    model, _ = serving_model(Size(users=size.users, items=size.items), seed,
                             device)
    rng = np.random.RandomState(seed + 21)
    with torch.no_grad():
        corpus = model.candidate_embeddings(
            {"movie_id": torch.arange(size.items, device=device)})
        users = torch.from_numpy(rng.randint(
            0, size.users, size.queries).astype(np.int32)).to(device)
        brute = factorized_top_k.BruteForce(k=max(CORPUS_KS),
                                            device=device).index(corpus)
        top1 = torch.cat([
            brute(model.query_embeddings({"user_id": users[i:i + size.batch]}),
                  k=1)[1][:, 0]
            for i in range(0, size.queries, size.batch)])
    # True ids: every other query's BruteForce top-1 row, else a uniform
    # row, so the accuracies are neither all 0 nor all 1.
    true = torch.from_numpy(rng.randint(0, size.items, size.queries).astype(
        np.int32)).to(device)
    true[::2] = top1[::2].to(true.dtype)
    batches = [{"user_id": users[i:i + size.batch],
                "movie_id": true[i:i + size.batch]}
               for i in range(0, size.queries, size.batch)]
    host_chunks = [corpus[i:i + size.chunk].cpu()
                   for i in range(0, size.items, size.chunk)]
    if device.type == "cuda":
        host_chunks = [chunk.pin_memory() for chunk in host_chunks]
    indexes = {
        "BruteForce": brute,
        "Streaming.index": factorized_top_k.Streaming(
            k=max(CORPUS_KS), chunk_size=size.chunk,
            device=device).index(corpus),
        "Streaming.index_from_dataset": factorized_top_k.Streaming(
            k=max(CORPUS_KS), device=device).index_from_dataset(
                lambda: iter(host_chunks)),
        "Bucketed f32": factorized_top_k.Bucketed(
            k=max(CORPUS_KS), device=device, **BUCKETED["f32"]).index(corpus),
    }
    sync(device)
    results, states, qps, peak = {}, {}, {}, {}
    reset_counts()
    for name, index in indexes.items():
        metric = metrics.FactorizedTopK(index, ks=CORPUS_KS)
        step = models.make_corpus_eval_step(model, metric)
        mstate = metric.init()
        reset_peak(device)
        sync(device)
        t = time.perf_counter()
        for batch in batches:
            mstate = step(mstate, batch, corpus)
        sync(device)
        qps[name] = size.queries / (time.perf_counter() - t)
        peak[name] = device_peak_mb(device)
        states[name] = mstate
        results[name] = [float(v) for v in metric.result(mstate).values()]
    k3 = scoring.bucketed_scores.launches_by_format["f32"]
    if device.type == "cuda":
        check(k3 == len(batches), f"{k3} K3 launches in the Bucketed eval, "
              f"expected {len(batches)}")
    for name in indexes:
        print(f"  {name}: {qps[name]:.0f} queries/s, peak device memory "
              f"{peak[name]:.1f} MB, top-{list(CORPUS_KS)} accuracy "
              f"{[round(x, 5) for x in results[name]]}", flush=True)
    want = results["BruteForce"]
    check(0 < want[0] < 1, f"BruteForce accuracies {want}")
    for name in ("Streaming.index", "Streaming.index_from_dataset"):
        check(results[name] == want,
              f"{name} accuracies {results[name]} != BruteForce {want}")
    check(abs(results["Bucketed f32"][-1] - want[-1])
          <= BUCKETED_ACCURACY_MARGIN,
          f"Bucketed top-100 accuracy {results['Bucketed f32'][-1]} vs "
          f"{want[-1]}")
    with torch.no_grad():
        # The step's states against hits counted from BruteForce's ids.
        ids = torch.cat([brute(model.query_embeddings(batch))[1]
                         for batch in batches])
        hit = (ids == true[:, None].to(ids.dtype)).cumsum(dim=1) > 0
        for k in CORPUS_KS:
            hits = int(hit[:, k - 1].sum())
            state = states["BruteForce"][k]
            check(float(state["total"]) == hits
                  and float(state["count"]) == size.queries,
                  f"make_corpus_eval_step's top-{k} state {state} vs "
                  f"{hits} hits in {size.queries} BruteForce results")
        queries = model.query_embeddings(batches[0])
        want_ids = brute(queries)[1].sort(dim=1).values
        for name in ("Streaming.index", "Streaming.index_from_dataset"):
            got_ids = indexes[name](queries)[1].sort(dim=1).values
            check(torch.equal(got_ids.to(want_ids.dtype), want_ids),
                  f"{name}: top-100 id sets differ from BruteForce's")
    phase("corpus eval", started,
          f"{size.queries} queries over {size.items} x {DIM}, four indexes, "
          f"K3 launches {k3}")
    del indexes, host_chunks, corpus
    return {"bucketed_scores[f32]": {"corpus eval, Bucketed f32": k3}}


# --- The ranking slice: DLRM / DCN, HybridTrainer, Multitask, listwise ---


@dataclasses.dataclass(frozen=True)
class RankingSize:
    tables: int = 26              # benchmarks/multi_table.py:38, with its
    min_rows: int = 2_000         # np.geomspace(2_000, 1_000_000, 26)
    max_rows: int = 1_000_000     # vocabs (multi_table.py:64-68)
    dim: int = 16                 # the default bottom stack's last width
    dense: int = 13               # Criteo's dense features
    batch: int = 4096
    batches: int = 30             # an epoch of fit; hybrid steps a form
    # Epochs of the prebuilt Ranking fit: under Adagrad 0.05 one epoch of
    # 30 batches leaves the dot model's held-out AUC below the floor
    # (tried on the CPU at this batch with smaller tables); three clear
    # it on the card (PERF.md, section 6).
    epochs: int = 3
    warmup: int = 2
    eval_batches: int = 8
    parity_steps: int = 3
    users: int = 65_536           # bench.py:67 (the multitask model)
    items: int = 131_072          # bench.py:68
    tower_dim: int = 64           # phase 20's towers
    lists: int = 4096             # lists of 8 examples,
    list_size: int = 8            # examples/listwise_ranking.py:59


RANKING_FORMS = ("dot", "dcn")
RANKING_LR = 0.05                 # examples/prebuilt_dlrm.py:42-45
DENSE_LR = 1e-3                   # examples/prebuilt_dlrm.py:47
HYBRID_TABLE_LR = 0.1             # examples/hybrid_dlrm.py:64-80
HYBRID_HEAD_LR = 1e-2             # examples/hybrid_dlrm.py:82
MULTITASK_LR = 0.2                # examples/multitask.py:27
AUC_FLOOR = 0.6
# Card against CPU over 3 steps from one weight set: each parameter
# group's change on the card within its own gap (`group_gaps`) of the
# CPU's, a limit that a learning rate 1 % high, planted on the CPU side,
# must exceed in every group, as must an update 1 % too large confined
# to one dense group (`CONFINED_FAULT`) in that group. The gap comes
# from discrete events, not from smooth rounding: a relu input within
# rounding of 0 that takes the other branch on the card (`relu_flips`),
# and under Adam (DCN) a weight moved by ±lr where rounding sets its
# gradient's sign; so it moves with the draw. Each limit is the
# geometric mean of the largest card reading at seeds 0-2 and the
# smallest reading of a fault the group must catch, on the H100 (PERF.md,
# section 6): dot tables 6.95e-4 / 1.75e-2, bottom 1.16e-4 / 1.00e-2,
# top 4.18e-4 / 1.02e-2; DCN (26-28 flips at seeds 1-2) tables 3.89e-3 /
# 4.71e-2, bottom 1.28e-3 / 2.24e-2, interaction 2.10e-3 / 1.14e-2, top
# 1.63e-3 / 3.10e-2; hybrid head (from its trained state) bottom 1.28e-4
# / 1.00e-2, top 6.01e-4 / 1.19e-2; multitask (no flips) unfused query
# 4.12e-7 / 1.01e-2, candidate 3.93e-7 / 1.02e-2, rating 2.55e-7 /
# 6.38e-2, fused query 8.75e-7, candidate 8.80e-7, rating 2.54e-7.
RANKING_GROUPS = {"tables": "embedding.", "bottom": "bottom.",
                  "interaction": "interaction.", "top": "top."}
HYBRID_GROUPS = {"bottom": "bottom.", "top": "top."}
MULTITASK_GROUPS = {"query": "query_tower.", "candidate": "candidate_tower.",
                    "rating": "rating_head."}
CONFINED_FAULT = {"dot": "bottom", "dcn": "interaction", "hybrid": "bottom"}
RANKING_GAP = {
    "dot": {"tables": 3.5e-3, "bottom": 1.1e-3, "top": 2.1e-3},
    "dcn": {"tables": 1.4e-2, "bottom": 5.4e-3, "interaction": 4.9e-3,
            "top": 7.1e-3},
}
HYBRID_GAP = {"bottom": 1.1e-3, "top": 2.7e-3}
MULTITASK_GAP = {
    False: {"query": 6.4e-5, "candidate": 6.3e-5, "rating": 1.3e-4},
    True: {"query": 9.4e-5, "candidate": 9.5e-5, "rating": 1.3e-4},
}
FAULT_LR = 1.01
RANKING_TRACED_STEPS = 5
K1_DLRM_ROW = "sorted_block_apply[adagrad f32, DLRM]"
K2_F32_ROWS = {name: f"fused_retrieval_{name}[f32 scores]"
               for name in ("fwd", "dq", "dc")}
LISTWISE_LOSSES = ("softmax_listwise", "pairwise_logistic", "lambdarank",
                   "list_mle", "approx_ndcg")
LISTWISE_WEIGHTS = ("ndcg_lambda_weights", "dcg_lambda_weights")


def full_ranking(size: RankingSize) -> bool:
    """Whether the run trains as long as the full size: the AUC floor
    holds only there."""
    full = RankingSize()
    return (size.batch >= full.batch and size.batches >= full.batches
            and size.epochs >= full.epochs)


def unset_rows(generator, shape, dtype=torch.float32, device="cpu"):
    """A table initializer that draws nothing, for a model whose weights
    are loaded next."""
    return torch.empty(shape, dtype=dtype, device=device)


def criteo_configs(size: RankingSize, optimizer=None,
                   initializer=None) -> tuple:
    """26 sparse features `f00`..`f25` over tables `t00`..`t25` of
    `multi_table.py`'s vocabs, width 16."""
    return tuple(
        emb_config.FeatureConfig(
            emb_config.TableConfig(v, size.dim, name=f"t{i:02d}",
                                   optimizer=optimizer,
                                   initializer=initializer),
            name=f"f{i:02d}")
        for i, v in enumerate(stack_vocabs(size)))


def ctr_batches(size: RankingSize, seed: int, count: int) -> list:
    """Host (NumPy) click batches: 13 normal dense features, 26 uniform
    sparse ids, clicks drawn from a planted logit as
    `examples/prebuilt_dlrm.py:20-33` draws them (1.5 · dense 0, ± 0.5
    by the parity of the smallest table's id)."""
    rng = np.random.RandomState(seed)
    vocabs = stack_vocabs(size)
    out = []
    for _ in range(count):
        dense = rng.normal(size=(size.batch, size.dense)).astype(np.float32)
        batch = {f"f{i:02d}": rng.randint(0, v, size.batch).astype(np.int32)
                 for i, v in enumerate(vocabs)}
        logit = 1.5 * dense[:, 0] + ((batch["f00"] % 2) - 0.5)
        batch["dense_features"] = dense
        batch["clicked"] = (rng.uniform(size=size.batch)
                            < 1.0 / (1.0 + np.exp(-logit))).astype(
                                np.float32)
        out.append(batch)
    return out


def ranking_model(size: RankingSize, device, form: str, seed: int,
                  initializer=None):
    """`models.Ranking` at the reference's defaults (bottom (256, 64, 16)
    relu, top (512, 256, 1) sigmoid, `concat_dense`): the DLRM dot
    interaction (`skip_gather`), or `multi_layer_dcn_interaction()` over
    the concatenated features; tables drawn by `initializer` (the
    default's truncated normal when None)."""
    dot = form == "dot"
    return models.Ranking(
        criteo_configs(size, initializer=initializer), size.dense,
        feature_interaction=(ranking.default_interaction if dot
                             else ranking.multi_layer_dcn_interaction()),
        interaction_takes_list=dot, device=device,
        generator=torch.Generator(device).manual_seed(seed))


def ranking_optimizer(form: str, model, lr_scale: float = 1.0):
    """`optax.adagrad(0.05)`'s counterpart for the dot model; for DCN the
    production split (`examples/prebuilt_dlrm.py:43-49`): ClippyAdagrad
    0.05 on the embedding tables, Adam 1e-3 on the rest, routed by
    `embedding_param_labels`."""
    if form == "dot":
        return lambda params: quickstart_adagrad(params,
                                                 RANKING_LR * lr_scale)
    labels = ranking.embedding_param_labels(model)
    return optimizers.composite_optimizer(
        [(lambda p: optimizers.ClippyAdagrad(p, lr=RANKING_LR * lr_scale),
          lambda path: labels[".".join(path)] == "embedding"),
         (lambda p: torch.optim.Adam(p, lr=DENSE_LR * lr_scale),
          lambda path: True)],
        model.named_parameters())


def check_parity(label: str, card: tuple, host: tuple, faults: dict,
                 start: dict, groups: dict, limits: dict,
                 flips: int) -> None:
    """Card against CPU: losses to rtol 1e-4, and the change of each
    parameter group within its own limit (`group_gaps`, `limits` by
    group). `faults` maps each fault planted in a CPU run to (its final
    parameters, the groups it must be caught in): its gap must exceed
    the limit of each. Prints every gap by group, "all" beside them,
    and `flips` (`relu_flips` over the steps)."""
    (card_params, card_losses), (host_params, host_losses) = card, host
    change = squared_gaps(host_params, start)
    gaps = {"card": group_gaps(card_params, host_params, change, groups)}
    for name, (params, _) in faults.items():
        gaps[name] = group_gaps(params, host_params, change, groups)
    delta = max(float((card_params[k] - host_params[k]).abs().max())
                for k in host_params)
    print(f"  parity {label}: losses {[round(x, 5) for x in card_losses]} "
          f"vs CPU {[round(x, 5) for x in host_losses]}, largest parameter "
          f"|delta| {delta:.3g}, relu flips {flips}; parameter gap by group "
          "(limit): " + ", ".join(
              f"{g} {v:.4g}" + (f" ({limits[g]:.3g})" if g in limits else "")
              for g, v in gaps["card"].items()) + "; " + "; ".join(
              f"{name}: " + ", ".join(f"{g} {v:.4g}" for g, v in by.items())
              for name, by in gaps.items() if name != "card"), flush=True)
    check(np.allclose(card_losses, host_losses, rtol=1e-4, atol=0),
          f"{label}: losses {card_losses} vs CPU {host_losses}")
    for group, limit in limits.items():
        check(gaps["card"][group] <= limit,
              f"{label} {group} parameters, card vs CPU: gap "
              f"{gaps['card'][group]} above {limit}")
    for name, (_, caught) in faults.items():
        for group in caught:
            check(gaps[name][group] > limits[group],
                  f"the {label} {group} gap limit {limits[group]} passes a "
                  f"planted fault ({name}: {gaps[name][group]})")


def prebuilt_dlrm(device: torch.device, size: RankingSize, seed: int):
    """Phase 24: `Trainer.fit` / `evaluate` of the prebuilt Ranking
    model, dot and DCN."""
    # 24. Each form's epochs after a warm-up, then evaluate.
    started = time.perf_counter()
    warm = ctr_batches(size, seed + 31, size.warmup)
    train_set = ctr_batches(size, seed + 32, size.batches)
    eval_set = ctr_batches(size, seed + 33, size.eval_batches)
    for form in RANKING_FORMS:
        model = ranking_model(size, device, form, seed)
        fit_trainer = models.Trainer(model, ranking_optimizer(form, model))
        state = fit_trainer.init(torch.Generator(device).manual_seed(seed),
                                 warm[0])
        state, _ = fit_trainer.fit(state, lambda: iter(warm), verbose=False)
        sync(device)
        reset_peak(device)
        rates, aucs = [], []
        for _ in range(size.epochs):   # held-out AUC after each epoch
            state, history = fit_trainer.fit(
                state, lambda: iter(train_set), verbose=False)
            sync(device)
            rates.append(round(history["epochs"][0]["examples_per_sec"]))
            evaluated = fit_trainer.evaluate(state, lambda: iter(eval_set))
            aucs.append(round(evaluated["auc"], 4))
        peak = device_peak_mb(device)
        fit = history["epochs"][0]
        rows = sum(p.shape[0] for n, p in model.named_parameters()
                   if n.startswith("embedding."))
        print(f"  fit {form}: {size.epochs} x {size.batches} x "
              f"{size.batch}, examples/s by epoch {rates}, held-out auc by "
              f"epoch {aucs}, last epoch's loss {fit['loss']:.4f}, auc "
              f"{fit['auc']:.4f}; peak device memory {peak:.1f} MB ({rows} "
              f"table rows x {size.dim}); evaluate "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                  evaluated.items())), flush=True)
        check(np.isfinite(fit["loss"]) and np.isfinite(
            evaluated["total_loss"]), f"{form}: non-finite losses")
        traced = train_set[:RANKING_TRACED_STEPS]
        traced_window(f"ranking_{form}", lambda: fit_trainer.fit(
            state, lambda: iter(traced), verbose=False), len(traced), device)
        if full_ranking(size):
            check(evaluated["auc"] > AUC_FLOOR,
                  f"{form}: evaluated AUC {evaluated['auc']} <= {AUC_FLOOR}")
        del model, fit_trainer, state
    phase("prebuilt dlrm", started,
          f"fit {size.epochs} epochs of {size.batches} batches dot and DCN, "
          f"evaluate {size.eval_batches}")


def ranking_parity(device: torch.device, size: RankingSize, seed: int):
    """Phase 25: the prebuilt Ranking model, dot and DCN, 3 steps on
    the card against the CPU."""
    # 25. Card against CPU from one weight set, drawn on the card and
    # carried to the CPU model through `convert` (its own tables are
    # never drawn: 72.6M truncated normals take seconds on the host).
    started = time.perf_counter()
    host_s = 0.0
    steps = ctr_batches(size, seed + 34, size.parity_steps)
    for form in RANKING_FORMS:
        card = ranking_model(size, device, form, seed)
        host = ranking_model(size, "cpu", form, seed + 1, unset_rows)
        convert.load_flax_params(host, convert.to_flax_params(card))
        start = cpu_params(host)
        with relu_signs(card) as card_signs:
            card_run = trainer_steps(card, ranking_optimizer(form, card),
                                     steps)
        t = time.perf_counter()
        with relu_signs(host) as host_signs:
            host_run = trainer_steps(host, ranking_optimizer(form, host),
                                     steps)
        confined = CONFINED_FAULT[form]
        faults = {}
        for name, lr_scale, overstep, caught in (
                ("lr 1 % high", FAULT_LR, None, tuple(RANKING_GAP[form])),
                (f"{confined} 1 % overstep", 1.0,
                 (RANKING_GROUPS[confined], FAULT_LR), (confined,))):
            with torch.no_grad():
                for k, param in host.named_parameters():
                    param.copy_(start[k])
            faults[name] = (trainer_steps(
                host, ranking_optimizer(form, host, lr_scale), steps,
                overstep)[0], caught)
        host_s += time.perf_counter() - t
        check_parity(f"ranking {form}", card_run, host_run, faults, start,
                     RANKING_GROUPS, RANKING_GAP[form],
                     relu_flips(card_signs, host_signs))
        del host, card, card_run, host_run, faults, start
    phase("ranking parity", started,
          f"{size.parity_steps} steps, card vs CPU, dot and DCN, planted "
          f"faults rejected; the CPU's steps {host_s:.1f} s")


class DLRMHead(nn.Module):
    """The phase-24 DLRM stack over an engine's activations: bottom MLP
    over the dense features, dot interaction (`skip_gather`) over the 26
    activations and the dense embedding, `[dense, interaction]`, top MLP,
    BCE. Returns `(loss, predictions)`."""

    def __init__(self, size: RankingSize, device, seed: int):
        super().__init__()
        generator = torch.Generator(device).manual_seed(seed)
        self.names = [fc.name for fc in criteo_configs(size)]
        self.bottom = ranking.default_bottom_stack(size.dense, device,
                                                   generator)
        self.interaction = dot_interaction.DotInteraction(skip_gather=True)
        features = len(self.names) + 1
        self.top = ranking.default_top_stack(size.dim + features ** 2,
                                             device, generator)
        self.task = tasks.Ranking()

    def forward(self, batch, acts):
        dense = self.bottom(batch["dense_features"])
        x = self.interaction([acts[n] for n in self.names] + [dense])
        pred = torch.reshape(self.top(torch.cat([dense, x], dim=-1)), (-1,))
        out = self.task(batch["clicked"], pred)
        return out.loss, out.predictions


def hybrid_engine(size: RankingSize, device) -> emb_engine.EmbeddingEngine:
    """`examples/hybrid_dlrm.py:57-82`'s engine at the Criteo layout: the
    26 tables stacked, f32, adagrad at lr 0.1."""
    spec = emb_config.OptimizerSpec(kind="adagrad",
                                    learning_rate=HYBRID_TABLE_LR)
    return emb_engine.EmbeddingEngine(criteo_configs(size, spec),
                                      stack_tables=True, device=device)


def tap_activation_grads(sink: list):
    """A forward pre-hook for a hybrid head: appends each training
    step's activation grads (by feature) to `sink`, the grads the
    trainer hands the engine."""
    def hook(module, args):
        grads = {}
        acts = args[1]
        if any(a.requires_grad for a in acts.values()):
            sink.append(grads)
        for name, act in acts.items():
            if act.requires_grad:
                act.register_hook(lambda g, n=name: grads.__setitem__(n, g))
    return hook


def hybrid_adam(params):
    """`optax.adam(1e-2)` (`examples/hybrid_dlrm.py:82`)'s counterpart."""
    return torch.optim.Adam(params, lr=HYBRID_HEAD_LR)


def hybrid_steps(head, engine, engine_state, batches, pipelined: bool,
                 opt_state: dict, lr_scale: float = 1.0, overstep=None):
    """`HybridTrainer` steps (and `finalize`) from the head's weights,
    `engine_state` and Adam's `opt_state` (a `state_dict`), with Adam's
    lr scaled by `lr_scale` and a fault planted when `overstep` is given
    (`faulty_step`); returns (head weights on the CPU, engine state,
    losses)."""
    trainer = models.HybridTrainer(head, engine, hybrid_adam,
                                   pipelined=pipelined)
    state = trainer.init(engine_state=engine_state, optimizer_state=opt_state)
    for group in state.opt_state.param_groups:
        group["lr"] = HYBRID_HEAD_LR * lr_scale
    losses = []
    for batch in batches:
        state, loss, _ = faulty_step(
            lambda: trainer.train_step(state, batch), head, overstep)
        losses.append(float(loss))
    state = trainer.finalize(state)
    return cpu_params(head), state.engine_state, losses


def hybrid(device: torch.device, size: RankingSize, seed: int) -> dict:
    """Phase 26: `HybridTrainer` over the stacked engine, plain then
    pipelined; card against CPU; returns the K1 DLRM report row."""
    # 26. 30 steps plain, 30 pipelined + finalize: K1 once a step.
    started = time.perf_counter()
    engine = hybrid_engine(size, device)
    head = DLRMHead(size, device, seed)
    batches = ctr_batches(size, seed + 41, size.warmup + 2 * size.batches)
    warm = batches[:size.warmup]
    forms = {"plain": batches[size.warmup:size.warmup + size.batches],
             "pipelined": batches[size.warmup + size.batches:]}
    plain = models.HybridTrainer(head, engine, hybrid_adam)
    state = plain.init(torch.Generator(device).manual_seed(seed), warm[0])
    for batch in warm:
        state, _, _ = plain.train_step(state, batch)
    sync(device)
    reset_peak(device)
    launches, ms, losses = {}, {}, {}
    for form, form_batches in forms.items():
        # The state carries the optimizer on: `init` is not called again.
        trainer = models.HybridTrainer(head, engine, hybrid_adam,
                                       pipelined=form == "pipelined")
        sync(device)
        sparse_apply.sorted_block_apply.launches = 0
        t = time.perf_counter()
        got = []
        for batch in form_batches:
            state, loss, _ = trainer.train_step(state, batch)
            got.append(loss)
        state = trainer.finalize(state)
        sync(device)
        ms[form] = (time.perf_counter() - t) * 1e3 / len(form_batches)
        launches[form] = sparse_apply.sorted_block_apply.launches
        losses[form] = torch.stack(got).cpu()
        check(bool(torch.isfinite(losses[form]).all()),
              f"hybrid {form}: non-finite losses")
        if device.type == "cuda":
            check(launches[form] == len(form_batches),
                  f"hybrid {form}: {launches[form]} K1 launches in "
                  f"{len(form_batches)} steps, expected one a step")
    peak = device_peak_mb(device)
    storage = next(iter(engine._storage_rows.items()))
    phase("hybrid dlrm", started,
          f"{size.batches} steps plain and pipelined over {storage[1]} "
          f"stacked rows x {size.dim} f32, K1 launches {launches}")
    for form in forms:
        print(f"  hybrid {form}: {ms[form]:.3f} ms/step over "
              f"{size.batches} steps (finalize included), losses "
              f"{losses[form][0]:.4f} -> {losses[form][-1]:.4f}", flush=True)
    print(f"  hybrid peak device memory {peak:.1f} MB", flush=True)
    traced = batches[size.warmup:size.warmup + RANKING_TRACED_STEPS]

    def traced_steps():
        nonlocal state
        for batch in traced:
            state, _, _ = plain.train_step(state, batch)
        sync(device)

    traced_window("hybrid", traced_steps, len(traced), device)

    # Card against CPU from the trained state (head, Adam's moments,
    # engine): losses, the engine through K1's twin (a CPU engine fed the
    # card's ids and activation grads, bit for bit), each head group's
    # change within HYBRID_GAP, planted faults beyond it. From the
    # initial state Adam's first steps move every weight by ±lr, wherever
    # a gradient's sign is set by rounding too, and the runs part.
    started = time.perf_counter()
    steps = ctr_batches(size, seed + 42, size.parity_steps)
    host_engine = hybrid_engine(size, "cpu")
    engine_start = clone_state(state.engine_state)
    opt_start = copy.deepcopy(state.opt_state.state_dict())
    start = cpu_params(head)
    host_head = DLRMHead(size, "cpu", seed + 2)
    confined = CONFINED_FAULT["hybrid"]
    del plain, state
    for pipelined in (False, True):
        form = "pipelined" if pipelined else "plain"
        head.load_state_dict(start)
        taps = []
        hook = head.register_forward_pre_hook(tap_activation_grads(taps))
        with relu_signs(head) as card_signs:
            card_params, card_engine, card_losses = hybrid_steps(
                head, engine, clone_state(engine_start), steps, pipelined,
                opt_start)
        hook.remove()
        host_head.load_state_dict(start)
        with relu_signs(host_head) as host_signs:
            host_params, _, host_losses = hybrid_steps(
                host_head, host_engine, clone_state(engine_start, "cpu"),
                steps, pipelined, opt_start)
        faults = {}
        for name, lr_scale, overstep, caught in (
                ("lr 1 % high", FAULT_LR, None, tuple(HYBRID_GAP)),
                (f"{confined} 1 % overstep", 1.0,
                 (HYBRID_GROUPS[confined], FAULT_LR), (confined,))):
            host_head.load_state_dict(start)
            faults[name] = (hybrid_steps(
                host_head, host_engine, clone_state(engine_start, "cpu"),
                steps, pipelined, opt_start, lr_scale, overstep)[0], caught)
        check_parity(f"hybrid {form}", (card_params, card_losses),
                     (host_params, host_losses), faults, start,
                     HYBRID_GROUPS, HYBRID_GAP,
                     relu_flips(card_signs, host_signs))
        twin_state = clone_state(engine_start, "cpu")
        for batch, grads in zip(steps, taps):
            twin_state = host_engine.update(
                twin_state, {n: torch.from_numpy(batch[n])
                             for n in head.names},
                {k: g.cpu() for k, g in grads.items()})
        got = engine.logical_state(card_engine)
        want = host_engine.logical_state(twin_state)
        for name in want["tables"]:
            check(torch.equal(got["tables"][name].cpu(),
                              want["tables"][name]),
                  f"hybrid {form}: table {name} on {device} != K1's twin")
            for slot, plane in want["slots"][name].items():
                check(torch.equal(got["slots"][name][slot].cpu(), plane),
                      f"hybrid {form}: slot {name}/{slot} != K1's twin")
    phase("hybrid parity", started,
          f"{size.parity_steps} steps, card vs CPU, plain and pipelined; "
          "the engine bit-equal to K1's twin, planted faults rejected")
    row = stacked_k1_row(
        engine, card_engine,
        {n: torch.from_numpy(steps[-1][n]).to(device) for n in head.names},
        {k: g.to(device) for k, g in taps[-1].items()}, device,
        K1_DLRM_ROW, "K1 DLRM",
        {"hybrid DLRM, plain": launches["plain"],
         "hybrid DLRM, pipelined": launches["pipelined"]})
    del engine, host_engine, engine_start, card_engine, twin_state, opt_start
    return row


def multitask_model(size: RankingSize, device, fused: bool, seed: int):
    """`Multitask` at bench.py's vocab: two `EmbeddingTower`s of width 64
    and the tutorial's rating head (256, 128, 1)."""
    gen = torch.Generator(device).manual_seed(seed)
    return models.Multitask(
        models.EmbeddingTower(size.users, size.tower_dim, device=device,
                              generator=gen),
        models.EmbeddingTower(size.items, size.tower_dim, device=device,
                              generator=gen),
        fused=fused, generator=gen)


def multitask_adagrad(lr_scale: float = 1.0):
    """`optax.adagrad(0.2)` (`examples/multitask.py:27`)'s counterpart."""
    return lambda params: quickstart_adagrad(params,
                                             MULTITASK_LR * lr_scale)


def rating_batches(size: RankingSize, seed: int, count: int) -> list:
    """`trainer_batches` (uniform user and movie ids) with ratings 1-5."""
    rng = np.random.RandomState(seed + 1)
    return [dict(batch, user_rating=rng.randint(1, 6, size.batch).astype(
                np.float32))
            for batch in trainer_batches(size, seed, count)]


def multitask(device: torch.device, size: RankingSize, seed: int) -> dict:
    """Phase 27: `Multitask` fit unfused and fused (K2, f32 scores), then
    card against CPU; returns K2's launches on the fused fit."""
    # 27. One epoch each form after a warm-up.
    started = time.perf_counter()
    warm = rating_batches(size, seed + 61, size.warmup)
    train_set = rating_batches(size, seed + 62, size.batches)
    k2 = {}
    for fused in (False, True):
        form = "fused" if fused else "unfused"
        model = multitask_model(size, device, fused, seed)
        fit_trainer = models.Trainer(model, multitask_adagrad())
        state = fit_trainer.init(torch.Generator(device).manual_seed(seed),
                                 warm[0])
        state, _ = fit_trainer.fit(state, lambda: iter(warm), verbose=False)
        sync(device)
        reset_peak(device)
        reset_train_counts()
        state, history = fit_trainer.fit(state, lambda: iter(train_set),
                                         verbose=False)
        sync(device)
        counts = dict(fused_retrieval.fused_retrieval_loss.launches_by_kernel)
        fit = history["epochs"][0]
        print(f"  multitask {form}: {size.batches} x {size.batch}, "
              f"{fit['examples_per_sec']:.0f} examples/s, loss "
              f"{fit['loss']:.4f}, rating_rmse {fit['rating_rmse']:.4f}, "
              f"batch top-10 {fit['batch_top_10_categorical_accuracy']:.4f};"
              f" peak device memory {device_peak_mb(device):.1f} MB; K2 "
              f"launches {k2_text(counts)}", flush=True)
        check(np.isfinite(fit["loss"]), f"multitask {form}: non-finite loss")
        if device.type == "cuda":
            check_k2_counts(f"multitask {form} fit", counts,
                            size.batches if fused else 0, "f32")
        if fused:
            k2 = counts
        traced = train_set[:RANKING_TRACED_STEPS]
        traced_window(f"multitask_{form}", lambda: fit_trainer.fit(
            state, lambda: iter(traced), verbose=False), len(traced), device)
        del model, fit_trainer, state
    phase("multitask", started, f"fit {size.batches} batches unfused and "
          "fused, each traced")

    # Card against CPU from one weight set (through `convert`).
    started = time.perf_counter()
    steps = rating_batches(size, seed + 63, size.parity_steps)
    for fused in (False, True):
        form = "fused" if fused else "unfused"
        host = multitask_model(size, "cpu", fused, seed)
        start = cpu_params(host)
        card = multitask_model(size, device, fused, seed + 1)
        convert.load_flax_params(card, convert.to_flax_params(host))
        with relu_signs(card) as card_signs:
            card_run = trainer_steps(card, multitask_adagrad(), steps)
        with relu_signs(host) as host_signs:
            host_run = trainer_steps(host, multitask_adagrad(), steps)
        with torch.no_grad():
            for name, param in host.named_parameters():
                param.copy_(start[name])
        fault, _ = trainer_steps(host, multitask_adagrad(FAULT_LR), steps)
        check_parity(f"multitask {form}", card_run, host_run,
                     {"lr 1 % high": (fault, tuple(MULTITASK_GAP[fused]))},
                     start, MULTITASK_GROUPS, MULTITASK_GAP[fused],
                     relu_flips(card_signs, host_signs))
    phase("multitask parity", started,
          f"{size.parity_steps} steps, card vs CPU, unfused and fused, a "
          "planted fault rejected")
    return {K2_F32_ROWS[name]: {"multitask, fused fit": k2.get((name, "f32"),
                                                               0)}
            for name in K2_F32_ROWS}


def listwise_values(name: str, labels, scores, mask, weight):
    """(value, score grads or None) of one listwise function."""
    fn = getattr(listwise, name)
    if name in LISTWISE_WEIGHTS:
        return fn(labels, scores, mask=mask), None
    scores = scores.detach().clone().requires_grad_(True)
    value = fn(labels, scores, sample_weight=weight, mask=mask)
    value.backward()
    return value.detach(), scores.grad


def listwise_losses(device: torch.device, size: RankingSize, seed: int):
    """Phase 28: every listwise function on `[lists, 8]` lists, half of
    them ragged by `mask`, card against CPU."""
    # 28. Values and score grads to |d| <= 1e-5 |want| + 1e-6 max|want|
    # (values) and 1e-4 |want| + 1e-5 max|want| (grads): the same f32
    # operations, reductions and exp / log in other orders and ulps.
    started = time.perf_counter()
    rng = np.random.RandomState(seed + 71)
    shape = (size.lists, size.list_size)
    labels = rng.randint(0, 5, shape).astype(np.float32)
    scores = rng.randn(*shape).astype(np.float32)
    lengths = rng.randint(2, size.list_size + 1, size.lists)
    lengths[::2] = size.list_size
    mask = np.arange(size.list_size)[None, :] < lengths[:, None]
    weight = (rng.rand(size.lists) + 0.5).astype(np.float32)
    inputs = [torch.from_numpy(x) for x in (labels, scores, mask, weight)]
    errs = {}
    for name in LISTWISE_LOSSES + LISTWISE_WEIGHTS:
        got = listwise_values(name, *(x.to(device) for x in inputs))
        want = listwise_values(name, *inputs)
        errs[name] = []
        for g, w, rtol, scale in zip(got, want, (1e-5, 1e-4), (1e-6, 1e-5)):
            if w is None:
                continue
            g = g.cpu()
            check(bool(torch.isfinite(g).all()), f"{name}: not finite")
            err = (g - w).abs()
            tol = rtol * w.abs() + scale * float(w.abs().max())
            check(bool((err <= tol).all()),
                  f"{name}: max |err| {float(err.max())} card vs CPU")
            errs[name].append(float(err.max()))
    phase("listwise", started, f"{len(errs)} functions on "
          f"{size.lists} x {size.list_size} lists, card vs CPU")
    print("  listwise max |err| (value, grads): " + ", ".join(
        f"{k} {'/'.join(f'{e:.3g}' for e in v)}" for k, v in errs.items()))


def ranking_slice(device: torch.device, size: RankingSize,
                  seed: int) -> tuple:
    """Phases 24-28; returns (the K1 DLRM report row, launches by path
    of the K2 f32 rows)."""
    prebuilt_dlrm(device, size, seed)
    ranking_parity(device, size, seed)
    row = hybrid(device, size, seed)
    k2 = multitask(device, size, seed)
    listwise_losses(device, size, seed)
    return row, k2


# --- The data slice: the user journey, featurization, quality parity -------


@dataclasses.dataclass(frozen=True)
class PipelineSize:
    users: int = 6_040            # MovieLens-1M's published size
    movies: int = 3_706
    ratings: int = 1_000_209
    dim: int = 64                 # examples/full_pipeline.py:47-50
    batch: int = 4096             # examples/full_pipeline.py:55
    threads: int = 4
    resume_steps: int = 5         # tests/test_checkpoint.py:73-88
    top: int = 5


PIPELINE_LR = 0.5                 # examples/full_pipeline.py:53
PIPELINE_KS = (10, 100)           # examples/full_pipeline.py:67


class PaddedBucketed(factorized_top_k.Bucketed):
    """Bucketed over embeddings zero-padded to a multiple of 128 wide
    (K3's widths): zero columns leave every score as it was."""

    def __init__(self, **kwargs):
        super().__init__(query_fn=self.pad, **kwargs)

    @staticmethod
    def pad(x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (0, -x.shape[1] % 128))

    def index(self, candidates, identifiers=None):
        return super().index(self.pad(candidates), identifiers)


def write_ratings_dat(path: Path, ds) -> None:
    """The dataset as an ML-1M `ratings.dat` (`user::item::rating::time`,
    1-based ids)."""
    table = np.stack([ds.user_ids.astype(np.int64) + 1,
                      ds.movie_ids.astype(np.int64) + 1,
                      ds.ratings.astype(np.int64), ds.timestamps], axis=1)
    np.savetxt(path, table, fmt="%d", delimiter="::")


def pipeline_model(size: PipelineSize, users: int, movies: int, device,
                   seed: int):
    """`examples/full_pipeline.py`'s towers of width 64, fused (K2, bf16
    scores)."""
    gen = torch.Generator(device).manual_seed(seed)
    return models.TwoTowerRetrieval(
        models.EmbeddingTower(users, size.dim, device=device, generator=gen),
        models.EmbeddingTower(movies, size.dim, device=device, generator=gen),
        fused=True, score_dtype=torch.bfloat16)


def train_tensors(state) -> dict:
    """The parameters and the optimizer's state tensors, on the CPU."""
    out = {k: v.detach().cpu().clone() for k, v in state.params.items()}
    for i, slots in state.opt_state.state_dict()["state"].items():
        for k, v in slots.items():
            if isinstance(v, torch.Tensor):
                out[f"opt/{i}/{k}"] = v.detach().cpu().clone()
    return out


def same_tensors(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def pipeline(device: torch.device, size: PipelineSize, seed: int) -> dict:
    """Phase 29: raw ids → vocabularies → `NativeBatcher` → fused
    `Trainer.fit` → corpus eval (BruteForce, Bucketed f32) → checkpoint
    and bit-exact resume → decoded top movies; returns K2's and K3's
    launches on the path."""
    # 29. The README's user journey at MovieLens-1M's size.
    started = time.perf_counter()
    ds = data.synthetic_movielens(num_users=size.users,
                                  num_movies=size.movies,
                                  num_interactions=size.ratings, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ratings.dat"
        t = time.perf_counter()
        write_ratings_dat(path, ds)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = data.load_movielens(str(path), size.users, size.movies)
        read_s = time.perf_counter() - t
    for name in ("user_ids", "movie_ids", "ratings", "timestamps"):
        check(np.array_equal(getattr(loaded, name), getattr(ds, name)),
              f"ratings.dat read back: {name} differ")
    raw = {"user": np.char.add("user_", loaded.user_ids.astype(str)),
           "movie": np.char.add("movie_", loaded.movie_ids.astype(str))}
    t = time.perf_counter()
    user_vocab = vocab.build_vocabulary(raw["user"])
    movie_vocab = vocab.build_vocabulary(raw["movie"])
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    encoded = data.SyntheticMovieLens(
        user_ids=user_vocab.encode(raw["user"]),
        movie_ids=movie_vocab.encode(raw["movie"]),
        ratings=loaded.ratings, timestamps=loaded.timestamps,
        num_users=user_vocab.size, num_movies=movie_vocab.size)
    encode_s = time.perf_counter() - t
    check(int(encoded.user_ids.min()) >= 1
          and int(encoded.movie_ids.min()) >= 1, "an id encoded as OOV")
    train_split, test_split = encoded.split(0.8, seed=17)
    train_set = {k: train_split.as_dict()[k] for k in ("user_id",
                                                       "movie_id")}
    test_set = {k: test_split.as_dict()[k] for k in ("user_id", "movie_id")}
    print(f"  pipeline data: {size.ratings} ratings written as ratings.dat "
          f"in {write_s:.3f} s, read back equal in {read_s:.3f} s; "
          f"vocabularies {user_vocab.size} users, {movie_vocab.size} movies "
          f"built in {build_s:.3f} s, encoded in {encode_s:.3f} s "
          f"(vocab {build_s + encode_s:.3f} s)", flush=True)

    check(data.native_available(), "the native batcher did not build: "
          f"{native_loader._build_error}")
    batcher = data.NativeBatcher(train_set, size.batch, shuffle=True,
                                 seed=seed, drop_remainder=True,
                                 num_threads=size.threads)
    t = time.perf_counter()
    rows = sum(b["user_id"].shape[0] for b in batcher())
    native_rows = rows / (time.perf_counter() - t)
    batches = len(train_set["user_id"]) // size.batch
    check(rows == batches * size.batch, f"NativeBatcher gave {rows} rows")
    model = pipeline_model(size, user_vocab.size, movie_vocab.size, device,
                           seed)
    fit_trainer = models.Trainer(
        model, lambda p: quickstart_adagrad(p, PIPELINE_LR))
    state = fit_trainer.init(torch.Generator(device).manual_seed(seed),
                             next(iter(batcher())))
    sync(device)
    reset_train_counts()
    state, history = fit_trainer.fit(state, batcher, verbose=False)
    sync(device)
    k2 = dict(fused_retrieval.fused_retrieval_loss.launches_by_kernel)
    fit = history["epochs"][0]
    check(np.isfinite(fit["loss"]), "pipeline fit: non-finite loss")
    if device.type == "cuda":
        check_k2_counts("pipeline fit", k2, batches, "bf16")
    print(f"  pipeline fit: native batcher {native_rows:.0f} rows/s alone "
          f"({size.threads} threads); {batches} x {size.batch}, "
          f"{fit['examples_per_sec']:.0f} examples/s, loss "
          f"{fit['loss']:.4f}; K2 launches {k2_text(k2)}", flush=True)

    candidates = {"movie_id": np.arange(movie_vocab.size, dtype=np.int32)}
    eval_batches = data.batched(test_set, size.batch)
    evals, qps = {}, {}
    factories = {
        "BruteForce": None,
        "Bucketed f32": lambda: PaddedBucketed(
            k=max(PIPELINE_KS), device=device, **BUCKETED["f32"]),
    }
    queries = (len(test_set["user_id"]) // size.batch) * size.batch
    warm = [next(eval_batches())]
    for name, factory in factories.items():
        # One batch through the index first, off the clock and the
        # counts: the rate is the warm one, whatever ran before.
        retrieval.evaluate_with_corpus_metrics(
            fit_trainer, state, warm, candidates, ks=PIPELINE_KS,
            index_factory=factory)
        reset_counts()
        sync(device)
        t = time.perf_counter()
        evals[name] = retrieval.evaluate_with_corpus_metrics(
            fit_trainer, state, eval_batches, candidates, ks=PIPELINE_KS,
            index_factory=factory)
        sync(device)
        qps[name] = queries / (time.perf_counter() - t)
    k3 = scoring.bucketed_scores.launches_by_format["f32"]
    if device.type == "cuda":
        check(k3 == queries // size.batch, f"{k3} K3 launches in the "
              f"pipeline's Bucketed eval, expected {queries // size.batch}")
    want = list(evals["BruteForce"].values())
    got = list(evals["Bucketed f32"].values())
    check(0 < want[0] <= want[1] < 1, f"pipeline accuracies {want}")
    check(abs(got[1] - want[1]) <= BUCKETED_ACCURACY_MARGIN,
          f"pipeline Bucketed top-100 {got[1]} vs BruteForce {want[1]}")
    for name in factories:
        print(f"  pipeline eval {name}: {qps[name]:.0f} queries/s, top-"
              f"{list(PIPELINE_KS)} accuracy "
              f"{[round(v, 5) for v in evals[name].values()]}", flush=True)

    # Checkpoint on the card, then resume: 5 steps from the restored
    # state must equal 5 steps from the state that was never saved.
    steps = list(data.batched(train_set, size.batch, shuffle=True,
                              seed=seed + 1)())[:size.resume_steps]
    with tempfile.TemporaryDirectory() as tmp:
        manager = checkpoint.CheckpointManager(tmp)
        sync(device)
        t = time.perf_counter()
        manager.save(state.step, state)
        save_s = time.perf_counter() - t
        saved = train_tensors(state)
        megabytes = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                        if f.is_file()) / 1e6
        losses_a = []
        for batch in steps:
            state, loss = fit_trainer.train_step(state, batch)
            losses_a.append(float(loss))
        continued = train_tensors(state)
        sync(device)
        t = time.perf_counter()
        state = manager.restore(template=state)
        sync(device)
        restore_s = time.perf_counter() - t
        check(same_tensors(train_tensors(state), saved),
              "the restored state differs from the saved one")
        losses_b = []
        for batch in steps:
            state, loss = fit_trainer.train_step(state, batch)
            losses_b.append(float(loss))
        check(losses_a == losses_b, f"resumed losses {losses_b} differ "
              f"from the uninterrupted run's {losses_a}")
        check(same_tensors(train_tensors(state), continued),
              "the resumed state differs from the uninterrupted run's")
        host_model = pipeline_model(size, user_vocab.size, movie_vocab.size,
                                    "cpu", seed + 1)
        host_trainer = models.Trainer(
            host_model, lambda p: quickstart_adagrad(p, PIPELINE_LR))
        host_state = host_trainer.init(torch.Generator().manual_seed(seed))
        host_state = checkpoint.restore(str(Path(tmp) / str(
            manager.latest_step())), host_state)
        check(same_tensors(train_tensors(host_state), saved),
              "the card's checkpoint restored on the CPU differs")
    print(f"  pipeline checkpoint: {megabytes:.3f} MB, save {save_s:.3f} s, "
          f"restore {restore_s:.3f} s; {size.resume_steps} resumed steps "
          f"bit-equal (losses {[round(x, 5) for x in losses_b]}); restored "
          "on the CPU equal", flush=True)

    user = raw["user"][0]
    with torch.no_grad():
        model.eval()
        corpus = model.candidate_embeddings(
            {"movie_id": torch.arange(movie_vocab.size, device=device)})
        index = factorized_top_k.BruteForce(k=size.top, device=device)
        index.index(corpus)
        query = model.query_embeddings({"user_id": torch.from_numpy(
            user_vocab.encode(np.asarray([user]))).to(device)})
        _, ids = index(query)
    movies = [str(m) for m in movie_vocab.decode(ids[0].cpu().numpy())]
    check(len(movies) == size.top and all(
        m.startswith("movie_") or m == "[OOV]" for m in movies),
        f"decoded recommendations {movies}")
    phase("pipeline", started, f"{size.ratings} ratings, fit {batches} "
          f"batches fused, "
          f"eval over BruteForce and Bucketed f32 (K3 {k3}), checkpoint; "
          f"top {size.top} for {user}: {movies}")
    return {
        **{K2_ROWS[name]: {"pipeline, fused fit": k2.get((name, "bf16"), 0)}
           for name in K2_ROWS},
        "bucketed_scores[f32]": {"pipeline eval, Bucketed f32": k3},
    }


@dataclasses.dataclass(frozen=True)
class FeaturizationSize:
    interactions: int = 100_000   # examples/featurization.py:103
    batch: int = 8192             # examples/featurization.py:146
    # Under the example's Adagrad 0.3 the loss grows from step 2 on, in
    # the JAX example too, and amplifies rounding: over 5 steps the port
    # parts from JAX on the CPU by up to 4.1e-4 relative
    # (tests/test_torch_featurization.py), and from the CPU on the card
    # as `--featurization-drift 5` prints (PERF.md, section 6). The
    # first 3 steps stay within the 1e-4 limit in both.
    steps: int = 3
    bins: int = 100               # examples/featurization.py:110
    max_tokens: int = 64          # examples/featurization.py:112
    hash_bins: int = 2048         # examples/featurization.py:139


FEATURIZATION_LR = 0.3            # examples/featurization.py:145
TITLE_WORDS = (
    "star galaxy night return empire dark knight lost city of the "
    "last great secret garden river king queen storm golden shadow "
    "summer winter dream stone fire ice crown legend journey"
).split()                         # examples/featurization.py:32-36


def synthetic_titles(num_movies: int) -> list:
    """`examples/featurization.py::synthetic_titles`: 2-4 word titles."""
    rng = np.random.RandomState(99)
    titles = []
    for _ in range(num_movies):
        words = rng.choice(TITLE_WORDS, size=rng.randint(2, 5),
                           replace=False)
        titles.append(" ".join(words).title() + "!")
    return titles


class FeaturizedQuery(nn.Module):
    """User id + the timestamp normalized and discretized on the device
    (`examples/featurization.py::QueryTower`)."""

    def __init__(self, num_users, normalizer, discretizer, device, gen,
                 dim: int = 32):
        super().__init__()
        self.normalizer, self.discretizer = normalizer, discretizer
        self.user = nn.Embedding(num_users, dim, device=device)
        self.time = nn.Embedding(discretizer.num_bins, dim // 2,
                                 device=device)
        self.mlp = blocks.MLP(dim + dim // 2 + 1, (64, dim), device=device)
        with torch.no_grad():
            self.user.weight.normal_(0.0, dim ** -0.5, generator=gen)
            self.time.weight.normal_(0.0, (dim // 2) ** -0.5, generator=gen)
        self.mlp.reset_parameters(gen)

    def forward(self, inputs):
        ts = inputs["timestamp"]
        return self.mlp(torch.cat([
            self.user(inputs["user_id"]), self.time(self.discretizer(ts)),
            self.normalizer(ts)[:, None]], dim=-1))


class FeaturizedCandidate(nn.Module):
    """Hashed movie id + mean-pooled title tokens
    (`examples/featurization.py::CandidateTower`)."""

    def __init__(self, hash_bins, title_vocab, device, gen, dim: int = 32):
        super().__init__()
        self.hash_bins = hash_bins
        self.movie = nn.Embedding(hash_bins, dim, device=device)
        self.tokens = nn.Embedding(title_vocab, dim, device=device)
        self.mlp = blocks.MLP(2 * dim, (64, dim), device=device)
        with torch.no_grad():
            self.movie.weight.normal_(0.0, dim ** -0.5, generator=gen)
            self.tokens.weight.normal_(0.0, dim ** -0.5, generator=gen)
        self.mlp.reset_parameters(gen)

    def forward(self, inputs):
        bucket = hashing.hash_bucket(inputs["movie_id"], self.hash_bins,
                                     salt=7)
        tokens = inputs["title_tokens"]
        return self.mlp(torch.cat([
            self.movie(bucket),
            preprocessing.masked_mean(self.tokens(tokens), tokens)], dim=-1))


def featurization_data(size: FeaturizationSize, seed: int) -> dict:
    """`examples/featurization.py`'s host-side adaptation (the Keras
    `adapt()` step) on a synthetic MovieLens split, and the first
    `size.steps` shuffled batches of its inputs."""
    train, _ = data.synthetic_movielens(
        num_interactions=size.interactions, seed=seed).split(0.8)
    user_vocab = vocab.build_vocabulary([f"user_{u}" for u in
                                         train.user_ids])
    titles = synthetic_titles(train.num_movies)
    vectorizer = preprocessing.TextVectorizer.adapt(
        titles, max_tokens=size.max_tokens)
    title_tokens = vectorizer(titles, sequence_length=4)
    inputs = {"user_id": user_vocab.encode([f"user_{u}" for u in
                                            train.user_ids]),
              "movie_id": train.movie_ids, "timestamp": train.timestamps,
              "title_tokens": title_tokens[train.movie_ids]}
    return {
        "train": train, "user_vocab": user_vocab, "vectorizer": vectorizer,
        "normalizer": preprocessing.Normalizer.adapt(train.timestamps),
        "discretizer": preprocessing.Discretizer.adapt(
            train.timestamps, num_bins=size.bins),
        "steps": list(data.batched(inputs, size.batch, shuffle=True,
                                   seed=seed)())[:size.steps],
    }


def featurization_model(prep: dict, size: FeaturizationSize, where,
                        seed: int) -> models.TwoTowerRetrieval:
    gen = torch.Generator(where).manual_seed(seed)
    return models.TwoTowerRetrieval(
        FeaturizedQuery(prep["user_vocab"].size, prep["normalizer"],
                        prep["discretizer"], where, gen),
        FeaturizedCandidate(size.hash_bins, prep["vectorizer"].vocab_size,
                            where, gen),
        query_key=("user_id", "timestamp"),
        candidate_key=("movie_id", "title_tokens"),
        batch_metric_ks=(10, 100))


def featurization_losses(device: torch.device, size: FeaturizationSize,
                         seed: int, prep: dict) -> tuple:
    """The same steps under the example's Adagrad on the CPU and on
    `device` from one weight set; returns (card losses, CPU losses)."""
    losses = []
    weights = None
    for where in (torch.device("cpu"), device):
        model = featurization_model(prep, size, where, seed)
        if weights is not None:
            model.load_state_dict(weights)
        weights = cpu_params(model)
        losses.append(trainer_steps(model, lambda p: quickstart_adagrad(
            p, FEATURIZATION_LR), prep["steps"])[1])
    return losses[1], losses[0]


def relative_gaps(got: list, want: list) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def featurization(device: torch.device, size: FeaturizationSize, seed: int):
    """Phase 30: `examples/featurization.py`'s towers, card against CPU."""
    # 30. Host-side adaptation, then the same steps on the card and the
    # CPU from one weight set.
    started = time.perf_counter()
    prep = featurization_data(size, seed)
    card_losses, host_losses = featurization_losses(device, size, seed,
                                                    prep)
    gaps = relative_gaps(card_losses, host_losses)
    check(max(gaps) <= 1e-4,
          f"featurization losses {card_losses} vs CPU {host_losses}")
    train, discretizer = prep["train"], prep["discretizer"]
    movie_ids = torch.from_numpy(train.movie_ids)
    ts = torch.from_numpy(train.timestamps)
    buckets = hashing.hash_bucket(movie_ids.to(device), size.hash_bins, 7)
    bins = discretizer(ts.to(device))
    check(torch.equal(buckets.cpu(), hashing.hash_bucket(
        movie_ids, size.hash_bins, 7)), "hash buckets differ card vs CPU")
    check(torch.equal(bins.cpu(), discretizer(ts)),
          "discretized timestamps differ card vs CPU")
    norm_err = float((prep["normalizer"](ts.to(device)).cpu()
                      - prep["normalizer"](ts)).abs().max())
    print(f"  featurization: {prep['user_vocab'].size} users, "
          f"{discretizer.num_bins} time buckets, "
          f"{prep['vectorizer'].vocab_size} title tokens; losses "
          f"{[round(x, 5) for x in card_losses]} vs CPU "
          f"{[round(x, 5) for x in host_losses]} (relative gaps "
          f"{[float(f'{g:.3g}') for g in gaps]}); {len(buckets)} hash "
          f"buckets and discretized ids bit-equal, normalized max |err| "
          f"{norm_err:.3g}", flush=True)
    phase("featurization", started, f"{size.steps} steps of "
          f"{size.batch}, card vs CPU")


def featurization_drift(device: torch.device, size: FeaturizationSize,
                        seed: int):
    """`--featurization-drift STEPS`: phase 30's card-vs-CPU losses and
    their relative gap at each of `size.steps` steps, printed as one
    JSON line and not held to a limit (a diagnostic of how the example's
    Adagrad 0.3 amplifies rounding as its loss grows)."""
    card, host = featurization_losses(device, size, seed,
                                      featurization_data(size, seed))
    print(json.dumps({"seed": seed, "steps": size.steps, "card": card,
                      "cpu": host, "gap": relative_gaps(card, host)}),
          flush=True)


def full_quality(args) -> bool:
    """Whether `args` are the tool's defaults (its device aside): the
    bounds against the JAX package's recorded means hold only at that
    size. The bounds themselves are the tool's constants."""
    defaults = vars(quality_parity.parse_args([]))
    return all(getattr(args, k) == v for k, v in defaults.items()
               if k != "device")


# Phase 31's fused retrieval run against its unfused run, which starts
# from the same weights and takes the same batches: K2 with f32 scores
# (split precision) stands in for the unfused path's f32 scores and
# softmax, so each epoch's loss stays within K2's own loss tolerance
# against its twin (rtol 1e-5), and each top-k accuracy within 0.001 (a
# query whose positive sits within rounding of a rank boundary may change
# sides).
FUSED_LOSS_RTOL = 1e-5
FUSED_TOPK_MARGIN = 0.001


def quality(device: torch.device, args) -> dict:
    """Phases 31 and 32: `tools/quality_parity.py` at its defaults, held
    to the JAX package's recorded means; the fused retrieval run also
    held to the unfused one, and K2 to its twin on the run's own
    embeddings. Returns K2 f32's launches on the fused retrieval run."""
    # 31. Retrieval unfused and fused (K2, f32 scores), and the rating
    # model.
    started = time.perf_counter()
    train, test = quality_parity.movielens_split(args)
    results = {}
    for run, fused in (("retrieval", False), ("retrieval fused", True)):
        reset_train_counts()
        model = quality_parity.retrieval_model(
            train.num_users, train.num_movies, args, fused=fused)
        results[run] = quality_parity.train_retrieval(model, train, test,
                                                      args)
        if fused:
            k2 = dict(fused_retrieval.fused_retrieval_loss.launches_by_kernel)
    steps = args.epochs * (len(train) // args.batch)
    if device.type == "cuda":
        # `Trainer.init`'s forward pass on a sample batch launches fwd once.
        check_k2_counts("quality parity, fused retrieval", k2,
                        {"fwd": steps + 1, "dq": steps, "dc": steps}, "f32")
    plain, fused_run = results["retrieval"], results["retrieval fused"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(fused_run["losses"],
                                                       plain["losses"]))
    check(loss_gap <= FUSED_LOSS_RTOL, f"fused retrieval's epoch losses "
          f"{fused_run['losses']} vs unfused {plain['losses']}")
    topk_gap = max(abs(fused_run[k] - plain[k])
                   for k in ("top_10", "top_50", "top_100"))
    check(topk_gap <= FUSED_TOPK_MARGIN, f"fused retrieval's top-k "
          f"{fused_run} vs unfused {plain}")
    # K2 against its twin at this path's shapes and on its own inputs:
    # the trained towers' embeddings of the first training batch.
    first = next(data.batched(train.as_dict(), args.batch, shuffle=True,
                              seed=args.seed)())
    with torch.no_grad():
        batch = {k: torch.from_numpy(v).to(device) for k, v in first.items()}
        q = model.query_embeddings(batch)
        cand = model.candidate_embeddings(batch)
    loss, tloss, loss_err, errs = k2_against_twin(
        q, cand, {"score_dtype": None}, "quality K2 f32")
    results["ranking"] = quality_parity.run_ours_ranking(train, test, args)
    for run, values in results.items():
        check(all(np.isfinite(v) and v > 0 for k, v in values.items()
                  if k in quality_parity.RECORDED),
              f"{run}: a metric is not positive and finite ({values})")
        print(f"  {run}: " + ", ".join(
            f"{k} {v:.4f} (JAX {quality_parity.RECORDED[k]})"
            for k, v in values.items() if k in quality_parity.RECORDED)
            + f"; epoch losses {[round(x, 5) for x in values['losses']]}, "
            f"fit {values['train_seconds']:.3f} s", flush=True)
    print(f"  quality fused retrieval: K2 launches {k2_text(k2)}; against "
          f"unfused, epoch losses within {loss_gap:.3g} relative (limit "
          f"{FUSED_LOSS_RTOL}), top-k within {topk_gap:.3g} (limit "
          f"{FUSED_TOPK_MARGIN}); K2 f32 on the trained embeddings of a "
          f"batch (B=C={q.shape[0]} D={q.shape[1]}): loss {float(loss):.6f} "
          f"vs twin {float(tloss):.6f} (|err| {loss_err:.3g}), max |err| "
          f"dq {errs['dq']:.3g}, dc {errs['dc']:.3g}", flush=True)
    failures = quality_parity.quality_failures(results)
    check(not failures or not full_quality(args), "; ".join(failures))
    phase("quality parity", started, f"{args.interactions} interactions, "
          f"{args.epochs} epochs of {args.batch}; retrieval unfused and "
          "fused, ranking")

    # 32. The unified-embedding three-way study.
    started = time.perf_counter()
    uet = quality_parity.run_ours_uet(*quality_parity.make_uet(args), args)
    check(all(0 < v < 1 for v in uet.values()), f"uet AUCs {uet}")
    print("  uet AUC: " + ", ".join(
        f"{k} {v:.4f} (JAX {quality_parity.RECORDED[k]})"
        for k, v in uet.items()) + f"; collisionless - hash "
        f"{uet['collisionless'] - uet['hash']:.4f}, unified - hash "
        f"{uet['unified'] - uet['hash']:.4f}", flush=True)
    failures = quality_parity.quality_failures({"uet": uet})
    check(not failures or not full_quality(args), "; ".join(failures))
    phase("unified embedding", started, f"{args.examples} examples, "
          f"{args.uet_epochs} epochs, three arms")
    return {K2_F32_ROWS[name]: {"quality parity, fused retrieval":
                                k2.get((name, "f32"), 0)}
            for name in K2_F32_ROWS}


def data_slice(device: torch.device, pipeline_size: PipelineSize,
               featurization_size: FeaturizationSize, quality_args,
               seed: int) -> list:
    """Phases 29-32; returns the kernels' launches on their paths."""
    counts = [pipeline(device, pipeline_size, seed)]
    featurization(device, featurization_size, seed)
    counts.append(quality(device, quality_args))
    return counts


# --- Distribution: one-rank NCCL group and four ranks on one card ------------


@dataclasses.dataclass(frozen=True)
class ParallelSize:
    """The two distributed phases' widths: the smoke's own
    configurations (`Size`, `ScannSize`, `TrainSize`, `TrainerSize`) and
    `benchmarks/id_exchange.py:53-59`'s exchange (2²⁰ × 128, batch
    8,192)."""
    serving: Size = Size(requests=2)
    scann: ScannSize = ScannSize(requests=2)
    train: TrainSize = TrainSize()
    trainer: TrainerSize = TrainerSize()
    steps: int = 3
    exchange_rows: int = 1 << 20
    exchange_dim: int = 128
    exchange_batch: int = 8192


# The sharded ScaNN indexes: the gather path (K4) and the main path (K5).
PARALLEL_INDEXES = ("int8_reorder", MAIN_INDEX)


# Meshed-engine rules held f32-bit-equal to the unsharded engine, and the
# four-rank fall-back tolerance (`tests/test_meshed_kernel.py`).
MESHED_KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")
MESHED_RTOL, MESHED_ATOL = 1e-5, 5e-7
POOLED_LR = 1.0


# The report rows each distributed path must launch on the card.
PATH_ROWS = {
    "sharded bucketed": [f"bucketed_scores[{f}]" for f in BUCKETED],
    "sharded ScaNN": ["probed_leaf_scores[int8]",
                      "probed_bucketed_scores[int8]"],
    "meshed engine": ["sorted_block_apply[adagrad bf16+SR]"],
    "pooled negatives": [f"fused_retrieval_{n}[f32 scores]"
                         for n in ("fwd", "dq", "dc")],
}


def check_launched(device: torch.device, path: str, counts: dict) -> None:
    """On the card, every kernel of `path` launched (its wrappers count
    kernel launches only; the CPU runs the twins)."""
    if device.type != "cuda":
        return
    kind = next(k for k in PATH_ROWS if path.startswith(k))
    idle = [row for row in PATH_ROWS[kind] if not counts.get(row)]
    check(not idle, f"{path}: {idle} never launched")


def request_ms(fn, device: torch.device, calls: int = 3) -> float:
    """Host ms of one `fn()` ending in a synchronize, the mean of
    `calls` after a warm-up."""
    fn()
    sync(device)
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    sync(device)
    return (time.perf_counter() - start) * 1e3 / calls


def parallel_group(device: torch.device, root: str):
    """A one-rank default group from a `FileStore` (NCCL on the card)."""
    import torch.distributed as dist

    store = dist.FileStore(str(Path(root) / "store"), 1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=0, world_size=1)


def reset_all_counts() -> None:
    reset_counts()
    reset_leaf_counts()
    reset_train_counts()


def tally(paths: dict, path: str) -> None:
    """Adds the launches since the last `reset_all_counts` to `path`'s."""
    into = paths.setdefault(path, {})
    for row, n in kernel_counts().items():
        into[row] = into.get(row, 0) + n


def group_collectives(device: torch.device, mesh) -> int:
    """Every collective helper on `mesh`'s one-rank group on tensors on
    `device` (NCCL on the card), each held to what a one-rank group
    gives (its input back; the differentiable gather's backward, the
    cotangent); returns the collectives run."""
    calls = parallel_mesh.STATS["calls"]
    gen = torch.Generator(device).manual_seed(5)
    x = torch.randn(64, 32, generator=gen, device=device)
    for t in (x, x.to(torch.bfloat16), (x * 100).to(torch.int64),
              x > 0):
        check(torch.equal(parallel_mesh.all_gather(t, mesh, "model"), t)
              and torch.equal(parallel_mesh.broadcast(t, mesh, "model"), t),
              f"phase 33: a one-rank all-gather or broadcast of {t.dtype} "
              "changed its input")
    for op in ("sum", "max", "min"):
        check(torch.equal(parallel_mesh.all_reduce(x, mesh, "model", op),
                          x), f"phase 33: a one-rank all-reduce {op} "
              "changed its input")
    leaf = x.clone().requires_grad_(True)
    (parallel_mesh.gather(leaf, mesh, "model") * x).sum().backward()
    check(torch.equal(leaf.grad, x), "phase 33: the one-rank gather's "
          "backward is not its cotangent")
    return parallel_mesh.STATS["calls"] - calls


def kernel_counts() -> dict:
    """Launches by report row since the last `reset_all_counts`."""
    out = {f"bucketed_scores[{f}]": n for f, n in
           scoring.bucketed_scores.launches_by_format.items()}
    for fn in KERNEL_FNS.values():
        out.update({f"{fn.__name__}[{f}]": n
                    for f, n in fn.launches_by_format.items()})
    out["sorted_block_apply[adagrad bf16+SR]"] = (
        sparse_apply.sorted_block_apply.launches)
    by = fused_retrieval.fused_retrieval_loss.launches_by_kernel
    for name in K2_ROWS:
        for label in ("bf16", "f32"):
            out[f"fused_retrieval_{name}[{label} scores]"] = by.get(
                (name, label), 0)
    return out


def serving_inputs(size: Size, seed: int, device: torch.device):
    """(the serving slice's 1M × 128 corpus, its first request of 1024
    users' query embeddings), from `serving_model`'s weights."""
    model, _ = serving_model(size, seed, device)
    with torch.no_grad():
        corpus = model.candidate_embeddings(
            {"movie_id": torch.arange(size.items, device=device)})
        users = torch.from_numpy(np.random.RandomState(seed + 1).randint(
            0, size.users, size.batch)).to(device)
        queries = model.query_embeddings({"user_id": users})
    return corpus.contiguous(), queries


def meshed_engine(size: TrainSize, device, mesh, kind: str, bf16: bool):
    """`bench.py`'s engine (or its f32 form under `kind`) on `mesh`."""
    return emb_engine.EmbeddingEngine(
        (emb_config.FeatureConfig(emb_config.TableConfig(
            size.users, size.dim, name="user"), name="user_id"),
         emb_config.FeatureConfig(emb_config.TableConfig(
             size.items, size.dim, name="item"), name="item_id")),
        optimizer=emb_config.OptimizerSpec(kind=kind,
                                           learning_rate=TRAIN_LR),
        dtype=torch.bfloat16 if bf16 else torch.float32,
        slot_dtype=torch.bfloat16 if bf16 else None,
        stochastic_rounding=bf16, mesh=mesh, device=device)


def engine_steps(size: TrainSize, device, mesh, kind: str, bf16: bool,
                 seed: int, act_grads=None) -> tuple:
    """3 unfused steps of the engine from `logical_state`'s tables and
    the slots `init` gives `kind`: (the logical state after them as NumPy,
    bf16 as bits; the activation grads each step took, on the CPU). With
    `act_grads`, the steps apply those instead of their own (the card's
    grads fed to a CPU run, so K1's twin meets the kernel's inputs)."""
    engine = meshed_engine(size, device, mesh, kind, bf16)
    start = convert.engine_state_to_logical(engine, engine.init())
    start["tables"] = logical_state(size, seed)["tables"]
    state = convert.engine_state_from_logical(engine, start)
    taken = []
    for i, batch in enumerate(train_batches(size, seed + 5, 3, device)):
        if act_grads is None:
            acts = engine.lookup(state, batch)
            _, _, grads = engine._value_and_grad(train_loss(False), acts)
            taken.append({k: v.cpu() for k, v in grads.items()})
        else:
            grads = {k: v.to(device) for k, v in act_grads[i].items()}
        state = engine.update(state, batch, grads)
    return convert.engine_state_to_logical(engine, state), taken


def same_logical(a: dict, b: dict) -> bool:
    return all(np.array_equal(a["tables"][n], b["tables"][n])
               and all(np.array_equal(a["slots"][n][k], b["slots"][n][k])
                       for k in a["slots"][n])
               for n in a["tables"])


def logical_close(a: dict, b: dict) -> bool:
    return all(np.allclose(a["tables"][n], b["tables"][n],
                           rtol=MESHED_RTOL, atol=MESHED_ATOL)
               for n in a["tables"])


def pooled_model(size: TrainerSize, device, seed: int):
    """The quickstart towers with the fused task at f32 scores (K2's
    f32 bodies): bf16 scores round the backward's coefficients to bf16,
    where the pooled step's other sum order moves them by an ulp."""
    model = trainer_model(size, device, fused=True, seed=seed)
    model.task = tasks.Retrieval(fused=True)
    return model


def pooled_run(size: TrainerSize, device, mesh, seed: int) -> tuple:
    """One pooled-negatives step (fused, f32 scores, SGD lr 1) of the
    quickstart towers on `mesh`'s data axis, over the global batch;
    (loss, the parameters' change as NumPy)."""
    from recommenders_tpu_torch.parallel import retrieval_step

    model = pooled_model(size, device, seed)
    before = cpu_params(model)
    opt = torch.optim.SGD(model.parameters(), lr=POOLED_LR)
    step = retrieval_step.make_pooled_negatives_train_step(model, opt, mesh)
    batch = trainer_batches(size, seed + 3, 1)[0]
    local = {k: torch.from_numpy(v).to(device) for k, v in
             parallel_mesh.shard_batch(batch, mesh).items()}
    loss = float(step(local))
    return loss, {k: (v - before[k]).numpy() for k, v in
                  cpu_params(model).items()}


def global_step(size: TrainerSize, device, seed: int) -> tuple:
    """The one-device step `pooled_run` must equal: the global batch
    through the fused task, SGD lr 1."""
    model = pooled_model(size, device, seed)
    before = cpu_params(model)
    opt = torch.optim.SGD(model.parameters(), lr=POOLED_LR)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             trainer_batches(size, seed + 3, 1)[0].items()}
    opt.zero_grad()
    loss = model.task(model.query_embeddings(batch),
                      model.candidate_embeddings(batch)).loss
    loss.backward()
    opt.step()
    return float(loss.detach()), {k: (v - before[k]).numpy() for k, v in
                         cpu_params(model).items()}


def trainer_run(size: TrainerSize, device, mesh, seed: int) -> tuple:
    """`size.parity_steps` `Trainer` steps (unfused, quickstart Adagrad)
    on `mesh` (or one device); (losses, final parameters as NumPy)."""
    model = trainer_model(size, device, fused=False, seed=seed)
    run = models.Trainer(model, quickstart_adagrad, mesh=mesh)
    state, losses = run.init(), []
    for batch in trainer_batches(size, seed + 4, size.parity_steps):
        state, loss = run.train_step(state, batch)
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in cpu_params(model).items()}


def one_rank(device: torch.device, size: ParallelSize, seed: int) -> tuple:
    """Phase 33: every sharded entry point on a one-rank group (NCCL on
    the card) at full width, each bit-equal to its unsharded
    counterpart. Returns (the launches by report row, the references
    phase 34 compares with)."""
    import torch.distributed as dist
    from recommenders_tpu_torch import parallel

    started = time.perf_counter()
    laps, last = {}, [started]

    def lap(name):
        sync(device)
        now = time.perf_counter()
        laps[name] = round(now - last[0], 3)
        last[0] = now

    root = tempfile.mkdtemp(prefix="one_rank_")
    parallel_group(device, root)
    ref, paths = {}, {}
    try:
        model_mesh = parallel.create_mesh((1,), ("model",), device.type)
        data_mesh = parallel.create_mesh((1,), ("data",), device.type)
        corpus, queries = serving_inputs(size.serving, seed, device)
        ref["brute"] = factorized_top_k.BruteForce(
            k=K, device=device).index(corpus)(queries)[1].cpu().numpy()
        parallel_mesh.reset_stats()
        collectives = {"helpers": group_collectives(device, model_mesh)}
        timings = {}
        for fmt, kw in BUCKETED.items():
            single = factorized_top_k.Bucketed(
                k=K, device=device, **kw).index(corpus)
            sharded = ann_lib.ShardedBucketed(
                k=K, mesh=model_mesh, device=device, **kw).index(corpus)
            reset_all_counts()
            got = sharded(queries)
            tally(paths, "sharded bucketed 1-rank")
            want = single(queries)
            timings[f"bucketed {fmt}"] = (
                request_ms(lambda: single(queries), device),
                request_ms(lambda: sharded(queries), device))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"phase 33: one-rank ShardedBucketed {fmt} differs "
                  "from Bucketed")
            ref[f"bucketed {fmt}"] = want[1].cpu().numpy()
        del corpus
        lap("bucketed")
        scann_corpus, requests = clustered_data(size.scann, seed)
        scann_corpus = torch.from_numpy(scann_corpus).to(device)
        scann_q = torch.from_numpy(requests[0]).to(device)
        configs = scann_configs(size.scann)
        for name in PARALLEL_INDEXES:
            settings = configs[name][0]
            single = approximate.ScaNN(k=K, device=device, **settings).index(
                scann_corpus)
            want = single(scann_q)
            ref[f"scann {name}"] = tuple(x.cpu().numpy() for x in want)
            ref[f"scann {name} centroids"] = single._centroids.cpu().numpy()
            sharded = ann_lib.ShardedScaNN(approximate.ScaNN(
                k=K, device=device, **settings), mesh=model_mesh).index(
                    scann_corpus)
            reset_all_counts()
            got = sharded(scann_q)
            tally(paths, "sharded ScaNN 1-rank")
            timings[f"scann {name}"] = (
                request_ms(lambda: single(scann_q), device),
                request_ms(lambda: sharded(scann_q), device))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"phase 33: one-rank ShardedScaNN {name} differs from "
                  "ScaNN")
        ref["scann brute"] = factorized_top_k.BruteForce(
            k=K, device=device).index(scann_corpus)(scann_q)[1].cpu().numpy()
        del scann_corpus
        lap("scann")
        reset_all_counts()
        got = engine_steps(size.train, device, model_mesh, "adagrad", True,
                           seed)[0]
        paths["meshed engine 1-rank"] = kernel_counts()
        want = engine_steps(size.train, device, None, "adagrad", True,
                            seed)[0]
        check(same_logical(got, want), "phase 33: one-rank meshed engine "
              "differs from the unsharded engine")
        for kind in MESHED_KINDS:
            ref[f"engine {kind}"] = engine_steps(size.train, device, None,
                                                 kind, False, seed)[0]
        lap("engine")
        reset_all_counts()
        pooled = pooled_run(size.trainer, device, data_mesh, seed)
        paths["pooled negatives 1-rank"] = kernel_counts()
        ref["global step"] = global_step(size.trainer, device, seed)
        check(pooled[0] == ref["global step"][0] and all(
            np.array_equal(pooled[1][k], v)
            for k, v in ref["global step"][1].items()),
            "phase 33: one-rank pooled negatives differ from the "
            "global-batch step")
        got = trainer_run(size.trainer, device, data_mesh, seed)
        ref["trainer"] = trainer_run(size.trainer, device, None, seed)
        check(got[0] == ref["trainer"][0] and all(
            np.array_equal(got[1][k], v)
            for k, v in ref["trainer"][1].items()),
            "phase 33: one-rank Trainer(mesh) differs from Trainer")
        lap("pooled and trainer")
        collectives["sharded paths"] = (parallel_mesh.STATS["calls"]
                                        - collectives["helpers"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    for path, counts in paths.items():
        check_launched(device, path, counts)
    backend = "NCCL" if device.type == "cuda" else "gloo"
    print(f"  one-rank {backend} collectives run: {collectives}; launches "
          + json.dumps({p: {k: v for k, v in c.items() if v}
                        for p, c in paths.items()}))
    print("  one-rank request ms (one device, one-rank sharded): "
          + json.dumps({k: [round(a, 3), round(b, 3)]
                        for k, (a, b) in timings.items()}))
    phase("33 one-rank group", started,
          "ShardedBucketed x4, ShardedScaNN x2, meshed engine, pooled "
          f"negatives, Trainer(mesh) bit-equal to unsharded; s {laps}")
    return paths, ref


def _digest(tree) -> str:
    """A digest of the arrays and numbers of a nested result."""
    import hashlib

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())

    walk(tree)
    return h.hexdigest()[:16]


def four_rank_worker(device: torch.device, size: ParallelSize,
                     seed: int) -> dict:
    """Phase 34's rank: every sharded path on this rank's shard. Rank 0
    returns the arrays the parent compares; every rank its digests,
    launches and times."""
    import torch.distributed as dist
    from recommenders_tpu_torch import parallel
    from recommenders_tpu_torch.parallel import embedding_lookup

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    out = {"rank": rank, "launches": {}, "ms": {}, "digests": {}}
    keep = rank == 0
    model_mesh = parallel.create_mesh((4,), ("model",), device.type)
    grid = parallel.create_mesh((2, 2), device_type=device.type)

    def timed(label, fn):
        sync(device)
        start = time.perf_counter()
        value = fn()
        sync(device)
        out["ms"][label] = (time.perf_counter() - start) * 1e3
        return value

    def record(path, value):
        out["digests"][path] = _digest(value)
        if keep:
            out[path] = value

    parallel_mesh.reset_stats()
    reset_all_counts()
    corpus, queries = serving_inputs(size.serving, seed, device)
    shards = {}
    for fmt, kw in BUCKETED.items():
        index = ann_lib.ShardedBucketed(k=K, mesh=model_mesh, device=device,
                                        **kw).index(corpus)
        index(queries)   # warm-up
        got = timed(f"bucketed {fmt} request",
                    lambda: index(queries))
        record(f"bucketed {fmt}", tuple(x.cpu().numpy() for x in got))
        shards[fmt] = (index, got)
    out["launches"]["sharded bucketed 4-rank"] = kernel_counts()
    out["shard twin"] = {}
    for fmt, (index, (scores, ids)) in shards.items():
        out["shard twin"][fmt] = shard_against_twin(index, queries, fmt)
        if keep:
            out[f"bucketed {fmt} dot err"] = exact_dots(
                fmt, corpus, queries, scores, ids, device)
    del corpus, index, shards
    reset_all_counts()
    scann_corpus, requests = clustered_data(size.scann, seed)
    scann_corpus = torch.from_numpy(scann_corpus).to(device)
    scann_q = torch.from_numpy(requests[0]).to(device)
    configs = scann_configs(size.scann)
    for name in PARALLEL_INDEXES:
        index = ann_lib.ShardedScaNN(approximate.ScaNN(
            k=K, device=device, **configs[name][0]),
            mesh=model_mesh).index(scann_corpus)
        index(scann_q)   # warm-up
        got = timed(f"scann {name} request", lambda: index(scann_q))
        record(f"scann {name}", tuple(x.cpu().numpy() for x in got))
        record(f"scann {name} centroids", index._centroids.cpu().numpy())
    del scann_corpus, index
    out["launches"]["sharded ScaNN 4-rank"] = kernel_counts()
    reset_all_counts()
    state, grads = timed("meshed engine 3 steps", lambda: engine_steps(
        size.train, device, model_mesh, "adagrad", True, seed))
    record("engine bf16", state)
    record("engine grads", grads)
    out["launches"]["meshed engine 4-rank"] = kernel_counts()
    for kind in MESHED_KINDS:
        record(f"engine {kind}", engine_steps(
            size.train, device, model_mesh, kind, False, seed)[0])
    # The id exchange on (data, model) = (2, 2).
    gen = torch.Generator(device).manual_seed(seed + 7)
    table = torch.randn(size.exchange_rows, size.exchange_dim,
                        generator=gen, device=device)
    ids = torch.randint(0, size.exchange_rows, (size.exchange_batch,),
                        generator=gen, device=device)
    grads = torch.randn(size.exchange_batch, size.exchange_dim,
                        generator=gen, device=device)
    shard = corpus_lib.shard_rows(table, grid, "model").contiguous()
    local_ids = parallel.shard_batch(ids, grid)
    rows = timed("exchange lookup", lambda: embedding_lookup.sharded_lookup(
        shard, local_ids, grid))
    added = timed("exchange scatter-add",
                  lambda: embedding_lookup.sharded_scatter_add(
                      shard, local_ids, parallel.shard_batch(grads, grid),
                      grid, scale=-0.1))
    dense = table.clone().index_add_(0, ids, -0.1 * grads)
    out["exchange ok"] = (
        torch.equal(rows, table[local_ids])
        and bool(torch.allclose(added, corpus_lib.shard_rows(
            dense, grid, "model"), rtol=1e-6, atol=1e-6)))
    del table, dense, shard
    # The first optimizer step of a process under a process group
    # imports `torch.distributed.tensor` (seconds of host time): once
    # off the clock.
    pooled_run(size.trainer, device, grid, seed)
    reset_all_counts()
    record("pooled", timed("pooled negatives step",
                           lambda: pooled_run(size.trainer, device,
                                              grid, seed)))
    out["launches"]["pooled negatives 4-rank"] = kernel_counts()
    record("trainer", timed("Trainer(mesh) steps", lambda: trainer_run(
        size.trainer, device, grid, seed)))
    out["collectives"] = dict(parallel_mesh.STATS)
    for path, counts in out["launches"].items():
        check_launched(device, path, counts)
    return out


def shard_against_twin(index, queries: torch.Tensor, fmt: str) -> dict:
    """This rank's K3 launch over its own shard, with the shard's
    `valid_rows` (below the shard's rows on the last rank), against
    `bucketed_scores_reference` at the same `valid_rows`: scores within
    `score_tolerance`, ids equal where the twin's bucket winner is clear
    of its runner-up, and no padding row where the twin found a real
    one. Returns the rank's valid rows and the max |err|."""
    q = (queries if index._quantize
         else queries.to(index._candidates.dtype))[:TWIN_QUERIES]
    packed4 = fmt == "int4"
    vals, rows = scoring.bucketed_scores_padded(
        q, index._candidates, index._scales, index._buckets, index._chunk,
        index._query_tile, index._valid_rows, packed4)
    twin_vals, twin_rows = scoring.bucketed_scores_reference(
        q, index._candidates, index._scales, buckets=index._buckets,
        valid_rows=index._valid_rows, packed4=packed4)
    err = (vals - twin_vals).abs()
    tol = score_tolerance(index, q, twin_rows, twin_vals)
    check(bool((err <= tol).all()), f"phase 34: shard K3 {fmt} scores off "
          f"the twin by {float(err.max())}")
    real = twin_vals > scoring.MIN_FLOAT / 2
    check(bool((rows[real] < index._valid_rows).all()),
          f"phase 34: shard K3 {fmt} returned a padding row")
    stored = index._candidates
    if packed4:
        stored = quantization.unpack_nibbles(stored)
    table = scoring.reference_scores(
        q, stored, index._scales, index._valid_rows).view(
            q.shape[0], -1, index._buckets)
    if table.shape[1] > 1:
        top2 = table.topk(2, dim=1).values
        separated = (top2[:, 0] - top2[:, 1]) > 2 * tol
    else:   # one row a bucket: its winner has no runner-up
        separated = torch.ones_like(real)
    check(torch.equal(rows[separated], twin_rows[separated]),
          f"phase 34: shard K3 {fmt} ids differ from the twin's in a "
          "separated bucket")
    return {"valid_rows": index._valid_rows,
            "rows": index._rows_per_shard,
            "max_abs_err": float(err.max())}


def exact_dots(fmt: str, corpus: torch.Tensor, queries: torch.Tensor,
               scores: torch.Tensor, ids: torch.Tensor, device) -> float:
    """The sharded index's returned scores against exact dots of the
    returned rows: f32 dots of the corpus rows, or of the rows as one
    device's index of the format stores them (bf16, or dequantized
    codes: a row's codes depend on that row only), within
    `score_tolerance`. Returns the max |err|."""
    single = factorized_top_k.Bucketed(k=K, device=device,
                                       **BUCKETED[fmt]).index(corpus)
    check(bool((ids >= 0).all()), f"phase 34: ShardedBucketed {fmt} "
          "returned an empty slot")
    codes, scales = stored_rows(single, ids)
    exact = (scored_query(single, queries)[:, None, :]
             * codes).sum(-1) * scales
    tol = score_tolerance(single, queries, ids, exact)
    err = (scores - exact).abs()
    check(bool((err <= tol).all()), f"phase 34: ShardedBucketed {fmt}'s "
          f"scores are not exact dots of its rows ({float(err.max())})")
    return float(err.max())


def engine_cpu_worker(device: torch.device, size: TrainSize, seed: int,
                      act_grads: list):
    """The four-rank bf16 + SR engine on the CPU (K1's twin per shard)
    fed the card's activation grads: the card's bit-level reference."""
    from recommenders_tpu_torch import parallel

    mesh = parallel.create_mesh((4,), ("model",), device.type)
    return engine_steps(size, device, mesh, "adagrad", True, seed,
                        act_grads)[0]


def ties_apart(got: tuple, want: tuple) -> int:
    """Positions where two top-k id lists differ; each must sit in a
    score tie (the same score twice in its row), or the check fails."""
    (gs, gi), (ws, wi) = got, want
    apart = np.argwhere(gi != wi)
    for r, c in apart:
        tied = (ws[r] == ws[r, c]).sum() > 1 or (gs[r] == gs[r, c]).sum() > 1
        check(tied and set(gi[r]) == set(wi[r]),
              f"phase 34: row {r} col {c} differs outside a score tie")
    return len(apart)


def four_ranks(device: torch.device, size: ParallelSize, ref: dict,
               seed: int) -> dict:
    """Phase 34: four processes share the card through `run_ranks` on
    gloo (collectives staged through host memory); each runs its
    shard's K1 / K3 / K4 / K5 / K2. Held against phase 33's unsharded
    references. Returns the launches by report row (all ranks)."""
    from recommenders_tpu_torch.parallel import launch

    started = time.perf_counter()
    ranks = launch.run_ranks(four_rank_worker, 4, "gloo", device.type,
                             size, seed, timeout=900, threads=2)
    r0 = ranks[0]
    for r in ranks[1:]:
        apart = [k for k in r0["digests"]
                 if r["digests"][k] != r0["digests"][k]]
        check(not apart, f"phase 34: rank {r['rank']}'s {apart} differ "
              "from rank 0's")
    brute = ref["brute"]
    for fmt in BUCKETED:
        scores, ids = r0[f"bucketed {fmt}"]
        got, one = recall(torch.from_numpy(ids), torch.from_numpy(brute)), \
            recall(torch.from_numpy(ref[f"bucketed {fmt}"]),
                   torch.from_numpy(brute))
        check(got >= one, f"phase 34: ShardedBucketed {fmt} recall@100 "
              f"{got:.4f} below one device's {one:.4f}")
        twins = [r["shard twin"][fmt] for r in ranks]
        print(f"  sharded bucketed {fmt}: recall@100 {got:.4f} "
              f"(one device {one:.4f}); scores exact dots (max |err| "
              f"{r0[f'bucketed {fmt} dot err']:.3g}); each shard's K3 vs "
              "its twin at its valid rows: "
              + json.dumps([[t["valid_rows"], t["rows"],
                             float(f"{t['max_abs_err']:.3g}")]
                            for t in twins]))
    ties = {}
    for name in PARALLEL_INDEXES:
        check(np.array_equal(r0[f"scann {name} centroids"],
                             ref[f"scann {name} centroids"]),
              f"phase 34: {name}'s ranks built another partition than "
              "one device")
        got, want = r0[f"scann {name}"], ref[f"scann {name}"]
        if configs_gather(size, name):
            ties[name] = ties_apart(got, want)
            check(np.array_equal(np.sort(got[0], 1), np.sort(want[0], 1)),
                  f"phase 34: {name}'s reorder scores are not bit-equal")
        else:
            mine = recall(torch.from_numpy(got[1]),
                          torch.from_numpy(ref["scann brute"]))
            one = recall(torch.from_numpy(want[1]),
                         torch.from_numpy(ref["scann brute"]))
            check(mine >= one, f"phase 34: {name} recall@100 {mine:.4f} "
                  f"below one device's {one:.4f}")
            print(f"  sharded {name}: recall@100 {mine:.4f} (one device "
                  f"{one:.4f})")
    print(f"  sharded ScaNN gather path: {ties} ids apart, each in a score "
          "tie")
    reasons = {}
    for kind in MESHED_KINDS:
        got, want = r0[f"engine {kind}"], ref[f"engine {kind}"]
        if same_logical(got, want):
            reasons[kind] = "bit-equal"
        else:
            check(logical_close(got, want), f"phase 34: meshed {kind} "
                  f"outside rtol {MESHED_RTOL} / atol {MESHED_ATOL}")
            reasons[kind] = "within tolerance"
    print(f"  meshed engine f32 vs unsharded: {reasons}")
    host = launch.run_ranks(engine_cpu_worker, 4, "gloo", "cpu", size.train,
                            seed, r0["engine grads"], timeout=600,
                            threads=2)[0]
    check(same_logical(r0["engine bf16"], host), "phase 34: the four-rank "
          "bf16 + SR engine differs from its CPU run")
    check(all(r["exchange ok"] for r in ranks),
          "phase 34: the (2, 2) id exchange differs from the dense gather")
    loss, change = r0["pooled"]
    want_loss, want_change = ref["global step"]
    check(np.isclose(loss, want_loss, rtol=1e-5) and all(
        np.allclose(change[k], v, rtol=1e-4, atol=1e-6)
        for k, v in want_change.items()),
        "phase 34: pooled negatives differ from the global-batch step")
    losses, params = r0["trainer"]
    want_losses, want_params = ref["trainer"]
    check(np.allclose(losses, want_losses, rtol=1e-5) and all(
        np.allclose(params[k], v, rtol=1e-4, atol=1e-6)
        for k, v in want_params.items()),
        "phase 34: Trainer(mesh) differs from the global-batch step")
    card = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "CPU")
    label = f"4 ranks on one {card}, gloo through host"
    for r in ranks:
        launched = {p: {k: v for k, v in c.items() if v}
                    for p, c in r["launches"].items()}
        print(f"  rank {r['rank']} ({label}): ms "
              + json.dumps({k: round(v, 3) for k, v in r["ms"].items()})
              + f"; collectives {r['collectives']['calls']} calls "
              f"{r['collectives']['seconds'] * 1e3:.1f} ms host, "
              f"{r['collectives']['staged_bytes'] / 2**20:.1f} MiB staged; "
              f"launches {json.dumps(launched)}", flush=True)
    paths = {}
    for path in r0["launches"]:
        for row in r0["launches"][path]:
            total = sum(r["launches"][path][row] for r in ranks)
            paths.setdefault(row, {})[f"{path} (all ranks)"] = total
    phase("34 four ranks on one card", started, label)
    return paths


def configs_gather(size: ParallelSize, name: str) -> bool:
    return scann_configs(size.scann)[name][1] == "K4"


def distribution(device: torch.device, size: ParallelSize, seed: int):
    """Phases 33-34; returns the launches by report row and path."""
    paths, ref = one_rank(device, size, seed)
    four = four_ranks(device, size, ref, seed)
    by_row = {}
    for path, counts in paths.items():
        for row, n in counts.items():
            if n:
                by_row.setdefault(row, {})[path] = n
    for row, by_path in four.items():
        for path, n in by_path.items():
            if n:
                by_row.setdefault(row, {})[path] = n
    return by_row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=Size.requests)
    parser.add_argument(
        "--featurization-drift", type=int, metavar="STEPS",
        help="only print phase 30's card-vs-CPU loss gaps over STEPS "
        "steps at --seed, then exit with no result line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: FAILED: CUDA is not available; this smoke runs "
            "only on an NVIDIA GPU"
        )
    if args.featurization_drift:
        featurization_drift(
            torch.device("cuda", 0),
            FeaturizationSize(steps=args.featurization_drift), args.seed)
        return 0
    # f32 products stay f32 in the twin and the library call (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(nvidia_smi(), flush=True)
    report = run(device, Size(requests=args.requests), args.seed)
    report += scann(device, ScannSize(requests=args.requests), args.seed)
    report += train(device, TrainSize(), args.seed)
    stacked = stacked_engine(device, StackSize(), args.seed)
    paths = {}
    counts_by_phase = [trainer(device, TrainerSize(), args.seed),
                       corpus_eval(device, CorpusSize(), args.seed)]
    k1_dlrm, k2_f32 = ranking_slice(device, RankingSize(), args.seed)
    counts_by_phase += data_slice(
        device, PipelineSize(), FeaturizationSize(),
        quality_parity.parse_args(["--device", str(device)]), args.seed)
    counts_by_phase.append(distribution(device, ParallelSize(), args.seed))
    for counts in counts_by_phase + [k2_f32]:
        for row, by_path in counts.items():
            paths.setdefault(row, {}).update(by_path)
    for row in report:
        row["path_launches"] = paths.get(row["name"], {})
    report += stacked + [k1_dlrm]
    print(f"total {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
