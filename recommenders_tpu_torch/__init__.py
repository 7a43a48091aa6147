"""recommenders_tpu_torch: the PyTorch + CUDA port of `recommenders_tpu`.

The package mirrors `recommenders_tpu`'s layout (`ops/`, `layers/`,
`embedding/`, `tasks/`, `models/`, `utils/`) so each module sits where
its JAX counterpart does.
It imports `torch` and never JAX or the JAX package; the JAX package is
the reference every part of the port is tested against.

Entry points take an explicit `device` argument that defaults to
`"cuda"`. They run on the CPU only when the caller passes `device="cpu"`,
and raise when CUDA is asked for and missing.

Ported so far:
  - serving: `EmbeddingTower` / `TwoTowerRetrieval.query_embeddings` →
    `BruteForce` / `Bucketed` indexes → `ops.scoring.bucketed_top_k` →
    the hand-written CUDA kernel `csrc/bucketed_scores.cu`;
  - training: `embedding.EmbeddingEngine.lookup` → `tasks.Retrieval`
    (unfused, or `fused=True` through `csrc/fused_retrieval.cu`) →
    activation gradients → `EmbeddingEngine.update` →
    `sparse_optimizer.apply_sparse` → `csrc/sparse_apply.cu`;
  - probed serving: `layers.ScaNN` (k-means partition, capacity packing,
    int8/int4/bf16 leaves) → probes → `ops.leaf_scoring` →
    `csrc/leaf_scoring.cu` (K4 leaf scores, or K5 bucketed argmax) →
    optional exact reorder;
  - the trainer: `models.Trainer(model, optimizer).fit(...)` over a
    `models.Model` (`TwoTowerRetrieval` with `EmbeddingTower` or
    `SequenceTower`s), streaming `metrics`, and corpus-level
    `metrics.FactorizedTopK` over `BruteForce`, `Streaming` or
    `Bucketed`; `EmbeddingEngine(stack_tables=True)`; `utils.profiling`
    on `torch.profiler`;
  - ranking: `models.Ranking` (DLRM / DCN-v2 over `PartialEmbedding`
    tables), `tasks.Ranking` and `tasks.listwise`, `models.Multitask`
    (retrieval + rating, `fused=True` through K2), `models.HybridTrainer`
    (a dense head under a torch optimizer over an `EmbeddingEngine`'s
    tables, K1), and `optimizers` (Clippy Adagrad, composite);
  - the data path: `data` (vocabularies, preprocessing, synthetic
    MovieLens and its file reader, the native C++ batcher over
    `native/loader.cc`), `ops.hashing` and
    `embedding.UnifiedEmbedding`, and `utils.checkpoint`.
"""

__version__ = "0.1.0"

from recommenders_tpu_torch import data
from recommenders_tpu_torch import embedding
from recommenders_tpu_torch import layers
from recommenders_tpu_torch import metrics
from recommenders_tpu_torch import models
from recommenders_tpu_torch import ops
from recommenders_tpu_torch import optimizers
from recommenders_tpu_torch import tasks
from recommenders_tpu_torch import utils

__all__ = ["data", "embedding", "layers", "metrics", "models", "ops",
           "optimizers", "tasks", "utils"]
