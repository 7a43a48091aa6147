"""Prebuilt Ranking model: the DLRM / DCN-v2 skeleton.

Port of `recommenders_tpu/models/ranking.py` (the counterpart of
`tfrs.experimental.models.Ranking`): an embedding layer over the sparse
features → a bottom MLP over the dense features → a feature interaction
over [sparse embeddings..., dense embedding] → optionally the dense
embedding again beside it → a top MLP with a sigmoid head → the Ranking
task (BCE), with AUC / accuracy / label-mean / prediction-mean metrics.

The embedding layer is a `PartialEmbedding` (tables above
`size_threshold` rows in its sharded partition, stored in `table_dtype`),
whose gradients are dense. Flax modules infer their input widths at the
first call; here the stacks are built from factories `(in_features,
device, generator) -> nn.Module`, and the model works out each width
from the features' table dims and a forward pass of one zero row
through the bottom stack and the interaction.

Serving. `logits` gives the top stack's output before its final
activation, through the modules `forward` runs; the sum-pooled bags
(`embedding.poolable`) of a call are pooled by one `ops.pooled_lookup`
call. On the card, a DCN-style model (`interaction_takes_list=False`)
can `capture(rows)` its dense stack (bottom, interaction, the top's
`logits`) in one CUDA graph per row count; `logits` then pools a batch
of that many rows straight into the sparse columns of the graphs'
static `x0` and replays the graph: a request is one pooled launch and
one replay instead of a launch a layer.

`embedding_param_labels` labels each parameter `"embedding"` or
`"dense"` for a split between two optimizers (the reference's
`embedding_trainable_variables` / `dense_trainable_variables`), as
`optimizers.composite_optimizer` takes it.
"""

from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, Iterable, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import torch
from torch import nn

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.embedding import partial as partial_lib
from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.layers.feature_interaction import dcn
from recommenders_tpu_torch.layers.feature_interaction import dot_interaction
from recommenders_tpu_torch.metrics import base as metrics_base
from recommenders_tpu_torch.models import base as models_base
from recommenders_tpu_torch.tasks import ranking as ranking_task
from recommenders_tpu_torch.utils import activations as activations_lib
from recommenders_tpu_torch.utils import device as device_lib
from recommenders_tpu_torch.utils import profiling

Tensor = torch.Tensor
# `(in_features, device, generator) -> module`.
ModuleFactory = Callable[[int, torch.device, Optional[torch.Generator]],
                         nn.Module]


def mlp_stack(units: Sequence[int],
              final_activation: activations_lib.Activation = None
              ) -> ModuleFactory:
    """A factory of `blocks.MLP(in_features, units)` with relu between
    layers and flax's initialisation."""

    def make(in_features, device, generator=None) -> nn.Module:
        mlp = blocks.MLP(in_features, tuple(units),
                         final_activation=final_activation, device=device)
        mlp.reset_parameters(generator)
        return mlp

    return make


# The reference's default bottom MLP ([256, 64, 16], relu throughout) and
# top MLP ([512, 256, 1], sigmoid head), experimental/models/ranking.py
# :96-110.
default_bottom_stack = mlp_stack((256, 64, 16), "relu")
default_top_stack = mlp_stack((512, 256, 1), "sigmoid")


def default_interaction(in_features, device, generator=None) -> nn.Module:
    """DLRM dot interaction (the reference's default)."""
    return dot_interaction.DotInteraction(skip_gather=True)


def cross_interaction(projection_dim: Optional[int] = None) -> ModuleFactory:
    """DCN-v2 interaction factory (`interaction='cross'`)."""

    def make(in_features, device, generator=None) -> nn.Module:
        return dcn.Cross(in_features, projection_dim=projection_dim,
                         device=device, generator=generator)

    return make


def multi_layer_dcn_interaction(
    num_layers: int = 3, projection_dim: int = 1
) -> ModuleFactory:
    def make(in_features, device, generator=None) -> nn.Module:
        return dcn.MultiLayerDCN(in_features, projection_dim=projection_dim,
                                 num_layers=num_layers, device=device,
                                 generator=generator)

    return make


class _Captured(NamedTuple):
    """`Ranking.capture`'s graphs by row count (each with its output),
    the static inputs they read, the card and the stream (its
    `cudaStream_t`) they replay on, and the lock that lets one call at a
    time fill the inputs and replay."""
    graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, Tensor]]
    x0: Tensor
    dense: Tensor
    device: int
    stream: int
    lock: threading.Lock


class Ranking(models_base.Model):
    """DLRM/DCN-style ranking model.

    Batches are dicts with `dense_features` (`[B, num_dense_features]`
    floats), one entry per sparse `FeatureConfig` name (`[B]` or padded
    `[B, L]` ids), `clicked` (`[B]` float labels) for training and
    evaluation, and optionally `sample_weight` (`[B]`).

    Args:
      feature_configs: Sparse feature declarations (tables may be
        shared).
      num_dense_features: Width of `dense_features`.
      bottom_stack: Factory of the dense-feature MLP; its output width
        must equal the embedding dim for the dot interaction.
      feature_interaction: Factory of the interaction; it gets the list
        of `[B, D]` embeddings (DLRM style) or their `[B, F·D]`
        concatenation (DCN style), per `interaction_takes_list`, and is
        built with `D` or `F·D` as its input width.
      top_stack: Factory of the output MLP (sigmoid head).
      interaction_takes_list: DLRM style (True) or DCN style.
      concat_dense: Put the bottom-MLP output beside the interaction's
        before the top stack.
      size_threshold: Vocab threshold for the sharded partition.
      task: The ranking task (BCE by default).
      device: Where the weights live (default CUDA).
      mesh: Optional `parallel.Mesh`: the big tables are row-sharded over
        its model axis (train it with `Trainer(mesh=...)`).
      generator: Optional `torch.Generator` for the initial weights
        (tables, then bottom, interaction and top).
      table_dtype: The embedding tables' dtype (fp16 tables are pooled
        in f32).
    """

    def __init__(
        self,
        feature_configs: Sequence[config_lib.FeatureConfig],
        num_dense_features: int,
        bottom_stack: ModuleFactory = default_bottom_stack,
        feature_interaction: ModuleFactory = default_interaction,
        top_stack: ModuleFactory = default_top_stack,
        interaction_takes_list: bool = True,
        concat_dense: bool = True,
        size_threshold: Optional[int] = 10_000,
        task: Optional[ranking_task.Ranking] = None,
        device: device_lib.DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
        mesh=None,
        table_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        device = device_lib.resolve(device)
        self.feature_configs = tuple(feature_configs)
        self.num_dense_features = num_dense_features
        self.interaction_takes_list = interaction_takes_list
        self.concat_dense = concat_dense
        self.task = task or ranking_task.Ranking()
        self.embedding = partial_lib.PartialEmbedding(
            self.feature_configs, size_threshold=size_threshold,
            device=device, dtype=table_dtype, generator=generator,
            mesh=mesh)
        self.bottom = bottom_stack(num_dense_features, device, generator)
        with torch.no_grad():
            dense = self.bottom(torch.zeros(1, num_dense_features,
                                            device=device))
            probe = [torch.zeros(1, fc.table.dim, device=device)
                     for fc in self.feature_configs] + [dense]
            width = (dense.shape[-1] if interaction_takes_list
                     else sum(x.shape[-1] for x in probe))
            self.interaction_width = width
            self.interaction = feature_interaction(width, device, generator)
            out = self._interact(probe)
        self.top = top_stack(
            out.shape[-1] + (dense.shape[-1] if concat_dense else 0), device,
            generator)

    def _interact(self, features: Sequence[Tensor]) -> Tensor:
        if self.interaction_takes_list:
            return self.interaction(list(features))
        return self.interaction(torch.cat(list(features), dim=-1))

    def forward(self, batch: Mapping[str, Any],
                training: bool = False) -> Tensor:
        """`[B]` click probabilities (the top stack's output)."""
        with profiling.annotate("ranking.forward"):
            return torch.reshape(self.top(self._top_input(batch)), (-1,))

    def logits(self, batch: Mapping[str, Any]) -> Tensor:
        """`[B]` logits: the top stack's output before its final
        activation (its `logits`), through the modules `forward` runs; a
        captured graph's replay where one holds the batch's row count."""
        head = getattr(self.top, "logits", None)
        if head is None:
            raise TypeError(f"the top stack ({type(self.top).__name__}) "
                            "has no `logits`: its pre-activation output is "
                            "not known")
        with profiling.annotate("ranking.forward"):
            replayed = self._replay(batch)
            if replayed is not None:
                return replayed
            return torch.reshape(head(self._top_input(batch)), (-1,))

    def capture(self, rows: Iterable[int]) -> None:
        """Records the dense stack on the card in one CUDA graph per row
        count of `rows` (replacing any graphs captured before), for
        `logits` to replay. The graphs read one static `x0` and
        dense-feature buffer of the largest row count and share one
        memory pool, so `logits` replays them one call at a time (a
        lock) on the stream current here; a call on another stream
        takes the eager path. A DCN-style model without `concat_dense`,
        on CUDA."""
        if self.interaction_takes_list or self.concat_dense:
            raise ValueError("capture takes a DCN-style model "
                             "(interaction_takes_list=False) without "
                             "concat_dense")
        rows = sorted({int(r) for r in rows})
        device = next(self.parameters()).device
        if device.type != "cuda" or not rows or rows[0] < 1:
            raise ValueError(f"capture needs CUDA weights and row counts "
                             f"of at least 1; got {device}, {rows[:3]}")
        self._captured = None
        x0 = torch.zeros((rows[-1], self.interaction_width), device=device)
        dense = torch.zeros((rows[-1], self.num_dense_features),
                            device=device)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        graphs = {}
        with torch.no_grad():
            for r in rows:
                side.wait_stream(stream)
                with torch.cuda.stream(side):   # cuBLAS's lazy set-up
                    self._dense_logits(x0[:r], dense[:r])
                stream.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    out = self._dense_logits(x0[:r], dense[:r])
                graphs[r] = (graph, out)
        self._captured = _Captured(graphs, x0, dense, device.index,
                                   stream.cuda_stream, threading.Lock())

    _captured = None

    def _replay(self, batch: Mapping[str, Any]) -> Optional[Tensor]:
        """The captured graph's logits for `batch`, or None where nothing
        is captured for its row count or the current stream, or a feature
        does not pool."""
        captured = self._captured
        if captured is None:
            return None
        rows = batch["dense_features"].shape[0]
        entry = captured.graphs.get(rows)
        if entry is None or torch._C._cuda_getCurrentRawStream(
                captured.device) != captured.stream:
            return None
        graph, out = entry
        with captured.lock:
            with profiling.annotate("ranking.lookup"):
                if self.embedding.pooled(self._features(batch),
                                         out=captured.x0[:rows]) is None:
                    return None
            with profiling.annotate("ranking.dense"):
                captured.dense[:rows].copy_(batch["dense_features"])
                graph.replay()
                return out.clone()   # the next replay rewrites `out`

    def _dense_logits(self, x0: Tensor, dense_features: Tensor) -> Tensor:
        """The dense stack over a pooled `x0` whose last columns take the
        bottom MLP's output: `[B]` logits."""
        dense = self.bottom(dense_features)
        x0[:, x0.shape[1] - dense.shape[1]:] = dense
        return torch.reshape(self.top.logits(self.interaction(x0)), (-1,))

    def _features(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """The sparse features in config order (the dense one goes last)."""
        missing = [fc.name for fc in self.feature_configs
                   if fc.name not in batch]
        if missing:
            raise KeyError(
                f"Batch is missing sparse features {missing}; expected one "
                f"entry per FeatureConfig "
                f"({[fc.name for fc in self.feature_configs]})."
            )
        return {fc.name: batch[fc.name] for fc in self.feature_configs}

    def _top_input(self, batch: Mapping[str, Any]) -> Tensor:
        with profiling.annotate("ranking.lookup"):
            embeddings = self.embedding(self._features(batch))
        with profiling.annotate("ranking.dense"):
            dense = self.bottom(batch["dense_features"])
            sparse = [embeddings[fc.name] for fc in self.feature_configs]
            out = self._interact(sparse + [dense])
            if self.concat_dense:
                out = torch.cat([dense, out], dim=-1)
            return out

    def shard_tasks(self, mesh, axis: str) -> None:
        """The ranking task computes its loss over the gathered batch
        (see `models.Model.shard_tasks`)."""
        self.task = self.task.on_mesh(mesh, axis)

    def compute_loss(
        self, batch: Mapping[str, Any], training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Dict[str, Any]]:
        predictions = self(batch, training=training)
        out = self.task(batch["clicked"], predictions,
                        sample_weight=batch.get("sample_weight"))
        return out.loss, {"ranking": out}

    # --- Metrics (AUC + accuracy + label / prediction means,
    #     experimental/models/ranking.py:111-127) -----------------------

    def metrics(self) -> Dict[str, metrics_base.Metric]:
        return {
            "auc": metrics_base.AUC(),
            "accuracy": metrics_base.BinaryAccuracy(),
            "label_mean": metrics_base.Mean(),
            "prediction_mean": metrics_base.Mean(),
        }

    def update_metrics(self, states, batch, aux):
        out: ranking_task.RankingOutput = aux["ranking"]
        m = self.metrics()
        weight = batch.get("sample_weight")
        labels, predictions = out.labels, out.predictions.detach()
        return {
            "auc": m["auc"].update(states["auc"], labels, predictions,
                                   weight),
            "accuracy": m["accuracy"].update(states["accuracy"], labels,
                                             predictions, weight),
            "label_mean": m["label_mean"].update(states["label_mean"],
                                                 labels, weight),
            "prediction_mean": m["prediction_mean"].update(
                states["prediction_mean"], predictions, weight),
        }


def embedding_param_labels(model: nn.Module) -> Dict[str, str]:
    """`"embedding"` for every parameter under a module named
    `embedding`, `"dense"` for the rest, by `named_parameters` name."""
    return {
        name: ("embedding" if "embedding" in name.split(".") else "dense")
        for name, _ in model.named_parameters()
    }
