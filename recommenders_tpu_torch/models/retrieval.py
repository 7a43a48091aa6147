"""Prebuilt two-tower retrieval models (sequential towers included).

Port of `recommenders_tpu/models/retrieval.py`:

  - `EmbeddingTower`: id → embedding → optional MLP.
  - `SequenceTower`: `[B, L]` padded id history → embeddings → GRU or
    self-attention encoder → optional MLP.
  - `TwoTowerRetrieval`: two towers feeding the retrieval task, with
    in-batch top-k accuracy metrics, trained by `models.Trainer`.
  - `make_corpus_eval_step` and `evaluate_with_corpus_metrics`:
    corpus-level `FactorizedTopK` evaluation against an index built from
    `candidate_embeddings()`.

Flax modules take factories and build their towers in `setup`; here the
towers are `nn.Module`s handed to the model. Weights of a flax model
carry across with `utils.convert`.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.layers import factorized_top_k as ftk
from recommenders_tpu_torch.layers import sequential as sequential_lib
from recommenders_tpu_torch.metrics import base as metrics_base
from recommenders_tpu_torch.metrics import factorized_top_k as ftk_metric
from recommenders_tpu_torch.models import base as models_base
from recommenders_tpu_torch.tasks import retrieval as retrieval_task
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor
Key = Union[str, Tuple[str, ...]]

PAD_ID = config_lib.PAD_ID


class EmbeddingTower(nn.Module):
    """Scalar-id tower: embedding lookup plus an optional MLP head.

    Negative ids (padding) are clamped to row 0, as in the JAX tower.

    Args:
      vocab_size: Id vocabulary.
      embedding_dim: Embedding width.
      mlp_units: Optional dense stack on top (output width = last entry,
        `out_features`).
      device: Where the weights live (default CUDA).
      generator: Optional `torch.Generator` for the initial weights.
      embedding_init: Optional `(weight, generator)` callable that fills
        the `[vocab_size, embedding_dim]` table in place (the JAX tower's
        `embedding_init`). Defaults to the JAX package's default:
        truncated normal with standard deviation `1/sqrt(embedding_dim)`.
    """

    def __init__(
        self,
        vocab_size: int,
        embedding_dim: int,
        mlp_units: Sequence[int] = (),
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
        embedding_init: Optional[Callable[
            [Tensor, Optional[torch.Generator]], object]] = None,
    ) -> None:
        super().__init__()
        device = device_lib.resolve(device)
        self.embedding_init = embedding_init
        self.embedding = nn.Embedding(vocab_size, embedding_dim, device=device)
        self.mlp = (
            blocks.MLP(embedding_dim, tuple(mlp_units), device=device)
            if mlp_units else None
        )
        self.out_features = mlp_units[-1] if mlp_units else embedding_dim
        self.reset_parameters(generator)

    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        if self.embedding_init is None:
            blocks.truncated_normal_(
                self.embedding.weight, self.embedding.embedding_dim ** -0.5,
                generator,
            )
        else:
            with torch.no_grad():
                self.embedding_init(self.embedding.weight, generator)
        if self.mlp is not None:
            self.mlp.reset_parameters(generator)

    def forward(self, ids: Tensor) -> Tensor:
        x = self.embedding(torch.clamp(ids, min=0))
        if self.mlp is not None:
            x = self.mlp(x)
        return x


class SequenceTower(nn.Module):
    """History tower: padded `[B, L]` ids → encoder → embedding.

    Positions holding `PAD_ID` are masked: their embeddings are zeroed
    and the encoder skips them.

    Args:
      vocab_size: Id vocabulary.
      embedding_dim: Item-embedding width (also the output width unless
        an MLP head is configured).
      encoder: `"gru"` or `"attention"`.
      encoder_units: Encoder output width (defaults to `embedding_dim`).
      mlp_units: Optional dense stack on top (its last entry, else
        `encoder_units`, is `out_features`).
      device: Where the weights live (default CUDA).
      generator: Optional `torch.Generator` for the initial weights.
    """

    def __init__(
        self,
        vocab_size: int,
        embedding_dim: int,
        encoder: str = "gru",
        encoder_units: Optional[int] = None,
        mlp_units: Sequence[int] = (),
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = device_lib.resolve(device)
        units = encoder_units or embedding_dim
        self.embedding = nn.Embedding(vocab_size, embedding_dim, device=device)
        blocks.truncated_normal_(self.embedding.weight,
                                 embedding_dim ** -0.5, generator)
        if encoder == "gru":
            self.encoder = sequential_lib.GRUEncoder(
                embedding_dim, units, device=device, generator=generator)
        elif encoder == "attention":
            self.encoder = sequential_lib.SelfAttentionEncoder(
                embedding_dim, out_dim=units, device=device,
                generator=generator)
        else:
            raise ValueError(
                f"encoder must be 'gru' or 'attention', got {encoder!r}")
        self.mlp = None
        if mlp_units:
            self.mlp = blocks.MLP(units, tuple(mlp_units), device=device)
            self.mlp.reset_parameters(generator)
        self.out_features = mlp_units[-1] if mlp_units else units

    def forward(self, ids: Tensor) -> Tensor:
        mask = ids != PAD_ID
        x = self.embedding(torch.clamp(ids, min=0))
        x = x * mask[..., None].to(x.dtype)
        x = self.encoder(x, mask)
        if self.mlp is not None:
            x = self.mlp(x)
        return x


class TwoTowerRetrieval(models_base.Model):
    """Two-tower retrieval model with in-batch sampled softmax.

    Batches carry `query_key` and `candidate_key` entries, and optionally
    `sample_weight` and `candidate_sampling_probability`.

    Args:
      query_tower: Module mapping the query input to embeddings.
      candidate_tower: Module mapping the candidate input to embeddings.
      query_key: Batch key feeding the query tower; a tuple of keys passes
        the tower a sub-dict.
      candidate_key: Batch key feeding the candidate tower (or a tuple);
        scalar ids there are the candidate ids for accidental hits.
      temperature: Softmax temperature.
      remove_accidental_hits: Mask in-batch negatives that share the
        positive's id.
      num_hard_negatives: Keep only this many top negatives in the loss.
      num_extra_negatives: In training, this many uniformly drawn
        candidate ids are embedded and appended as shared negatives.
      candidate_vocab_size: Id range for those draws.
      score_dtype: Optional dtype (`torch.bfloat16`) of the scoring
        inputs; scores stay f32.
      fused: Compute the loss with the flash-CE kernel K2. The `[B, C]`
        logits then never exist, and the batch metrics keep their
        initial states.
      batch_metric_ks: Cutoffs of the in-batch top-k accuracy metrics.
    """

    def __init__(
        self,
        query_tower: nn.Module,
        candidate_tower: nn.Module,
        query_key: Key = "user_id",
        candidate_key: Key = "movie_id",
        temperature: Optional[float] = None,
        remove_accidental_hits: bool = False,
        num_hard_negatives: Optional[int] = None,
        num_extra_negatives: int = 0,
        candidate_vocab_size: Optional[int] = None,
        score_dtype: Optional[torch.dtype] = None,
        fused: bool = False,
        batch_metric_ks: Tuple[int, ...] = (1, 10),
    ) -> None:
        super().__init__()
        self.batch_metric_ks = tuple(batch_metric_ks)
        self.query_tower = query_tower
        self.candidate_tower = candidate_tower
        self.query_key = query_key
        self.candidate_key = candidate_key
        self.num_extra_negatives = num_extra_negatives
        self.candidate_vocab_size = candidate_vocab_size
        self.task = retrieval_task.Retrieval(
            temperature=temperature,
            remove_accidental_hits=remove_accidental_hits,
            num_hard_negatives=num_hard_negatives,
            score_dtype=score_dtype,
            fused=fused,
        )

    @staticmethod
    def _tower_input(batch: Mapping, key: Key):
        if isinstance(key, tuple):
            return {k: batch[k] for k in key}
        return batch[key]

    def query_embeddings(self, batch: Mapping) -> Tensor:
        return self.query_tower(self._tower_input(batch, self.query_key))

    def candidate_embeddings(self, batch: Mapping) -> Tensor:
        return self.candidate_tower(
            self._tower_input(batch, self.candidate_key)
        )

    def shard_tasks(self, mesh, axis: str) -> None:
        """The retrieval task pools candidates across `axis` (see
        `models.Model.shard_tasks`)."""
        self.task = self.task.on_mesh(mesh, axis)

    def compute_loss(
        self,
        batch: Mapping,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, dict]:
        """`(loss, {"retrieval": RetrievalOutput})` of one batch.

        In training with `num_extra_negatives`, the extra negative ids are
        drawn uniformly from `[0, candidate_vocab_size)` with `generator`
        (on the model's device); they take a log-q of
        `num_extra_negatives / candidate_vocab_size` when the batch
        carries sampling probabilities.
        """
        q = self.query_embeddings(batch)
        c = self.candidate_embeddings(batch)
        candidate_ids = None
        if self.task.remove_accidental_hits:
            ids = batch[self.candidate_key]
            if ids.dim() != 1:
                raise ValueError(
                    "Accidental-hit removal needs scalar candidate ids; "
                    f"got shape {tuple(ids.shape)} for "
                    f"{self.candidate_key!r}."
                )
            candidate_ids = ids
        sampling_probability = batch.get("candidate_sampling_probability")
        if training and self.num_extra_negatives:
            if self.candidate_vocab_size is None:
                raise ValueError(
                    "num_extra_negatives requires candidate_vocab_size."
                )
            neg_ids = torch.randint(
                0, self.candidate_vocab_size, (self.num_extra_negatives,),
                generator=generator, device=c.device,
            )
            c = torch.cat([c, self.candidate_tower(neg_ids)], dim=0)
            if candidate_ids is not None:
                candidate_ids = torch.cat(
                    [candidate_ids, neg_ids.to(candidate_ids.dtype)]
                )
            if sampling_probability is not None:
                uniform = torch.full(
                    (self.num_extra_negatives,),
                    self.num_extra_negatives / self.candidate_vocab_size,
                    dtype=sampling_probability.dtype,
                    device=sampling_probability.device,
                )
                sampling_probability = torch.cat(
                    [sampling_probability, uniform]
                )
        out = self.task(
            q,
            c,
            sample_weight=batch.get("sample_weight"),
            candidate_sampling_probability=sampling_probability,
            candidate_ids=candidate_ids,
        )
        return out.loss, {"retrieval": out}

    def metrics(self) -> Dict[str, metrics_base.Metric]:
        return {
            f"batch_top_{k}_categorical_accuracy":
                metrics_base.TopKCategoricalAccuracy(k=k)
            for k in self.batch_metric_ks
        }

    def update_metrics(self, states, batch, aux):
        """The batch metrics read the FINAL logits and labels fed to the
        loss (after log-q correction, accidental-hit removal and
        hard-negative mining), as the reference's `update_state` does.
        Under `fused=True` there are no logits; the states stay as they
        were."""
        out: retrieval_task.RetrievalOutput = aux["retrieval"]
        if out.logits is None:
            return dict(states)
        weight = batch.get("sample_weight")
        return {
            name: metric.update(states[name], out.labels, out.logits, weight)
            for name, metric in self.metrics().items()
        }


def _true_id_key(model) -> str:
    key = model.candidate_key
    return key if isinstance(key, str) else key[0]


def make_corpus_eval_step(model, metric, candidate_key=None):
    """One corpus-eval step: embed → index → metric update.

    The JAX package jits the whole step into one dispatch
    (`recommenders_tpu/models/retrieval.py:274-318`); the port has no
    jit, so the step runs eagerly, without gradients, on the device of
    the index.

    Args:
      model: A `TwoTowerRetrieval`-contract model (`query_embeddings`
        and a scalar-id `candidate_key`).
      metric: A `FactorizedTopK` whose index is on the device.
      candidate_key: Batch key of the true candidate id; defaults to
        `model.candidate_key`.

    Returns:
      `step(metric_state, batch, corpus_embeddings) -> metric_state`.
      `corpus_embeddings` is the `[num_candidates, dim]` tensor the true
      candidates' embeddings are read from (the one the index was built
      from). The model's weights are its own, so the JAX step's `params`
      argument has no counterpart.
    """
    key = candidate_key or _true_id_key(model)

    @torch.no_grad()
    def step(mstate, batch, corpus_embeddings):
        batch = device_lib.to_device(batch, corpus_embeddings.device)[0]
        queries = model.query_embeddings(batch)
        true_ids = batch[key]
        true_embs = corpus_embeddings[true_ids.long()]
        return metric.update(mstate, queries, true_embs,
                             true_candidate_ids=true_ids)

    return step


@torch.no_grad()
def evaluate_with_corpus_metrics(
    trainer,
    state,
    eval_batches,
    candidate_batch,
    ks: Tuple[int, ...] = (1, 5, 10, 50, 100),
    index_factory=None,
    exclusions_key: Optional[str] = None,
):
    """Corpus-level `FactorizedTopK` evaluation of a trained two-tower
    model: embed the whole candidate corpus once, index it, then stream
    the evaluation batches through the index.

    Args:
      trainer: The `Trainer` holding the model.
      state: Its `TrainState` (the weights are the model's own).
      eval_batches: Zero-arg factory (or iterable) of evaluation batches.
      candidate_batch: Batch covering the FULL candidate corpus in corpus
        order (row i ↔ candidate id i), fed to the candidate tower.
      ks: Accuracy cutoffs.
      index_factory: `() -> TopK`; defaults to `BruteForce` on the
        model's device.
      exclusions_key: Optional batch key with `[B, E]` candidate ids to
        exclude per query (e.g. train-set watches).

    Returns:
      Dict of `factorized_top_k/top_K_categorical_accuracy` floats.
    """
    model = trainer.model
    device = trainer.device
    model.eval()
    candidates = model.candidate_embeddings(
        device_lib.to_device(candidate_batch, device)[0])
    index = (index_factory or (lambda: ftk.BruteForce(device=device)))()
    index.index(candidates)
    metric = ftk_metric.FactorizedTopK(candidates=index, ks=ks)
    mstate = metric.init()
    step = make_corpus_eval_step(model, metric)
    key = _true_id_key(model)
    batches = eval_batches() if callable(eval_batches) else eval_batches
    for batch in batches:
        if exclusions_key is None:
            mstate = step(mstate, batch, candidates)
            continue
        batch = device_lib.to_device(batch, device)[0]
        true_ids = batch[key]
        scores, ids = index.query_with_exclusions(
            model.query_embeddings(batch), batch[exclusions_key], k=max(ks))
        # Id-based accounting of the pre-queried results; MIN_FLOAT marks
        # padded or excluded slots.
        pad = scores <= ftk.MIN_FLOAT / 2
        match = ((true_ids[:, None] == ids) & ~pad).to(torch.float32)
        for k in ks:
            found = torch.clamp(match[:, :k].sum(1), 0.0, 1.0)
            mstate[k] = metric._mean.update(mstate[k], found)
    return {name: float(v) for name, v in metric.result(mstate).items()}
