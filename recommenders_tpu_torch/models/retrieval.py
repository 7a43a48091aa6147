"""Two-tower retrieval model.

Port of `recommenders_tpu/models/retrieval.py`: `EmbeddingTower`
(`:41-69`) and `TwoTowerRetrieval`'s `query_embeddings`,
`candidate_embeddings`, `_tower_input` (`:180-192`) and `compute_loss`
(`:194-243`) with the retrieval task. The batch metrics, `SequenceTower`
and `make_corpus_eval_step` come with the slice that ports `metrics/`
and `models/base.py`.

Flax modules take factories and build their towers in `setup`; here the
towers are `nn.Module`s handed to the model. Weights of a flax model
carry across with `utils.convert`.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.tasks import retrieval as retrieval_task
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor
Key = Union[str, Tuple[str, ...]]


class EmbeddingTower(nn.Module):
    """Scalar-id tower: embedding lookup plus an optional MLP head.

    Negative ids (padding) are clamped to row 0, as in the JAX tower.
    The embedding is initialised like the JAX package's default:
    truncated normal with standard deviation `1/sqrt(embedding_dim)`.

    Args:
      vocab_size: Id vocabulary.
      embedding_dim: Embedding width.
      mlp_units: Optional dense stack on top (output width = last entry).
      device: Where the weights live (default CUDA).
      generator: Optional `torch.Generator` for the initial weights.
    """

    def __init__(
        self,
        vocab_size: int,
        embedding_dim: int,
        mlp_units: Sequence[int] = (),
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = device_lib.resolve(device)
        self.embedding = nn.Embedding(vocab_size, embedding_dim, device=device)
        self.mlp = (
            blocks.MLP(embedding_dim, tuple(mlp_units), device=device)
            if mlp_units else None
        )
        self.reset_parameters(generator)

    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        blocks.truncated_normal_(
            self.embedding.weight, self.embedding.embedding_dim ** -0.5,
            generator,
        )
        if self.mlp is not None:
            self.mlp.reset_parameters(generator)

    def forward(self, ids: Tensor) -> Tensor:
        x = self.embedding(torch.clamp(ids, min=0))
        if self.mlp is not None:
            x = self.mlp(x)
        return x


class TwoTowerRetrieval(nn.Module):
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
      fused: Compute the loss with the flash-CE kernel K2.
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
    ) -> None:
        super().__init__()
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
