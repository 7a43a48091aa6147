"""Two-tower retrieval model: the serving half.

Port of `recommenders_tpu/models/retrieval.py`: `EmbeddingTower`
(`:41-69`) and the parts of `TwoTowerRetrieval` that serving runs —
`query_embeddings`, `candidate_embeddings` and `_tower_input`
(`:180-192`). The loss, the batch metrics, `SequenceTower` and
`make_corpus_eval_step` come with the training slice.

Flax modules take factories and build their towers in `setup`; here the
towers are `nn.Module`s handed to the model. Weights of a flax model
carry across with `utils.convert`.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from recommenders_tpu_torch.layers import blocks
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
    """Two-tower retrieval model (serving half).

    Args:
      query_tower: Module mapping the query input to embeddings.
      candidate_tower: Module mapping the candidate input to embeddings.
      query_key: Batch key feeding the query tower; a tuple of keys passes
        the tower a sub-dict.
      candidate_key: Batch key feeding the candidate tower (or a tuple).
    """

    def __init__(
        self,
        query_tower: nn.Module,
        candidate_tower: nn.Module,
        query_key: Key = "user_id",
        candidate_key: Key = "movie_id",
    ) -> None:
        super().__init__()
        self.query_tower = query_tower
        self.candidate_tower = candidate_tower
        self.query_key = query_key
        self.candidate_key = candidate_key

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
