"""Feature preprocessing: normalization, discretization, text tokens.

Port of `recommenders_tpu/data/preprocessing.py`: counterparts of the
Keras preprocessing layers the reference's featurization tutorial builds
towers from (`docs/examples/featurization.ipynb`): `Normalization`,
`Discretization` and `TextVectorization` (`StringLookup` is covered by
`data.vocab` and `Hashing` by `ops.hashing`). The adapt() step runs on
the host over NumPy; the transforms are plain arithmetic and
searchsorted over static state.

Each transform keeps both of the JAX module's branches. A tensor (on any
device) follows its `jax.Array` branch, in float32; anything else
follows its NumPy branch (`Discretizer` there compares in float64). The
two branches can disagree on a value within a float32 ulp of an edge,
and do so as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

# TextVectorizer id layout, matching Keras TextVectorization: 0 is the
# padding/mask id, 1 is out-of-vocabulary, real tokens start at 2.
PAD_ID = 0
TEXT_OOV_ID = 1

_PUNCTUATION = re.compile(r"[!-/:-@\[-`{-~]")


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Standardizes continuous features to zero mean / unit variance.

    Counterpart of `tf.keras.layers.Normalization` as adapted over the
    timestamp feature in `featurization.ipynb`. A tensor is standardized
    in float32 on its own device.
    """

    mean: float
    std: float

    @classmethod
    def adapt(cls, values) -> "Normalizer":
        arr = np.asarray(values, dtype=np.float64)
        std = float(arr.std())
        return cls(mean=float(arr.mean()), std=std if std > 0.0 else 1.0)

    def __call__(self, x):
        if isinstance(x, torch.Tensor):
            return (x.to(torch.float32) - self.mean) / self.std
        return (np.asarray(x, np.float32) - self.mean) / np.float32(
            self.std
        )


@dataclasses.dataclass(frozen=True)
class Discretizer:
    """Maps continuous values to quantile-bucket ids.

    Counterpart of `tf.keras.layers.Discretization` with adapted bin
    boundaries (`featurization.ipynb` buckets timestamps into 1000
    bins). Bucket id = number of boundaries <= x, i.e. values below the
    first boundary map to 0 and above the last to `num_bins - 1`.
    """

    boundaries: Tuple[float, ...]

    @property
    def num_bins(self) -> int:
        return len(self.boundaries) + 1

    @classmethod
    def adapt(cls, values, num_bins: int) -> "Discretizer":
        if num_bins < 2:
            raise ValueError(f"num_bins must be >= 2, got {num_bins}")
        arr = np.asarray(values, dtype=np.float64)
        qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
        edges = np.unique(np.quantile(arr, qs))
        return cls(boundaries=tuple(float(e) for e in edges))

    def __call__(self, x):
        if isinstance(x, torch.Tensor):
            edges = torch.tensor(self.boundaries, dtype=torch.float32,
                                 device=x.device)
            return torch.searchsorted(
                edges, x.to(torch.float32), right=True
            ).to(torch.int32)
        edges = np.asarray(self.boundaries, np.float64)
        return np.searchsorted(
            edges, np.asarray(x, np.float64), side="right"
        ).astype(np.int32)


def standardize(text: str) -> str:
    """Keras TextVectorization's default `lower_and_strip_punctuation`."""
    return _PUNCTUATION.sub("", text.lower())


def tokenize(text: str) -> list:
    """Whitespace split after standardization (the Keras default)."""
    return standardize(text).split()


@dataclasses.dataclass(frozen=True)
class TextVectorizer:
    """Raw strings -> fixed-length int32 token-id matrices.

    Counterpart of `tf.keras.layers.TextVectorization` as used on movie
    titles in `featurization.ipynb`: lowercase + strip punctuation +
    whitespace split, frequency-ordered vocabulary, id 0 = padding,
    id 1 = OOV. Tokenization happens on the host; the output feeds an
    embedding and a `masked_mean` pool on the device.
    """

    vocabulary: Tuple[str, ...]

    @property
    def vocab_size(self) -> int:
        """Total ids including padding and OOV (rows an embedding needs)."""
        return len(self.vocabulary) + 2

    @classmethod
    def adapt(
        cls,
        texts: Iterable[str],
        max_tokens: Optional[int] = None,
    ) -> "TextVectorizer":
        """Builds a frequency-ordered vocabulary (ties: first seen).

        `max_tokens` counts the padding and OOV ids, mirroring Keras'
        `max_tokens` semantics (so at most `max_tokens - 2` real tokens
        are kept).
        """
        counts: dict = {}
        for text in texts:
            for token in tokenize(_as_str(text)):
                counts[token] = counts.get(token, 0) + 1
        ordered = sorted(
            counts, key=lambda t: counts[t], reverse=True
        )
        if max_tokens is not None:
            if max_tokens < 3:
                raise ValueError(
                    f"max_tokens must be >= 3 (2 ids are reserved for "
                    f"padding and OOV), got {max_tokens}"
                )
            ordered = ordered[: max_tokens - 2]
        return cls(vocabulary=tuple(ordered))

    def __call__(
        self, texts: Sequence[str], sequence_length: int
    ) -> np.ndarray:
        """Encodes to a `[len(texts), sequence_length]` int32 matrix,
        truncated / zero-padded on the right."""
        index = {t: i + 2 for i, t in enumerate(self.vocabulary)}
        out = np.full(
            (len(texts), sequence_length), PAD_ID, dtype=np.int32
        )
        for row, text in enumerate(texts):
            tokens = tokenize(_as_str(text))[:sequence_length]
            for col, token in enumerate(tokens):
                out[row, col] = index.get(token, TEXT_OOV_ID)
        return out


def masked_mean(embeddings: torch.Tensor,
                token_ids: torch.Tensor) -> torch.Tensor:
    """Mean-pools token embeddings, ignoring padding positions.

    Counterpart of `GlobalAveragePooling1D` over a mask-propagating
    `Embedding(mask_zero=True)` (`featurization.ipynb`'s title-text
    tower). All-padding rows pool to zero.

    Args:
      embeddings: `[..., L, D]` token embeddings.
      token_ids: `[..., L]` ids that produced them; `PAD_ID` is masked.
    """
    mask = (token_ids != PAD_ID).to(embeddings.dtype)[..., None]
    total = torch.sum(embeddings * mask, dim=-2)
    denom = torch.clamp(torch.sum(mask, dim=-2), min=1.0)
    return total / denom


def _as_str(text) -> str:
    if isinstance(text, bytes):
        return text.decode("utf-8")
    return str(text)
