"""Vocabulary utilities: string/int feature → dense id mapping.

The port's own copy of `recommenders_tpu/data/vocab.py` (pure NumPy, so
the two agree id for id). Tensors hold no strings, so the Keras
`StringLookup`/`IntegerLookup` adaptation step the reference tutorials
use (`docs/examples/basic_retrieval.ipynb`) happens on the host: build a
`Vocabulary` from raw values in first-seen order, map features to
contiguous ids before batching, and keep the inverse for serving-time
decoding. OOV maps to a dedicated id (0), matching Keras' default
mask/OOV head layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Union

import numpy as np

Value = Union[str, int, bytes]

OOV_ID = 0


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    """An immutable value ↔ dense-id mapping with one OOV bucket at id 0."""

    values: tuple

    @property
    def size(self) -> int:
        """Total ids including the OOV bucket (so `size` = rows needed)."""
        return len(self.values) + 1

    def _index(self) -> Dict[Value, int]:
        return {v: i + 1 for i, v in enumerate(self.values)}

    def encode(self, inputs) -> np.ndarray:
        """Maps raw values to ids; unknown values map to `OOV_ID`."""
        index = self._index()
        flat = np.asarray(inputs).reshape(-1)
        out = np.fromiter(
            (index.get(v.item() if hasattr(v, "item") else v, OOV_ID)
             for v in flat),
            dtype=np.int32,
            count=flat.shape[0],
        )
        return out.reshape(np.shape(inputs))

    def decode(self, ids) -> np.ndarray:
        """Maps ids back to values; `OOV_ID` decodes to `"[OOV]"`."""
        table = np.asarray(["[OOV]"] + [str(v) for v in self.values])
        return table[np.asarray(ids)]


def build_vocabulary(inputs: Iterable[Value]) -> Vocabulary:
    """Builds a vocabulary of unique values in first-seen order
    (the adapt() step of Keras lookup layers)."""
    seen: Dict[Value, None] = {}
    for v in np.asarray(list(inputs)).reshape(-1):
        key = v.item() if hasattr(v, "item") else v
        if key not in seen:
            seen[key] = None
    return Vocabulary(values=tuple(seen.keys()))


def encode_features(
    features: Dict[str, np.ndarray],
    vocabularies: Dict[str, Vocabulary],
) -> Dict[str, np.ndarray]:
    """Encodes every feature that has a vocabulary; passes others through."""
    return {
        name: (
            vocabularies[name].encode(value)
            if name in vocabularies
            else value
        )
        for name, value in features.items()
    }
