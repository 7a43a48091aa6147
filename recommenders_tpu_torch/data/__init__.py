"""Data utilities: synthetic MovieLens, batching, vocab, preprocessing,
native loader (port of `recommenders_tpu/data/`)."""

from recommenders_tpu_torch.data import preprocessing
from recommenders_tpu_torch.data import vocab
from recommenders_tpu_torch.data.movielens import SyntheticMovieLens
from recommenders_tpu_torch.data.movielens import batched
from recommenders_tpu_torch.data.movielens import evaluate
from recommenders_tpu_torch.data.movielens import load_movielens
from recommenders_tpu_torch.data.movielens import sample_listwise
from recommenders_tpu_torch.data.movielens import synthetic_movielens
from recommenders_tpu_torch.data.native_loader import NativeBatcher
from recommenders_tpu_torch.data.native_loader import batched_native_or_python
from recommenders_tpu_torch.data.native_loader import native_available

__all__ = [
    "NativeBatcher",
    "SyntheticMovieLens",
    "batched",
    "batched_native_or_python",
    "evaluate",
    "load_movielens",
    "native_available",
    "preprocessing",
    "sample_listwise",
    "synthetic_movielens",
    "vocab",
]
