"""Low-level ops: top-k primitives, quantization, salted hashing, and the
kernels' wrappers (scoring K3, sparse apply K1, fused retrieval CE K2,
leaf scoring K4 and K5)."""

from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops import fused_retrieval
from recommenders_tpu_torch.ops import hashing
from recommenders_tpu_torch.ops import leaf_scoring
from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.ops import sparse_apply
from recommenders_tpu_torch.ops import topk

__all__ = ["cuda_build", "fused_retrieval", "hashing", "leaf_scoring",
           "quantization", "scoring", "sparse_apply", "topk"]
