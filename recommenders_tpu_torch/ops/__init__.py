"""Low-level ops: top-k primitives, quantization, scoring kernels."""

from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.ops import topk

__all__ = ["cuda_build", "quantization", "scoring", "topk"]
