"""The least work of a DLRM-DCNv2 request, counted from the configuration
and the request's ids, never from the port's plans, and the symbol of
the port's pooled-lookup kernel, which the ranking metrics match
themselves (`yardstick.KERNELS` names the index kernels alone).

- Pooled lookup: each id read once (at its dtype's size), each distinct
  (table, row) of the request read once (`embedding_dim` values of the
  table's dtype: a Zipf-hot row read by many bags hits L2, so a per-id
  count could read past 100 %), and `[S, 26, dim]` f32 written once, at
  the HBM rate (3.35 TB/s).
- Dense layers: 2 × the multiply-adds of the bottom MLP, the three
  low-rank cross layers and the top MLP a pair, against the f32 CUDA
  cores' 67 TFLOP/s (the configuration keeps TF32 off).
"""

from __future__ import annotations

import re
from typing import List

import torch

from portbench import yardstick

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, at 700 W.
PEAK_F32_FLOPS = 67e12

# `csrc/pooled_lookup.cu`'s kernel, as the profiler names it.
POOL_KERNEL = re.compile(r"(?<![A-Za-z0-9_])pooled_lookup_kernel")


def is_pool_kernel(name: str) -> bool:
    return POOL_KERNEL.search(name) is not None


def dense_flops_per_pair(config: dict) -> int:
    """2 × the multiply-adds of one pair through the dense layers."""
    macs = 0
    widths = [config["dense_features"]] + list(config["bottom_mlp"])
    macs += sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    x0 = (len(config["vocab_sizes"]) * config["embedding_dim"]
          + config["bottom_mlp"][-1])
    macs += config["cross_layers"] * 2 * x0 * config["cross_rank"]
    widths = [x0] + list(config["top_mlp"])
    macs += sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return 2 * macs


def pool_bytes(config: dict, ids: List[torch.Tensor]) -> int:
    """The pooled lookup's least bytes for one request: its ids, each
    distinct row of each table once, the f32 sums written once. `ids`:
    one `[S, bag]` tensor a feature, feature t reading table t."""
    row = config["embedding_dim"] * torch.empty(
        (), dtype=getattr(torch, config["table_dtype"])).element_size()
    pairs = ids[0].shape[0]
    total = 0
    for x in ids:
        total += x.numel() * x.element_size()
        total += torch.unique(x[x >= 0]).numel() * row
    return total + pairs * len(ids) * config["embedding_dim"] * 4


def request_work(config: dict, ids: List[torch.Tensor]) -> dict:
    """A request's least work: the pooled lookup's bytes and their time,
    and the dense layers' operations."""
    nbytes = pool_bytes(config, ids)
    return {"pool_bytes": nbytes,
            "pool_least_s": nbytes / yardstick.HBM_BYTES_PER_S,
            "flops": dense_flops_per_pair(config) * ids[0].shape[0]}
