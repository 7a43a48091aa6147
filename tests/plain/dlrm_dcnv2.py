"""A plain DLRM-DCNv2 forward pass for the tier-1 tests.

Plain `torch` in f32, with no kernel, cache or batching, written apart
from both the port and the benchmark's reference
(`portbench/reference/ranking.py`): it imports neither JAX nor
`recommenders_tpu_torch` nor `portbench`. Pooling is
`F.embedding_bag(mode="sum")` over the tables widened to f32, each pad
weighted 0; the dense layers are `F.linear`. Weights come in by the
benchmark reference's names (`bottom.<i>.weight`, `cross.<l>.u.weight`,
`cross.<l>.v.weight` / `.bias`, `top.<i>.weight`, ...), and x0 is the
pooled rows and then the bottom output, as there.
"""

from typing import Dict, List

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _stack(x: Tensor, weights: Dict[str, Tensor], name: str, layers: int,
           last_relu: bool) -> Tensor:
    for i in range(layers):
        x = F.linear(x, weights[f"{name}.{i}.weight"],
                     weights[f"{name}.{i}.bias"])
        if i < layers - 1 or last_relu:
            x = F.relu(x)
    return x


def logits(tables: List[Tensor], weights: Dict[str, Tensor],
           ids: List[Tensor], dense: Tensor, bottom_layers: int,
           cross_layers: int, top_layers: int) -> Tensor:
    """`[S]` logits: `tables[t]` `[rows, dim]`, `ids[t]` `[S, bag]` (-1
    pads, other negative ids read row 0), `dense` `[S, features]`."""
    with torch.no_grad():
        pooled = [F.embedding_bag(x.clamp(min=0), t.float(), mode="sum",
                                  per_sample_weights=(x != -1).float())
                  for t, x in zip(tables, ids)]
        bottom = _stack(dense.float(), weights, "bottom", bottom_layers,
                        last_relu=True)
        x0 = torch.cat(pooled + [bottom], dim=1)
        x = x0
        for layer in range(cross_layers):
            inner = F.linear(x, weights[f"cross.{layer}.u.weight"])
            x = x0 * F.linear(inner, weights[f"cross.{layer}.v.weight"],
                              weights[f"cross.{layer}.v.bias"]) + x
        return _stack(x, weights, "top", top_layers, last_relu=False)[:, 0]
