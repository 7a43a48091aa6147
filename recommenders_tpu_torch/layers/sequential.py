"""Sequence encoders for sequential retrieval towers.

Port of `recommenders_tpu/layers/sequential.py`:

  - `GRUEncoder`: masked GRU over `[B, L, D]` inputs, returning the final
    hidden state. Padded positions hold the carry wherever they fall in
    the history, so the cell runs step by step (`nn.GRUCell` in a loop
    over L with `torch.where`), not as a packed `nn.GRU`, which assumes
    the padding at the end.
  - `SelfAttentionEncoder`: one pre-LN transformer block (multi-head
    attention + FFN) with masked mean pooling.

Both take a boolean validity mask (True = real position), the `PAD_ID`
convention of the embedding layers. Weights are drawn as flax draws its
defaults (lecun-normal kernels, orthogonal recurrent kernels, zero
biases) from an optional generator; `utils.convert` carries a flax
model's weights across.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor


def _zero_rz_grads(grad: Tensor) -> Tensor:
    """Flax's GRU cell has no recurrent bias on the r and z gates; their
    rows of `bias_hh` stay at zero because their gradient is zeroed."""
    grad = grad.clone()
    grad[: 2 * grad.shape[0] // 3] = 0.0
    return grad


class GRUEncoder(nn.Module):
    """Masked GRU encoder: `[B, L, D] → [B, units]` (final state).

    Flax's `GRUCell` computes r = σ(W_ir x + b_ir + W_hr h), z likewise,
    n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn)); `nn.GRUCell` is the
    same cell with two more biases, on the recurrent r and z terms, which
    are held at zero (their gradient is zeroed), so both cells train
    alike.

    Args:
      input_dim: Width D of the inputs.
      units: Hidden width.
      device: Where the weights live (default CUDA).
      generator: Optional `torch.Generator` for the initial weights.
    """

    def __init__(
        self,
        input_dim: int,
        units: int,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.units = units
        self.cell = nn.GRUCell(input_dim, units,
                               device=device_lib.resolve(device))
        self.cell.bias_hh.register_hook(_zero_rz_grads)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """Flax's `GRUCell` defaults: lecun-normal input kernels,
        orthogonal recurrent kernels (one per gate), zero biases."""
        h = self.units
        for g in range(3):
            rows = slice(g * h, (g + 1) * h)
            blocks.lecun_normal_(self.cell.weight_ih[rows], generator)
            nn.init.orthogonal_(self.cell.weight_hh[rows], generator=generator)
        nn.init.zeros_(self.cell.bias_ih)
        nn.init.zeros_(self.cell.bias_hh)

    def forward(self, inputs: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        if inputs.dim() != 3:
            raise ValueError(
                f"GRUEncoder expects [B, L, D] inputs, got "
                f"{tuple(inputs.shape)}."
            )
        batch, length = inputs.shape[:2]
        carry = inputs.new_zeros((batch, self.units))
        for t in range(length):
            new_carry = self.cell(inputs[:, t], carry)
            if mask is None:
                carry = new_carry
            else:
                # Padded steps pass the carry through unchanged.
                carry = torch.where(mask[:, t, None], new_carry, carry)
        return carry


class _Attention(nn.Module):
    """Flax's `MultiHeadDotProductAttention` (self-attention, no dropout):
    per-head queries scaled by 1/sqrt(head_dim), masked logits filled
    with the dtype's least value, softmax, output projection."""

    def __init__(self, dim: int, num_heads: int, device) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = (
            nn.Linear(dim, dim, device=device) for _ in range(4))

    def forward(self, x: Tensor, mask: Tensor) -> Tensor:
        b, l, d = x.shape
        heads, head_dim = self.num_heads, d // self.num_heads

        def split(t):
            return t.reshape(b, l, heads, head_dim)

        q = split(self.query(x)) / head_dim ** 0.5
        k, v = split(self.key(x)), split(self.value(x))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        # Fill, not -inf: a row with no valid key attends uniformly, as
        # in flax (SDPA would return NaN there).
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(b, l, d))


class SelfAttentionEncoder(nn.Module):
    """One pre-LN transformer block + masked mean pooling:
    `[B, L, D] → [B, out_dim]`.

    Args:
      dim: Width D of the inputs (a multiple of `num_heads`).
      num_heads: Attention heads.
      mlp_dim: FFN inner width; defaults to `4 × D`.
      out_dim: Output width; defaults to `D` (else a last projection).
      device: Where the weights live (default CUDA).
      generator: Optional `torch.Generator` for the initial weights.
    """

    def __init__(
        self,
        dim: int,
        num_heads: int = 4,
        mlp_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = device_lib.resolve(device)
        if dim % num_heads:
            raise ValueError(
                f"dim ({dim}) must be a multiple of num_heads ({num_heads})")
        self.dim = dim
        self.num_heads = num_heads
        mlp_dim = mlp_dim or 4 * dim
        out_dim = out_dim or dim
        # Flax's LayerNorm epsilon.
        self.layer_norm_0 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.layer_norm_1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.attention = _Attention(dim, num_heads, device)
        self.dense_0 = nn.Linear(dim, mlp_dim, device=device)
        self.dense_1 = nn.Linear(mlp_dim, dim, device=device)
        self.dense_2 = (nn.Linear(dim, out_dim, device=device)
                        if out_dim != dim else None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """Flax's defaults: lecun-normal kernels (fan-in D for every
        attention projection), zero biases, unit LayerNorm scales."""
        linears = [self.attention.query, self.attention.key,
                   self.attention.value, self.attention.out, self.dense_0,
                   self.dense_1] + ([self.dense_2] if self.dense_2 else [])
        for layer in linears:
            blocks.lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
        for norm in (self.layer_norm_0, self.layer_norm_1):
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def forward(self, inputs: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        if inputs.dim() != 3:
            raise ValueError(
                f"SelfAttentionEncoder expects [B, L, D] inputs, got "
                f"{tuple(inputs.shape)}."
            )
        b, l, _ = inputs.shape
        if mask is None:
            mask = torch.ones((b, l), dtype=torch.bool, device=inputs.device)
        attn_mask = mask[:, None, None, :] & mask[:, None, :, None]
        x = inputs
        x = x + self.attention(self.layer_norm_0(x), attn_mask)
        y = self.dense_1(torch.relu(self.dense_0(self.layer_norm_1(x))))
        x = x + y
        # Masked mean pool over valid positions.
        w = mask.to(x.dtype)[..., None]
        pooled = torch.sum(x * w, dim=1) / torch.clamp(torch.sum(w, dim=1),
                                                       min=1e-12)
        if self.dense_2 is not None:
            pooled = self.dense_2(pooled)
        return pooled
