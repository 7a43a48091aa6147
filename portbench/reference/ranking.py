"""The plain reference of DLRM-DCNv2 serving: a request's logits from the
configuration and the seed alone, in plain PyTorch.

It imports neither JAX nor the JAX package nor anything of
`recommenders_tpu_torch`, and takes nothing the program made, weights
included: it redraws every weight itself, from generators that the
caller makes from (`--seed`, the tensor's salt) (`seeded(salt)`), by
the rule below, which the runner also follows to hand the program its
weights. A table the program stored below its stated dtype therefore
shows.

- Table t (the configuration's order) is drawn in blocks of
  `BLOCK_ROWS` rows, block b from salt `TABLE_SALT + t * 2**24 + b`: a
  unit normal truncated to ±2 (`nn.init.trunc_normal_`), divided by
  √dim in f32, rounded to the configuration's `table_dtype`. Only the
  vocabulary's rows are drawn; the last block is short.
- Dense tensor k of `dense_tensors` (bottom, cross, top, in order; each
  `nn.Linear`'s weight `[out, in]` then its bias) is U(-1/√fan_in,
  1/√fan_in), from salt `DENSE_SALT + k`, as `nn.Linear` draws its own.

A request is one query of S pairs: each sparse feature's ids `[S, bag]`
(-1 pads; a negative id reads row 0) and `[S, dense]` dense features.
Pooling sums each bag's rows in f32 (`torch.sum`, in its own order);
the bottom MLP (ReLU after every layer), three DCN-v2 low-rank cross
layers x_{l+1} = x0 ⊙ (V_l(U_l x_l) + b_l) + x_l, and the top MLP (ReLU
between, none after the last) run in f32 with TF32 off. The logit is
the output; the sigmoid is left to the caller.

Departure from torchrec's DLRM-DCNv2: x0 is the 26 pooled rows and
then the bottom output (the port's order), where torchrec puts the
bottom output first: a permutation of x0's blocks, equivalent under the
same permutation of the cross and top weights.

The controls: `accumulate=torch.float16` pools in fp16 (each add
rounded), `tf32=True` runs the dense layers in TF32 (on the card with
TF32 matmuls; on the CPU, which has none, each operand rounded to TF32's
10-bit mantissa first).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Tensor = torch.Tensor
Seeded = Callable[[int], torch.Generator]

BLOCK_ROWS = 1 << 20
TABLE_SALT = 1 << 50
DENSE_SALT = 1 << 51
PAD_ID = -1


def table_dtype(config: dict) -> torch.dtype:
    return getattr(torch, config["table_dtype"])


def table_block(seeded: Seeded, config: dict, table: int, block: int,
                device: torch.device) -> Tensor:
    """Rows `[block * BLOCK_ROWS, ...)` of table `table`, in the
    configuration's table dtype."""
    vocab = config["vocab_sizes"][table]
    dim = config["embedding_dim"]
    rows = min(BLOCK_ROWS, vocab - block * BLOCK_ROWS)
    out = torch.empty((rows, dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(
        out, std=1.0, a=-2.0, b=2.0,
        generator=seeded(TABLE_SALT + table * (1 << 24) + block))
    return out.div_(dim ** 0.5).to(table_dtype(config))


def dense_tensors(config: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, fan_in) of every dense tensor, in draw order."""
    out = []

    def linear(name, fan_in, fan_out, bias=True):
        out.append((f"{name}.weight", (fan_out, fan_in), fan_in))
        if bias:
            out.append((f"{name}.bias", (fan_out,), fan_in))

    widths = [config["dense_features"]] + list(config["bottom_mlp"])
    for i in range(len(widths) - 1):
        linear(f"bottom.{i}", widths[i], widths[i + 1])
    x0 = x0_width(config)
    for layer in range(config["cross_layers"]):
        linear(f"cross.{layer}.u", x0, config["cross_rank"], bias=False)
        linear(f"cross.{layer}.v", config["cross_rank"], x0)
    widths = [x0] + list(config["top_mlp"])
    for i in range(len(widths) - 1):
        linear(f"top.{i}", widths[i], widths[i + 1])
    return out


def x0_width(config: dict) -> int:
    """The 26 pooled rows and the bottom output, side by side."""
    return (len(config["vocab_sizes"]) * config["embedding_dim"]
            + config["bottom_mlp"][-1])


def dense_weights(seeded: Seeded, config: dict,
                  device: torch.device) -> Dict[str, Tensor]:
    out = {}
    for k, (name, shape, fan_in) in enumerate(dense_tensors(config)):
        bound = fan_in ** -0.5
        out[name] = torch.empty(shape, device=device).uniform_(
            -bound, bound, generator=seeded(DENSE_SALT + k))
    return out


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """CUDA f32 matmuls in TF32 where `tf32`, else in full f32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: Tensor) -> Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (half away from zero
    in magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & -(1 << 13)).view(torch.float32)


class Reference:
    """The reference's side of a set of requests: the dense weights and
    the table rows those requests read, each redrawn from the seed.

    Args:
      config: The configuration's file.
      seeded: `salt -> torch.Generator` on `device`, from the run's seed.
      requests: Each request's `(ids, dense)`: a list of `[S, bag]` ids
        per sparse feature and `[S, dense]` features.
      device: Where the reference computes.
    """

    def __init__(self, config: dict, seeded: Seeded,
                 requests: Sequence[Tuple[List[Tensor], Tensor]],
                 device: torch.device):
        self.config = config
        self.device = device
        self.weights = dense_weights(seeded, config, device)
        self.rows, self.keys = [], []
        for t in range(len(config["vocab_sizes"])):
            wanted = torch.cat([ids[t].reshape(-1).to(device)
                                for ids, _ in requests])
            keys = torch.unique(wanted.clamp(min=0))
            self.keys.append(keys)
            self.rows.append(self._table_rows(seeded, t, keys))

    def _table_rows(self, seeded: Seeded, table: int, keys: Tensor) -> Tensor:
        """Table `table`'s rows `keys` (sorted), drawn block by block."""
        out = torch.empty((keys.numel(), self.config["embedding_dim"]),
                          dtype=table_dtype(self.config), device=self.device)
        blocks = keys // BLOCK_ROWS
        for block in torch.unique(blocks).tolist():
            at = (blocks == block).nonzero().reshape(-1)
            rows = table_block(seeded, self.config, table, block, self.device)
            out[at] = rows[keys[at] - block * BLOCK_ROWS]
        return out

    def pooled(self, ids: List[Tensor],
               accumulate: torch.dtype = torch.float32) -> Tensor:
        """`[S, 26 * dim]`: each feature's bag summed in `accumulate`."""
        blocks = []
        for t, x in enumerate(ids):
            x = x.to(self.device)
            at = torch.searchsorted(self.keys[t], x.clamp(min=0))
            rows = self.rows[t][at]                      # [S, bag, dim]
            valid = (x != PAD_ID)[..., None]
            if accumulate == torch.float32:
                blocks.append(torch.sum(
                    torch.where(valid, rows.float(), 0.0), dim=1))
                continue
            total = torch.zeros(rows.shape[0], rows.shape[2],
                                dtype=accumulate, device=self.device)
            for pos in range(rows.shape[1]):
                total = torch.where(valid[:, pos],
                                    total + rows[:, pos].to(accumulate),
                                    total)
            blocks.append(total.float())
        return torch.cat(blocks, dim=1)

    def logits(self, ids: List[Tensor], dense: Tensor,
               accumulate: torch.dtype = torch.float32,
               tf32: bool = False) -> Tensor:
        """`[S]` f32 logits of one request."""
        w = self.weights
        emulate = tf32 and self.device.type != "cuda"

        def linear(x, name):
            weight = w[f"{name}.weight"]
            if emulate:
                x, weight = round_tf32(x), round_tf32(weight)
            y = x @ weight.T
            bias = w.get(f"{name}.bias")
            return y if bias is None else y + bias

        with matmul_precision(tf32 and not emulate):
            x = dense.to(self.device, torch.float32)
            for i in range(len(self.config["bottom_mlp"])):
                x = torch.relu(linear(x, f"bottom.{i}"))
            x0 = torch.cat([self.pooled(ids, accumulate), x], dim=1)
            xl = x0
            for layer in range(self.config["cross_layers"]):
                xl = x0 * linear(linear(xl, f"cross.{layer}.u"),
                                 f"cross.{layer}.v") + xl
            y = xl
            last = len(self.config["top_mlp"]) - 1
            for i in range(last + 1):
                y = linear(y, f"top.{i}")
                if i < last:
                    y = torch.relu(y)
        return y[:, 0]
