"""Table-batched pooled lookup: each bag's table rows summed in f32.

One call pools many multi-hot features, each a table `[rows, D]`, its
ids `[B, bag]` (`PAD_ID` = -1 marks padding) and optional weights
`[B, bag]`, into the columns of one f32 output `[B, width]`: feature i's
sums land at columns `[c_i, c_i + D_i)`, with `c_i` the sum of the
earlier features' widths; the output may be the caller's own, wider
than that (`out`: a DCN's `x0`, whose last columns keep its dense
block). Each output value sums its bag's rows in bag order, from zero,
one f32 add at a time, each row first multiplied by its weight in f32:
the same sums whatever the table's dtype (f32 or fp16), never in fp16.

`pooled_lookup` is the wrapper of the hand-written CUDA kernel
`csrc/pooled_lookup.cu`, bound as the dispatcher op
`torch.ops.recommenders_tpu_torch.pooled_lookup` (`csrc/pooled_ops.cpp`,
a library of its own, built and loaded at the first call on the card).
For tensors on the CPU it runs the plain twin `pooled_lookup_reference`;
for CUDA tensors it launches the kernel, one launch for every feature
whose table shares a dtype and width (up to 64 a launch), and the op
raises on a feature it cannot read (`takes_rows`). Its `launches`
attribute counts the launches, `launches_by_format` by table dtype.

Ids are `max(id, 0)` rows, as the port's gather reads them (only
`PAD_ID` positions are skipped). An id at or past a table's rows is an
error: the twin raises; the kernel, which cannot, skips it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.utils import profiling

Tensor = torch.Tensor

PAD_ID = -1
# Table dtypes the kernel reads, by their names in the op's counts.
FORMATS = {torch.float32: "f32", torch.float16: "f16"}
ID_DTYPES = (torch.int32, torch.int64)
# The most 16-byte vectors a row may hold (f32 D = 512, fp16 D = 1,024).
MAX_VECTORS = 128


def takes_rows(dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernel reads table rows of `dim` values of `dtype`: f32
    or fp16, a power of two of 16-byte vectors, at most `MAX_VECTORS`.
    The op checks the rest of each feature itself: a contiguous 2-D
    table that starts on 16 bytes, on the output's device, 2-D int32 or
    int64 ids of one dtype a launch, and weights shaped as the ids."""
    if dtype not in FORMATS:
        return False
    vecs, rest = divmod(dim * torch.finfo(dtype).bits // 8, 16)
    return not rest and 1 <= vecs <= MAX_VECTORS and not vecs & (vecs - 1)


def pooled_lookup(
    tables: Sequence[Tensor],
    ids: Sequence[Tensor],
    weights: Optional[Sequence[Optional[Tensor]]] = None,
    out: Optional[Tensor] = None,
) -> Tensor:
    """Sum-pools every feature into the columns of one f32 tensor.

    Args:
      tables: Each feature's table `[rows, D_i]`.
      ids: Each feature's ids `[B, bag_i]` (`PAD_ID` for padding).
      weights: Each feature's weights `[B, bag_i]` or None (all ones);
        None for none at all.
      out: Where to write: f32 `[B, W]` with `W` at least the sum of the
        `D_i` and unit column stride (a prefix of a wider buffer's rows
        will do); its columns past the features' are not written. None
        for a new `[B, sum D_i]`.

    Returns:
      `out`: feature i's sums at columns `[c_i, c_i + D_i)`.
    """
    tables, ids = list(tables), list(ids)
    weights = [None] * len(tables) if weights is None else list(weights)
    if not (len(tables) == len(ids) == len(weights)) or not tables:
        raise ValueError("pooled_lookup takes one table, ids and weights "
                         "entry per feature, at least one feature")
    columns, width, groups = [], 0, {}
    for n, (t, i) in enumerate(zip(tables, ids)):
        columns.append(width)
        d = t.shape[1]
        width += d
        groups.setdefault((t.dtype, d, i.dtype), []).append(n)
    batch = ids[0].shape[0]
    if out is None:
        out = torch.empty((batch, width), dtype=torch.float32,
                          device=ids[0].device)
    elif (out.dtype != torch.float32 or out.dim() != 2
          or out.shape[0] != batch or out.shape[1] < width):
        raise ValueError(f"out must be f32 [{batch}, >= {width}]; got "
                         f"{out.dtype} {tuple(out.shape)}")
    if out.device.type == "cpu":
        for i, w in zip(ids, weights):
            if i.dim() != 2 or i.shape[0] != batch:
                raise ValueError(f"ids must be [{batch}, bag]; got "
                                 f"{tuple(i.shape)}")
            if w is not None and tuple(w.shape) != tuple(i.shape):
                raise ValueError(f"weights {tuple(w.shape)} do not match "
                                 f"ids {tuple(i.shape)}")
        return pooled_lookup_reference(tables, ids, weights, columns, out)
    with profiling.annotate("pool.launch"):
        return _launch(tables, ids, weights, columns, groups, out)


pooled_lookup.launches = 0
pooled_lookup.launches_by_format = dict.fromkeys(FORMATS.values(), 0)


def pooled_lookup_reference(tables, ids, weights, columns,
                            out: Tensor) -> Tensor:
    """The kernel's plain PyTorch twin: writes each feature's sums into
    `out[:, c:c + D]` and returns `out`. Rows are gathered, widened to
    f32, weighted in f32, and added position by position from zero; a
    `PAD_ID` position adds zero, which leaves a sum as skipping it does
    (a sum from +0 is never -0)."""
    for table, i, w, c in zip(tables, ids, weights, columns):
        rows = torch.index_select(table, 0, i.clamp(min=0).reshape(-1))
        rows = rows.view(tuple(i.shape) + (table.shape[1],))
        valid = (i != PAD_ID)[..., None]
        total = torch.zeros((i.shape[0], table.shape[1]),
                            dtype=torch.float32, device=out.device)
        for pos in range(i.shape[1]):
            x = rows[:, pos].float()
            if w is not None:
                x = w[:, pos, None].float() * x
            total = total + torch.where(valid[:, pos], x, 0.0)
        out[:, c:c + table.shape[1]] = total
    return out


def _launch(tables, ids, weights, columns, groups, out: Tensor) -> Tensor:
    """Launches the kernel once for each (table dtype, width, id dtype)
    of `groups` (its features by index); the op checks every feature
    (`takes_rows`) and raises on one it cannot read."""
    empty = out.new_empty((0,))
    weights = [empty if w is None else w.float() for w in weights]
    op = _op()
    for (dtype, _, _), members in groups.items():
        if len(members) == len(tables):
            op(tables, ids, weights, columns, out)
        else:
            op(*([x[n] for n in members]
                 for x in (tables, ids, weights, columns)), out)
        if not torch.compiler.is_compiling():
            count = -(-len(members) // 64)
            pooled_lookup.launches += count
            pooled_lookup.launches_by_format[FORMATS[dtype]] += count
    return out


def _op():
    """The dispatcher op, its library built and loaded at first use."""
    cuda_build.pooled_ops()
    return torch.ops.recommenders_tpu_torch.pooled_lookup
