"""Corpus scoring for retrieval serving: exact and bucketed top-k.

Port of `recommenders_tpu/ops/scoring.py:48-499`. The serving op is
`queries [Q, D] × corpus [N, D] → top-k`. Two paths:

  - `exact_top_k`: one `[Q, N]` matmul plus `torch.topk`.
  - `bucketed_top_k`: `bucketed_scores` sweeps the corpus once and keeps,
    for every query, a running max and argmax per bucket `row % B`; the
    `[Q, N]` score matrix never exists. An exact `torch.topk` over the
    `[Q, B]` bucket state gives the result. Scores are exact; recall < 1
    only when top-k items collide in one bucket (≈ `1 − (k−1)/2B`).

`bucketed_scores` is the wrapper of the hand-written CUDA kernel
`csrc/bucketed_scores.cu`. For a tensor on the CPU it runs the kernel's
plain PyTorch twin `bucketed_scores_reference`; for a CUDA tensor it
launches the kernel through the dispatcher op
`torch.ops.recommenders_tpu_torch.bucketed_scores` (`csrc/torch_ops.cpp`,
whose fake impl below lets `torch.export` trace the call), or raises.
Every body multiplies on the bf16 tensor
cores; the f32 body splits both operands into three bf16 terms and takes
six of their nine products (`split3` and `split_scores` model that split
in plain PyTorch; nothing on the serving path calls them). int8 codes
run on Hopper's `wgmma`, fed by bulk copies. `_tc_plan` (`_int8_plan`
for int8) picks the query tile and how many blocks share one tile's
walk over the row groups (a second small kernel merges those). Its
`launches` attribute counts wrapper launches of the kernel (and
`launches_by_format` splits them by corpus format;
`launches_by_int8_tile` splits the int8 ones by query tile, which with
the width picks the body's instance, `bucketed_int8_kernel<tile / 2,
D / 64>`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import topk as topk_ops
from recommenders_tpu_torch.utils import profiling

Tensor = torch.Tensor

MIN_FLOAT = topk_ops.MIN_FLOAT

# Same divisibility rules as the JAX package (its lane width), so one set
# of index settings is valid for both packages.
_LANES = 128

# Limits of the CUDA kernel: the query tile lives in shared memory
# (≤ 227 KB a block), row ids are int32, and the grid's second dimension
# holds one block per 32, 64 or 128 queries.
_MAX_DIM = 768
_MAX_ROWS = 2**31 - 1
_MAX_QUERIES = 65535 * 32
# Buckets a block owns, and the widest D the bf16 / code bodies hold 128
# queries of in shared memory (64 above it).
_BUCKET_TILE = 64
_TC_WIDE_DIM = 512
# Shared memory a block may take on the H100 (227 KB), and the f32 body's
# ring of two f32 corpus slabs, [64][136] floats each; its three bf16
# query planes take 6·TQ·(D + 8) bytes beside it (`tc_smem` in
# `csrc/bucketed_scores.cu`).
_SMEM_PER_BLOCK = 232_448
_F32_RING_BYTES = 2 * 64 * 136 * 4

# The int8 body (`bucketed_int8_kernel`): a block of two consumer
# warpgroups owns 64 buckets x a query tile of 256, 128 or 64, the tile
# kept as bf16 in shared memory beside barriers and a ring of 2 .. 8
# stages, each 64 code rows and their 64 f32 scales; its registers hold
# one block an SM.
_INT8_TILES = (256, 128, 64)
_INT8_BARRIER_BYTES = 128

_FORMAT_ROWS, _FORMAT_INT8, _FORMAT_PACKED4 = 0, 1, 2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@contextlib.contextmanager
def _full_f32_matmul():
    """Keeps CUDA f32 matmuls in full f32 (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def exact_top_k(
    queries: Tensor, candidates: Tensor, k: int,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Exact scoring: one `[Q, N]` matmul plus `torch.topk`.

    Invalid rows are masked in place in the fresh score matrix, so the
    peak is one `[Q, N]` f32 matrix, not two.
    """
    scores = (queries @ candidates.T).to(torch.float32)
    if valid is not None:
        scores.masked_fill_(~valid[None, :], MIN_FLOAT)
    return topk_ops.top_k(scores, k)


def bucketed_scores(
    queries: Tensor,
    candidates: Tensor,
    scales: Optional[Tensor] = None,
    buckets: int = 2048,
    chunk: int = 2048,
    query_tile: int = 256,
    valid_rows: Optional[int] = None,
    packed4: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Sweeps the corpus once; returns per-bucket `([Q, B], [Q, B])` max
    scores (f32) and their candidate rows (int32).

    `candidates` is already padded to a multiple of `chunk` (padding is
    masked by `valid_rows`, the true corpus size). Formats:

      - f32 or bf16 rows `[N, D]`, with queries of the same dtype;
      - int8 codes `[N, D]` with f32 `scales [N]` (the query rounds to
        bf16, the scale multiplies after the dot);
      - with `packed4`, int4 codes `[N/2, D]` in the `pack_nibbles`
        layout (row c ↔ row c + N/2), natural-order `scales [N]`, and a
        required `valid_rows`.

    The validation is the JAX package's (`scoring.py:250-286`), so the
    same settings are accepted by both. `chunk` and `query_tile` only
    shape the index and the query padding here; the CUDA kernel picks
    its own tiles.
    """
    qn, d = queries.shape
    n = candidates.shape[0] * 2 if packed4 else candidates.shape[0]
    if valid_rows is None:
        if packed4:
            raise ValueError("packed4 requires explicit valid_rows")
        valid_rows = n
    if n % chunk != 0:
        raise ValueError(f"corpus rows {n} not a multiple of chunk {chunk}")
    if chunk % buckets != 0:
        raise ValueError(
            f"chunk ({chunk}) must be a multiple of buckets ({buckets})"
        )
    if packed4 and (chunk // 2) % _LANES != 0:
        raise ValueError(
            f"packed4 needs chunk/2 to be a multiple of {_LANES}; got "
            f"chunk={chunk}"
        )
    if packed4 and (chunk // 2) % buckets != 0:
        raise ValueError(
            f"packed4 needs buckets ({buckets}) to divide chunk/2 "
            f"({chunk // 2})"
        )
    if d % _LANES != 0:
        raise ValueError(f"embedding dim {d} must be a multiple of {_LANES}")
    tq = min(query_tile, _round_up(qn, 8))
    if qn % tq != 0:
        raise ValueError(f"num queries {qn} not a multiple of tile {tq}")
    if packed4 and scales is None:
        raise ValueError("packed4 requires per-row scales")
    if scales is not None and scales.shape[0] != n:
        raise ValueError(f"scales rows {scales.shape[0]} != corpus rows {n}")
    if queries.device.type == "cpu":
        return bucketed_scores_reference(
            queries, candidates, scales, buckets=buckets,
            valid_rows=valid_rows, packed4=packed4,
        )
    with profiling.annotate("k3.launch"):
        return _launch(queries, candidates, scales, buckets,
                       int(valid_rows), packed4)


bucketed_scores.launches = 0
bucketed_scores.launches_by_format = {
    "f32": 0, "bf16": 0, "int8": 0, "int4": 0,
}
bucketed_scores.launches_by_int8_tile = dict.fromkeys(_INT8_TILES, 0)


def _bucketed_scores_fake(queries, candidates, scales, fmt, buckets,
                          valid_rows, query_tile, splits, mask_value):
    """The op's outputs without running it (`torch.export`'s tracing)."""
    qn = queries.shape[0]
    return (queries.new_empty((qn, buckets), dtype=torch.float32),
            queries.new_empty((qn, buckets), dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _op():
    """The K3 dispatcher op, its library built and loaded at first use."""
    cuda_build.torch_ops()
    torch.library.register_fake("recommenders_tpu_torch::bucketed_scores",
                                _bucketed_scores_fake)
    return torch.ops.recommenders_tpu_torch.bucketed_scores


def _tc_plan(qn: int, n: int, d: int, buckets: int, sms: int,
             f32: bool = False) -> Tuple[int, int]:
    """(query tile, splits) of a launch: a block owns a query tile × 64
    buckets; where those blocks are fewer than the card holds at once (two
    an SM; one for the f32 body, whose shared memory fills an SM), the walk
    over the `n / buckets` row groups is split over more blocks. The f32
    body takes the largest tile of 128, 64 and 32 queries whose planes fit
    (128 at D = 128, 64 to D = 384, 32 to D = 768)."""
    if f32:
        tq = next(t for t in (128, 64, 32)
                  if 6 * t * (d + 8) + _F32_RING_BYTES <= _SMEM_PER_BLOCK)
    else:
        tq = 128 if d <= _TC_WIDE_DIM else 64
    per_sm = 1 if f32 else 2
    blocks = -(-buckets // _BUCKET_TILE) * -(-qn // tq)
    return tq, max(1, min(n // buckets, -(-per_sm * sms // blocks)))


def _int8_stage_bytes(d: int) -> int:
    """Shared bytes of one stage of the int8 body's ring: 64 code rows of
    D bytes and their 64 f32 scales."""
    return _BUCKET_TILE * (d + 4)


def _int8_tile(qn: int, d: int) -> int:
    """The int8 body's query tile: the largest of 256, 128 and 64 whose
    bf16 rows and a ring of two stages fit a block's shared memory,
    halved while half of it still holds every query."""
    tq = next(t for t in _INT8_TILES
              if _INT8_BARRIER_BYTES + 2 * t * d + 2 * _int8_stage_bytes(d)
              <= _SMEM_PER_BLOCK)
    while tq > _INT8_TILES[-1] and qn <= tq // 2:
        tq //= 2
    return tq


def _int8_plan(qn: int, n: int, d: int, buckets: int,
               sms: int) -> Tuple[int, int]:
    """(query tile, splits) of an int8 launch: one block an SM, each
    reading its tile's 64 buckets of every row group once; where those
    blocks are fewer than the SMs, the walk over the `n / buckets` groups
    is split over as many blocks as one wave holds (a merge kernel folds
    the splits' planes, ties to the lowest row)."""
    tq = _int8_tile(qn, d)
    blocks = -(-buckets // _BUCKET_TILE) * -(-qn // tq)
    return tq, max(1, min(n // buckets, sms // blocks))


def _launch(
    queries: Tensor,
    candidates: Tensor,
    scales: Optional[Tensor],
    buckets: int,
    valid_rows: int,
    packed4: bool,
) -> Tuple[Tensor, Tensor]:
    """Checks the inputs against what the kernel takes and launches it."""
    device = queries.device
    if device.type != "cuda":
        raise ValueError(f"queries on {device}: the kernel needs CUDA")
    qn, d = queries.shape
    n = candidates.shape[0] * 2 if packed4 else candidates.shape[0]
    if scales is None:
        fmt = _FORMAT_ROWS
        if candidates.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(
                f"corpus rows must be float32 or bfloat16, got "
                f"{candidates.dtype}"
            )
        if queries.dtype != candidates.dtype:
            raise TypeError(
                f"queries ({queries.dtype}) and corpus "
                f"({candidates.dtype}) must share a dtype"
            )
        name = "bf16" if candidates.dtype == torch.bfloat16 else "f32"
    else:
        fmt = _FORMAT_PACKED4 if packed4 else _FORMAT_INT8
        if candidates.dtype != torch.int8:
            raise TypeError(f"codes must be int8, got {candidates.dtype}")
        if scales.dtype != torch.float32:
            raise TypeError(f"scales must be float32, got {scales.dtype}")
        # The query rounds to bf16, where the codes are exact
        # (JAX `scoring.py:131,185`).
        queries = queries.to(torch.bfloat16)
        name = "int4" if packed4 else "int8"
    tensors = [queries, candidates] + ([] if scales is None else [scales])
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, queries on {device}")
        if not t.is_contiguous():
            raise ValueError("bucketed_scores needs contiguous tensors")
    if candidates.shape[1] != d:
        raise ValueError(
            f"corpus dim {candidates.shape[1]} != query dim {d}"
        )
    if d > _MAX_DIM:
        raise ValueError(f"embedding dim {d} > {_MAX_DIM}, the kernel limit")
    if n > _MAX_ROWS or qn > _MAX_QUERIES:
        raise ValueError(f"{qn} queries × {n} rows exceed the kernel limits")

    # The plan is fixed here, on the host, for the card that runs (or
    # exports) the call. The op checks alignment and launches.
    sms = cuda_build.sm_count(device)
    if name == "int8":
        tq, splits = _int8_plan(qn, n, d, buckets, sms)
    else:
        tq, splits = _tc_plan(qn, n, d, buckets, sms, f32=name == "f32")
    empty = queries.new_empty((0,), dtype=torch.float32)
    vals, rows = _op()(queries, candidates,
                       empty if scales is None else scales, fmt, buckets,
                       valid_rows, tq, splits, MIN_FLOAT)
    if not torch.compiler.is_compiling():   # an export's trace launches none
        bucketed_scores.launches += 1
        bucketed_scores.launches_by_format[name] += 1
        if name == "int8":
            bucketed_scores.launches_by_int8_tile[tq] += 1
    return vals, rows


def reference_scores(
    queries: Tensor,
    candidates: Tensor,
    scales: Optional[Tensor] = None,
    valid_rows: Optional[Union[int, Tensor]] = None,
) -> Tensor:
    """The twin's `[Q, N]` f32 scores, rows ≥ `valid_rows` at MIN_FLOAT.

    `candidates` is f32/bf16 rows, or int8 codes with `scales` (unpack
    int4 first).
    """
    with _full_f32_matmul():
        if scales is not None:
            # Int8 codes: bf16 query × codes (exact in bf16), f32 sums,
            # then the per-row scale.
            scores = (
                queries.to(torch.bfloat16).to(torch.float32)
                @ candidates.to(torch.float32).T
            )
            scores *= scales.to(torch.float32)[None, :]
        else:
            scores = (
                queries.to(torch.float32) @ candidates.to(torch.float32).T
            )
    if valid_rows is not None:
        scores[:, int(valid_rows):] = MIN_FLOAT
    return scores


def bucketed_scores_reference(
    queries: Tensor,
    candidates: Tensor,
    scales: Optional[Tensor] = None,
    buckets: int = 2048,
    valid_rows: Optional[Union[int, Tensor]] = None,
    packed4: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch twin of the CUDA kernel: same `([Q, B], [Q, B])`.

    Scores all rows into `[Q, N]` f32 (full f32 matmul, TF32 off), masks
    rows ≥ `valid_rows` to MIN_FLOAT, pads to a multiple of `buckets`,
    reshapes to `[Q, N/B, B]` and takes the max over the group axis; ties
    go to the first (lowest) row, as in the kernel.
    """
    if packed4:
        candidates = quantization.unpack_nibbles(candidates)
    n = candidates.shape[0]
    scores = reference_scores(queries, candidates, scales, valid_rows)
    padded_n = _round_up(n, buckets)
    if padded_n != n:
        scores = F.pad(scores, (0, padded_n - n), value=MIN_FLOAT)
    groups = padded_n // buckets
    vals, best = scores.view(-1, groups, buckets).max(dim=1)
    rows = best * buckets + torch.arange(buckets, device=best.device)
    return vals, rows.to(torch.int32)


# The f32 body's term products, (query term, corpus term) of (h, m, l):
# hh, hm, mh, hl, lh, mm; it drops ml, lm and ll.
SPLIT_PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))
# Its bound on |split dot − q·c| (`csrc/bucketed_scores.cu`): the dropped
# terms, at most 2(1 + 2⁻⁸)2⁻⁸·2⁻¹⁶ + 2⁻³² ≤ 1.006·2⁻²³ of |q_k||c_k| a
# product, and 2⁻¹³⁴ of the partner for each value below 2⁻¹¹⁰, where the
# split rounds onto bf16's subnormal grid.
SPLIT_REL_BOUND = 2 * (1 + 2.0**-8) * 2.0**-24 + 2.0**-32
SPLIT_TINY = 2.0**-110
SPLIT_ABS_BOUND = 2.0**-134


def split3(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The f32 body's split of `x` into three bf16 terms, returned as f32:
    h = bf16(x), m = bf16(x − h), l = bf16(x − h − m), each rounded to
    nearest even (`tc::split3`). h + m + l = x exactly for 2⁻¹¹⁰ ≤ |x| <
    (2 − 2⁻⁸)·2¹²⁷."""
    x = x.to(torch.float32)
    h = x.to(torch.bfloat16).to(torch.float32)
    r = x - h
    m = r.to(torch.bfloat16).to(torch.float32)
    return h, m, (r - m).to(torch.bfloat16).to(torch.float32)


def split_scores(queries: Tensor, candidates: Tensor) -> Tensor:
    """`[Q, N]` float64 scores as the f32 body forms them, less its f32
    rounding: the sum of its six exact term products (`SPLIT_PRODUCTS`)."""
    qs = [t.double() for t in split3(queries)]
    cs = [t.double() for t in split3(candidates)]
    return sum(qs[i] @ cs[j].T for i, j in SPLIT_PRODUCTS)


def split_error_bound(queries: Tensor, candidates: Tensor) -> Tensor:
    """`[Q, N]` float64 bound on |`split_scores` − q·c|."""
    q = queries.double().abs()
    c = candidates.double().abs()
    bound = SPLIT_REL_BOUND * (q @ c.T)
    bound += SPLIT_ABS_BOUND * ((q < SPLIT_TINY).double() @ c.T
                                + q @ (c < SPLIT_TINY).double().T)
    return bound


def bucketed_top_k(
    queries: Tensor,
    candidates: Tensor,
    k: int,
    buckets: int = 2048,
    chunk: int = 2048,
    query_tile: int = 256,
    scales: Optional[Tensor] = None,
    packed4: bool = False,
    valid_rows: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Approximate top-k with exact scores via one bucketed corpus sweep.

    Returns `([Q, k] scores, [Q, k] candidate rows)`, descending. With
    `scales`, `candidates` holds int8 per-row codes; with `packed4`, it
    holds `[n/2, D]` packed int4 codes already padded to a chunk multiple
    (packing bakes in the pairing stride), and `valid_rows` gives the true
    corpus size. `valid_rows` may also be given for unpacked corpora whose
    rows are already padded to the chunk grid.
    """
    if packed4:
        if valid_rows is None:
            raise ValueError("packed4 requires valid_rows")
        padded = candidates
        logical = candidates.shape[0] * 2
        if scales.shape[0] != logical:
            raise ValueError(
                f"scales rows {scales.shape[0]} != padded logical rows "
                f"{logical}"
            )
    else:
        if valid_rows is None:
            valid_rows = candidates.shape[0]
        padded = pad_to_multiple(candidates, chunk)
        # `F.pad` copies even when it adds nothing: an index already on
        # the chunk grid (every `Bucketed`) passes its scales as they are.
        if scales is not None and scales.shape[0] != padded.shape[0]:
            scales = F.pad(scales, (0, padded.shape[0] - scales.shape[0]))
    vals, rows = bucketed_scores_padded(
        queries, padded, scales, buckets, chunk, query_tile, valid_rows,
        packed4)
    with profiling.annotate("bucketed.merge"):
        k = min(k, int(valid_rows), buckets)
        top_vals, idx = topk_ops.top_k(vals, k)
        return top_vals, topk_ops.take_along_rows(rows, idx)


def bucketed_scores_padded(
    queries: Tensor, candidates: Tensor, scales: Optional[Tensor],
    buckets: int, chunk: int, query_tile: int, valid_rows: int,
    packed4: bool,
) -> Tuple[Tensor, Tensor]:
    """`bucketed_scores` for any number of queries: they are padded to
    the query tile and the padding's rows cut from the `([Q, B], [Q, B])`
    result. `candidates` is already on the chunk grid."""
    qn = queries.shape[0]
    tq = min(query_tile, _round_up(qn, 8))
    padded_q = _round_up(qn, tq)
    if padded_q != qn:
        queries = F.pad(queries, (0, 0, 0, padded_q - qn))
    vals, rows = bucketed_scores(
        queries, candidates, scales, buckets=buckets, chunk=chunk,
        query_tile=tq, valid_rows=valid_rows, packed4=packed4,
    )
    return vals[:qn], rows[:qn]


def bucketed_top_k_reference(
    queries: Tensor,
    candidates: Tensor,
    k: int,
    buckets: int = 2048,
    scales: Optional[Tensor] = None,
    packed4: bool = False,
    valid_rows: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Plain oracle with the same bucket semantics, on any device."""
    n = candidates.shape[0] * (2 if packed4 else 1)
    vals, rows = bucketed_scores_reference(
        queries, candidates, scales, buckets=buckets, valid_rows=valid_rows,
        packed4=packed4,
    )
    if valid_rows is not None:
        k = min(k, int(valid_rows))
    k = min(k, buckets, n)
    top_vals, idx = topk_ops.top_k(vals, k)
    return top_vals, topk_ops.take_along_rows(rows, idx)


def pad_to_multiple(candidates: Tensor, multiple: int) -> Tensor:
    """Zero-pads corpus rows up to a multiple (padding is masked later)."""
    n = candidates.shape[0]
    padded = _round_up(n, multiple)
    if padded == n:
        return candidates
    return F.pad(candidates, (0, 0, 0, padded - n))
