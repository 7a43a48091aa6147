"""Probed leaf scoring for the ScaNN index: kernels K4 and K5.

Port of `recommenders_tpu/ops/leaf_scoring.py`. A ScaNN query scores only
the leaves it probes. Leaves are stored `[L, cap, D]`: f32 or bf16 rows,
int8 codes with per-row f32 scales `[L, cap]`, or int4 codes packed two
per byte `[L, cap/2, D]` (slot `s` in the low nibble of packed row `s`,
slot `s + cap/2` in the high nibble, `ops/quantization.pack_nibbles`).
Two ops score them in place, without the `[Q, P, cap, D]` gather:

  - `probed_leaf_scores` (K4): every probed slot's score, `[Q, P·cap]`,
    probe-major (probe p's slots at `[p·cap, (p+1)·cap)`), for the
    caller's top-k.
  - `probed_bucketed_scores` (K5): probes are shared by a tile of
    `query_tile` queries, and the scores fold into `B` running-argmax
    cells per query (slot `c` of each probed leaf into bucket `c % B`,
    probe-major, first maximum wins), so only `[Q, B]` scores and global
    rows leave the kernel.

Numerics are the JAX kernels': f32 sums; f32 or bf16 rows are scored
against the f32 query (bf16 promotes to f32); for int8 and int4 the query
rounds to bf16, where the codes are exact, and the per-row scale
multiplies after the dot. On the card f32 rows are multiplied in split
precision, as K3's f32 body does (`scoring.split_scores`: six exact bf16
term products, within `scoring.split_error_bound` of the f32 dot).

Each wrapper runs its plain PyTorch twin (`probed_scores_reference`,
`probed_bucketed_reference`) for tensors on the CPU and launches its CUDA
kernel (`csrc/leaf_scoring.cu`) for CUDA tensors, or raises, through a
dispatcher op (`torch.ops.recommenders_tpu_torch.probed_leaf_scores` /
`probed_bucketed_scores`, `csrc/torch_ops.cpp`), so `torch.export` traces
the call (the fake impls below) and an exported program launches the
same kernels. The twins
loop over query chunks so the gather they form stays bounded. Each
wrapper counts its launches in `launches` and, by leaf format,
`launches_by_format`.

The kernels' plans are plain PyTorch, run on the device without a host
synchronisation and tested on the CPU: `leaf_groups` inverts K4's
`[Q, P]` probes into groups of at most `GROUP` (query, probe) pairs of one
leaf, a block each; `bucketed_splits` picks how many blocks share K5's
walk over a tile's probes (`probe_splits` gives their ranges), and
`merge_probe_splits_reference` is the twin of the kernel that merges
their partial results. K5's int8 body runs on Hopper's `wgmma`; its
splits merge by the order key p·G + g (a tie to the lower key), and
`int8_splits` and `int8_units` give their even shares of the walk.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.ops import topk as topk_ops
from recommenders_tpu_torch.utils import profiling

Tensor = torch.Tensor

MIN_FLOAT = topk_ops.MIN_FLOAT

# Kernel format codes (`csrc/leaf_scoring.cu`).
_FORMATS = {"f32": 0, "bf16": 1, "int8": 2, "int4": 3}
# The kernels keep the query (K4) or a 64-query tile (K5) of this many
# columns in shared memory.
_MAX_DIM = 512
# Elements of the `[chunk, P, cap, D]` gather one twin chunk may form
# (512 MB as f32).
_TWIN_CHUNK_ELEMENTS = 1 << 27
# K4: (query, probe) pairs of one leaf a block scores (its query rows;
# `kTQ` in the kernel).
GROUP = 64
# K5: a block owns 64 queries x 64 buckets of a tile; the probe walk is
# split until the grid holds this many blocks an SM, about two waves of
# the 2-3 blocks an SM holds. Each split stages its queries again and
# adds a plane to the merge: on an H100 (PERF.md) 3 to 6 blocks an
# SM read fastest, 12 to 48 slower.
_QUERY_BLOCK = 64
_BUCKET_BLOCK = 64
_K5_BLOCKS_PER_SM = 6
# K5: most probes one split walks (the kernel keeps them in shared memory).
_SPLIT_PROBES = 256
# K5's int8 body (`probed_bucketed_int8_kernel`): a consumer warpgroup
# multiplies a query block of 16, 32 or 64 of a tile's queries (the
# smallest that holds the tile, else 64) against 64-slot slabs; each
# bucket tile of G_bt groups a leaf is split S·G_bt ways, so every block
# walks about P / S (probe, group) units, at most `_INT8_SPAN` probes.
_INT8_QUERY_BLOCKS = (16, 32, 64)
_INT8_SPAN = 1024


def _format(leaf_embs: Tensor, leaf_scales: Optional[Tensor],
            packed4: bool) -> str:
    if packed4 and leaf_scales is None:
        raise ValueError("packed4 requires per-row scales")
    if packed4:
        return "int4"
    if leaf_scales is not None:
        return "int8"
    return "bf16" if leaf_embs.dtype == torch.bfloat16 else "f32"


def _check_shapes(queries: Tensor, leaf_embs: Tensor,
                  leaf_scales: Optional[Tensor], probes: Tensor,
                  packed4: bool) -> int:
    """Checks what both kernels share; returns the logical capacity."""
    _format(leaf_embs, leaf_scales, packed4)
    if queries.ndim != 2 or leaf_embs.ndim != 3 or probes.ndim != 2:
        raise ValueError(
            f"need queries [Q, D], leaves [L, cap, D], probes [., P]; got "
            f"{tuple(queries.shape)}, {tuple(leaf_embs.shape)}, "
            f"{tuple(probes.shape)}"
        )
    if queries.shape[1] != leaf_embs.shape[2]:
        raise ValueError(
            f"query dim {queries.shape[1]} != leaf dim {leaf_embs.shape[2]}"
        )
    cap = leaf_embs.shape[1] * (2 if packed4 else 1)
    if leaf_scales is not None and tuple(leaf_scales.shape) != (
            leaf_embs.shape[0], cap):
        raise ValueError(
            f"scales {tuple(leaf_scales.shape)} != [L, cap] = "
            f"{(leaf_embs.shape[0], cap)}"
        )
    return cap


def probed_leaf_scores(
    queries: Tensor,
    leaf_embs: Tensor,
    leaf_scales: Optional[Tensor],
    probes: Tensor,
    packed4: bool = False,
) -> Tensor:
    """Scores each query against every slot of its probed leaves (K4).

    Args:
      queries: `[Q, D]`, scored in f32 (any `D ≤ 512` on the card).
      leaf_embs: `[L, cap, D]` f32/bf16 rows or int8 codes, or with
        `packed4` `[L, cap/2, D]` nibble-packed int4 codes (any `cap`,
        even for int4).
      leaf_scales: `[L, cap]` f32 per-row scales of the codes, or None.
      probes: `[Q, P]` leaf ids in `[0, L)` probed by each query.
      packed4: The leaves hold two 4-bit codes per byte.

    Returns:
      `[Q, P·cap]` f32 scores, probe-major. A probe outside `[0, L)`
      scores MIN_FLOAT on the card; the twin raises on it.
    """
    cap = _check_shapes(queries, leaf_embs, leaf_scales, probes, packed4)
    if probes.shape[0] != queries.shape[0]:
        raise ValueError(
            f"probes rows ({probes.shape[0]}) != queries rows "
            f"({queries.shape[0]})"
        )
    if queries.device.type == "cpu":
        return probed_scores_reference(
            queries, leaf_embs, leaf_scales, probes, packed4=packed4
        )
    return _launch_leaf(queries, leaf_embs, leaf_scales, probes, cap,
                        packed4)


probed_leaf_scores.launches = 0
probed_leaf_scores.launches_by_format = dict.fromkeys(_FORMATS, 0)


def probed_bucketed_scores(
    queries: Tensor,
    leaf_embs: Tensor,
    leaf_scales: Optional[Tensor],
    leaf_rows: Tensor,
    probes: Tensor,
    buckets: int,
    query_tile: int = 8,
    packed4: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Scores probed leaves into per-bucket running argmax cells (K5).

    Queries `[tiles·query_tile, D]` come in tiles of `query_tile` that
    share one probe list, `probes [tiles, P]`. Slot `c` of each probed
    leaf folds into bucket `c % buckets`, probes in order, then groups
    of `buckets` slots in order, the first maximum winning; a partial
    tail group (`cap % buckets` slots) folds into the leading buckets.
    Slots whose `leaf_rows` entry is -1 (padding) never win.

    Args:
      queries: `[Q, D]`, `Q = tiles · query_tile`, any `D ≤ 512` on the
        card.
      leaf_embs, leaf_scales, packed4: As for `probed_leaf_scores`.
      leaf_rows: `[L, cap]` int32 global row of each slot, -1 for padding.
      probes: `[tiles, P]` leaf ids per query tile.
      buckets: Reduction width `B`, at most `cap` (any value on the card).
      query_tile: Queries per probe tile.

    Returns:
      `([Q, B] f32 scores, [Q, B] int32 global rows)`; empty buckets hold
      MIN_FLOAT / -1.
    """
    cap = _check_shapes(queries, leaf_embs, leaf_scales, probes, packed4)
    qn = queries.shape[0]
    tiles = probes.shape[0]
    if qn != tiles * query_tile:
        raise ValueError(
            f"queries rows ({qn}) must equal tiles ({tiles}) × "
            f"query_tile ({query_tile})."
        )
    if not 0 < buckets <= cap:
        raise ValueError(
            f"needs 0 < buckets <= cap; got buckets={buckets}, cap={cap}."
        )
    if tuple(leaf_rows.shape) != (leaf_embs.shape[0], cap):
        raise ValueError(
            f"leaf_rows {tuple(leaf_rows.shape)} != [L, cap] = "
            f"{(leaf_embs.shape[0], cap)}"
        )
    if queries.device.type == "cpu":
        return probed_bucketed_reference(
            queries, leaf_embs, leaf_scales, leaf_rows, probes, buckets,
            query_tile=query_tile, packed4=packed4,
        )
    with profiling.annotate("k5.launch"):
        return _launch_bucketed(queries, leaf_embs, leaf_scales, leaf_rows,
                                probes, buckets, query_tile, cap, packed4)


probed_bucketed_scores.launches = 0
probed_bucketed_scores.launches_by_format = dict.fromkeys(_FORMATS, 0)


# --- The plain twins --------------------------------------------------------

def _tile_scores(
    qt: Tensor, leaf_embs: Tensor, leaf_scales: Optional[Tensor],
    probes: Tensor, packed4: bool,
) -> Tensor:
    """`[t, T, P, cap]` f32 scores of query tiles `qt [t, T, D]` against
    their probed leaves `probes [t, P]`, through the gather."""
    probes = probes.long()
    embs = leaf_embs[probes]                        # [t, P, cap(/2), D]
    if packed4:
        embs = quantization.unpack_nibbles(embs)
    with scoring._full_f32_matmul():
        if leaf_scales is not None:
            # Codes are exact in bf16; the query rounds; the scale
            # multiplies after the dot.
            q = qt.to(torch.bfloat16).to(torch.float32)
            scores = torch.einsum("tqd,tpcd->tqpc", q,
                                  embs.to(torch.float32))
            return scores * leaf_scales[probes][:, None].to(torch.float32)
        return torch.einsum("tqd,tpcd->tqpc", qt.to(torch.float32),
                            embs.to(torch.float32))


def _chunk(num_probes: int, cap: int, d: int, tile: int) -> int:
    """Tiles per twin chunk: the gather and the scores stay bounded."""
    per_tile = max(1, num_probes * cap * max(d, tile))
    return max(1, _TWIN_CHUNK_ELEMENTS // per_tile)


def probed_scores_reference(
    queries: Tensor,
    leaf_embs: Tensor,
    leaf_scales: Optional[Tensor],
    probes: Tensor,
    packed4: bool = False,
) -> Tensor:
    """Plain twin of `probed_leaf_scores`: gather + `einsum`, chunked
    over queries."""
    qn, d = queries.shape
    num_probes = probes.shape[1]
    cap = leaf_embs.shape[1] * (2 if packed4 else 1)
    step = _chunk(num_probes, cap, d, 1)
    parts = [
        _tile_scores(queries[i:i + step, None], leaf_embs, leaf_scales,
                     probes[i:i + step], packed4).reshape(-1, num_probes * cap)
        for i in range(0, qn, step)
    ]
    if not parts:
        return torch.empty((0, num_probes * cap), dtype=torch.float32,
                           device=queries.device)
    return torch.cat(parts)


def probed_bucket_candidates(
    queries: Tensor,
    leaf_embs: Tensor,
    leaf_scales: Optional[Tensor],
    leaf_rows: Tensor,
    probes: Tensor,
    buckets: int,
    query_tile: int = 1,
    packed4: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Every candidate of every bucket, `([Q, G, B] scores, [Q, G, B]
    rows)`, in fold order (G = P · ⌈cap / B⌉ groups, probe-major).
    Padding slots carry MIN_FLOAT / -1. Unchunked: for small inputs, and
    for tests that need a bucket's runner-up."""
    qn, d = queries.shape
    tiles, num_probes = probes.shape
    cap = leaf_embs.shape[1] * (2 if packed4 else 1)
    qt = queries.reshape(tiles, query_tile, d)
    scores = _tile_scores(qt, leaf_embs, leaf_scales, probes, packed4)
    rows = leaf_rows[probes.long()]                 # [t, P, cap]
    scores = scores.masked_fill(rows[:, None] < 0, MIN_FLOAT)
    pad = (-cap) % buckets
    if pad:
        scores = F.pad(scores, (0, pad), value=MIN_FLOAT)
        rows = F.pad(rows, (0, pad), value=-1)
    groups = num_probes * (cap + pad) // buckets
    scores = scores.reshape(qn, groups, buckets)
    rows = rows.reshape(tiles, 1, groups, buckets).expand(
        tiles, query_tile, groups, buckets).reshape(qn, groups, buckets)
    return scores, rows


def probed_bucketed_reference(
    queries: Tensor,
    leaf_embs: Tensor,
    leaf_scales: Optional[Tensor],
    leaf_rows: Tensor,
    probes: Tensor,
    buckets: int,
    query_tile: int = 1,
    packed4: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Plain twin of `probed_bucketed_scores`: the candidates of
    `probed_bucket_candidates`, then the first maximum over the group
    axis, chunked over tiles."""
    qn, d = queries.shape
    tiles, num_probes = probes.shape
    cap = leaf_embs.shape[1] * (2 if packed4 else 1)
    step = _chunk(num_probes, cap, d, query_tile)
    vals, rows = [], []
    for i in range(0, tiles, step):
        q = queries[i * query_tile:(i + step) * query_tile]
        scores, cand = probed_bucket_candidates(
            q, leaf_embs, leaf_scales, leaf_rows, probes[i:i + step],
            buckets, query_tile, packed4,
        )
        v, best = scores.max(dim=1)
        r = torch.gather(cand, 1, best[:, None]).squeeze(1)
        vals.append(v)
        rows.append(torch.where(v <= MIN_FLOAT, -1, r).to(torch.int32))
    if not vals:
        return (torch.empty((0, buckets), device=queries.device),
                torch.empty((0, buckets), dtype=torch.int32,
                            device=queries.device))
    return torch.cat(vals), torch.cat(rows)


# --- The kernels' plans -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cached_arange(n: int, device: torch.device) -> Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _arange(n: int, device: torch.device) -> Tensor:
    """`arange(n)` int32, kept between eager calls; a trace (an export)
    records a fresh one instead of a cached constant."""
    if torch.compiler.is_compiling():
        return torch.arange(n, dtype=torch.int32, device=device)
    return _cached_arange(n, device)


def leaf_groups(probes: Tensor,
                num_leaves: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K4's leaf-major plan: `(order, bounds, last, block_leaf)`, int32.

    `order` `[Q·P]` lists the flat pairs `q·P + p` sorted by leaf
    (stable); leaf l's pairs sit at `[bounds[l], bounds[l + 1])` of it
    (`bounds` `[L + 2]`), probes outside `[0, L)` as leaf `L`. Each leaf's
    pairs are cut into groups of at most `GROUP`, one block each, the
    leaf's groups the blocks `[last[l] − groups_l, last[l])` (`last`
    `[L + 1]`, cumulative); `block_leaf` `[⌈Q·P/GROUP⌉ + L]` gives each
    block's leaf, `L + 1` past the live groups (Σ⌈c_l/GROUP⌉ over L + 1
    runs is at most ⌈Q·P/GROUP⌉ + L). Ten device ops and no value read
    back to the host, so the call stays asynchronous and graph-capturable.
    """
    device = probes.device
    n = probes.numel()
    # Ids outside [0, L) → L: -1 and L both land on L modulo L + 1.
    key = (probes.reshape(-1).to(torch.int32).clamp(-1, num_leaves)
           .remainder_(num_leaves + 1))
    keys, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(keys, _arange(num_leaves + 2, device),
                                out_int32=True)
    per = bounds.diff().add_(GROUP - 1).div_(GROUP, rounding_mode="floor")
    last = torch.cumsum(per, 0, dtype=torch.int32)
    block_leaf = torch.searchsorted(
        last, _arange(-(-n // GROUP) + num_leaves, device), right=True,
        out_int32=True)
    return order.to(torch.int32), bounds, last, block_leaf


def probe_splits(num_probes: int, splits: int) -> list:
    """K5's probe range `[P·z/S, P·(z+1)/S)` of each split z, as the
    kernel computes it."""
    return [(num_probes * z // splits, num_probes * (z + 1) // splits)
            for z in range(splits)]


def bucketed_splits(tiles: int, query_tile: int, buckets: int,
                    num_probes: int, sms: int) -> int:
    """Splits of K5's probe walk: enough that the grid holds
    `_K5_BLOCKS_PER_SM` blocks an SM and no split walks more than
    `_SPLIT_PROBES` probes, at most one a probe."""
    blocks = (-(-buckets // _BUCKET_BLOCK) * tiles
              * -(-query_tile // _QUERY_BLOCK))
    want = max(-(-_K5_BLOCKS_PER_SM * sms // max(1, blocks)),
               -(-num_probes // _SPLIT_PROBES))
    return max(1, min(num_probes, want))


def int8_query_block(query_tile: int) -> int:
    """Queries a K5 int8 block multiplies: the smallest of 16, 32 and 64
    that holds the tile, else 64 (a tile then takes several blocks)."""
    return next((b for b in _INT8_QUERY_BLOCKS if query_tile <= b),
                _INT8_QUERY_BLOCKS[-1])


def int8_tile_groups(cap: int, buckets: int) -> list:
    """Groups of `buckets` slots a leaf has that reach each 64-bucket
    tile: ⌈(cap − b0) / B⌉ for b0 = 0, 64, … < B."""
    return [-(-(cap - b0) // buckets)
            for b0 in range(0, buckets, _BUCKET_BLOCK)]


def int8_splits(tiles: int, query_tile: int, buckets: int, cap: int,
                num_probes: int, sms: int) -> int:
    """S of K5's int8 body: bucket tile b0's walk of P·G_bt units is
    split S·G_bt ways, so every block walks about P / S units; S is the
    least that gives the grid `_K5_BLOCKS_PER_SM` blocks an SM and keeps
    a block's probes within `_INT8_SPAN`, at most P."""
    qblocks = -(-query_tile // int8_query_block(query_tile))
    blocks = tiles * qblocks * sum(int8_tile_groups(cap, buckets))
    want = max(-(-_K5_BLOCKS_PER_SM * sms // max(1, blocks)),
               -(-num_probes // _INT8_SPAN))
    return max(1, min(num_probes, want))


def int8_units(num_probes: int, groups: int, splits: int) -> list:
    """The units `[U·z/S', U·(z+1)/S')` of each split z of a bucket tile
    with `groups` groups a leaf (U = P·groups, S' = splits·groups), as
    the kernel computes them; unit u is (probe u // groups, group
    u % groups), its order key."""
    units, parts = num_probes * groups, splits * groups
    return [(units * z // parts, units * (z + 1) // parts)
            for z in range(parts)]


def k5_splits(fmt: str, tiles: int, query_tile: int, buckets: int,
              cap: int, num_probes: int, sms: int) -> int:
    """The splits K5 launches with for leaves of format `fmt`."""
    if fmt == "int8":
        return int8_splits(tiles, query_tile, buckets, cap, num_probes, sms)
    return bucketed_splits(tiles, query_tile, buckets, num_probes, sms)


def merge_probe_splits_reference(vals: Tensor,
                                 rows: Tensor) -> Tuple[Tensor, Tensor]:
    """Twin of the kernel merging K5's split planes `[S, Q, B]` in order
    of split: a later split replaces only where strictly greater."""
    best_v, best_r = vals[0], rows[0]
    for v, r in zip(vals[1:], rows[1:]):
        better = v > best_v
        best_v = torch.where(better, v, best_v)
        best_r = torch.where(better, r, best_r)
    return best_v, best_r


# --- The CUDA kernels --------------------------------------------------------

def _leaf_fake(queries, leaves, scales, order, bounds, last, block_leaf,
               fmt, num_probes, cap, mask_value):
    """K4's op output without running it (`torch.export`'s tracing)."""
    return queries.new_empty((queries.shape[0], num_probes * cap),
                             dtype=torch.float32)


def _bucketed_fake(queries, leaves, scales, leaf_rows, probes, fmt,
                   query_tile, cap, buckets, splits, mask_value):
    """K5's op outputs without running them."""
    qn = queries.shape[0]
    return (queries.new_empty((qn, buckets), dtype=torch.float32),
            queries.new_empty((qn, buckets), dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _ops():
    """The K4 and K5 dispatcher ops, their library built and loaded at
    first use."""
    cuda_build.torch_ops()
    torch.library.register_fake(
        "recommenders_tpu_torch::probed_leaf_scores", _leaf_fake)
    torch.library.register_fake(
        "recommenders_tpu_torch::probed_bucketed_scores", _bucketed_fake)
    ops = torch.ops.recommenders_tpu_torch
    return ops.probed_leaf_scores, ops.probed_bucketed_scores


def _prepare(queries, leaf_embs, leaf_scales, probes, packed4):
    """Checks what the kernels take; returns (format, f32 queries,
    int32 probes)."""
    device = queries.device
    if device.type != "cuda":
        raise ValueError(f"queries on {device}: the kernel needs CUDA")
    fmt = _format(leaf_embs, leaf_scales, packed4)
    if fmt in ("int8", "int4"):
        if leaf_embs.dtype != torch.int8:
            raise TypeError(f"codes must be int8, got {leaf_embs.dtype}")
        if leaf_scales.dtype != torch.float32:
            raise TypeError(
                f"scales must be float32, got {leaf_scales.dtype}")
    elif leaf_embs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"leaf rows must be float32 or bfloat16, got {leaf_embs.dtype}")
    if queries.shape[1] > _MAX_DIM:
        raise ValueError(
            f"embedding dim {queries.shape[1]} > {_MAX_DIM}, the kernel "
            "limit")
    queries = queries.to(torch.float32).contiguous()
    probes = probes.to(device=device, dtype=torch.int32).contiguous()
    for t in (leaf_embs, leaf_scales):
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, queries on {device}")
        if not t.is_contiguous():
            raise ValueError("leaf scoring needs contiguous leaves/scales")
    return fmt, queries, probes


def _scales_arg(queries: Tensor, leaf_scales: Optional[Tensor]) -> Tensor:
    """The op's scales argument: an empty tensor stands for none."""
    if leaf_scales is None:
        return queries.new_empty((0,), dtype=torch.float32)
    return leaf_scales


def _launch_leaf(queries, leaf_embs, leaf_scales, probes, cap, packed4):
    fmt, queries, probes = _prepare(queries, leaf_embs, leaf_scales, probes,
                                    packed4)
    qn = queries.shape[0]
    num_probes = probes.shape[1]
    num_leaves = leaf_embs.shape[0]
    if qn * num_probes * cap == 0:
        return torch.empty((qn, num_probes * cap), dtype=torch.float32,
                           device=queries.device)
    if qn * num_probes > 2**31 - 1:
        raise ValueError(f"{qn} × {num_probes} pairs exceed int32")
    order, bounds, last, block_leaf = leaf_groups(probes, num_leaves)
    out = _ops()[0](queries, leaf_embs, _scales_arg(queries, leaf_scales),
                    order, bounds, last, block_leaf, _FORMATS[fmt],
                    num_probes, cap, MIN_FLOAT)
    if not torch.compiler.is_compiling():   # an export's trace launches none
        probed_leaf_scores.launches += 1
        probed_leaf_scores.launches_by_format[fmt] += 1
    return out


def _launch_bucketed(queries, leaf_embs, leaf_scales, leaf_rows, probes,
                     buckets, query_tile, cap, packed4):
    fmt, queries, probes = _prepare(queries, leaf_embs, leaf_scales, probes,
                                    packed4)
    if leaf_rows.dtype != torch.int32 or not leaf_rows.is_contiguous():
        raise TypeError("leaf_rows must be contiguous int32")
    if leaf_rows.device != queries.device:
        raise ValueError(f"leaf_rows on {leaf_rows.device}")
    device = queries.device
    qn = queries.shape[0]
    tiles, num_probes = probes.shape
    if qn == 0:
        return (torch.empty((0, buckets), dtype=torch.float32, device=device),
                torch.empty((0, buckets), dtype=torch.int32, device=device))
    splits = k5_splits(fmt, tiles, query_tile, buckets, cap, num_probes,
                       cuda_build.sm_count(device))
    if fmt == "int8":
        if splits * sum(int8_tile_groups(cap, buckets)) > 65535:
            raise ValueError(f"{buckets} buckets of a {cap}-slot leaf "
                             "exceed the grid")
    elif tiles * -(-query_tile // _QUERY_BLOCK) > 65535:
        raise ValueError(f"{tiles} tiles of {query_tile} exceed the grid")
    vals, rows = _ops()[1](queries, leaf_embs,
                           _scales_arg(queries, leaf_scales), leaf_rows,
                           probes, _FORMATS[fmt], query_tile, cap, buckets,
                           splits, MIN_FLOAT)
    if not torch.compiler.is_compiling():   # an export's trace launches none
        probed_bucketed_scores.launches += 1
        probed_bucketed_scores.launches_by_format[fmt] += 1
    return vals, rows
