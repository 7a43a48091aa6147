"""ScaNN-equivalent approximate retrieval index: partition → probe → score.

Port of `recommenders_tpu/layers/approximate.py`, itself the rebuild of
the reference's ScaNN layer
(`tensorflow_recommenders/layers/factorized_top_k.py:613-793`) as device
code:

  - **Partitioning**: k-means over the corpus into `num_leaves` leaves
    (Lloyd iterations with device matmuls), then bounded-capacity packing
    with spill to the next-nearest leaf with space.
  - **Search**: score queries × centroids, probe the top
    `num_leaves_to_search` leaves and score only their rows in place:
    `ops.leaf_scoring.probed_leaf_scores` (K4) and a `[Q, P·cap]` top-k,
    or, with `scoring_buckets`, `probed_bucketed_scores` (K5), which folds
    the scores into per-bucket argmax cells, and a top-k over the buckets.
  - **Quantization** (optional): int8 or nibble-packed int4 leaves with
    per-row scales, or bf16 leaves.
  - **Reordering** (optional): the best `num_reordering_candidates` are
    re-scored exactly from the stored corpus and re-ranked.

The NumPy draws (initial centroids, reseeds, samples) are the JAX
package's, call for call, so both packages start k-means from the same
centroids for the same seed. Leaf scoring dispatches on the tensors'
device: the plain twins on the CPU, the CUDA kernels on the card.

An empty result slot (k larger than the valid slots probed, or an empty
bucket) carries row -1 and identifier -1; string-identified indexes
decode it to the empty identifier (`TopK._decode`), never to row 0's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.ops import leaf_scoring
from recommenders_tpu_torch.ops import sparse_apply
from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.ops import topk as topk_ops
from recommenders_tpu_torch.utils import profiling

Tensor = torch.Tensor

MIN_FLOAT = topk_ops.MIN_FLOAT

# Identifier of an empty result slot.
EMPTY_ID = -1

_full_f32 = scoring._full_f32_matmul


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _half_norms(centroids: Tensor) -> Tensor:
    return 0.5 * torch.sum(torch.square(centroids), dim=1)


def _rows(index: np.ndarray, device) -> Tensor:
    return torch.as_tensor(index, dtype=torch.long, device=device)


# --- Host build --------------------------------------------------------------

def _assign_chunk(chunk: Tensor, centroids: Tensor) -> Tensor:
    """Nearest centroid by squared L2: argmax(x·c − ‖c‖²/2)."""
    with _full_f32():
        affinity = chunk @ centroids.T - _half_norms(centroids)
    return torch.argmax(affinity, dim=1)


def assign(
    data: np.ndarray, centroids: np.ndarray, chunk_size: int = 65536,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Nearest-centroid assignment for all rows, chunked, on `device`."""
    centroids_dev = torch.as_tensor(centroids, dtype=torch.float32,
                                    device=device)
    out = np.empty((data.shape[0],), np.int32)
    for start in range(0, data.shape[0], chunk_size):
        chunk = torch.as_tensor(data[start:start + chunk_size],
                                dtype=torch.float32, device=device)
        out[start:start + chunk.shape[0]] = (
            _assign_chunk(chunk, centroids_dev).cpu().numpy()
        )
    return out


def kmeans(
    data: np.ndarray,
    num_clusters: int,
    iterations: int = 10,
    seed: int = 0,
    chunk_size: int = 65536,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Lloyd's k-means; assignment on `device`, centroid update on host."""
    rng = np.random.RandomState(seed)
    n = data.shape[0]
    centroids = data[rng.choice(n, size=num_clusters, replace=False)]
    for _ in range(iterations):
        assignments = assign(data, centroids, chunk_size, device)
        sums = np.zeros_like(centroids)
        np.add.at(sums, assignments, data)
        counts = np.bincount(assignments, minlength=num_clusters)
        empty = counts == 0
        counts = np.maximum(counts, 1)
        centroids = sums / counts[:, None]
        if empty.any():
            # Re-seed empty clusters from random points.
            centroids[empty] = data[
                rng.choice(n, size=int(empty.sum()), replace=False)
            ]
    return centroids.astype(np.float32)


def _pack_leaves(
    candidates: np.ndarray,
    identifiers: np.ndarray,
    centroids: np.ndarray,
    capacity: int,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Buckets rows into fixed-capacity leaves, spilling overflow to the
    next-nearest leaf with space. Returns (embs, ids, rows, valid).

    A row's slot is its rank among its leaf's rows (a grouped cumulative
    count); only overflow rows rank every centroid, one by one.
    """
    num_leaves = centroids.shape[0]
    n, dim = candidates.shape
    assignments = assign(candidates, centroids, device=device)

    order = np.argsort(assignments, kind="stable")
    sorted_assign = assignments[order]
    group_start = np.searchsorted(sorted_assign, np.arange(num_leaves))
    slot_sorted = np.arange(n) - group_start[sorted_assign]
    leaf_of = assignments.astype(np.int32).copy()
    slot_of = np.empty((n,), np.int32)
    slot_of[order] = slot_sorted.astype(np.int32)

    fill = np.minimum(
        np.bincount(assignments, minlength=num_leaves), capacity
    ).astype(np.int32)
    for row in np.where(slot_of >= capacity)[0]:
        affinity = (
            candidates[row] @ centroids.T
            - 0.5 * np.sum(np.square(centroids), axis=1)
        )
        for leaf in np.argsort(-affinity):
            if fill[leaf] < capacity:
                leaf_of[row] = leaf
                slot_of[row] = fill[leaf]
                fill[leaf] += 1
                break
        else:
            raise ValueError(
                "Leaf capacity too small to hold the corpus; increase "
                "`leaf_capacity` (or `num_leaves`)."
            )

    embs = np.zeros((num_leaves, capacity, dim), np.float32)
    ids = np.zeros((num_leaves, capacity), identifiers.dtype)
    rows = np.full((num_leaves, capacity), -1, np.int32)
    valid = np.zeros((num_leaves, capacity), bool)
    embs[leaf_of, slot_of] = candidates
    ids[leaf_of, slot_of] = identifiers
    rows[leaf_of, slot_of] = np.arange(n, dtype=np.int32)
    valid[leaf_of, slot_of] = True
    return embs, ids, rows, valid


# --- Device build ------------------------------------------------------------

def _topr_assign_soar_device(
    corpus: Tensor, centroids: Tensor, soar_lambda: float, r: int,
    chunk: int,
) -> Tensor:
    """Top-`r` secondary leaves per row under the SOAR objective (Sun et
    al. 2023): rank leaves by ‖x − c‖² + λ·(r₁·(x − c))²/‖r₁‖², where
    r₁ = x − c₁ is the primary residual, the primary leaf excluded."""
    n = corpus.shape[0]
    half_norms = _half_norms(centroids)
    out = torch.empty((n, r), dtype=torch.int32, device=corpus.device)
    with _full_f32():
        for start in range(0, n, chunk):
            block = corpus[start:start + chunk]
            affinity = block @ centroids.T - half_norms
            primary = torch.argmax(affinity, dim=1)
            dist2 = -2.0 * affinity
            resid = block - centroids[primary]
            r_norm2 = torch.clamp(
                torch.sum(torch.square(resid), dim=1, keepdim=True), min=1e-12
            )
            r_dot_x = torch.sum(resid * block, dim=1, keepdim=True)
            parallel = r_dot_x - resid @ centroids.T
            loss = dist2 + soar_lambda * torch.square(parallel) / r_norm2
            loss.scatter_(1, primary[:, None], float("inf"))
            idx = torch.topk(-loss, r, dim=1).indices
            out[start:start + block.shape[0]] = idx.to(torch.int32)
    return out


def _topr_assign_device(
    corpus: Tensor, centroids: Tensor, r: int, chunk: int
) -> Tensor:
    """Top-`r` nearest centroids per row, `[n, r]` int32, over corpus
    chunks of `chunk` rows (the `[chunk, L]` affinity bounds memory)."""
    n = corpus.shape[0]
    half_norms = _half_norms(centroids)
    out = torch.empty((n, r), dtype=torch.int32, device=corpus.device)
    with _full_f32():
        for start in range(0, n, chunk):
            block = corpus[start:start + chunk]
            affinity = block @ centroids.T - half_norms
            if r == 1:
                idx = torch.argmax(affinity, dim=1, keepdim=True)
            else:
                idx = torch.topk(affinity, r, dim=1).indices
            out[start:start + block.shape[0]] = idx.to(torch.int32)
    return out


def _assign_device(corpus: Tensor, centroids: Tensor, chunk: int) -> Tensor:
    """Nearest-centroid assignment with the corpus on the device."""
    return _topr_assign_device(corpus, centroids, 1, chunk)[:, 0]


def _kmeans_step_device(
    corpus: Tensor, centroids: Tensor, reseed: Tensor, num_clusters: int,
    chunk: int, balance: int = 0,
) -> Tensor:
    """One Lloyd iteration on the device (assign + per-cluster sums).

    Empty clusters re-seed from `reseed`. With `balance > 0`, that many
    of the lightest clusters move next to the heaviest (split-reseed
    balancing), offset 5 % toward a reseed row.

    The cluster sums add each cluster's rows in row order
    (`sparse_apply.fixed_order_index_add_`), so a build is the same run
    to run; `index_add_`'s atomics on the card would add in arrival
    order.
    """
    assignments = _assign_device(corpus, centroids, chunk).long()
    sums = sparse_apply.fixed_order_index_add_(torch.zeros(
        (num_clusters, corpus.shape[1]), dtype=torch.float32,
        device=corpus.device,
    ), assignments, corpus)
    counts = torch.bincount(assignments, minlength=num_clusters).to(
        torch.float32
    )
    empty = counts == 0
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    new = torch.where(empty[:, None], reseed, new)
    if balance:
        order = torch.argsort(counts, stable=True)
        light = order[:balance]
        heavy = order[-balance:]
        new[light] = new[heavy] + 0.05 * (reseed[:balance] - new[heavy])
    return new


def kmeans_device(
    corpus: Tensor,
    num_clusters: int,
    iterations: int = 10,
    seed: int = 0,
    chunk: int = 16384,
    sample: Optional[int] = None,
    balance_fraction: float = 0.0,
) -> Tensor:
    """Lloyd's k-means with the corpus resident on its device.

    `sample` caps the training rows (a random subset); `balance_fraction`
    enables split-reseed balancing on every iteration but the last two.
    NumPy draws, in the JAX package's order: the sample, the initial
    centroids, then one reseed draw per iteration.
    """
    rng = np.random.RandomState(seed)
    n = corpus.shape[0]
    train = corpus
    if sample is not None and sample < n:
        train = corpus[_rows(rng.choice(n, size=sample, replace=False),
                             corpus.device)]
        n = sample
    centroids = train[_rows(rng.choice(n, size=num_clusters, replace=False),
                            corpus.device)]
    nb = int(balance_fraction * num_clusters)
    for it in range(iterations):
        reseed = train[_rows(rng.randint(0, n, size=num_clusters),
                             corpus.device)]
        centroids = _kmeans_step_device(
            train, centroids, reseed, num_clusters, chunk,
            balance=nb if it < iterations - 2 else 0,
        )
    return centroids


def _pack_assign_device(
    choices: Tensor, num_leaves: int, capacity: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Bounded-capacity leaf assignment from per-row top-R choices.

    R rounds: in round j every unplaced row bids for its j-th nearest
    leaf, ranks among that leaf's bidders by a stable sort, and is
    accepted while `fill + rank < capacity`. Rows still unplaced then
    fill the global pool of free slots in leaf order.

    Returns `(leaf_of, slot_of, unplaced)`; unplaced rows carry
    `leaf_of == num_leaves`.
    """
    n, r = choices.shape
    device = choices.device
    choices = choices.long()
    iota = torch.arange(n, device=device)
    leaves = torch.arange(num_leaves, device=device)
    leaf_of = torch.full((n,), num_leaves, dtype=torch.long, device=device)
    slot_of = torch.zeros((n,), dtype=torch.long, device=device)
    fill = torch.zeros((num_leaves,), dtype=torch.long, device=device)
    for j in range(r):
        unplaced = leaf_of == num_leaves
        cand = torch.where(unplaced, choices[:, j], num_leaves)
        safe = torch.clamp(cand, max=num_leaves - 1)
        order = torch.argsort(cand, stable=True)
        sorted_cand = cand[order]
        group_start = torch.searchsorted(sorted_cand, leaves)
        rank_sorted = iota - group_start[
            torch.clamp(sorted_cand, max=num_leaves - 1)
        ]
        rank = torch.empty_like(rank_sorted)
        rank[order] = rank_sorted
        slot = rank + fill[safe]
        ok = unplaced & (slot < capacity)
        leaf_of = torch.where(ok, cand, leaf_of)
        slot_of = torch.where(ok, slot, slot_of)
        fill = fill + torch.bincount(safe[ok], minlength=num_leaves)

    unplaced = leaf_of == num_leaves
    cum = torch.cumsum(capacity - fill, dim=0)
    pos = torch.cumsum(unplaced.long(), dim=0) - 1  # rank among unplaced
    dest_leaf = torch.searchsorted(cum, pos, right=True)
    in_pool = unplaced & (pos < cum[-1])
    safe_leaf = torch.clamp(dest_leaf, max=num_leaves - 1)
    prev_cum = torch.where(
        safe_leaf > 0, cum[torch.clamp(safe_leaf - 1, min=0)], 0
    )
    dest_slot = pos - prev_cum + fill[safe_leaf]
    leaf_of = torch.where(in_pool, safe_leaf, leaf_of)
    slot_of = torch.where(in_pool, dest_slot, slot_of)
    return (leaf_of.to(torch.int32), slot_of.to(torch.int32),
            torch.sum(leaf_of == num_leaves))


def _scatter_leaves(
    values: Tensor, leaf_of: Tensor, slot_of: Tensor,
    num_leaves: int, capacity: int, fill=0,
) -> Tensor:
    """Scatters per-row values into `[num_leaves, capacity, ...]` blocks;
    unplaced rows (leaf == num_leaves) drop out. Empty slots hold
    `fill`."""
    out = torch.full((num_leaves, capacity) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    keep = leaf_of < num_leaves
    out[leaf_of[keep].long(), slot_of[keep].long()] = values[keep]
    return out


def _scatter_batch(
    embs_buf: Tensor, rows_buf: Tensor, valid_buf: Tensor,
    batch: Tensor, leaf_b: Tensor, slot_b: Tensor, row0: int,
) -> None:
    """Scatters one corpus batch into unquantized leaf storage, in place.
    `row0` is the batch's first global row."""
    keep = leaf_b < embs_buf.shape[0]
    leaf, slot = leaf_b[keep].long(), slot_b[keep].long()
    rows = row0 + torch.arange(batch.shape[0], dtype=torch.int32,
                               device=batch.device)
    embs_buf[leaf, slot] = batch[keep].to(embs_buf.dtype)
    rows_buf[leaf, slot] = rows[keep]
    valid_buf[leaf, slot] = True


def _scatter_batch_quantized(
    codes_buf: Tensor, scales_buf: Tensor, rows_buf: Tensor,
    valid_buf: Tensor, batch: Tensor, leaf_b: Tensor, slot_b: Tensor,
    row0: int, threshold, bits: int, half: int,
) -> None:
    """Quantizes one batch and scatters it into int8 (or nibble-packed
    int4) leaf storage, in place. For `bits=4`, slot `s` lands in packed
    slot `s % half`: the low nibble for `s < half`, the high one
    otherwise. Each (leaf, packed slot, nibble) is written once over a
    zero buffer, so an OR merges the two halves."""
    keep = leaf_b < codes_buf.shape[0]
    leaf, slot = leaf_b[keep].long(), slot_b[keep].long()
    rows = row0 + torch.arange(batch.shape[0], dtype=torch.int32,
                               device=batch.device)
    scales, codes = quantization.quantize_block(batch, threshold, bits=bits)
    codes = codes[keep]
    if bits == 4:
        # Low then high nibbles, each pass with unique (leaf, slot) pairs.
        for high in (False, True):
            m = (slot >= half) if high else (slot < half)
            li, si = leaf[m], slot[m] % half
            codes_buf[li, si] = quantization.merge_nibbles(
                codes_buf[li, si], codes[m], high)
    else:
        codes_buf[leaf, slot] = codes
    scales_buf[leaf, slot] = scales[keep]
    rows_buf[leaf, slot] = rows[keep]
    valid_buf[leaf, slot] = True


# --- Query path --------------------------------------------------------------

def _search(
    queries: Tensor,
    centroids: Tensor,
    leaf_embs: Tensor,
    leaf_scales: Optional[Tensor],
    leaf_ids: Tensor,
    leaf_rows: Tensor,
    leaf_valid: Tensor,
    num_probes: int,
    k: int,
    quantized: Optional[str],
    dedup: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Probe the top leaves, score their rows in place (K4), top-k.

    Returns (scores, identifiers, global rows). With `dedup` (SOAR packs
    rows twice), duplicate rows among the 2k best are removed before the
    final top-k. `quantized` is None, "int8" or "int4".
    """
    with _full_f32():
        cscores = queries @ centroids.T  # [Q, L]
    _, probes = topk_ops.top_k(cscores, num_probes)  # [Q, P]
    q = queries.shape[0]
    scores = leaf_scoring.probed_leaf_scores(
        queries, leaf_embs, leaf_scales if quantized else None, probes,
        packed4=quantized == "int4",
    )
    scores = scores.masked_fill(~leaf_valid[probes].reshape(q, -1),
                                MIN_FLOAT)
    ids = leaf_ids[probes].reshape(q, -1)
    rows = leaf_rows[probes].reshape(q, -1)
    k = min(k, scores.shape[1])
    fetch = min(2 * k, scores.shape[1]) if dedup else k
    top_scores, idx = topk_ops.top_k(scores, fetch)
    top_rows = topk_ops.take_along_rows(rows, idx)
    top_ids = torch.where(top_rows >= 0,
                          topk_ops.take_along_rows(ids, idx), EMPTY_ID)
    if dedup:
        top_scores, top_ids, top_rows = _dedup_topk(
            top_scores, top_ids, top_rows, k
        )
    return top_scores, top_ids, top_rows


def _dedup_topk(
    top_scores: Tensor, top_ids: Tensor, top_rows: Tensor, k: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Removes duplicate global rows from a 2k-wide shortlist, re-top-ks
    to k: sort by row, drop the second of each equal pair (SOAR copies
    score identically), re-top-k."""
    q = top_scores.shape[0]
    order = torch.argsort(top_rows, dim=1, stable=True)
    sr = torch.gather(top_rows, 1, order)
    ss = torch.gather(top_scores, 1, order)
    si = torch.gather(top_ids, 1, order)
    dup = torch.cat(
        [torch.zeros((q, 1), dtype=torch.bool, device=sr.device),
         sr[:, 1:] == sr[:, :-1]], dim=1,
    )
    ss = ss.masked_fill(dup, MIN_FLOAT)
    top_scores, idx2 = topk_ops.top_k(ss, k)
    return (top_scores, topk_ops.take_along_rows(si, idx2),
            topk_ops.take_along_rows(sr, idx2))


def _tile_probes(
    queries: Tensor, cscores: Tensor, num_probes: int, tile: int
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Probe lists per query tile.

    `tile == 1`: per-query top-P probes, queries untouched. `tile > 1`:
    queries sort by primary centroid so tiles are probe-coherent; each
    member contributes its top-⌊P/tile⌋ leaves, interleaved rank-major,
    the rest are the tile's consensus leaves (max affinity over members),
    and each tile's list is sorted so duplicates sit side by side.

    Returns `(queries, probes [tiles, P] int32, inv)`, where `inv`
    restores the original query order (None when tile == 1).
    """
    if tile == 1:
        _, probes = topk_ops.top_k(cscores, num_probes)
        return queries, probes.to(torch.int32), None
    q = queries.shape[0]
    primary = torch.argmax(cscores, dim=1)
    order = torch.argsort(primary, stable=True)
    queries = queries[order]
    cscores = cscores[order]
    tiles = q // tile
    p_each = num_probes // tile
    parts = []
    if p_each:
        _, per_q = topk_ops.top_k(cscores, p_each)  # [Q, p']
        parts.append(per_q.reshape(tiles, tile, p_each).transpose(1, 2)
                     .reshape(tiles, tile * p_each))
    rem = num_probes - p_each * tile
    if rem:
        tile_aff = torch.amax(cscores.reshape(tiles, tile, -1), dim=1)
        _, shared = topk_ops.top_k(tile_aff, rem)
        parts.append(shared)
    probes = torch.sort(torch.cat(parts, dim=1), dim=1).values
    return queries, probes.to(torch.int32), torch.argsort(order)


def _search_bucketed(
    queries: Tensor,
    centroids: Tensor,
    leaf_embs: Tensor,
    leaf_scales: Optional[Tensor],
    leaf_rows: Tensor,
    identifiers: Optional[Tensor],
    num_probes: int,
    k: int,
    quantized: Optional[str],
    dedup: bool,
    buckets: int,
    tile: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Probed search through the bucketed-argmax kernel (K5): scores fold
    into `buckets` cells per query inside the kernel, so the final top-k
    is over B columns; with `tile > 1`, each tile of queries shares one
    probe list. Query order is restored on return."""
    with profiling.annotate("scann.probe"):
        with _full_f32():
            cscores = queries @ centroids.T  # [Q, L]
        queries, probes, inv = _tile_probes(queries, cscores, num_probes,
                                            tile)
    packed4 = quantized == "int4"
    # The fold width cannot exceed a leaf's capacity.
    buckets = min(buckets, leaf_embs.shape[1] * (2 if packed4 else 1))
    vals, rows = leaf_scoring.probed_bucketed_scores(
        queries, leaf_embs, leaf_scales if quantized else None, leaf_rows,
        probes, buckets, query_tile=tile, packed4=packed4,
    )
    with profiling.annotate("scann.merge"):
        if inv is not None:
            vals, rows = vals[inv], rows[inv]
        k = min(k, buckets)
        fetch = min(2 * k, buckets) if dedup else k
        top_scores, idx = topk_ops.top_k(vals, fetch)
        top_rows = topk_ops.take_along_rows(rows, idx)
        # identifiers=None: rows are the ids.
        if identifiers is None:
            top_ids = top_rows
        else:
            top_ids = torch.where(
                top_rows >= 0,
                identifiers[torch.clamp(top_rows, min=0).long()], EMPTY_ID,
            )
        if dedup:
            top_scores, top_ids, top_rows = _dedup_topk(
                top_scores, top_ids, top_rows, k
            )
    return top_scores, top_ids, top_rows


def _reorder(
    queries: Tensor,
    candidate_rows: Tensor,
    scores: Tensor,
    corpus: Tensor,
    identifiers: Tensor,
    k: int,
) -> Tuple[Tensor, Tensor]:
    """Exact re-scoring of the shortlisted rows (ScaNN's reorder pass);
    the stored corpus promotes to f32."""
    rows = candidate_rows.long()
    gathered = corpus[torch.clamp(rows, min=0)]  # [Q, R, D]
    with _full_f32():
        exact = torch.einsum("qd,qrd->qr", queries.to(torch.float32),
                             gathered.to(torch.float32))
    exact = exact.masked_fill(~(scores > MIN_FLOAT / 2), MIN_FLOAT)
    k = min(k, exact.shape[1])
    top_scores, idx = topk_ops.top_k(exact, k)
    top_rows = topk_ops.take_along_rows(rows, idx)
    ids = identifiers[torch.clamp(top_rows, min=0)]
    return top_scores, torch.where(top_scores > MIN_FLOAT / 2, ids, EMPTY_ID)


# --- The whole query path, as a function of the index's arrays ----------------

# The arrays a query reads, in `_export_scann`'s argument order
# (`recommenders_tpu/utils/export.py:323-330`); `ScaNN.serving_arrays`
# holds those its settings use.
SERVING_ARRAYS = ("centroids", "leaf_embs", "leaf_scales", "leaf_ids",
                  "leaf_rows", "leaf_valid", "flat_ids", "corpus",
                  "corpus_identifiers")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """A built index's query settings (`ScaNN.serving_config`)."""

    num_probes: int
    quantize: Optional[str]
    dedup: bool
    reorder_n: Optional[int]
    scoring_buckets: Optional[int]
    probe_tile: int
    query_batch: int
    num_candidates: int


def search(queries: Tensor, arrays: dict, config: ServingConfig,
           k: int) -> Tuple[Tensor, Tensor]:
    """`ScaNN.__call__` on query embeddings, less the string decode: the
    queries in chunks of `query_batch` (padded so every chunk has one
    shape), probe → K4 or K5 → optional exact reorder. A pure function
    of `arrays` (`SERVING_ARRAYS`, absent names as None), so the index
    and its export (`utils.export`) run the same ops."""
    queries = queries.to(torch.float32)
    k = min(k, config.num_candidates)
    qn = queries.shape[0]
    qb = config.query_batch
    if qn <= qb:
        return _search_chunk(queries, arrays, config, k)
    padded_q = _round_up(qn, qb)
    if padded_q != qn:
        queries = F.pad(queries, (0, 0, 0, padded_q - qn))
    parts = [_search_chunk(queries[i:i + qb], arrays, config, k)
             for i in range(0, padded_q, qb)]
    return (torch.cat([p[0] for p in parts])[:qn],
            torch.cat([p[1] for p in parts])[:qn])


def _search_chunk(queries: Tensor, arrays: dict, config: ServingConfig,
                  k: int) -> Tuple[Tensor, Tensor]:
    a = arrays
    shortlist = max(k, config.reorder_n) if config.reorder_n else k
    if config.scoring_buckets is not None:
        qn = queries.shape[0]
        pad = (-qn) % config.probe_tile
        queries_p = F.pad(queries, (0, 0, 0, pad)) if pad else queries
        scores, ids, rows = _search_bucketed(
            queries_p, a["centroids"], a["leaf_embs"], a.get("leaf_scales"),
            a["leaf_rows"], a.get("flat_ids"), config.num_probes, shortlist,
            config.quantize, config.dedup, config.scoring_buckets,
            config.probe_tile,
        )
        if pad:
            scores, ids, rows = scores[:qn], ids[:qn], rows[:qn]
    else:
        scores, ids, rows = _search(
            queries, a["centroids"], a["leaf_embs"], a.get("leaf_scales"),
            a["leaf_ids"], a["leaf_rows"], a["leaf_valid"],
            config.num_probes, shortlist, config.quantize, config.dedup,
        )
    if config.reorder_n:
        return _reorder(queries, rows, scores, a["corpus"],
                        a["corpus_identifiers"], k)
    if scores.shape[1] > k:
        scores, ids = scores[:, :k], ids[:, :k]
    return scores, ids


# --- The index ---------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16)


class ScaNN(factorized_top_k.TopK):
    """Approximate top-K index: partition → probe → (quantized) score →
    optional exact reorder.

    API counterpart of the reference's `ScaNN` layer
    (layers/factorized_top_k.py:613-707): `num_leaves`,
    `num_leaves_to_search` and `num_reordering_candidates` mean the same;
    `quantize` takes the place of `dimensions_per_block`.

    Attributes:
      query_fn: Optional query-embedding function applied before search.
      k: Default number of results.
      num_leaves: Partitions of the k-means tree.
      num_leaves_to_search: Leaves probed per query.
      training_iterations: Lloyd iterations at index build.
      quantize: `False`, `"int8"` (or `True`) or `"int4"`: integer leaves
        with per-row scales; int4 packs two codes per byte.
      leaf_dtype: `torch.float32` or `torch.bfloat16` storage of
        unquantized leaves (exclusive with `quantize`).
      reorder_dtype: `torch.float32` or `torch.bfloat16` storage of the
        exact-reorder corpus.
      anisotropic_quantization_threshold: Score-aware quantization dial
        (ScaNN's `score_ah` parameter); None uses abs-max scales.
      num_reordering_candidates: If set, shortlist size re-scored exactly
        from the stored corpus before the final top-k.
      soar_lambda: If set, every row is also packed into a secondary leaf
        chosen by the SOAR spilling objective; duplicate hits are removed
        at query time. Device build only (NumPy corpora move to it).
      scoring_buckets: If set, probed leaves are scored through the
        bucketed-argmax kernel into this many cells per query (a multiple
        of 128, clamped to the leaf capacity).
      probe_tile: With `scoring_buckets`, queries sort by primary centroid
        and each tile of `probe_tile` queries shares one probe list.
      leaf_capacity: Rows per leaf; defaults to `1.3 × N / num_leaves`
        rounded up to 128 (256 for int4).
      query_batch: Queries scored per search call; larger batches are
        padded and chunked.
      seed: k-means seed.
      kmeans_sample_size: If set, the device build's Lloyd iterations
        train on this many sampled rows.
      kmeans_balance_fraction: Split-reseed balancing of k-means.
      assign_chunk: Corpus rows per assignment block of the device build.
      spill_rounds: Overflow rows spill to at most this many nearest
        leaves in the device build's packing.
      device: Where the index lives (default `"cuda"`).
    """

    def __init__(
        self,
        query_fn: Optional[Callable] = None,
        k: int = 10,
        num_leaves: int = 100,
        num_leaves_to_search: int = 10,
        training_iterations: int = 10,
        quantize=False,
        leaf_dtype: torch.dtype = torch.float32,
        reorder_dtype: torch.dtype = torch.float32,
        anisotropic_quantization_threshold: Optional[float] = 0.2,
        num_reordering_candidates: Optional[int] = None,
        soar_lambda: Optional[float] = None,
        scoring_buckets: Optional[int] = None,
        probe_tile: int = 1,
        leaf_capacity: Optional[int] = None,
        query_batch: int = 256,
        seed: int = 0,
        kmeans_sample_size: Optional[int] = None,
        kmeans_balance_fraction: float = 0.0,
        assign_chunk: int = 16384,
        spill_rounds: int = 8,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(k=k, device=device)
        self.query_fn = query_fn
        self._num_leaves = num_leaves
        self._num_probes = min(num_leaves_to_search, num_leaves)
        self._iterations = training_iterations
        quantize = {True: "int8", False: None}.get(quantize, quantize)
        if quantize not in (None, "int8", "int4"):
            raise ValueError(
                f"quantize must be False, True, 'int8' or 'int4'; got "
                f"{quantize!r}"
            )
        self._quantize = quantize
        if leaf_dtype not in _DTYPES:
            raise ValueError(
                f"leaf_dtype must be float32 or bfloat16, got {leaf_dtype}"
            )
        if reorder_dtype not in _DTYPES:
            raise ValueError(
                f"reorder_dtype must be float32 or bfloat16, "
                f"got {reorder_dtype}"
            )
        if quantize and leaf_dtype != torch.float32:
            raise ValueError(
                "quantize=True stores int8 leaves; leaf_dtype applies "
                "only to unquantized indexes."
            )
        self._leaf_dtype = leaf_dtype
        self._reorder_dtype = reorder_dtype
        self._anisotropic_threshold = anisotropic_quantization_threshold
        self._reorder_n = num_reordering_candidates
        if soar_lambda is not None and soar_lambda < 0:
            raise ValueError(f"soar_lambda must be >= 0, got {soar_lambda}")
        self._soar_lambda = soar_lambda
        if scoring_buckets is not None and scoring_buckets % 128:
            raise ValueError(
                f"scoring_buckets must be a multiple of 128, got "
                f"{scoring_buckets}"
            )
        if probe_tile < 1:
            raise ValueError(f"probe_tile must be >= 1, got {probe_tile}")
        if probe_tile > 1 and scoring_buckets is None:
            raise ValueError(
                "probe_tile > 1 requires scoring_buckets (tile-coherent "
                "probing runs through the bucketed kernel)."
            )
        self._scoring_buckets = scoring_buckets
        self._probe_tile = probe_tile
        self._leaf_capacity = leaf_capacity
        self._query_batch = query_batch
        self._seed = seed
        self._kmeans_sample = kmeans_sample_size
        self._kmeans_balance = kmeans_balance_fraction
        self._assign_chunk = assign_chunk
        self._spill_rounds = spill_rounds
        self._built = False

    def _capacity(self, num_leaves: int, n: int) -> int:
        # SOAR packs every row twice (primary + spilled assignment).
        rows = 2 * n if self._soar_lambda is not None else n
        # Capacities stay on the JAX package's 128-row grid, so both
        # packages build the same leaves. int4 pairs slots (s, s + cap/2)
        # per byte, so its half-capacity sits on that grid: grain 256.
        grain = 256 if self._quantize == "int4" else 128
        if self._leaf_capacity is not None:
            if num_leaves * self._leaf_capacity < rows:
                raise ValueError(
                    f"num_leaves ({num_leaves}) × leaf_capacity "
                    f"({self._leaf_capacity}) = "
                    f"{num_leaves * self._leaf_capacity} cannot hold "
                    f"the {rows} packed rows."
                )
            return _round_up(self._leaf_capacity, grain)
        return _round_up(
            max(1, int(np.ceil(1.3 * rows / num_leaves))), grain
        )

    def index(self, candidates, identifiers=None) -> "ScaNN":
        """Builds the index. A `torch.Tensor` corpus builds on the device
        (k-means, packing and quantization never leave it); a NumPy corpus
        takes the host build. String identifiers stay on the host."""
        identifiers = self._intern_identifiers(identifiers, len(candidates))
        if isinstance(candidates, Tensor):
            return self._index_device(candidates, identifiers)
        if self._soar_lambda is not None:
            # SOAR assignment is implemented on the device only.
            return self._index_device(
                torch.as_tensor(np.asarray(candidates, np.float32)),
                identifiers,
            )
        candidates = np.asarray(candidates, np.float32)
        n = candidates.shape[0]
        ids_np = (np.arange(n, dtype=np.int32) if identifiers is None
                  else identifiers.cpu().numpy())
        num_leaves = min(self._num_leaves, n)
        capacity = self._capacity(num_leaves, n)
        centroids = kmeans(candidates, num_leaves, self._iterations,
                           self._seed, device=self.device)
        embs, ids, rows, valid = _pack_leaves(
            candidates, ids_np, centroids, capacity, self.device
        )

        def dev(array):
            return torch.from_numpy(array).to(self.device)

        self._centroids = dev(centroids)
        self._leaf_ids = dev(ids)
        self._leaf_rows = dev(rows)
        self._leaf_valid = dev(valid)
        if self._quantize:
            bits = 4 if self._quantize == "int4" else 8
            scales, codes = quantization.quantize_rows(
                embs, self._anisotropic_threshold, bits=bits
            )
            codes = dev(codes)
            if bits == 4:
                codes = quantization.pack_nibbles(codes)
            self._leaf_embs = codes
            self._leaf_scales = dev(scales.astype(np.float32))
        else:
            self._leaf_embs = dev(embs).to(self._leaf_dtype)
            self._leaf_scales = None
        ids_dev = dev(ids_np)
        self._corpus = (dev(candidates).to(self._reorder_dtype)
                        if self._reorder_n else None)
        self._identifiers = ids_dev if self._reorder_n else None
        self._flat_ids = ids_dev if self._scoring_buckets is not None else None
        self._num_candidates = n
        self._built = True
        return self

    def _index_device(
        self, candidates: Tensor, identifiers: Optional[Tensor] = None
    ) -> "ScaNN":
        """Device build: Lloyd iterations, top-R assignment, capacity
        packing and quantization all run on the index's device; only the
        unplaced-row count returns to the host."""
        candidates = candidates.to(self.device, torch.float32)
        n = candidates.shape[0]
        if identifiers is None:
            identifiers = torch.arange(n, dtype=torch.int32,
                                       device=self.device)
        num_leaves = min(self._num_leaves, n)
        capacity = self._capacity(num_leaves, n)

        centroids = kmeans_device(
            candidates, num_leaves, self._iterations, self._seed,
            chunk=self._assign_chunk, sample=self._kmeans_sample,
            balance_fraction=self._kmeans_balance,
        )
        soar = self._soar_lambda is not None and num_leaves > 1
        rounds = min(self._spill_rounds,
                     num_leaves - 1 if soar else num_leaves)
        choices = _topr_assign_device(candidates, centroids, rounds,
                                      self._assign_chunk)
        if soar:
            # Each row packs twice: by nearest centroid and by the SOAR
            # objective (primary excluded), in one packing pass.
            choices = torch.cat([choices, _topr_assign_soar_device(
                candidates, centroids, float(self._soar_lambda), rounds,
                self._assign_chunk,
            )])

        def dup(values: Tensor) -> Tensor:
            return torch.cat([values, values]) if soar else values

        leaf_of, slot_of, unplaced = _pack_assign_device(
            choices, num_leaves, capacity
        )
        if int(unplaced) > 0:
            raise ValueError(
                f"{int(unplaced)} rows could not be placed within their "
                f"{rounds} nearest leaves; increase `leaf_capacity`, "
                "`num_leaves`, or `spill_rounds`."
            )

        def scatter(values, fill=0):
            return _scatter_leaves(dup(values), leaf_of, slot_of, num_leaves,
                                   capacity, fill)

        self._centroids = centroids
        self._leaf_ids = scatter(identifiers)
        self._leaf_rows = scatter(
            torch.arange(n, dtype=torch.int32, device=self.device), fill=-1)
        self._leaf_valid = scatter(
            torch.ones((n,), dtype=torch.bool, device=self.device))
        if self._quantize:
            # Quantize the flat corpus, then scatter the codes: the
            # [L, cap, D] float intermediate never exists.
            bits = 4 if self._quantize == "int4" else 8
            scales, codes = quantization.quantize_rows_device(
                candidates, self._anisotropic_threshold, bits=bits
            )
            leaf_codes = scatter(codes)
            if bits == 4:
                leaf_codes = quantization.pack_nibbles(leaf_codes)
            self._leaf_embs = leaf_codes
            self._leaf_scales = scatter(scales)
        else:
            self._leaf_embs = scatter(candidates.to(self._leaf_dtype))
            self._leaf_scales = None
        self._corpus = (candidates.to(self._reorder_dtype)
                        if self._reorder_n else None)
        self._identifiers = identifiers if self._reorder_n else None
        self._flat_ids = (identifiers if self._scoring_buckets is not None
                          else None)
        self._num_candidates = n
        self._built = True
        return self

    def index_streamed(self, batches, num_rows: int,
                       identifiers=None) -> "ScaNN":
        """Streamed partitioned build: the f32 corpus never exists on the
        device. Three passes over `batches` (a zero-arg callable returning
        a fresh iterator of `[b, D]` blocks in corpus order, or a list):
        stride-sample rows for k-means; top-R assignment into an `[N, R]`
        buffer and capacity packing; quantize (or cast) and scatter each
        batch into the preallocated leaves. No SOAR and no reorder (each
        needs corpus-scale state). With `identifiers=None`, global rows
        serve as ids."""
        if self._soar_lambda is not None:
            raise ValueError(
                "index_streamed does not support soar_lambda (SOAR "
                "doubles leaf memory; the streamed build exists because "
                "memory is the binding constraint)."
            )
        if self._reorder_n:
            raise ValueError(
                "index_streamed does not support "
                "num_reordering_candidates (the exact reorder needs the "
                "full-precision corpus resident on the device)."
            )
        if callable(batches):
            factory = batches
        else:
            blocks = list(batches)
            factory = lambda: iter(blocks)  # noqa: E731
        identifiers = self._intern_identifiers(identifiers, num_rows)
        centroids, leaf_of, slot_of, capacity = self._streamed_partition(
            factory, num_rows)
        num_leaves = centroids.shape[0]
        packed4 = self._quantize == "int4"

        # Pass 3: quantize (or cast) and scatter each batch.
        with profiling.phase("scann.build.scatter", self.device):
            d = centroids.shape[1]
            rows_buf = torch.full((num_leaves, capacity), -1,
                                  dtype=torch.int32, device=self.device)
            valid_buf = torch.zeros((num_leaves, capacity), dtype=torch.bool,
                                    device=self.device)
            scales_buf = None
            if self._quantize:
                code_cap = capacity // 2 if packed4 else capacity
                codes_buf = torch.zeros((num_leaves, code_cap, d),
                                        dtype=torch.int8, device=self.device)
                scales_buf = torch.zeros((num_leaves, capacity),
                                         dtype=torch.float32,
                                         device=self.device)
            else:
                codes_buf = torch.zeros((num_leaves, capacity, d),
                                        dtype=self._leaf_dtype,
                                        device=self.device)
            off = 0
            for batch in self._stream(factory):
                b = batch.shape[0]
                leaf_b, slot_b = leaf_of[off:off + b], slot_of[off:off + b]
                if self._quantize:
                    _scatter_batch_quantized(
                        codes_buf, scales_buf, rows_buf, valid_buf, batch,
                        leaf_b, slot_b, off,
                        threshold=self._anisotropic_threshold,
                        bits=4 if packed4 else 8, half=capacity // 2,
                    )
                else:
                    _scatter_batch(codes_buf, rows_buf, valid_buf, batch,
                                   leaf_b, slot_b, off)
                off += b

        self._centroids = centroids
        self._leaf_embs = codes_buf
        self._leaf_scales = scales_buf
        self._leaf_rows = rows_buf
        self._leaf_valid = valid_buf
        if identifiers is None:
            # Rows double as ids.
            self._leaf_ids = rows_buf
            self._flat_ids = None
        else:
            self._leaf_ids = _scatter_leaves(identifiers, leaf_of, slot_of,
                                             num_leaves, capacity)
            self._flat_ids = (identifiers if self._scoring_buckets
                              is not None else None)
        self._corpus = None
        self._identifiers = None
        self._num_candidates = num_rows
        self._built = True
        return self

    def _stream(self, factory):
        for batch in factory():
            yield torch.as_tensor(batch, device=self.device).to(
                torch.float32)

    def _streamed_partition(self, factory, num_rows: int):
        """Passes 1 and 2 of the streamed build: `(centroids, leaf_of,
        slot_of, capacity)` from a batch factory, on the index's device.
        """
        stream = lambda: self._stream(factory)  # noqa: E731
        num_leaves = min(self._num_leaves, num_rows)
        capacity = self._capacity(num_leaves, num_rows)

        # Pass 1: stride-sample rows for centroid training.
        with profiling.phase("scann.build.kmeans", self.device):
            sample_target = min(self._kmeans_sample or (1 << 21), num_rows)
            rng = np.random.RandomState(self._seed)
            parts, seen = [], 0
            for batch in stream():
                b = batch.shape[0]
                take = min(b, int(np.ceil(sample_target * b / num_rows)))
                if take:
                    idx = np.sort(rng.choice(b, size=take, replace=False))
                    parts.append(batch[_rows(idx, self.device)])
                seen += b
            if seen != num_rows:
                raise ValueError(
                    f"Batches supplied {seen} rows, expected num_rows="
                    f"{num_rows}."
                )
            sample = torch.cat(parts)
            del parts
            centroids = kmeans_device(
                sample, num_leaves, self._iterations, self._seed,
                chunk=self._assign_chunk,
                balance_fraction=self._kmeans_balance,
            )
            del sample

        # Pass 2: top-R assignment, then capacity packing.
        with profiling.phase("scann.build.assign", self.device):
            rounds = min(self._spill_rounds, num_leaves)
            choices = torch.zeros((num_rows, rounds), dtype=torch.int32,
                                  device=self.device)
            off = 0
            for batch in stream():
                choices[off:off + batch.shape[0]] = _topr_assign_device(
                    batch, centroids, rounds, self._assign_chunk)
                off += batch.shape[0]
            leaf_of, slot_of, unplaced = _pack_assign_device(
                choices, num_leaves, capacity
            )
        if int(unplaced) > 0:
            raise ValueError(
                f"{int(unplaced)} rows could not be placed within their "
                f"{rounds} nearest leaves; increase `leaf_capacity`, "
                "`num_leaves`, or `spill_rounds`."
            )
        del choices
        return centroids, leaf_of, slot_of, capacity

    def __call__(self, queries, k: Optional[int] = None
                 ) -> Tuple[Tensor, Tensor]:
        if not self._built:
            raise ValueError(
                "The `index` method must be called first to "
                "create the retrieval index."
            )
        k = k if k is not None else self._k
        with profiling.annotate("scann.search"):
            if self.query_fn is not None:
                queries = self.query_fn(queries)
            queries = torch.as_tensor(queries, device=self.device)
            return self._decode(*search(queries, self.serving_arrays(),
                                        self.serving_config(), k))

    def serving_config(self) -> ServingConfig:
        """The built index's query settings (for `search`)."""
        return ServingConfig(
            num_probes=self._num_probes, quantize=self._quantize,
            dedup=self._soar_lambda is not None, reorder_n=self._reorder_n,
            scoring_buckets=self._scoring_buckets,
            probe_tile=self._probe_tile, query_batch=self._query_batch,
            num_candidates=self._num_candidates)

    def serving_arrays(self) -> dict:
        """The arrays `search` reads, by `SERVING_ARRAYS` name, in that
        order: the leaf scales only for quantized leaves, the flat ids
        only where the bucketed path keeps them, the corpus only with a
        reorder."""
        arrays = {
            "centroids": self._centroids, "leaf_embs": self._leaf_embs,
            "leaf_scales": self._leaf_scales if self._quantize else None,
            "leaf_ids": self._leaf_ids, "leaf_rows": self._leaf_rows,
            "leaf_valid": self._leaf_valid,
            "flat_ids": (self._flat_ids if self._scoring_buckets is not None
                         else None),
            "corpus": self._corpus if self._reorder_n else None,
            "corpus_identifiers": (self._identifiers if self._reorder_n
                                   else None),
        }
        return {name: arrays[name] for name in SERVING_ARRAYS
                if arrays[name] is not None}

    def is_exact(self) -> bool:
        return False
