"""Mesh-sharded approximate serving: Bucketed and ScaNN over a corpus
axis.

Port of `recommenders_tpu/parallel/ann.py`. `ShardedBruteForce`
(`parallel/corpus.py`) scales exact retrieval by sharding corpus rows
over the mesh; this module applies the same distributed top-k to the
two approximate indexes:

  - `ShardedBucketed`: corpus rows sharded over `mesh[axis]`; every rank
    sweeps its own rows with the bucketed kernel K3
    (`ops/scoring.bucketed_top_k`, with that rank's own `valid_rows`),
    takes a local top-k over its buckets, and the global result is an
    all-gather of the partials and a re-top-k. Each rank folds into its
    own buckets, so the effective selection width is `ranks × buckets`:
    sharding never lowers bucket recall.
  - `ShardedScaNN`: k-means leaves sharded over `mesh[axis]`, centroids
    replicated. Every rank derives the same global probe list, scores
    only the probed leaves it owns (foreign probes park on a per-rank
    all-invalid sentinel leaf) with K4 (gather path) or K5 (bucketed
    path), and contributes a local shortlist; the reduction is the same
    all-gather and re-top-k, then SOAR's global dedup and the exact
    reorder over the row-sharded corpus, combined with a max over the
    axis (each row is owned once, so it equals the one-device reorder
    bit for bit).

Every rank calls `index` and the query with the same arguments (SPMD).
An empty result slot carries row -1 and identifier -1 (the empty string
for string identifiers): it never decodes through a wrapping take to
the last identifier, as `jnp.take(identifiers, rows)` does in the JAX
package (`recommenders_tpu/parallel/ann.py:533`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import factorized_top_k as layers_ftk
from recommenders_tpu_torch.ops import leaf_scoring
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.ops import topk as topk_ops
from recommenders_tpu_torch.parallel import corpus as corpus_lib
from recommenders_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor

MIN_FLOAT = topk_ops.MIN_FLOAT
EMPTY_ID = approximate.EMPTY_ID


# A host corpus past this many f32 bytes is not built on one device by
# `ShardedScaNN.index` (the build holds the corpus and its leaves): the
# streamed sharded build takes it, so no rank ever holds the corpus.
# A fifth of an 80 GB card.
SINGLE_DEVICE_BUILD_BUDGET_BYTES = 16 << 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _batched(arr: np.ndarray, rows: int = 1 << 18):
    def gen():
        for i in range(0, arr.shape[0], rows):
            yield arr[i:i + rows]
    return gen


def _rows_of(candidates, lo: int, hi: int, device) -> Tensor:
    """Rows `[lo, hi)` of a host or device corpus, as f32 on `device`
    (only those rows move)."""
    if isinstance(candidates, Tensor):
        return candidates[lo:hi].to(device, torch.float32)
    return torch.as_tensor(
        np.asarray(candidates[lo:hi], np.float32), device=device)


def _decode_rows(identifiers: Optional[Tensor], rows: Tensor,
                 scores: Tensor) -> Tensor:
    """Row → identifier; an empty slot (a MIN_FLOAT score or a negative
    row) is EMPTY_ID."""
    empty = (rows < 0) | ~(scores > MIN_FLOAT / 2)
    if identifiers is None:
        return torch.where(empty, EMPTY_ID, rows)
    ids = identifiers[torch.clamp(rows, min=0).long()]
    return torch.where(empty, torch.full_like(ids, EMPTY_ID), ids)


class ShardedBucketed(layers_ftk.TopK):
    """Bucketed serving (K3) over a mesh-sharded corpus.

    Same dials as `layers.factorized_top_k.Bucketed` (`buckets`,
    `chunk`, `query_tile`, `quantize` / `corpus_dtype`), with the corpus
    row-sharded over `mesh[axis]`: rank i holds rows
    `[i·rps, (i+1)·rps)`, `rps` the per-rank rows rounded up to the chunk
    grid, and its true row count goes to the kernel as `valid_rows`. An
    int4 index pairs nibbles within each rank's rows (slot r with
    r + rps/2), the stride the kernel derives from its local shape.

    Attributes:
      query_fn: Optional query-embedding function.
      buckets / chunk / query_tile: Kernel dials (see `Bucketed`).
      quantize: False, "int8" or "int4" (per-row scales).
      corpus_dtype: Storage dtype for unquantized corpora.
      anisotropic_quantization_threshold: Score-aware scale refinement.
      mesh: Device mesh; defaults to every rank on one `axis`.
      axis: Mesh axis sharding the corpus rows.
      device: Where this rank's shard lives (default CUDA).
    """

    def __init__(
        self,
        query_fn: Optional[Callable] = None,
        k: int = 10,
        buckets: int = 2048,
        chunk: int = 2048,
        query_tile: int = 256,
        corpus_dtype: Optional[torch.dtype] = None,
        quantize=False,
        anisotropic_quantization_threshold: Optional[float] = 0.2,
        mesh: Optional[mesh_lib.Mesh] = None,
        axis: str = mesh_lib.MODEL_AXIS,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(k=k, device=device)
        quantize = {True: "int8", False: None}.get(quantize, quantize)
        if quantize not in (None, "int8", "int4"):
            raise ValueError(
                f"quantize must be False, True, 'int8' or 'int4'; got "
                f"{quantize!r}"
            )
        if quantize and corpus_dtype is not None:
            raise ValueError(
                "quantize stores integer codes; corpus_dtype must be None."
            )
        if quantize == "int4" and (chunk // 2) % buckets != 0:
            raise ValueError(
                f"quantize='int4' needs buckets ({buckets}) to divide "
                f"chunk/2 ({chunk // 2})."
            )
        self.query_fn = query_fn
        self._buckets = buckets
        self._chunk = chunk
        self._query_tile = query_tile
        self._corpus_dtype = corpus_dtype
        self._quantize = quantize
        self._anisotropic_threshold = anisotropic_quantization_threshold
        self._mesh = corpus_lib.default_mesh(mesh, axis, self.device)
        self._axis = axis
        self._candidates: Optional[Tensor] = None
        self._scales: Optional[Tensor] = None

    def _layout(self, n: int) -> Tuple[int, int, int]:
        """`(rows per rank, this rank's first row, its valid rows)`."""
        s = mesh_lib.axis_size(self._mesh, self._axis)
        rps = _round_up(-(-n // s), self._chunk)
        lo = mesh_lib.axis_index(self._mesh, self._axis) * rps
        return rps, lo, int(np.clip(n - lo, 0, rps))

    def _check_dim(self, d: int) -> None:
        if d % 128 != 0:
            raise ValueError(
                "ShardedBucketed requires the embedding dim to be a "
                f"multiple of 128; got {d}."
            )

    def _alloc(self, rps: int, d: int) -> None:
        if self._quantize:
            code_rows = rps // 2 if self._quantize == "int4" else rps
            self._candidates = torch.zeros((code_rows, d), dtype=torch.int8,
                                           device=self.device)
            self._scales = torch.zeros((rps,), dtype=torch.float32,
                                       device=self.device)
        else:
            self._candidates = torch.zeros(
                (rps, d), dtype=self._corpus_dtype or torch.float32,
                device=self.device)
            self._scales = None

    def _write(self, block: Tensor, local: int, rps: int) -> None:
        """Casts or quantizes `block` (f32 rows) into this rank's storage
        at local row `local` (the int4 pairing strides within the rank's
        `rps` rows)."""
        layers_ftk.store_rows_(self._candidates, self._scales, block, local,
                               rps, self._quantize,
                               self._anisotropic_threshold)

    def _finish(self, n: int, rps: int, valid: int, identifiers) -> None:
        self._identifiers = identifiers
        self._num_candidates = n
        self._rows_per_shard = rps
        self._valid_rows = valid

    def index(
        self,
        candidates,
        identifiers: Optional[Tensor] = None,
    ) -> "ShardedBucketed":
        """Keeps this rank's rows of `candidates` (a host array or a
        tensor; of a host array only those rows reach the device), padded
        to the chunk grid and cast or quantized."""
        if len(np.shape(candidates)) != 2:
            raise ValueError(
                "The candidates tensor must be 2D (got "
                f"{tuple(np.shape(candidates))})."
            )
        n, d = np.shape(candidates)
        self._check_dim(d)
        identifiers = self._intern_identifiers(identifiers, n)
        rps, lo, valid = self._layout(n)
        self._alloc(rps, d)
        block = _rows_of(candidates, lo, lo + valid, self.device)
        self._write(F.pad(block, (0, 0, 0, rps - valid)), 0, rps)
        self._finish(n, rps, valid, identifiers)
        return self

    def index_streamed(
        self,
        batches,
        num_rows: int,
        identifiers: Optional[Tensor] = None,
    ) -> "ShardedBucketed":
        """Builds this rank's shard from row batches in corpus order
        (`Bucketed.index_streamed` composed with the sharding of
        `index`): each rank keeps the pieces of each batch that fall in
        its row range, so no device ever holds more than its shard and
        one batch.

        Args:
          batches: Iterable (or zero-arg callable returning one) of
            `[b, D]` row blocks, host arrays or tensors.
          num_rows: Total corpus rows (must match the stream).
          identifiers: Optional `[num_rows]` identifier array.
        """
        it = iter(batches() if callable(batches) else batches)
        identifiers = self._intern_identifiers(identifiers, num_rows)
        rps, lo, valid = self._layout(num_rows)
        off = 0
        for batch in it:
            if len(np.shape(batch)) != 2:
                raise ValueError(
                    f"Batches must be 2D row blocks (got "
                    f"{tuple(np.shape(batch))})."
                )
            b, d = np.shape(batch)
            if off == 0:
                self._check_dim(d)
                self._alloc(rps, d)
            if off + b > num_rows:
                raise ValueError(
                    f"Batches supply more than num_rows={num_rows} rows."
                )
            start, stop = max(off, lo), min(off + b, lo + valid)
            if start < stop:
                piece = _rows_of(batch, start - off, stop - off, self.device)
                self._write(piece, start - lo, rps)
            off += b
        if off != num_rows:
            raise ValueError(
                f"Batches supplied {off} rows, expected num_rows="
                f"{num_rows}."
            )
        self._finish(num_rows, rps, valid, identifiers)
        return self

    def __call__(
        self, queries, k: Optional[int] = None
    ) -> Tuple[Tensor, Tensor]:
        k = k if k is not None else self._k
        if self._candidates is None:
            raise ValueError(
                "The `index` method must be called first to "
                "create the retrieval index."
            )
        if self.query_fn is not None:
            queries = self.query_fn(queries)
        queries = torch.as_tensor(queries, device=self.device)
        k = min(k, self._num_candidates, self._buckets)
        if not self._quantize:
            queries = queries.to(self._candidates.dtype)
        vals, rows = scoring.bucketed_scores_padded(
            queries, self._candidates, self._scales, self._buckets,
            self._chunk, self._query_tile, self._valid_rows,
            self._quantize == "int4")
        # Every rank contributes k columns (a rank with fewer valid rows
        # contributes empty buckets, which score MIN_FLOAT).
        rows = rows + mesh_lib.axis_index(self._mesh, self._axis) * (
            self._rows_per_shard)
        scores, rows = topk_ops.distributed_top_k(
            vals, rows, k, self._mesh, self._axis)
        ids = _decode_rows(self._identifiers, rows, scores)
        if self._identifiers is not None:
            return scores, ids
        return self._decode(scores, ids)

    def is_exact(self) -> bool:
        return False


def _sentinel(block: Tensor, fill) -> Tensor:
    """`[l, ...] → [l + 1, ...]`: one `fill` leaf appended, the
    all-invalid leaf this rank parks foreign probes on (its rows are -1,
    so the bucketed fold and the validity mask drop it; as the largest
    local leaf, it sorts after every owned probe)."""
    pad = torch.full((1,) + tuple(block.shape[1:]), fill, dtype=block.dtype,
                     device=block.device)
    return torch.cat([block, pad]).contiguous()


def _checksum(x: Tensor) -> Tensor:
    """An int64 digest of a tensor's bytes (equal tensors, equal digest)."""
    flat = x.contiguous().view(-1)
    if flat.element_size() == 4:
        bits = flat.view(torch.int32).to(torch.int64)
    else:
        bits = flat.to(torch.int64)
    weights = torch.arange(1, bits.numel() + 1, device=bits.device) % 65521
    return torch.sum(bits * weights).reshape(1)


class ShardedScaNN(layers_ftk.TopK):
    """ScaNN probed serving with the leaves sharded over the mesh.

    Wraps a configured `layers.approximate.ScaNN`: `index` runs its
    build on every rank (the build is deterministic, so every rank holds
    the same partition, and the index checks that it does) and keeps
    this rank's `num_leaves / S` leaves plus a sentinel leaf; with
    `num_reordering_candidates`, the exact-reorder corpus is row-sharded
    over the same axis. Queries run on every rank: the same global probe
    list from the replicated centroids, K4 or K5 over the probed leaves
    this rank owns, then the all-gather, SOAR's global dedup (each rank
    fetched 2·shortlist) and the reorder.

    `num_leaves` must divide evenly over the axis.

    Attributes:
      scann: The configured (unbuilt) one-device index; its `k`,
        `query_fn`, probing, quantization, bucketed scoring, reorder,
        SOAR and query batching all apply.
      mesh: Device mesh; defaults to every rank on one `axis`.
      axis: Mesh axis sharding the leaves (and the reorder corpus).
    """

    def __init__(
        self,
        scann: approximate.ScaNN,
        mesh: Optional[mesh_lib.Mesh] = None,
        axis: str = mesh_lib.MODEL_AXIS,
    ) -> None:
        if not isinstance(scann, approximate.ScaNN):
            raise ValueError(
                f"scann must be a layers.approximate.ScaNN; got "
                f"{type(scann).__name__}."
            )
        super().__init__(k=scann.k, device=scann.device)
        self._scann = scann
        self._mesh = corpus_lib.default_mesh(mesh, axis, self.device)
        self._axis = axis
        self._built = False

    @property
    def query_fn(self):
        return self._scann.query_fn

    def _shards(self) -> Tuple[int, int]:
        return (mesh_lib.axis_size(self._mesh, self._axis),
                mesh_lib.axis_index(self._mesh, self._axis))

    def _check_same_partition(self, centroids: Tensor,
                              leaf_rows: Tensor) -> None:
        digest = torch.cat([_checksum(centroids), _checksum(leaf_rows)])
        hi = mesh_lib.all_reduce(digest, self._mesh, self._axis, op="max")
        lo = mesh_lib.all_reduce(digest, self._mesh, self._axis, op="min")
        if not torch.equal(hi, lo):
            raise RuntimeError(
                "ShardedScaNN: the ranks built different partitions; the "
                "build must be deterministic for the leaves to shard."
            )

    def _shard_leaves(self, centroids, embs, scales, ids, rows, valid,
                      flat_ids, corpus, n: int) -> None:
        """Keeps this rank's leaves (+ the sentinel) and reorder rows."""
        s, i = self._shards()
        num_leaves = centroids.shape[0]
        if num_leaves % s != 0:
            raise ValueError(
                f"num_leaves ({num_leaves}) must divide evenly over the "
                f"{s}-way '{self._axis}' axis."
            )
        self._check_same_partition(centroids, rows)
        l_local = num_leaves // s
        own = slice(i * l_local, (i + 1) * l_local)
        self._centroids = centroids
        self._leaf_embs = _sentinel(embs[own], 0)
        self._leaf_scales = None if scales is None else _sentinel(
            scales[own], 0)
        self._leaf_ids = _sentinel(ids[own], 0)
        self._leaf_rows = _sentinel(rows[own], -1)
        self._leaf_valid = _sentinel(valid[own], False)
        self._flat_ids = flat_ids
        self._num_leaves = num_leaves
        self._l_local = l_local
        self._num_candidates = n
        if corpus is not None:
            rps = -(-n // s)
            block = corpus[i * rps:(i + 1) * rps]
            self._corpus = F.pad(
                block, (0, 0, 0, rps - block.shape[0])).contiguous()
            self._corpus_rps = rps
        else:
            self._corpus = None
        self._built = True

    def index(self, candidates, identifiers=None) -> "ShardedScaNN":
        """Builds the inner index on every rank and keeps this rank's
        leaves. A host (NumPy) corpus whose f32 bytes pass
        `SINGLE_DEVICE_BUILD_BUDGET_BYTES` goes to `index_streamed`
        instead (`recommenders_tpu/parallel/ann.py:629-648`); with
        `soar_lambda` set, which cannot stream, that raises."""
        inner = self._scann
        if (not isinstance(candidates, Tensor)
                and mesh_lib.axis_size(self._mesh, self._axis) > 1
                and np.shape(candidates)[0] * np.shape(candidates)[1] * 4
                > SINGLE_DEVICE_BUILD_BUDGET_BYTES):
            if inner._soar_lambda is not None:
                raise ValueError(
                    "This corpus exceeds the single-device build budget "
                    "and soar_lambda is set: the eager build would hold "
                    "the full corpus on one device and the streamed build "
                    "does not support SOAR. Drop soar_lambda and build via "
                    "index_streamed, or shrink the corpus.")
            host = np.asarray(candidates)
            return self.index_streamed(_batched(host), host.shape[0],
                                       identifiers=identifiers)
        identifiers = self._intern_identifiers(identifiers, len(candidates))
        inner.index(candidates, identifiers)
        self._shard_leaves(
            inner._centroids, inner._leaf_embs, inner._leaf_scales,
            inner._leaf_ids, inner._leaf_rows, inner._leaf_valid,
            inner._flat_ids, inner._corpus, inner._num_candidates)
        # The one-device leaves are superseded by this rank's shard.
        inner._leaf_embs = inner._leaf_scales = None
        inner._leaf_ids = inner._leaf_rows = inner._leaf_valid = None
        inner._flat_ids = inner._corpus = inner._identifiers = None
        inner._built = False
        return self

    def index_streamed(self, batches, num_rows: int,
                       identifiers=None) -> "ShardedScaNN":
        """Streamed sharded build: the three passes of
        `ScaNN.index_streamed` (k-means on a sample, top-R assignment
        and capacity packing, then the scatter), where the scatter pass
        writes only the rows whose leaves this rank owns, so a rank
        holds `num_leaves / S` leaves and never the corpus. With
        `num_reordering_candidates`, each rank also keeps its row range
        of the reorder corpus. No SOAR (it doubles leaf memory)."""
        inner = self._scann
        if inner._soar_lambda is not None:
            raise ValueError(
                "index_streamed does not support soar_lambda (SOAR "
                "doubles leaf memory; the streamed build exists because "
                "memory is the binding constraint)."
            )
        if callable(batches):
            factory = batches
        else:
            blocks = list(batches)
            factory = lambda: iter(blocks)  # noqa: E731
        identifiers = self._intern_identifiers(identifiers, num_rows)
        s, i = self._shards()
        num_leaves = min(inner._num_leaves, num_rows)
        if num_leaves % s != 0:
            raise ValueError(
                f"num_leaves ({num_leaves}) must divide evenly over the "
                f"{s}-way '{self._axis}' axis."
            )
        centroids, leaf_of, slot_of, capacity = inner._streamed_partition(
            factory, num_rows)
        l_local = num_leaves // s
        lo = i * l_local
        packed4 = inner._quantize == "int4"
        d = centroids.shape[1]
        dev = inner.device
        stored = l_local + 1
        rows_buf = torch.full((stored, capacity), -1, dtype=torch.int32,
                              device=dev)
        valid_buf = torch.zeros((stored, capacity), dtype=torch.bool,
                                device=dev)
        scales_buf = None
        if inner._quantize:
            code_cap = capacity // 2 if packed4 else capacity
            embs_buf = torch.zeros((stored, code_cap, d), dtype=torch.int8,
                                   device=dev)
            scales_buf = torch.zeros((stored, capacity), dtype=torch.float32,
                                     device=dev)
        else:
            embs_buf = torch.zeros((stored, capacity, d),
                                   dtype=inner._leaf_dtype, device=dev)
        reorder = bool(inner._reorder_n)
        rps = -(-num_rows // s)
        corpus = (torch.zeros((rps, d), dtype=inner._reorder_dtype,
                              device=dev) if reorder else None)
        # Foreign rows map past the sentinel leaf (which stays empty) and
        # drop out of the scatter.
        local_leaf = torch.where(
            (leaf_of >= lo) & (leaf_of < lo + l_local), leaf_of - lo,
            stored).to(torch.int32)
        off = 0
        for batch in factory():
            batch = torch.as_tensor(batch, device=dev).to(torch.float32)
            b = batch.shape[0]
            leaf_b, slot_b = local_leaf[off:off + b], slot_of[off:off + b]
            if inner._quantize:
                approximate._scatter_batch_quantized(
                    embs_buf, scales_buf, rows_buf, valid_buf, batch,
                    leaf_b, slot_b, off,
                    threshold=inner._anisotropic_threshold,
                    bits=4 if packed4 else 8, half=capacity // 2,
                )
            else:
                approximate._scatter_batch(embs_buf, rows_buf, valid_buf,
                                           batch, leaf_b, slot_b, off)
            if reorder:
                start, stop = max(off, i * rps), min(off + b, (i + 1) * rps)
                if start < stop:
                    corpus[start - i * rps:stop - i * rps] = batch[
                        start - off:stop - off].to(corpus.dtype)
            off += b
        if identifiers is None:
            ids_buf = rows_buf
            flat_ids = None
        else:
            ids_buf = torch.zeros((stored, capacity),
                                  dtype=identifiers.dtype, device=dev)
            keep = local_leaf < l_local
            ids_buf[local_leaf[keep].long(), slot_of[keep].long()] = (
                identifiers.to(dev)[keep])
            flat_ids = (identifiers.to(dev) if inner._scoring_buckets
                        is not None else None)
        self._check_same_partition(centroids, leaf_of)
        self._centroids = centroids
        self._leaf_embs, self._leaf_scales = embs_buf, scales_buf
        self._leaf_rows, self._leaf_valid = rows_buf, valid_buf
        self._leaf_ids = ids_buf
        self._flat_ids = flat_ids
        self._num_leaves, self._l_local = num_leaves, l_local
        self._num_candidates = num_rows
        self._corpus, self._corpus_rps = corpus, rps
        self._built = True
        return self

    def __call__(self, queries, k: Optional[int] = None
                 ) -> Tuple[Tensor, Tensor]:
        if not self._built:
            raise ValueError(
                "The `index` method must be called first to "
                "create the retrieval index."
            )
        inner = self._scann
        k = k if k is not None else self._k
        if self.query_fn is not None:
            queries = self.query_fn(queries)
        queries = torch.as_tensor(queries, device=self.device).to(
            torch.float32)
        k = min(k, self._num_candidates)
        # Chunks of `query_batch`, as the one-device index takes them
        # (probe tiles form within a chunk).
        qn = queries.shape[0]
        qb = inner._query_batch
        if qn > qb:
            padded_q = _round_up(qn, qb)
            if padded_q != qn:
                queries = F.pad(queries, (0, 0, 0, padded_q - qn))
            parts = [self._query_chunk(queries[j:j + qb], k)
                     for j in range(0, padded_q, qb)]
            scores = torch.cat([p[0] for p in parts])[:qn]
            ids = torch.cat([p[1] for p in parts])[:qn]
            return self._decode(scores, ids)
        return self._decode(*self._query_chunk(queries, k))

    def _local_shortlist(self, queries: Tensor, fetch_of: Callable):
        """This rank's `(scores, ids, rows)` shortlist over the probed
        leaves it owns."""
        inner = self._scann
        s, i = self._shards()
        l_local = self._l_local
        lo = i * l_local
        num_probes = min(inner._num_probes, self._num_leaves)
        packed4 = inner._quantize == "int4"
        scales = self._leaf_scales if inner._quantize else None
        with approximate._full_f32():
            cscores = queries @ self._centroids.T        # [Q, L]
        if inner._scoring_buckets is not None:
            tile = inner._probe_tile
            cap = self._leaf_embs.shape[1] * (2 if packed4 else 1)
            buckets = min(inner._scoring_buckets, cap)
            q_t, probes, inv = approximate._tile_probes(
                queries, cscores, num_probes, tile)
            lp = probes - lo
            # Foreign probes park on the sentinel leaf; sorted, they sit
            # after the owned ones (order within a tile does not change
            # the running max).
            lp = torch.where((lp >= 0) & (lp < l_local), lp, l_local)
            if s > 1:
                lp = torch.sort(lp, dim=1).values
            vals, rows = leaf_scoring.probed_bucketed_scores(
                q_t, self._leaf_embs, scales, self._leaf_rows,
                lp.to(torch.int32), buckets, query_tile=tile,
                packed4=packed4)
            if inv is not None:
                vals, rows = vals[inv], rows[inv]
            ls, idx = topk_ops.top_k(vals, fetch_of(buckets))
            lr = topk_ops.take_along_rows(rows, idx)
            li = _decode_rows(self._flat_ids, lr, ls)
            return ls, li, lr
        _, probes = topk_ops.top_k(cscores, num_probes)
        lp = probes - lo
        lpc = torch.where((lp >= 0) & (lp < l_local), lp, l_local)
        q = queries.shape[0]
        scores = leaf_scoring.probed_leaf_scores(
            queries, self._leaf_embs, scales, lpc, packed4=packed4)
        scores = scores.masked_fill(
            ~self._leaf_valid[lpc].reshape(q, -1), MIN_FLOAT)
        flat_ids = self._leaf_ids[lpc].reshape(q, -1)
        flat_rows = self._leaf_rows[lpc].reshape(q, -1)
        ls, idx = topk_ops.top_k(scores, fetch_of(scores.shape[1]))
        lr = topk_ops.take_along_rows(flat_rows, idx)
        li = torch.where(lr >= 0, topk_ops.take_along_rows(flat_ids, idx),
                         EMPTY_ID)
        return ls, li, lr

    def _query_chunk(self, queries: Tensor, k: int
                     ) -> Tuple[Tensor, Tensor]:
        inner = self._scann
        s, i = self._shards()
        dedup = inner._soar_lambda is not None
        reorder_n = inner._reorder_n
        shortlist = max(k, reorder_n) if reorder_n else k
        qn = queries.shape[0]
        tile = (inner._probe_tile if inner._scoring_buckets is not None
                else 1)
        pad = (-qn) % tile
        queries_p = F.pad(queries, (0, 0, 0, pad)) if pad else queries
        fetch_of = (lambda width: min(2 * min(shortlist, width), width)
                    if dedup else min(shortlist, width))
        ls, li, lr = self._local_shortlist(queries_p, fetch_of)
        if pad:
            ls, li, lr = ls[:qn], li[:qn], lr[:qn]
        if s > 1:
            gs = mesh_lib.all_gather(ls, self._mesh, self._axis, dim=1)
            gi = mesh_lib.all_gather(li, self._mesh, self._axis, dim=1)
            gr = mesh_lib.all_gather(lr, self._mesh, self._axis, dim=1)
        else:
            gs, gi, gr = ls, li, lr
        if dedup:
            # A SOAR row's two copies may come from different ranks; each
            # rank fetched 2·shortlist, so `shortlist` unique rows remain.
            ts, ti, tr = approximate._dedup_topk(
                gs, gi, gr, min(shortlist, gs.shape[1]))
        elif s > 1:
            ts, idx = topk_ops.top_k(gs, min(shortlist, gs.shape[1]))
            ti = topk_ops.take_along_rows(gi, idx)
            tr = topk_ops.take_along_rows(gr, idx)
        else:
            ts, ti, tr = gs, gi, gr
        if reorder_n:
            return self._reorder(queries, ts, ti, tr, k)
        return ts[:, :k], ti[:, :k]

    def _reorder(self, queries, ts, ti, tr, k):
        """The exact reorder over the row-sharded corpus: each row is
        re-scored by the rank owning it, the rest read MIN_FLOAT, and a
        max over the axis combines them."""
        rps = self._corpus_rps
        s, i = self._shards()
        local = tr.long() - i * rps
        mine = (local >= 0) & (local < rps) & (ts > MIN_FLOAT / 2)
        gathered = self._corpus[torch.clamp(local, 0, rps - 1)]
        with approximate._full_f32():
            exact = torch.einsum("qd,qrd->qr", queries.to(torch.float32),
                                 gathered.to(torch.float32))
        exact = exact.masked_fill(~mine, MIN_FLOAT)
        exact = mesh_lib.all_reduce(exact, self._mesh, self._axis, op="max")
        top_scores, idx = topk_ops.top_k(exact, min(k, exact.shape[1]))
        ids = topk_ops.take_along_rows(ti, idx)
        return top_scores, torch.where(top_scores > MIN_FLOAT / 2, ids,
                                       EMPTY_ID)

    def is_exact(self) -> bool:
        return False
