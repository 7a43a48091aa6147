"""Retrieval index layers: exact brute force and the bucketed serving index.

Port of `recommenders_tpu/layers/factorized_top_k.py:53-814` (the `TopK`
base, `BruteForce`, `Streaming` and `Bucketed`), itself the rebuild of the
reference's factorized top-K layers
(`tensorflow_recommenders/layers/factorized_top_k.py:140,336,515`).
`ScaNN` lives in `layers/approximate.py` and is re-exported here, as in the
JAX package.

Identifiers may be integer tensors (kept on the index's device) or host
string arrays: string-identified indexes run on row positions on the
device and decode results back to strings on the host, so the returned
ids are then a NumPy string array.

Each index takes a `device` (default `"cuda"`); `index` moves the corpus
there, and queries must live there too.
"""

from __future__ import annotations

import abc
import collections
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.ops import topk as topk_ops
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor

MIN_FLOAT = topk_ops.MIN_FLOAT

# BruteForce pads its corpus to this row multiple.
_PAD_MULTIPLE = 128


def _is_string_array(identifiers) -> bool:
    """True for host arrays/sequences of str/bytes identifiers."""
    if identifiers is None or isinstance(identifiers, Tensor):
        return False
    return np.asarray(identifiers).dtype.kind in ("U", "S", "O")


def _pad_identifier(strings: np.ndarray):
    """The identifier a row outside the index decodes to: the empty value
    of the table's dtype ("" for str, b"" for bytes, None for objects)."""
    return None if strings.dtype.kind == "O" else strings.dtype.type()


class TopK(abc.ABC):
    """Interface for top-K retrieval layers.

    `index` builds the index, calling the layer queries it,
    `query_with_exclusions` over-fetches and masks, `is_exact` reports
    whether scores are exact (reference contract,
    tensorflow_recommenders/layers/factorized_top_k.py:140-301).

    String identifiers stay on the host; the device index runs on row
    positions and results decode back to the indexed strings. A row
    outside `[0, num_rows)` (padding) decodes to `_pad_identifier`, never
    to another row's string.
    """

    def __init__(
        self, k: int = 10, device: Union[str, torch.device] = "cuda"
    ) -> None:
        self._k = k
        self.device = device_lib.resolve(device)
        self._id_strings: Optional[np.ndarray] = None
        self._id_lookup = None
        self._suppress_decode = False

    # --- Host-side string identifier support ------------------------------

    def _intern_identifiers(self, identifiers, num_rows: int):
        """Stores string identifiers host-side; returns the identifier
        tensor the device index should use (None → row positions)."""
        self._id_lookup = None
        if _is_string_array(identifiers):
            arr = np.asarray(identifiers)
            if arr.ndim != 1 or arr.shape[0] != num_rows:
                raise ValueError(
                    f"identifiers must be a [num_rows] vector; got shape "
                    f"{arr.shape} for {num_rows} rows."
                )
            self._id_strings = arr
            return None
        self._id_strings = None
        if identifiers is None:
            return None
        identifiers = torch.as_tensor(identifiers, device=self.device)
        if identifiers.shape[0] != num_rows:
            raise ValueError(
                "The candidates and identifiers tensors must have the "
                f"same number of rows (got {num_rows} and "
                f"{identifiers.shape[0]})."
            )
        return identifiers

    def _decode(self, scores, rows):
        """Maps row-position results back to string identifiers (host).
        Identity when the index was built with numeric (or no)
        identifiers."""
        if self._id_strings is None or self._suppress_decode:
            return scores, rows
        rows = rows.cpu().numpy() if isinstance(rows, Tensor) else rows
        rows = np.asarray(rows)
        strings = self._id_strings
        inside = (rows >= 0) & (rows < strings.shape[0])
        out = np.take(strings, np.where(inside, rows, 0), axis=0)
        out[~inside] = _pad_identifier(strings)
        return scores, out

    def _encode_ids(self, ids) -> Tensor:
        """String identifiers → row positions (-1 for unknown, which
        matches no candidate row)."""
        if self._id_lookup is None:
            self._id_lookup = {
                s: i for i, s in enumerate(self._id_strings.tolist())
            }
        table = self._id_lookup
        ids = np.asarray(ids)
        flat = np.asarray(
            [table.get(s, -1) for s in ids.reshape(-1).tolist()],
            dtype=np.int32,
        )
        return torch.as_tensor(flat.reshape(ids.shape), device=self.device)

    @property
    def k(self) -> int:
        return self._k

    @abc.abstractmethod
    def index(
        self,
        candidates: Tensor,
        identifiers: Optional[Tensor] = None,
    ) -> "TopK":
        """Builds (or rebuilds) the retrieval index. Returns self."""

    def index_from_dataset(
        self,
        candidates: Iterable[Union[Tensor, Tuple[Tensor, Tensor]]],
    ) -> "TopK":
        """Builds the index from an iterable of embedding batches.

        Batches may be plain embedding tensors or `(identifiers,
        embeddings)` tuples, like the reference
        (layers/factorized_top_k.py:179-215); everything is concatenated
        and handed to `index`.
        """
        batches = list(candidates)
        if not batches:
            raise ValueError("The candidates iterable must not be empty.")
        if isinstance(batches[0], tuple):
            if any(not isinstance(b, tuple) or len(b) != 2 for b in batches):
                raise ValueError(
                    "The dataset must consistently yield candidate "
                    "embeddings or (identifiers, embeddings) tuples."
                )
            id_batches = [i for i, _ in batches]
            if any(_is_string_array(i) for i in id_batches):
                identifiers = np.concatenate(
                    [np.asarray(i) for i in id_batches], axis=0
                )
            else:
                identifiers = torch.cat(
                    [torch.as_tensor(i) for i in id_batches], dim=0
                )
            embeddings = torch.cat(
                [torch.as_tensor(e) for _, e in batches], dim=0
            )
            return self.index(embeddings, identifiers)
        embeddings = torch.cat([torch.as_tensor(b) for b in batches], dim=0)
        return self.index(embeddings, None)

    @abc.abstractmethod
    def __call__(
        self, queries, k: Optional[int] = None
    ) -> Tuple[Tensor, Tensor]:
        """Queries the index: returns `([q, k] scores, [q, k] ids)`."""

    def query_with_exclusions(
        self,
        queries,
        exclusions,
        k: Optional[int] = None,
    ) -> Tuple[Tensor, Tensor]:
        """Queries the index, excluding the given identifiers per row.

        Over-fetches `k + exclusions.shape[1]` candidates, then drops the
        excluded ones (reference: layers/factorized_top_k.py:242-288).
        String-identified indexes accept string exclusions, encoded to row
        positions before the device mask.
        """
        string_exclusions = _is_string_array(exclusions)
        if string_exclusions:
            exclusions = np.asarray(exclusions)
        k = k if k is not None else self._k
        adjusted_k = k + exclusions.shape[1]
        if self._id_strings is not None or string_exclusions:
            self._suppress_decode = True
            try:
                scores, rows = self(queries, k=adjusted_k)
            finally:
                self._suppress_decode = False
            if string_exclusions:
                if self._id_strings is None:
                    raise ValueError(
                        "String exclusions require a string-identified "
                        "index (none was built)."
                    )
                excl_rows = self._encode_ids(exclusions)
            else:
                excl_rows = torch.as_tensor(exclusions, device=rows.device)
            return self._decode(
                *topk_ops.exclude(scores, rows, excl_rows, k=k)
            )
        scores, ids = self(queries, k=adjusted_k)
        exclusions = torch.as_tensor(exclusions, device=ids.device)
        return topk_ops.exclude(scores, ids, exclusions, k=k)

    @abc.abstractmethod
    def is_exact(self) -> bool:
        """Whether the returned scores/candidates are exact."""


def _check_candidates(candidates, device: torch.device) -> Tensor:
    candidates = torch.as_tensor(candidates, device=device)
    if candidates.ndim != 2:
        raise ValueError(
            f"The candidates tensor must be 2D (got {tuple(candidates.shape)})."
        )
    return candidates


class BruteForce(TopK):
    """Exact brute-force retrieval with the corpus resident on the device.

    One `[q, n]` matmul over the padded corpus, a mask of the padding rows
    and `torch.topk` (reference: layers/factorized_top_k.py:515-610).

    Attributes:
      query_fn: Optional callable mapping raw query features to embeddings
        (the reference's `query_model`).
    """

    def __init__(
        self,
        query_fn: Optional[Callable] = None,
        k: int = 10,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(k=k, device=device)
        self.query_fn = query_fn
        self._candidates: Optional[Tensor] = None
        self._identifiers: Optional[Tensor] = None
        self._valid: Optional[Tensor] = None
        self._num_candidates = 0

    def index(
        self,
        candidates: Tensor,
        identifiers: Optional[Tensor] = None,
    ) -> "BruteForce":
        candidates = _check_candidates(candidates, self.device)
        identifiers = self._intern_identifiers(
            identifiers, candidates.shape[0]
        )
        self._num_candidates = candidates.shape[0]
        self._candidates, self._identifiers, self._valid = (
            topk_ops.pad_corpus(candidates, identifiers, _PAD_MULTIPLE)
        )
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
        k = min(k, self._num_candidates)
        values, indices = scoring.exact_top_k(
            queries, self._candidates, k, self._valid
        )
        return self._decode(values, self._identifiers[indices])

    def is_exact(self) -> bool:
        return True


class Streaming(TopK):
    """Exact top-K over a corpus scored chunk by chunk.

    Two modes, both with the running-merge semantics of the reference's
    `Streaming` (layers/factorized_top_k.py:336-512):

      - `index(...)` with a corpus on the device: a query runs
        `ops.topk.streaming_top_k` over chunks of the padded corpus.
      - `index_from_dataset(factory)` with a zero-arg callable returning
        an iterator of host batches (or a list of batches): every query
        streams the batches to the device, each scored and merged while
        the next ones are copied, for corpora larger than device memory.
        Batches without identifiers are enumerated with a running
        counter (the reference's `enumerate_rows`). String identifiers
        stay on the host and decode after the stream; a stream that
        mixes string and other identifiers raises.

    Attributes:
      query_fn: Optional callable mapping raw query features to embeddings.
      chunk_size: Candidate rows scored a chunk in on-device mode.
    """

    def __init__(
        self,
        query_fn: Optional[Callable] = None,
        k: int = 10,
        chunk_size: int = 4096,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(k=k, device=device)
        self.query_fn = query_fn
        self._chunk_size = chunk_size
        self._chunk = chunk_size
        self._candidates: Optional[Tensor] = None
        self._identifiers: Optional[Tensor] = None
        self._valid: Optional[Tensor] = None
        self._num_candidates = 0
        self._dataset_factory = None

    def index(
        self,
        candidates: Tensor,
        identifiers: Optional[Tensor] = None,
    ) -> "Streaming":
        candidates = _check_candidates(candidates, self.device)
        self._num_candidates = candidates.shape[0]
        identifiers = self._intern_identifiers(
            identifiers, self._num_candidates
        )
        self._chunk = min(self._chunk_size,
                          scoring._round_up(self._num_candidates, 128))
        self._candidates, self._identifiers, self._valid = (
            topk_ops.pad_corpus(candidates, identifiers, self._chunk)
        )
        self._dataset_factory = None
        return self

    def index_from_dataset(self, candidates) -> "Streaming":
        """Keeps a batch-iterator factory (or a list of batches) that
        every query streams anew."""
        if callable(candidates):
            self._dataset_factory = candidates
        else:
            batches = list(candidates)
            self._dataset_factory = lambda: iter(batches)
        self._candidates = None
        # String identifiers are found batch by batch during a streamed
        # query; each stream starts with a clean slate.
        self._id_strings = None
        self._id_lookup = None
        return self

    def __call__(
        self, queries, k: Optional[int] = None
    ) -> Tuple[Tensor, Tensor]:
        k = k if k is not None else self._k
        if self.query_fn is not None:
            queries = self.query_fn(queries)
        queries = torch.as_tensor(queries, device=self.device)
        if self._candidates is not None:
            k = min(k, self._num_candidates)
            return self._decode(*topk_ops.streaming_top_k(
                queries, self._candidates, self._identifiers, self._valid,
                k=k, chunk_size=self._chunk,
            ))
        if self._dataset_factory is None:
            raise ValueError(
                "The `index` method must be called first to "
                "create the retrieval index."
            )
        return self._host_streamed_query(queries, k)

    def _to_device(self, batch, counter: int, string_parts: list,
                   stream):
        """`({"ids", "emb"} on the device, ready event)` of one host
        batch, copied by `utils.device.to_device` (pinned, non-blocking,
        on the side `stream` when the index lives on CUDA)."""
        if isinstance(batch, tuple):
            ids, emb = batch
            if _is_string_array(ids):
                # String ids stay on the host: the device merges row
                # positions, decoded after the stream.
                string_parts.append(np.asarray(ids))
                ids = None
        else:
            ids, emb = None, batch
        emb = torch.as_tensor(emb)
        if ids is None:
            ids = torch.arange(counter, counter + emb.shape[0],
                               dtype=torch.int32)
        return device_lib.to_device({"ids": torch.as_tensor(ids),
                                     "emb": emb}, self.device, stream)

    def _host_streamed_query(
        self, queries: Tensor, k: int, prefetch: int = 2
    ) -> Tuple[Tensor, Tensor]:
        """Streams the host batches with up to `prefetch` copies in
        flight while the current batch's score + merge runs
        (`recommenders_tpu/layers/factorized_top_k.py:404-483`)."""
        q = queries.shape[0]
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        string_parts: list = []
        counter = 0
        it = iter(self._dataset_factory())
        staged = collections.deque()

        def refill():
            nonlocal counter
            while len(staged) < max(1, prefetch):
                try:
                    batch = next(it)
                except StopIteration:
                    return
                staged.append(self._to_device(batch, counter, string_parts,
                                              stream))
                counter += staged[-1][0]["emb"].shape[0]

        refill()
        if not staged:
            raise ValueError("The candidates dataset must not be empty.")
        state = None
        while staged:
            pair = device_lib.wait_batch(*staged.popleft())
            ids, emb = pair["ids"], pair["emb"]
            refill()
            if state is None:
                state = (
                    torch.full((q, k), MIN_FLOAT, dtype=torch.float32,
                               device=self.device),
                    torch.zeros((q, k), dtype=ids.dtype,
                                device=self.device),
                )
            state = _streaming_merge_step(queries, emb, ids, state, k)
        if string_parts:
            strings = np.concatenate(string_parts, axis=0)
            if strings.shape[0] != counter:
                raise ValueError(
                    "The dataset mixed string and non-string identifier "
                    f"batches ({strings.shape[0]} string-identified rows "
                    f"of {counter})."
                )
            self._id_strings = strings
            self._id_lookup = None
            return self._decode(*state)
        return state

    def is_exact(self) -> bool:
        return True


def _streaming_merge_step(queries, emb, ids, state, k):
    """Scores one batch and merges its top-k into the running state
    (`recommenders_tpu/layers/factorized_top_k.py:806-811`)."""
    dtype = torch.promote_types(queries.dtype, emb.dtype)
    scores = (queries.to(dtype) @ emb.to(dtype).T).to(torch.float32)
    chunk_scores, idx = topk_ops.top_k(scores, min(k, scores.shape[1]))
    return topk_ops.topk_merge(state, (chunk_scores, ids[idx]), k)


class Bucketed(TopK):
    """High-throughput serving index on the bucketed scoring kernel.

    Sweeps the stored corpus once per query batch with a per-bucket
    running argmax (`ops.scoring.bucketed_top_k`, the CUDA kernel on a
    CUDA device and its plain twin on the CPU); the `[q, corpus]` score
    matrix never exists. Returned scores are exact dot products of the
    stored corpus; recall < 1 only from top-k items colliding in one
    bucket (≈ `1 − (k−1)/2·buckets`), so `is_exact() == False`.

    Attributes:
      query_fn: Optional query-embedding function.
      buckets: Selection width (recall dial). Must divide `chunk`.
      chunk: Row multiple the stored corpus is padded to.
      query_tile: Query batches are padded to a multiple of
        `min(query_tile, round_up(q, 8))`.
      corpus_dtype: Optional storage dtype for the corpus
        (`torch.bfloat16` halves its bytes); queries are cast to it.
      quantize: `False`, `"int8"` (or `True`), or `"int4"`: store integer
        codes with per-row f32 scales (`ops/quantization.py`). int4 packs
        two codes per byte (`pack_nibbles`) and needs `buckets` to divide
        `chunk/2`. Mutually exclusive with `corpus_dtype`.
      anisotropic_quantization_threshold: Score-aware scale refinement
        for quantized indexes; None uses abs-max scaling.
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
        self._scales: Optional[Tensor] = None
        self._candidates: Optional[Tensor] = None
        self._identifiers: Optional[Tensor] = None
        self._num_candidates = 0

    def _check_dim(self, d: int) -> None:
        if d % 128 != 0:
            raise ValueError(
                "Bucketed requires the embedding dim to be a multiple of "
                f"128; got {d}. Pad the embeddings or use BruteForce."
            )

    def index(
        self,
        candidates: Tensor,
        identifiers: Optional[Tensor] = None,
    ) -> "Bucketed":
        candidates = _check_candidates(candidates, self.device)
        self._check_dim(candidates.shape[1])
        self._num_candidates = candidates.shape[0]
        identifiers = self._intern_identifiers(
            identifiers, self._num_candidates
        )
        # Pad to the chunk grid at index time for every mode, so a query
        # never copies the stored corpus; padding rows are masked by
        # `valid_rows`. For int4 the nibble pairing (row c ↔ c + n/2) is
        # over the padded n, so it is baked in here.
        if self._quantize:
            padded = scoring.pad_to_multiple(candidates, self._chunk)
            bits = 4 if self._quantize == "int4" else 8
            self._scales, codes = quantization.quantize_rows_device(
                padded, self._anisotropic_threshold, bits=bits
            )
            if bits == 4:
                codes = quantization.pack_nibbles(codes)
            self._candidates = codes
        else:
            if self._corpus_dtype is not None:
                candidates = candidates.to(self._corpus_dtype)
            self._candidates = scoring.pad_to_multiple(
                candidates, self._chunk
            ).contiguous()
            self._scales = None
        self._identifiers = identifiers
        return self

    def index_streamed(
        self,
        batches,
        num_rows: int,
        identifiers: Optional[Tensor] = None,
    ) -> "Bucketed":
        """Builds the index from row batches without ever holding the
        full-precision corpus on the device.

        Each batch is cast or quantized on the device and written into the
        preallocated storage in place, so peak device memory is the
        stored corpus plus one batch.

        Args:
          batches: Iterable (or zero-arg callable returning one) of
            `[b, D]` row blocks, in corpus order.
          num_rows: Total corpus rows (must match the sum of batches).
          identifiers: Optional `[num_rows]` identifier array.
        """
        it = iter(batches() if callable(batches) else batches)
        identifiers = self._intern_identifiers(identifiers, num_rows)
        packed4 = self._quantize == "int4"
        stored_n = scoring._round_up(num_rows, self._chunk)
        half = stored_n // 2
        buf = scales = None
        off = 0
        for batch in it:
            batch = torch.as_tensor(batch, device=self.device)
            if batch.ndim != 2:
                raise ValueError(
                    f"Batches must be 2D row blocks (got {tuple(batch.shape)})."
                )
            b, d = batch.shape
            if buf is None:
                self._check_dim(d)
                if self._quantize:
                    code_rows = half if packed4 else stored_n
                    buf = torch.zeros(
                        (code_rows, d), dtype=torch.int8, device=self.device
                    )
                    scales = torch.zeros(
                        (stored_n,), dtype=torch.float32, device=self.device
                    )
                else:
                    dtype = self._corpus_dtype or torch.float32
                    buf = torch.zeros(
                        (stored_n, d), dtype=dtype, device=self.device
                    )
            if off + b > num_rows:
                raise ValueError(
                    f"Batches supply more than num_rows={num_rows} rows."
                )
            store_rows_(buf, scales, batch, off, stored_n, self._quantize,
                        self._anisotropic_threshold)
            off += b
        if buf is None:
            raise ValueError("The batches iterable must not be empty.")
        if off != num_rows:
            raise ValueError(
                f"Batches supplied {off} rows, expected num_rows="
                f"{num_rows}."
            )
        self._num_candidates = num_rows
        self._candidates = buf
        self._scales = scales
        self._identifiers = identifiers
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
        k = min(k, self._num_candidates)
        if not self._quantize:
            # The stored dtype (corpus_dtype, else f32): bf16 indexes score
            # bf16 queries; an f32 index takes any query exactly in f32.
            queries = queries.to(self._candidates.dtype)
        scores, rows = scoring.bucketed_top_k(
            queries,
            self._candidates,
            k,
            buckets=self._buckets,
            chunk=self._chunk,
            query_tile=self._query_tile,
            scales=self._scales,
            packed4=self._quantize == "int4",
            valid_rows=self._num_candidates,
        )
        if self._identifiers is not None:
            return scores, self._identifiers[rows.long()]
        return self._decode(scores, rows)

    def is_exact(self) -> bool:
        return False


def store_rows_(buf: Tensor, scales: Optional[Tensor], block: Tensor,
                off: int, stored_n: int, quantize: Optional[str],
                threshold: Optional[float]) -> None:
    """Casts or quantizes the `[b, D]` rows `block` into rows `off:` of a
    bucketed index's storage of `stored_n` rows, in place: `buf` holds
    the rows in its dtype, or int8 codes (`[stored_n / 2, D]` packed
    nibbles for "int4") with their f32 `scales`."""
    b = block.shape[0]
    if not quantize:
        buf[off:off + b] = block.to(buf.dtype)
        return
    packed4 = quantize == "int4"
    s, codes = quantization.quantize_rows_device(
        block, threshold, bits=4 if packed4 else 8)
    scales[off:off + b] = s
    if not packed4:
        buf[off:off + b] = codes
        return
    # Row r lands in packed row r % half: the low nibble for r < half,
    # the high one otherwise. A block that straddles `half` splits; each
    # (row, nibble) is written once into the zeroed buffer.
    half = stored_n // 2
    cut = min(max(half - off, 0), b)
    if cut:
        _or_nibble_(buf, codes[:cut], off, high=False)
    if b - cut:
        _or_nibble_(buf, codes[cut:], off + cut - half, high=True)


def _or_nibble_(buf: Tensor, codes: Tensor, off: int, high: bool) -> None:
    """ORs int4 `codes` into rows `off:` of `buf`, as the high or low
    nibble (`pack_nibbles` byte layout), in place. Each (row, nibble) must
    be written at most once over a zero buffer."""
    rows = slice(off, off + codes.shape[0])
    buf[rows] = quantization.merge_nibbles(buf[rows], codes, high)


def __getattr__(name):
    # Lazy re-export of `ScaNN`, which the reference defines in this module
    # (layers/factorized_top_k.py:613); `approximate` imports `TopK` from
    # here, so an import at the top would be circular.
    if name == "ScaNN":
        from recommenders_tpu_torch.layers import approximate

        return approximate.ScaNN
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
