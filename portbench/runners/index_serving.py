"""Serving a retrieval index built over the streamed catalog: one client
in a closed loop, each request `[Q, D]` queries for their top k, timed
from the call until the ids and scores are on the host.

Set-up builds the configuration's index through the port's streamed
build over the seeded catalog, draws the request pool on the device and
warms up the cell's own request shape. The window serves the pool in
order for `--seconds`. Then a sample of the requests answered, drawn
from the seed, is held against the reference (`portbench/reference/`),
with the program's state freed but the partition the reference follows,
and against the exact top k, which follows nothing the program built.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from portbench import compare
from portbench import generator
from portbench import tracing
from portbench import yardstick
from portbench.reference import quantize
from portbench.reference import search

Tensor = torch.Tensor


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_index(config: dict, catalog: generator.Catalog,
                device: torch.device):
    """The system under test: the port's index named by the config, built
    by its own streamed build."""
    from recommenders_tpu_torch.layers import approximate
    from recommenders_tpu_torch.layers import factorized_top_k

    classes = {"ScaNN": approximate.ScaNN,
               "Bucketed": factorized_top_k.Bucketed}
    index = classes[config["index"]](device=device, **config["settings"])
    return index.index_streamed(catalog, num_rows=catalog.rows)


def bits_of(config: dict) -> int:
    return {"int8": 8, "int4": 4}[config["settings"]["quantize"]]


# --- What the reference follows and judges, taken before the index goes ---

@dataclasses.dataclass
class State:
    """The partition a ScaNN index chose (None for Bucketed), and a
    sample of its stored rows: `rows [m]` catalog rows, `codes [m, D]`,
    `scales [m]`, and (ScaNN) the `leaves [m]` holding them."""
    centroids: Optional[Tensor]
    leaf_rows: Optional[Tensor]
    rows: Tensor
    codes: Tensor
    scales: Tensor
    leaves: Optional[Tensor] = None


def take_state(index, config: dict, catalog: generator.Catalog,
               sample: int, seed: int) -> State:
    device = catalog.device
    gen = generator.generator(seed, generator.SAMPLE_SALT, device)
    if config["index"] == "ScaNN":
        leaf_rows = index._leaf_rows
        slots = torch.randint(0, leaf_rows.numel(), (sample,), generator=gen,
                              device=device)
        rows = leaf_rows.reshape(-1)[slots]
        keep = rows >= 0
        slots, rows = slots[keep], rows[keep].long()
        d = index._leaf_embs.shape[-1]
        return State(index._centroids, leaf_rows, rows,
                     index._leaf_embs.reshape(-1, d)[slots],
                     index._leaf_scales.reshape(-1)[slots],
                     slots // leaf_rows.shape[1])
    rows = torch.randint(0, catalog.rows, (sample,), generator=gen,
                         device=device)
    return State(None, None, rows, index._candidates[rows],
                 index._scales[rows])


def misstored(state: State, rows: int) -> int:
    """Catalog rows a ScaNN partition does not hold exactly once (0 for
    Bucketed, whose row r is stored at r)."""
    if state.leaf_rows is None:
        return 0
    held = state.leaf_rows[state.leaf_rows >= 0].long()
    outside = int((held >= rows).sum())
    counts = torch.bincount(held[held < rows], minlength=rows)
    return outside + int((counts != 1).sum())


def placement(state: State, table: "Table", rounds: int,
              block: int = 1 << 15) -> Optional[float]:
    """The share of the sampled stored rows that sit in one of their
    `rounds` nearest leaves (by the reference's decoded rows): a look at
    the partition the reference follows, printed beside the numbers
    (rows the packing could place nowhere nearer fill free slots)."""
    if state.leaves is None or not state.rows.numel():
        return None
    half = 0.5 * torch.sum(torch.square(state.centroids), dim=1)
    hits = 0
    for b in range(0, state.rows.numel(), block):
        rows = state.rows[b:b + block]
        decoded = (table.codes[rows].to(torch.float32)
                   * table.scales[rows][:, None])
        with search.full_f32():
            affinity = decoded @ state.centroids.T - half
        near = torch.topk(affinity, rounds, dim=1).indices
        hits += int((near == state.leaves[b:b + block, None]).any(1).sum())
    return hits / state.rows.numel()


# --- The reference's side ------------------------------------------------

@dataclasses.dataclass
class Table:
    """The catalog quantized by the reference at `bits`."""
    codes: Tensor
    scales: Tensor


def reference_table(config: dict, catalog: generator.Catalog,
                    bits: int) -> Table:
    codes, scales = quantize.quantize_catalog(
        catalog(), catalog.rows, catalog.dim,
        config["settings"].get("anisotropic_quantization_threshold"), bits,
        catalog.device)
    return Table(codes, scales)


def reference_answer(config: dict, state: State, table: Table,
                     queries: Tensor, k: int):
    """([Q, k] scores, [Q, k] rows) the configuration's semantics give
    over `table`."""
    s = config["settings"]
    if config["index"] == "ScaNN":
        return search.scann_top_k(
            queries, state.centroids, state.leaf_rows, table.codes,
            table.scales, s["num_leaves_to_search"], s["probe_tile"],
            s["scoring_buckets"], k)
    return search.bucketed_top_k(queries, table.codes, table.scales,
                                 s["buckets"], k)


def judge(config: dict, state: State, table: Table, queries: Tensor,
          k: int) -> tuple:
    """What one request is judged against: the configuration's answer
    ([Q, k] scores, [Q, k] rows) and the exact [Q, k] top rows."""
    scores, rows = reference_answer(config, state, table, queries, k)
    return scores, rows, search.exact_top_k(queries, table.codes,
                                            table.scales, k)[1]


def numbers(answers: list, stored: tuple, ref: Table, refs: list) -> dict:
    """The compared numbers of `answers` [(queries, scores, ids)] against
    the reference's `refs` [(scores, rows, exact rows)] on `ref`, and of
    the stored rows `stored` (rows, codes, scales)."""
    score_gap = rank_gap = 0.0
    missed = asked = 0
    for (queries, scores, ids), (ref_top, _, exact) in zip(answers, refs):
        ids = ids.to(queries.device).long()
        ref_of = search.scores_of(queries, ids, ref.codes, ref.scales)
        gaps = compare.result_gaps(scores.to(queries.device), ref_of,
                                   ref_top)
        score_gap = max(score_gap, gaps["score_gap"])
        rank_gap = max(rank_gap, gaps["rank_gap"])
        missed += compare.missed(ids, exact)
        asked += exact.numel()
    rows, codes, scales = stored
    return {"score_gap": score_gap, "rank_gap": rank_gap,
            "code_gap": compare.code_gap(codes, scales, ref.codes[rows],
                                         ref.scales[rows]),
            "recall_loss": missed / asked if asked else float("inf")}


def work_of(config: dict, state: State, queries: Tensor) -> dict:
    """The yardstick's least work of one request."""
    s = config["settings"]
    dim = queries.shape[1]
    if config["index"] == "ScaNN":
        with search.full_f32():
            cscores = queries @ state.centroids.T
        _, tiles = search.tile_probes(cscores, s["num_leaves_to_search"],
                                      s["probe_tile"])
        return yardstick.scann_work(s, dim, queries.shape[0],
                                    [t.tolist() for t in tiles])
    return yardstick.bucketed_work(s, config["catalog"]["rows"], dim,
                                   queries.shape[0])


@dataclasses.dataclass
class Reading:
    """What the per-layer metrics read: the traced window, the least work
    of its requests, and the port's launch counters over it."""
    trace: tracing.Trace
    work: dict
    counters: dict

    def least_seconds(self, family: str) -> Optional[float]:
        w = self.work.get(family)
        if w is None:
            return None
        return w["least_s"]


@dataclasses.dataclass
class Outcome:
    end_to_end: dict
    attempted: int
    failed: int
    numbers: dict
    memory_peak_bytes: int
    reading: Optional[Reading] = None


def _launch_counters(device: torch.device) -> dict:
    """The port's launch counts: its wrappers' by format, and on the card
    the op library's own by op and format."""
    from recommenders_tpu_torch.ops import cuda_build
    from recommenders_tpu_torch.ops import leaf_scoring
    from recommenders_tpu_torch.ops import scoring

    out = {"wrapper.bucketed_scores":
           dict(scoring.bucketed_scores.launches_by_format),
           "wrapper.probed_bucketed_scores":
           dict(leaf_scoring.probed_bucketed_scores.launches_by_format)}
    if device.type == "cuda":
        out.update(cuda_build.op_launches())
    return out


class Client:
    """The caller's side: each answer lands in host buffers of its own,
    pinned on the card's machine and reused, so a request's time holds no
    allocation of host memory; between requests the answer is filed into
    a store that grows by blocks whose pages are touched when made."""

    BLOCK = 64

    def __init__(self, device: torch.device):
        self.device = device
        self.stage = None
        self.blocks = None
        self.count = 0

    def request(self, index, queries: Tensor, k: int):
        """One request: the call, and its answer on the host."""
        scores, ids = index(queries, k)
        if self.stage is None:
            pin = self.device.type == "cuda"
            self.stage = tuple(torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=pin)
                               for t in (scores, ids))
        if not self._fits(scores, ids):
            return scores.cpu(), ids.cpu()
        self.stage[0].copy_(scores, non_blocking=True)
        self.stage[1].copy_(ids, non_blocking=True)
        sync(self.device)
        return self.stage

    def _fits(self, scores: Tensor, ids: Tensor) -> bool:
        return all(s.shape == t.shape and s.dtype == t.dtype
                   for s, t in zip(self.stage, (scores, ids)))

    def keep(self, scores: Tensor, ids: Tensor):
        """Files a host answer; returns the kept copy."""
        if not self._fits(scores, ids):
            return scores.clone(), ids.clone()
        slot = self.count % self.BLOCK
        if slot == 0:
            self.blocks = tuple(torch.zeros((self.BLOCK,) + tuple(t.shape),
                                            dtype=t.dtype)
                                for t in self.stage)
        self.count += 1
        self.blocks[0][slot].copy_(scores)
        self.blocks[1][slot].copy_(ids)
        return self.blocks[0][slot], self.blocks[1][slot]


def run(config: dict, traffic: dict, check: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t0: float,
        wrap: Optional[Callable] = None) -> Outcome:
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("index_serving runs one client in a closed loop")
    q, k = traffic["queries_per_request"], traffic["k"]
    t = time.perf_counter()
    catalog = generator.Catalog(config["catalog"], seed, device)
    sync(device)
    marks = {"imports": t - t0, "device": time.perf_counter() - t}
    t = time.perf_counter()
    index = build_index(config, catalog, device)
    sync(device)
    marks["build"] = time.perf_counter() - t
    t = time.perf_counter()
    served = index if wrap is None else wrap(index)
    client = Client(device)
    pool = catalog.requests(traffic["pool_requests"], q,
                            generator.REQUEST_SALT)
    warm = catalog.requests(traffic["warmup_requests"], q,
                            generator.WARMUP_SALT)
    for r in warm:
        client.request(served, r, k)
    if trace:
        # The profiler's first session pays its own start-up here.
        with torch.profiler.profile(activities=tracing.activities()):
            client.request(served, warm[0], k)
    sync(device)
    setup_s = time.perf_counter() - t0
    marks["warm-up"] = time.perf_counter() - t
    log("setup " + ", ".join(f"{n} {v:.3f} s" for n, v in marks.items()))

    latencies, answered, first_error = [], [], None
    prof, counters, traced_n = None, {}, 0
    if trace:
        before = _launch_counters(device)
        prof = torch.profiler.profile(activities=tracing.activities())
        prof.__enter__()
    profiling = trace
    i = 0
    start = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - start >= seconds:
            break
        if profiling and now - start >= traffic["trace_seconds"]:
            prof.__exit__(None, None, None)
            counters = _delta(before, _launch_counters(device))
            traced_n, profiling = i, False
        j = i % pool.shape[0]
        try:
            if profiling:
                with torch.profiler.record_function(tracing.REQUEST_SPAN):
                    scores, ids = client.request(served, pool[j], k)
            else:
                scores, ids = client.request(served, pool[j], k)
        except Exception:  # noqa: BLE001 - a request that raises fails
            scores = ids = None
            if first_error is None:
                first_error = traceback.format_exc()
        latencies.append(time.perf_counter() - now)
        if scores is not None:
            scores, ids = client.keep(scores, ids)
        answered.append((j, scores, ids))
        i += 1
    window_s = time.perf_counter() - start
    if profiling:
        prof.__exit__(None, None, None)
        counters = _delta(before, _launch_counters(device))
        traced_n = i
    if first_error is not None:
        log(f"first failed request:\n{first_error}")

    rows = config["catalog"]["rows"]
    good = [a for a in answered if a[1] is not None
            and not compare.malformed(a[1], a[2], q, k, rows)]
    failed = len(answered) - len(good)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    end_to_end = {
        "qps": q * len(good) / window_s,
        "request_p95_ms": float(np.percentile(latencies, 95) * 1e3),
        "setup_s": setup_s,
    }
    log(f"window {window_s:.6f} s: {len(answered)} requests of {q}, "
        f"{failed} failed; request ms p50 "
        f"{np.percentile(latencies, 50) * 1e3:.4f} p95 "
        f"{end_to_end['request_p95_ms']:.4f} max "
        f"{max(latencies) * 1e3:.4f}; setup {setup_s:.3f} s; peak "
        f"{memory_peak / 2**30:.3f} GiB")

    # The sample the reference judges, drawn from the seed.
    pick = np.random.default_rng(seed).permutation(len(good))[
        :check["requests"]]
    sample = [(pool[good[p][0]], good[p][1], good[p][2]) for p in pick]
    state = take_state(index, config, catalog, check["code_rows"], seed)
    reading = None
    if trace:
        reading = _reading(config, state, pool, answered[:traced_n],
                           counters, prof)
    del index, served
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    bad_rows = misstored(state, rows)
    table = reference_table(config, catalog, bits_of(config))
    refs = [judge(config, state, table, qs, k) for qs, _, _ in sample]
    found = numbers(sample, (state.rows, state.codes, state.scales), table,
                    refs)
    sync(device)
    log(f"reference: {len(sample)} requests and {state.rows.numel()} "
        f"stored rows judged in {time.perf_counter() - t:.3f} s; recall@{k} "
        f"{1.0 - found['recall_loss']:.6f}; catalog rows not stored exactly "
        f"once: {bad_rows}")
    if state.leaves is not None:
        rounds = config["settings"]["spill_rounds"]
        log(f"partition: {placement(state, table, rounds):.6f} of the "
            f"sampled stored rows within their {rounds} nearest leaves")
    if bad_rows:
        failed = len(answered)
    if not sample:
        found = {name: float("inf") for name in compare.NUMBERS}
    return Outcome(end_to_end, len(answered), failed, found, memory_peak,
                   reading)


def _delta(before: dict, after: dict) -> dict:
    return {op: {fmt: n - before[op][fmt] for fmt, n in fmts.items()}
            for op, fmts in after.items()}


def _reading(config: dict, state: State, pool: Tensor, traced: list,
             counters: dict, prof) -> Reading:
    """The traced window's `Reading`: its profile, the least work of the
    requests it holds, and the launch counters over it."""
    t = time.perf_counter()
    trace = tracing.read_profile(prof)
    work = {}
    for j, _, _ in traced:
        for name, value in work_of(config, state, pool[j]).items():
            if isinstance(value, dict):
                total = work.setdefault(name, {"ops": 0.0, "bytes": 0.0,
                                               "least_s": 0.0})
                total["ops"] += value["ops"]
                total["bytes"] += value["bytes"]
                total["least_s"] += yardstick.least_seconds(
                    value["ops"], value["bytes"])
            else:
                work[name] = work.get(name, 0.0) + value
    log(f"trace: {trace.requests} requests ({len(traced)} sent) in "
        f"{trace.window_s:.6f} s, {trace.launches()} kernels, busy "
        f"{trace.busy_s:.6f} s; least work {work}; op-library launches "
        f"{counters}; read in {time.perf_counter() - t:.3f} s")
    return Reading(trace, work, counters)
