"""The fixed yardstick: the H100's published peaks, the kernels by their
symbols, and the least work of a request, counted from the configuration
and the inputs (never from the port's plans), so a later change to a
kernel's tiling does not move it.

Least time = the larger of operations at the bf16 dense peak and bytes
at the HBM rate, each input byte read once and each output byte written
once (`PERF.md` §3; the same arithmetic as `chip_smoke.py`'s `k5_bound`
and `check_k3_scale`, frozen here).
"""

from __future__ import annotations

import re
from typing import Optional

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# Kernel symbols of each kernel family, as the profiler names them.
KERNELS = {
    # csrc/bucketed_scores.cu: the bodies and their split merge.
    "K3": re.compile(r"(?<![A-Za-z0-9_])(bucketed_int8_kernel|"
                     r"bucketed_tc_kernel|merge_splits_kernel)"),
    # csrc/leaf_scoring.cu: K5's bodies, its int8 finalize and merge.
    "K5": re.compile(r"(?<![A-Za-z0-9_])(probed_bucketed_int8_kernel|"
                     r"probed_bucketed_tc_kernel|finalize_int8_kernel|"
                     r"merge_probe_splits_kernel)"),
}


def family(kernel: str) -> Optional[str]:
    for name, pattern in KERNELS.items():
        if pattern.search(kernel):
            return name
    return None


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucketed_work(settings: dict, rows: int, dim: int, queries: int) -> dict:
    """A Bucketed int8 request of `queries` queries: every stored row
    (the catalog on the `chunk` grid) scored by every query; codes and
    scales read once, the f32 queries read, `[Q, B]` scores and rows
    written."""
    stored = round_up(rows, settings["chunk"])
    ops = 2.0 * queries * stored * dim
    nbytes = (queries * dim * 4 + stored * (dim + 4)
              + queries * settings["buckets"] * 8)
    return {"K3": {"ops": ops, "bytes": nbytes}, "flops": ops}


def scann_work(settings: dict, dim: int, queries: int,
               tile_leaves: list) -> dict:
    """A ScaNN int8 request whose tiles probe the distinct leaves
    `tile_leaves` (one list a tile, by the reference's probe selection):
    K5 reads each distinct leaf of the request once (codes, scales and
    slot rows of all `leaf_capacity` slots), the f32 queries and the
    probe lists, writes `[Q, B]` scores and rows, and multiplies each
    query by every slot of each distinct leaf its tile probes. The
    request's products add the queries against every centroid."""
    cap = settings["leaf_capacity"]
    buckets = min(settings["scoring_buckets"], cap)
    tile = settings["probe_tile"]
    union = set()
    pairs = 0
    for leaves in tile_leaves:
        union.update(int(x) for x in leaves)
        pairs += len(leaves)
    ops = 2.0 * dim * tile * pairs * cap
    nbytes = (len(union) * cap * (dim + 4 + 4) + queries * dim * 4
              + len(tile_leaves) * settings["num_leaves_to_search"] * 4
              + queries * buckets * 8)
    centroids = 2.0 * dim * queries * settings["num_leaves"]
    return {"K5": {"ops": ops, "bytes": nbytes}, "flops": ops + centroids}
