"""Runs a function on several ranks, one process each.

`run_ranks(fn, world_size, backend, device, *args)` starts `world_size`
processes with the spawn start method; each initializes the default
process group from a `file://` store in a fresh temporary directory (no
TCP port, so concurrent callers never collide), calls
`fn(device, *args)` and sends back what it returns. A rank that raises,
or dies, fails the call: the others are stopped and the traceback of the
rank that failed first is raised here (its peers then fail in their
collectives).

`fn` must be importable by name from a module (spawn pickles it by
reference), and the children import only what that module imports.
On `device="cuda"` rank `r` runs on card `r % device_count()`: several
ranks may share one card (on the gloo backend, which stages CUDA
tensors through host memory; NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from recommenders_tpu_torch.utils import device as device_lib


def _entry(rank: int, world_size: int, backend: str, device: str,
           root: str, threads: int, fn: Callable, args: tuple) -> None:
    result_path = os.path.join(root, f"rank{rank}.pkl")

    def write(status: str, value) -> None:
        with open(result_path + ".tmp", "wb") as f:
            pickle.dump((status, value, time.time()), f)
        os.replace(result_path + ".tmp", result_path)

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = device_lib.resolve(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(root, "store"),
            rank=rank, world_size=world_size,
        )
    except BaseException:
        write("error", traceback.format_exc())
        raise
    try:
        out = fn(dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
    except BaseException:
        # Written before the group closes, so it predates the errors the
        # closing raises in the peers.
        write("error", traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    write("ok", out)


def run_ranks(fn: Callable, world_size: int, backend: str = "gloo",
              device: str = "cuda", *args: Any, timeout: float = 600.0,
              threads: int = 0) -> List[Any]:
    """Runs `fn(device, *args)` on `world_size` ranks; returns each
    rank's result, in rank order.

    Args:
      fn: A module-level function `(torch.device, *args) -> picklable`.
      world_size: Ranks (processes).
      backend: `"gloo"` or `"nccl"`.
      device: `"cuda"` (the default; raises without CUDA) or `"cpu"`.
      *args: Picklable arguments, the same for every rank.
      timeout: Seconds before the call fails and stops every rank.
      threads: `torch.set_num_threads` in each rank (0 keeps the
        default).

    Raises:
      RuntimeError: a rank raised (its traceback is in the message),
        died, or the call ran past `timeout`.
    """
    device_lib.resolve(device)
    ctx = mp.get_context("spawn")
    root = tempfile.mkdtemp(prefix="run_ranks_")
    procs = []
    try:
        for rank in range(world_size):
            p = ctx.Process(
                target=_entry,
                args=(rank, world_size, backend, device, root, threads, fn,
                      args),
                daemon=True,
            )
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.is_alive() for p in procs):
            for rank, p in enumerate(procs):
                if not p.is_alive() and p.exitcode != 0:
                    failed = rank
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if failed is None:
            for rank, p in enumerate(procs):
                if p.exitcode not in (None, 0):
                    failed = rank
        if failed is not None or any(p.is_alive() for p in procs):
            # The peers of a failed rank fail in their next collective:
            # give them a moment, then report the rank that failed first.
            grace = time.monotonic() + 10
            while (failed is not None and time.monotonic() < grace
                   and any(p.is_alive() for p in procs)):
                time.sleep(0.05)
            if failed is not None:
                failed = _first_failure(root, world_size, failed)
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            if failed is None:
                raise RuntimeError(
                    f"run_ranks: {world_size} ranks ran past {timeout} s")
            raise RuntimeError(
                f"run_ranks: rank {failed} of {world_size} failed "
                f"(exit code {procs[failed].exitcode}):\n"
                + _read(root, failed, "no traceback (the process died)"))
        results = []
        for rank in range(world_size):
            status, out, _ = _load(root, rank)
            if status != "ok":
                raise RuntimeError(
                    f"run_ranks: rank {rank} of {world_size} failed:\n"
                    + out)
            results.append(out)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)


def _load(root: str, rank: int):
    """(status, result or traceback, when); a rank that left no file
    died."""
    path = os.path.join(root, f"rank{rank}.pkl")
    if not os.path.exists(path):
        return "error", "no result (the process died)", float("inf")
    with open(path, "rb") as f:
        return pickle.load(f)


def _first_failure(root: str, world_size: int, default: int) -> int:
    """The rank whose error was written first (`default` if none was)."""
    errors = [(when, rank) for rank in range(world_size)
              for status, _, when in [_load(root, rank)]
              if status == "error" and when != float("inf")]
    return min(errors)[1] if errors else default


def _read(root: str, rank: int, missing: str) -> str:
    status, out, _ = _load(root, rank)
    return out if status == "error" else missing
