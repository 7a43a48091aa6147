#!/usr/bin/env python3
"""Measures the card's streamed read-plus-write rate at the sparse
update's shape, beside K1 there, on one NVIDIA GPU.

    python3 -m recommenders_tpu_torch.tools.alias_probe [--bf16-table]

The port's counterpart of `benchmarks/_alias_probe.py`, at its shapes
(V = 131,072 rows, D = 64, N = 4,096 ids a step, `:31`) and with its
data (a normal table, in f32 or with `--bf16-table` in bf16, an f32
accumulator uniform in [0.1, 1), uniform ids and normal grads × 1e-3,
`:64-73`), drawn with NumPy from seed 0. It prints the card's name and
power limit, then four measurements, each in µs a step and as × its
floor:

  copy/alias      the copy step (`ops.copy_chain.copy_step`, kernel
                  `csrc/copy_chain.cu`) in place, chained so that each
                  launch reads what the last one wrote (the probe's scan
                  carries its state the same way, `:131-140`);
  copy/noalias    the copy step out of place, ping-ponging between two
                  buffer pairs;
  kernel/alias    K1 (`ops.sparse_apply.sorted_block_apply`, which is in
                  place only) over the step's ids and grads, with the
                  port's Adagrad rule at lr 0.1
                  (`embedding.sparse_optimizer._kernel_rule`). The probe
                  passes its own closure (`:81-86`); the port's rule
                  computes the same `t - lr·g·rsqrt(a + g² + 1e-12)` on
                  the run's summed grads, but takes the root correctly
                  rounded where `jax.lax.rsqrt` may be an ulp off. No
                  stochastic rounding, as in the probe: a bf16 table is
                  written rounded to nearest. The ids are sorted before
                  the timed chain; the probe sorts them inside its scan
                  (`:94`), so its kernel rows include an argsort;
  kernel/noalias  the counterpart of the probe's `_alias=False` (`:99`),
                  without a knob on K1: a sweep that is not aliased
                  writes fresh output buffers, so each step is the copy
                  step out of place into the other buffer pair, then K1
                  in place on it.

Timing: the probe differences host-clocked scans of 10 and 110 steps
(`:35-47`). Here each chain of 20 steps is timed by the checkout's
`chip_smoke.graph_ms`, which times every kernel of the smoke's
`{"kernels": [...]}` line: the chain captured in one CUDA graph and
replayed between CUDA events. A chain of distinct steps is one callable
that runs the next step at each call. The least of 3 readings is the
time of a step. The floor is the bytes one copy step must move,
V·D·(table bytes + 4)·2 (each value read once and written once), at
`chip_smoke.HBM_BYTES_PER_S`, the H100's data-sheet rate of 3.35 TB/s.

Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import itertools
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from recommenders_tpu_torch.embedding import config as emb_config
from recommenders_tpu_torch.embedding import sparse_optimizer
from recommenders_tpu_torch.ops import copy_chain
from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops import sparse_apply

ROOT = Path(__file__).resolve().parents[2]
LR = 0.1                                  # _alias_probe.py:86
GRAD_SCALE = 1e-3                         # _alias_probe.py:72
READS = 3
SEED = 0
MEASUREMENTS = ("copy/alias", "copy/noalias", "kernel/alias",
                "kernel/noalias")


@dataclasses.dataclass(frozen=True)
class Shape:
    """The probe's shape (`_alias_probe.py:31`) and the chain's length."""
    rows: int = 131_072
    dim: int = 64
    ids: int = 4096
    steps: int = 20


def traffic_bytes(rows: int, dim: int, table_dtype: torch.dtype) -> int:
    """Bytes one copy step moves: both arrays read once, written once."""
    itemsize = torch.empty((), dtype=table_dtype).element_size()
    return rows * dim * (itemsize + 4) * 2


def floor_us(rows: int, dim: int, table_dtype: torch.dtype) -> float:
    return (traffic_bytes(rows, dim, table_dtype)
            / smoke().HBM_BYTES_PER_S * 1e6)


def smoke():
    """The checkout's `chip_smoke.py`, for its timer and its bytes rate;
    loaded once, as `tools/kernel_ab.py` loads it."""
    module = sys.modules.get("chip_smoke")
    if module is None:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return module


def state(shape: Shape, table_dtype: torch.dtype, device,
          seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's table and accumulator (`:64-69`)."""
    rng = np.random.RandomState(seed)
    table = rng.normal(size=(shape.rows, shape.dim)).astype(np.float32)
    accum = rng.uniform(0.1, 1.0, size=(shape.rows, shape.dim))
    return (torch.from_numpy(table).to(device=device, dtype=table_dtype),
            torch.from_numpy(accum.astype(np.float32)).to(device))


def updates(shape: Shape, device, seed: int
            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each step's sorted ids (int32) and their grads (`:70-73`)."""
    rng = np.random.RandomState(seed + 1)
    out = []
    for _ in range(shape.steps):
        ids = rng.randint(0, shape.rows, size=shape.ids).astype(np.int32)
        grads = (rng.normal(size=(shape.ids, shape.dim)).astype(np.float32)
                 * GRAD_SCALE)
        order = np.argsort(ids, kind="stable")
        out.append((torch.from_numpy(ids[order]).to(device),
                    torch.from_numpy(grads[order]).to(device)))
    return out


def adagrad_rule(device) -> Tuple[sparse_apply.BlockRule, torch.Tensor]:
    """K1's Adagrad rule at lr 0.1 and its scalars on `device`."""
    spec = emb_config.OptimizerSpec(kind="adagrad", learning_rate=LR)
    _, scalars, rule, _ = sparse_optimizer._kernel_rule(spec, 0)
    return rule, scalars.to(device)


def step_us(fn: Callable[[], object], device, steps: int) -> float:
    """µs of one `fn()` call in a chain of `steps` calls: the least of
    `READS` readings of `chip_smoke.graph_ms`. Off the card its host clock
    (a rehearsal of the control flow, not a device time)."""
    return min(smoke().graph_ms(fn, device, launches=steps)
               for _ in range(READS)) * 1e3


def cycle(steps: Sequence[Callable[[], object]]) -> Callable[[], object]:
    """One callable that runs the next of `steps` at each call."""
    turn = itertools.cycle(steps)
    return lambda: next(turn)()


def wrapper_calls(shape: Shape) -> Tuple[int, int]:
    """The copy step's and K1's wrapper calls in one `measurements` run.
    Each reading of a chain calls its step once to warm up and
    `shape.steps` times under capture (`chip_smoke.graph_ms`); a replay
    reruns the captured launches without calling the wrapper. Three
    chains run the copy step and two run K1."""
    per_chain = READS * (shape.steps + 1)
    return 3 * per_chain, 2 * per_chain


def measurements(device, table_dtype: torch.dtype, shape: Shape = Shape(),
                 seed: int = SEED) -> Dict[str, float]:
    """The probe's four measurements, µs a step (`MEASUREMENTS`)."""
    table, accum = state(shape, table_dtype, device, seed)
    steps = updates(shape, device, seed)
    rule, scalars = adagrad_rule(device)
    spare = (torch.empty_like(table), torch.empty_like(accum))

    def fresh():
        return [(table.clone(), accum.clone()), spare]

    def copy(pairs, src: int, out: bool):
        pair, other = pairs[src], pairs[1 - src]
        return lambda: copy_chain.copy_step(*pair,
                                            out=other if out else None)

    def k1(pair, ids, grads):
        return lambda: sparse_apply.sorted_block_apply(
            pair, ids, grads, rule, scalars=scalars)

    def copy_then_k1(pairs, src: int, ids, grads):
        moved, update = copy(pairs, src, True), k1(pairs[1 - src], ids,
                                                    grads)

        def step():
            moved()
            update()
        return step

    pairs = fresh()
    out = {"copy/alias": step_us(copy(pairs, 0, False), device,
                                 shape.steps)}
    out["copy/noalias"] = step_us(
        cycle([copy(pairs, 0, True), copy(pairs, 1, True)]), device,
        shape.steps)
    pairs = fresh()
    out["kernel/alias"] = step_us(
        cycle([k1(pairs[0], ids, grads) for ids, grads in steps]), device,
        shape.steps)
    pairs = fresh()
    out["kernel/noalias"] = step_us(
        cycle([copy_then_k1(pairs, i % 2, ids, grads)
               for i, (ids, grads) in enumerate(steps)]), device,
        shape.steps)
    return out


def card() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bf16-table", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("alias_probe: FAILED: CUDA is not available; "
                         "this probe measures an NVIDIA GPU")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cuda_build.build(("copy_chain", "sparse_apply"))
    shape = Shape()
    dtype = torch.bfloat16 if args.bf16_table else torch.float32
    floor = floor_us(shape.rows, shape.dim, dtype)
    print(card())
    print(f"table={str(dtype).removeprefix('torch.')} traffic="
          f"{traffic_bytes(shape.rows, shape.dim, dtype) / 2**20:.0f} MiB "
          f"floor={floor:.1f} us at {smoke().HBM_BYTES_PER_S / 1e12} TB/s "
          f"(V={shape.rows} D={shape.dim} N={shape.ids}, chains of "
          f"{shape.steps} steps)", flush=True)
    for name, us in measurements(device, dtype, shape).items():
        print(f"  {name}: {us:.1f} us/step ({us / floor:.2f}x floor)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
