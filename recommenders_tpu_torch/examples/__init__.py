"""The JAX package's user examples (`examples/*.py`), ported.

Each module here keeps its JAX example's file name, arguments, defaults
and printed lines, and adds `device` (default `"cuda"`; `"cpu"` only when
asked). Run one on the card, or on the CPU:

    python -m recommenders_tpu_torch.examples.quickstart
    python -m recommenders_tpu_torch.examples.quickstart --device cpu

and all of them with `python -m recommenders_tpu_torch.tools.run_examples`.

The distributed examples (`distributed_retrieval`, `tpu_embedding`,
`sharded_ann_serving`) keep their per-rank body in a module-level `run`
that `main` starts on every rank through `parallel.launch.run_ranks`
(spawn pickles it by reference, so it lives here, importable by name).
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.utils import device as device_lib


def parse_args(argv: Optional[Sequence[str]] = None,
               ranks: bool = False) -> argparse.Namespace:
    """An example's command line: `--device` (default cuda) and, for the
    distributed ones, `--ranks`."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    if ranks:
        parser.add_argument(
            "--ranks", type=int, default=None,
            help="ranks to run (default: one a card on CUDA, 1 on the "
            "CPU); more ranks than cards share them over gloo")
    return parser.parse_args(argv)


def launch(fn: Callable, device, ranks: Optional[int], *args: Any) -> Any:
    """`fn(device, *args)` on `ranks` ranks; returns rank 0's result.

    `ranks` defaults to `torch.cuda.device_count()` on CUDA (one NCCL
    rank a card) and 1 on the CPU. More ranks than cards run on gloo:
    NCCL refuses two ranks on one device."""
    from recommenders_tpu_torch.parallel import launch as launch_lib

    device = device_lib.resolve(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if ranks is None:
        ranks = cards or 1
    backend = "nccl" if 0 < ranks <= cards else "gloo"
    return launch_lib.run_ranks(fn, ranks, backend, device.type, *args)[0]


def embed(num: int, dim: int, device, generator=None) -> nn.Embedding:
    """Flax `nn.Embed`'s counterpart: normal rows of std `dim ** -0.5`."""
    table = nn.Embedding(num, dim, device=device_lib.resolve(device))
    with torch.no_grad():
        table.weight.normal_(0.0, dim ** -0.5, generator=generator)
    return table


def dense(in_features: int, out_features: int, device,
          generator=None) -> nn.Linear:
    """Flax `nn.Dense`'s counterpart: lecun-normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features,
                      device=device_lib.resolve(device))
    blocks.lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


def sequential(in_features: int, units: Sequence[int], device,
               generator=None) -> nn.Sequential:
    """Flax `nn.Sequential([Dense, relu, ..., Dense])`: a relu between
    layers, none after the last (`utils.convert` maps layer i to flax's
    `layers_i`)."""
    layers = []
    for width in units:
        if layers:
            layers.append(nn.ReLU())
        layers.append(dense(in_features, width, device, generator))
        in_features = width
    return nn.Sequential(*layers)


def adagrad(lr: float):
    """`optax.adagrad(lr)`'s counterpart: accumulators from 0.1 and no
    epsilon (optax's 1e-7 under the root moves an update by ≤ 5e-7)."""
    return lambda params: torch.optim.Adagrad(
        params, lr=lr, initial_accumulator_value=0.1, eps=0.0)


def adam(lr: float):
    """`optax.adam(lr)`'s counterpart (optax takes `1 − β^t` in f32, so
    the two part by ~1e-5 relative a step)."""
    return lambda params: torch.optim.Adam(params, lr=lr)


def is_first_rank() -> bool:
    """Whether this process prints: rank 0, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0
