"""Weights and state carried between the JAX package and the port.

`load_flax_params` takes the flax `params` of a `TwoTowerRetrieval` as a
nested dict of NumPy arrays (e.g. `jax.tree.map(np.asarray, params)`) and
copies them into the port's module; `to_flax_params` is the inverse. The
names map as:

    _query / _candidate           ↔ query_tower / candidate_tower
    Embed_0/embedding             ↔ embedding.weight
    MLP_0/Dense_i/kernel [in,out] ↔ mlp.layers.i.weight [out,in] (transposed)
    MLP_0/Dense_i/bias            ↔ mlp.layers.i.bias

Any missing or extra key raises, as does a shape that does not match.

`engine_state_from_logical` takes the JAX engine's `logical_state(...)`
as nested NumPy dicts (e.g. `jax.tree.map(np.asarray, logical)`) and
builds the port engine's `EngineState`; `engine_state_to_logical` is the
inverse. bf16 arrays cross as bits: a NumPy array whose dtype is named
"bfloat16" (ml_dtypes' type, which `torch.from_numpy` refuses) is viewed
as uint16 and reinterpreted as `torch.bfloat16`; the way back gives the
uint16 bits (view them as a NumPy bf16 dtype to hand them to JAX).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_TOWERS = {"_query": "query_tower", "_candidate": "candidate_tower"}
_TOWERS_INV = {v: k for k, v in _TOWERS.items()}

Path = Tuple[str, ...]


def tensor_from_numpy(array) -> torch.Tensor:
    """A torch tensor of `array`'s values, bf16 arrays moved as bits."""
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(array).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(array))


def tensor_to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """NumPy values of `tensor`; bf16 comes out as its uint16 bits."""
    tensor = tensor.detach().cpu()
    if tensor.dtype == torch.bfloat16:
        return tensor.contiguous().view(torch.int16).numpy().view(np.uint16)
    return tensor.numpy().copy()


def _flax_to_torch(path: Path) -> Tuple[str, bool]:
    """Flax param path → (torch state-dict name, transpose?)."""
    if len(path) >= 2 and path[0] in _TOWERS:
        tower, rest = _TOWERS[path[0]], path[1:]
        if rest == ("Embed_0", "embedding"):
            return f"{tower}.embedding.weight", False
        if len(rest) == 3 and rest[0] == "MLP_0":
            m = re.fullmatch(r"Dense_(\d+)", rest[1])
            if m and rest[2] in ("kernel", "bias"):
                leaf = "weight" if rest[2] == "kernel" else "bias"
                return (
                    f"{tower}.mlp.layers.{m.group(1)}.{leaf}",
                    rest[2] == "kernel",
                )
    raise KeyError("/".join(path))


def _torch_to_flax(name: str) -> Tuple[Path, bool]:
    """Torch state-dict name → (flax param path, transpose?)."""
    tower, _, rest = name.partition(".")
    if tower in _TOWERS_INV:
        tower = _TOWERS_INV[tower]
        if rest == "embedding.weight":
            return (tower, "Embed_0", "embedding"), False
        m = re.fullmatch(r"mlp\.layers\.(\d+)\.(weight|bias)", rest)
        if m:
            leaf = "kernel" if m.group(2) == "weight" else "bias"
            return (tower, "MLP_0", f"Dense_{m.group(1)}", leaf), (
                leaf == "kernel"
            )
    raise KeyError(name)


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


@torch.no_grad()
def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copies flax `TwoTowerRetrieval` params into the port's model."""
    state = dict(model.named_parameters())
    mapped, extra = {}, []
    for path, array in _flatten(params).items():
        try:
            name, transpose = _flax_to_torch(path)
        except KeyError:
            extra.append("/".join(path))
            continue
        if name not in state:
            extra.append("/".join(path))
            continue
        mapped[name] = array.T if transpose else array
    missing = sorted(set(state) - set(mapped))
    if missing or extra:
        raise ValueError(
            f"flax params do not match the model: missing {missing}, "
            f"extra {sorted(extra)}"
        )
    for name, array in mapped.items():
        param = state[name]
        if tuple(array.shape) != tuple(param.shape):
            raise ValueError(
                f"{name}: flax shape {array.shape} (as torch) != "
                f"{tuple(param.shape)}"
            )
        param.copy_(torch.from_numpy(np.array(array)))
    return model


def to_flax_params(model: nn.Module) -> Dict:
    """The model's weights as a nested flax `params` dict of NumPy arrays."""
    tree: Dict = {}
    for name, param in model.named_parameters():
        path, transpose = _torch_to_flax(name)
        array = param.detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = array.T.copy() if transpose else array.copy()
    return tree


def engine_state_from_logical(engine, logical: Mapping):
    """The port engine's `EngineState` from the JAX engine's
    `logical_state` (nested dicts of NumPy arrays): tables, slots and the
    step, on the engine's device."""
    return engine.state_from_logical({
        "tables": {k: tensor_from_numpy(v)
                   for k, v in logical["tables"].items()},
        "slots": {
            name: {k: tensor_from_numpy(v) for k, v in planes.items()}
            for name, planes in logical["slots"].items()
        },
        "step": int(np.asarray(logical["step"])),
    })


def engine_state_to_logical(engine, state) -> Dict:
    """The port engine's state in the JAX engine's `logical_state` form,
    as NumPy arrays (bf16 planes as uint16 bits)."""
    logical = engine.logical_state(state)
    return {
        "tables": {k: tensor_to_numpy(v)
                   for k, v in logical["tables"].items()},
        "slots": {
            name: {k: tensor_to_numpy(v)
                   for k, v in planes.items()}
            for name, planes in logical["slots"].items()
        },
        "step": np.int32(logical["step"]),
    }
