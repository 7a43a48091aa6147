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

`scann_state_from_numpy` loads a built JAX `ScaNN` index's arrays (e.g.
`{name: np.asarray(getattr(index, name)) for name in SCANN_ARRAYS}`)
into a port `ScaNN` configured the same way, so both packages query the
same leaves; `scann_state_to_numpy` is the inverse.
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


# A ScaNN index's state: arrays (None where the configuration keeps none)
# and the corpus size.
SCANN_ARRAYS = (
    "_centroids", "_leaf_embs", "_leaf_scales", "_leaf_ids", "_leaf_rows",
    "_leaf_valid", "_corpus", "_identifiers", "_flat_ids",
)


def scann_state_from_numpy(index, arrays: Mapping):
    """Loads a built ScaNN state into the port `index`, on its device.

    `arrays` maps every name of `SCANN_ARRAYS` to a NumPy array or None,
    plus `_num_candidates`. bf16 arrays may come as ml_dtypes bf16 or as
    uint16 bits together with `index`'s dtypes (`leaf_dtype`,
    `reorder_dtype`). A missing key, or an array whose shape does not fit
    the others', raises.
    """
    missing = [k for k in SCANN_ARRAYS + ("_num_candidates",)
               if k not in arrays]
    if missing:
        raise ValueError(f"ScaNN state lacks {missing}")
    n = int(np.asarray(arrays["_num_candidates"]))
    rows = np.asarray(arrays["_leaf_rows"])
    centroids = np.asarray(arrays["_centroids"])
    if rows.ndim != 2 or centroids.ndim != 2:
        raise ValueError(
            f"_leaf_rows {rows.shape} and _centroids {centroids.shape} must "
            "be 2-D")
    num_leaves, cap = rows.shape
    d = centroids.shape[1]
    packed4 = index._quantize == "int4"
    want = {
        "_centroids": (num_leaves, d),
        "_leaf_embs": (num_leaves, cap // 2 if packed4 else cap, d),
        "_leaf_scales": (num_leaves, cap),
        "_leaf_ids": (num_leaves, cap),
        "_leaf_rows": (num_leaves, cap),
        "_leaf_valid": (num_leaves, cap),
        "_corpus": (n, d),
        "_identifiers": (n,),
        "_flat_ids": (n,),
    }
    bf16_views = {"_leaf_embs": index._leaf_dtype,
                  "_corpus": index._reorder_dtype}
    loaded = {}
    for name, shape in want.items():
        array = arrays[name]
        if array is None:
            if name in ("_centroids", "_leaf_embs", "_leaf_ids",
                        "_leaf_rows", "_leaf_valid"):
                raise ValueError(f"ScaNN state {name} is None")
            loaded[name] = None
            continue
        array = np.asarray(array)
        if tuple(array.shape) != shape:
            raise ValueError(
                f"ScaNN state {name} has shape {array.shape}, expected "
                f"{shape}")
        tensor = tensor_from_numpy(array)
        if (array.dtype == np.uint16
                and bf16_views.get(name) == torch.bfloat16):
            tensor = tensor.view(torch.bfloat16)
        loaded[name] = tensor.to(index.device)
    if (loaded["_leaf_scales"] is None) != (not index._quantize):
        raise ValueError(
            "ScaNN state's _leaf_scales does not match quantize="
            f"{index._quantize!r}")
    for name, tensor in loaded.items():
        setattr(index, name, tensor)
    index._num_candidates = n
    index._built = True
    return index


def scann_state_to_numpy(index) -> Dict:
    """The port index's state as NumPy arrays (bf16 as uint16 bits), in
    the form `scann_state_from_numpy` takes."""
    out = {name: (None if getattr(index, name) is None
                  else tensor_to_numpy(getattr(index, name)))
           for name in SCANN_ARRAYS}
    out["_num_candidates"] = int(index._num_candidates)
    return out
