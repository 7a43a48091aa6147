"""Weights and state carried between the JAX package and the port.

`load_flax_params` takes the flax `params` of a `TwoTowerRetrieval`, a
`Ranking` or a `Multitask` (or of one of their parts: a tower, an `MLP`,
an interaction, a `TpuEmbedding` / `PartialEmbedding` /
`UnifiedEmbedding`) as a nested dict
of NumPy arrays (e.g. `jax.tree.map(np.asarray, params)`, with
`nn.meta.unbox` applied to a sharded embedding's `Partitioned` boxes)
and copies them into the port's module; `to_flax_params` is the
inverse. The names map as (kernels `[in, out]` transposed to
`nn.Linear`'s `[out, in]`):

    _query / _candidate            ↔ query_tower / candidate_tower
    _rating (Multitask)            ↔ rating_head
    embedding/{sharded_embedding,dense_embedding}/<table> (Ranking)
                                   ↔ embedding.<partition>.<table>
                                     (padded rows)
    shared_tables/<table> (UnifiedEmbedding)
                                   ↔ shared_tables.<table>
    _bottom / _top (Ranking)       ↔ bottom / top
    _interaction/{dense | dense_u, dense_v}      (Cross)
                / {dense_u_i, dense_v_i}         (MultiLayerDCN)
                                   ↔ interaction.{dense | dense_u,
                                     dense_v | dense_u.i, dense_v.i}
    (MLP_0/)Dense_i/{kernel,bias}  ↔ (mlp.)layers.i.{weight,bias}
    Embed_0/embedding              ↔ embedding.weight
    GRUEncoder_0/Scan_Step_0/GRUCell_0/
      i{r,z,n}/{kernel,bias}       ↔ encoder.cell.{weight,bias}_ih rows
                                     of gate r, z, n (torch's order)
      h{r,z,n}/kernel, hn/bias     ↔ encoder.cell.weight_hh rows, and
                                     bias_hh's n rows (its r, z rows,
                                     which flax lacks, are zero)
    SelfAttentionEncoder_0/
      LayerNorm_i/{scale,bias}     ↔ encoder.layer_norm_i.{weight,bias}
      MultiHeadDotProductAttention_0/
        {query,key,value}/kernel [d, heads, head_dim]
                                   ↔ encoder.attention.{...}.weight
                                     [heads·head_dim, d]
        {query,key,value}/bias [heads, head_dim] ↔ ....bias
        out/kernel [heads, head_dim, d] ↔ encoder.attention.out.weight
      Dense_i                      ↔ encoder.dense_i

Any missing or extra key raises, as does a shape that does not match.

`engine_state_from_logical` takes an engine's `logical_state(...)` as
nested NumPy dicts (the JAX engine's through `jax.tree.map(np.asarray,
logical)`, or `engine_state_to_logical` output) and builds the port
engine's `EngineState` in its layout, stacked or not;
`engine_state_to_logical` is the inverse. bf16 arrays cross as bits: a
NumPy array whose dtype is named "bfloat16" (ml_dtypes' type, which
`torch.from_numpy` refuses) is viewed as uint16 and reinterpreted as
`torch.bfloat16`; the way back gives the uint16 bits (view them as a
NumPy bf16 dtype to hand them to JAX), which the way in also takes for a
bf16 engine.

`scann_state_from_numpy` loads a built JAX `ScaNN` index's arrays (e.g.
`{name: np.asarray(getattr(index, name)) for name in SCANN_ARRAYS}`)
into a port `ScaNN` configured the same way, so both packages query the
same leaves; `scann_state_to_numpy` is the inverse.

Sharded state crosses in its logical (unsharded) form and each rank keeps
its shard: `engine_state_from_logical` on a meshed engine keeps this
rank's rows; `sharded_scann_from_numpy` loads one-device ScaNN arrays
and shards the leaves; `sharded_bucketed_from_numpy` takes a JAX
`ShardedBucketed`'s stacked `[S, rows, ...]` arrays (`_candidates`,
`_scales`, `_valid`) and keeps this rank's row of them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

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


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One flax leaf ↔ rows of one torch parameter.

    `path` None marks rows flax does not have (held at zero)."""

    path: Optional[Path]
    name: str
    rows: Optional[slice] = None
    to_torch: Callable[[np.ndarray], np.ndarray] = _same
    to_flax: Callable[[np.ndarray], np.ndarray] = _same


def _linear(path: Path, name: str, bias: bool = True) -> Iterator[_Leaf]:
    """A flax `Dense` ↔ an `nn.Linear`."""
    yield _Leaf(path + ("kernel",), f"{name}.weight", None, _transpose,
                _transpose)
    if bias:
        yield _Leaf(path + ("bias",), f"{name}.bias")


def _prefix(name: str) -> str:
    return f"{name}." if name else ""


def _mlp(mlp, path: Path, name: str) -> Iterator[_Leaf]:
    """`blocks.MLP` ↔ flax `MLP` (`Dense_i` under `path`)."""
    for i, layer in enumerate(mlp.layers):
        yield from _linear(path + (f"Dense_{i}",), f"{_prefix(name)}layers.{i}",
                           layer.bias is not None)


def _interaction(module, path: Path, name: str) -> Iterator[_Leaf]:
    """`Cross` (`dense`, or `dense_u` / `dense_v`), `MultiLayerDCN`
    (`dense_u_i` / `dense_v_i` ↔ `dense_u.i` / `dense_v.i`) or
    `DotInteraction` (no leaves)."""
    from recommenders_tpu_torch.layers.feature_interaction import dcn
    from recommenders_tpu_torch.layers.feature_interaction import (
        dot_interaction,
    )

    pre = _prefix(name)
    if isinstance(module, dcn.Cross):
        if module.projection_dim is None:
            yield from _linear(path + ("dense",), f"{pre}dense",
                               module.dense.bias is not None)
        else:
            yield from _linear(path + ("dense_u",), f"{pre}dense_u", False)
            yield from _linear(path + ("dense_v",), f"{pre}dense_v",
                               module.dense_v.bias is not None)
    elif isinstance(module, dcn.MultiLayerDCN):
        for i, (u, v) in enumerate(zip(module.dense_u, module.dense_v)):
            yield from _linear(path + (f"dense_u_{i}",), f"{pre}dense_u.{i}",
                               False)
            yield from _linear(path + (f"dense_v_{i}",), f"{pre}dense_v.{i}",
                               v.bias is not None)
    elif not isinstance(module, dot_interaction.DotInteraction):
        raise TypeError(f"no flax layout for {type(module).__name__}")


def _gru(path: Path, name: str, units: int) -> Iterator[_Leaf]:
    """Flax `GRUCell` ↔ `nn.GRUCell` (gates r, z, n in torch's rows)."""
    for g, gate in enumerate("rzn"):
        rows = slice(g * units, (g + 1) * units)
        yield _Leaf(path + (f"i{gate}", "kernel"), f"{name}.weight_ih",
                    rows, _transpose, _transpose)
        yield _Leaf(path + (f"i{gate}", "bias"), f"{name}.bias_ih", rows)
        yield _Leaf(path + (f"h{gate}", "kernel"), f"{name}.weight_hh",
                    rows, _transpose, _transpose)
        yield _Leaf(path + ("hn", "bias") if gate == "n" else None,
                    f"{name}.bias_hh", rows)


def _attention(path: Path, name: str, heads: int,
               dim: int) -> Iterator[_Leaf]:
    """Flax `MultiHeadDotProductAttention` ↔ four `nn.Linear`s."""
    head_dim = dim // heads
    for proj in ("query", "key", "value"):
        yield _Leaf(path + (proj, "kernel"), f"{name}.{proj}.weight", None,
                    lambda a: a.reshape(a.shape[0], -1).T,
                    lambda w: w.T.reshape(dim, heads, head_dim))
        yield _Leaf(path + (proj, "bias"), f"{name}.{proj}.bias", None,
                    lambda a: a.reshape(-1),
                    lambda b: b.reshape(heads, head_dim))
    yield _Leaf(path + ("out", "kernel"), f"{name}.out.weight", None,
                lambda a: a.reshape(-1, a.shape[-1]).T,
                lambda w: w.T.reshape(heads, head_dim, dim))
    yield _Leaf(path + ("out", "bias"), f"{name}.out.bias")


def _leaves(model: nn.Module, path: Path = (),
            name: str = "") -> Iterator[_Leaf]:
    """Every parameter of `model` as flax leaves, for the port's
    retrieval, ranking and multitask models, their towers, MLPs,
    interactions and embedding collections."""
    from recommenders_tpu_torch.embedding import embedding as embedding_lib
    from recommenders_tpu_torch.embedding import partial
    from recommenders_tpu_torch.embedding import unified
    from recommenders_tpu_torch.layers import blocks
    from recommenders_tpu_torch.layers import sequential
    from recommenders_tpu_torch.models import multitask
    from recommenders_tpu_torch.models import ranking
    from recommenders_tpu_torch.models import retrieval

    if isinstance(model, retrieval.TwoTowerRetrieval):
        yield from _leaves(model.query_tower, ("_query",), "query_tower.")
        yield from _leaves(model.candidate_tower, ("_candidate",),
                           "candidate_tower.")
        return
    if isinstance(model, multitask.Multitask):
        yield from _leaves(model.query_tower, ("_query",), "query_tower.")
        yield from _leaves(model.candidate_tower, ("_candidate",),
                           "candidate_tower.")
        yield from _leaves(model.rating_head, ("_rating",), "rating_head")
        return
    if isinstance(model, ranking.Ranking):
        yield from _leaves(model.embedding, ("embedding",), "embedding")
        yield from _leaves(model.bottom, ("_bottom",), "bottom")
        yield from _leaves(model.interaction, ("_interaction",),
                           "interaction")
        yield from _leaves(model.top, ("_top",), "top")
        return
    if isinstance(model, partial.PartialEmbedding):
        for part in ("sharded_embedding", "dense_embedding"):
            if hasattr(model, part):
                yield from _leaves(getattr(model, part), path + (part,),
                                   f"{_prefix(name)}{part}")
        return
    if isinstance(model, unified.UnifiedEmbedding):
        yield from _leaves(model.shared_tables, path + ("shared_tables",),
                           f"{_prefix(name)}shared_tables")
        return
    if isinstance(model, embedding_lib.TpuEmbedding):
        for table in model.table_dict():
            yield _Leaf(path + (table,), f"{_prefix(name)}{table}")
        return
    if isinstance(model, blocks.MLP):
        yield from _mlp(model, path, name)
        return
    if not isinstance(model, (retrieval.EmbeddingTower,
                              retrieval.SequenceTower)):
        yield from _interaction(model, path, name)
        return
    yield _Leaf(path + ("Embed_0", "embedding"), f"{name}embedding.weight")
    encoder = getattr(model, "encoder", None)
    if isinstance(encoder, sequential.GRUEncoder):
        yield from _gru(path + ("GRUEncoder_0", "Scan_Step_0", "GRUCell_0"),
                        f"{name}encoder.cell", encoder.units)
    elif isinstance(encoder, sequential.SelfAttentionEncoder):
        enc, ename = path + ("SelfAttentionEncoder_0",), f"{name}encoder"
        for i in (0, 1):
            yield _Leaf(enc + (f"LayerNorm_{i}", "scale"),
                        f"{ename}.layer_norm_{i}.weight")
            yield _Leaf(enc + (f"LayerNorm_{i}", "bias"),
                        f"{ename}.layer_norm_{i}.bias")
        yield from _attention(enc + ("MultiHeadDotProductAttention_0",),
                              f"{ename}.attention", encoder.num_heads,
                              encoder.dim)
        for i in range(3 if encoder.dense_2 is not None else 2):
            yield from _linear(enc + (f"Dense_{i}",), f"{ename}.dense_{i}")
    if model.mlp is not None:
        yield from _mlp(model.mlp, path + ("MLP_0",), f"{name}mlp")


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
    """Copies flax params of a model (or of one of its parts, see the
    module docstring) into the port's module."""
    state = dict(model.named_parameters())
    leaves = list(_leaves(model))
    flat = _flatten(params)
    known = {leaf.path for leaf in leaves if leaf.path is not None}
    extra = sorted("/".join(p) for p in flat if p not in known)
    missing = {leaf.name for leaf in leaves
               if leaf.path is not None and leaf.path not in flat}
    missing |= set(state) - {leaf.name for leaf in leaves}
    if missing or extra:
        raise ValueError(
            f"flax params do not match the model: missing {sorted(missing)}, "
            f"extra {extra}"
        )
    for leaf in leaves:
        target = state[leaf.name]
        if leaf.rows is not None:
            target = target[leaf.rows]
        if leaf.path is None:
            target.zero_()
            continue
        array = leaf.to_torch(flat[leaf.path])
        if tuple(array.shape) != tuple(target.shape):
            raise ValueError(
                f"{leaf.name}: flax shape {flat[leaf.path].shape} (as torch "
                f"{array.shape}) != {tuple(target.shape)}"
            )
        target.copy_(torch.from_numpy(np.array(array)))
    return model


def to_flax_params(model: nn.Module) -> Dict:
    """The model's weights as a nested flax `params` dict of NumPy arrays."""
    state = dict(model.named_parameters())
    tree: Dict = {}
    for leaf in _leaves(model):
        if leaf.path is None:
            continue
        value = state[leaf.name].detach().cpu()
        if leaf.rows is not None:
            value = value[leaf.rows]
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = np.array(leaf.to_flax(value.numpy()))
    return tree


def _engine_plane(array, dtype: torch.dtype) -> torch.Tensor:
    """A state plane for an engine storing `dtype`: uint16 arrays are
    bf16 bits (what `engine_state_to_logical` writes) when it is bf16."""
    tensor = tensor_from_numpy(array)
    if tensor.dtype == torch.uint16 and dtype == torch.bfloat16:
        tensor = tensor.view(torch.bfloat16)
    return tensor


def engine_state_from_logical(engine, logical: Mapping):
    """The port engine's `EngineState` from a `logical_state` as nested
    dicts of NumPy arrays (the JAX engine's, or `engine_state_to_logical`
    output): tables, slots and the step, on the engine's device, in its
    layout (stacked or not). bf16 planes may come as uint16 bits."""
    slot_dtype = engine.slot_dtype or torch.float32
    return engine.state_from_logical({
        "tables": {k: _engine_plane(v, engine.dtype)
                   for k, v in logical["tables"].items()},
        "slots": {
            name: {k: _engine_plane(v, slot_dtype)
                   for k, v in planes.items()}
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


def sharded_scann_from_numpy(index, arrays: Mapping):
    """Loads one-device ScaNN arrays (`scann_state_from_numpy`'s form)
    into a port `parallel.ShardedScaNN`, which keeps this rank's leaves
    and reorder rows. Every rank passes the same arrays."""
    inner = scann_state_from_numpy(index._scann, arrays)
    index._shard_leaves(
        inner._centroids, inner._leaf_embs, inner._leaf_scales,
        inner._leaf_ids, inner._leaf_rows, inner._leaf_valid,
        inner._flat_ids, inner._corpus, inner._num_candidates)
    inner._built = False
    return index


def sharded_bucketed_from_numpy(index, arrays: Mapping):
    """Loads a JAX `ShardedBucketed`'s arrays into a port
    `parallel.ShardedBucketed` over a mesh axis of the same size: this
    rank keeps row `axis_index` of the stacked `_candidates` (int8 codes,
    packed int4 codes, or f32 / bf16 rows; bf16 as uint16 bits),
    `_scales` and `_valid`. `_num_candidates`, `_rows_per_shard` and the
    optional `_identifiers` are replicated."""
    from recommenders_tpu_torch.parallel import mesh as mesh_lib

    cands = np.asarray(arrays["_candidates"])
    s = mesh_lib.axis_size(index._mesh, index._axis)
    if cands.shape[0] != s:
        raise ValueError(
            f"the state has {cands.shape[0]} shards, the index's axis "
            f"{s}")
    i = mesh_lib.axis_index(index._mesh, index._axis)
    block = tensor_from_numpy(cands[i])
    if cands.dtype == np.uint16:
        block = block.view(torch.bfloat16)
    index._candidates = block.to(index.device).contiguous()
    scales = arrays.get("_scales")
    index._scales = (None if scales is None else tensor_from_numpy(
        np.asarray(scales)[i]).to(index.device))
    ids = arrays.get("_identifiers")
    index._identifiers = (None if ids is None else tensor_from_numpy(
        np.asarray(ids)).to(index.device))
    index._num_candidates = int(arrays["_num_candidates"])
    index._rows_per_shard = int(arrays["_rows_per_shard"])
    index._valid_rows = int(np.asarray(arrays["_valid"])[i])
    return index


def scann_state_to_numpy(index) -> Dict:
    """The port index's state as NumPy arrays (bf16 as uint16 bits), in
    the form `scann_state_from_numpy` takes."""
    out = {name: (None if getattr(index, name) is None
                  else tensor_to_numpy(getattr(index, name)))
           for name in SCANN_ARRAYS}
    out["_num_candidates"] = int(index._num_candidates)
    return out
