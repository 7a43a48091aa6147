"""Row-sparse optimizer updates over id-sorted gradients (kernel K1).

Port of `recommenders_tpu/ops/sparse_apply.py`. An embedding table's
sparse update arrives as `[n]` row ids, sorted ascending, and `[n, D]`
gradients. For every touched row the update sums the row's gradients
(duplicates included), counts them, and applies one optimizer rule to
the row of every state array (the table, then its slot planes), writing
bf16 planes back with stochastic rounding when a seed is given. Rows
that no id touches are never read or written.

`sorted_block_apply` is the wrapper of the hand-written CUDA kernel
`csrc/sparse_apply.cu`. For states on the CPU it runs the kernel's plain
PyTorch twin `sorted_block_apply_reference`; for CUDA states it launches
the kernel or raises. Its `launches` attribute counts the launches. Both
update the states IN PLACE and return them.

The TPU kernel streamed whole blocks of rows and routed gradients through
a one-hot matrix product with a bf16 hi/lo split; those were TPU layout
choices. Here the duplicate sums are exact f32 sums in sorted order, so
`exact_routing` is accepted and has no effect.

Stochastic rounding draws its bits from `counter_random_u32`'s hash at
position `row · D + col` (D the table's width, for every plane) and
stream = the state's index: the bits of the JAX package's reference twin
(`sparse_apply.py:676-692`), never the TPU's hardware generator. The
unsigned 32-bit arithmetic is done in int64 and masked to 32 bits after
every step.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops.hashing import M32 as _M32
from recommenders_tpu_torch.ops.hashing import mul32 as _mul32
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor
# `(states [S][R, w] f32, summed grads [R, D] f32, count [R, 1] f32,
# scalars tuple) -> new states`: elementwise over rows, and the identity
# for rows with count == 0.
RuleFn = Callable[..., Sequence[Tensor]]

# The kernel's rule kinds (`csrc/sparse_apply.cu`, enum Kind).
KIND_IDS = {"sgd": 0, "adagrad": 1, "rowwise_adagrad": 2, "adam": 3,
            "ftrl": 4}
# Rows of D the kernel takes: each lane of a warp owns up to 8 columns.
_MAX_DIM = 256


@dataclasses.dataclass(frozen=True)
class BlockRule:
    """One optimizer rule, in the two forms the two paths run.

    Attributes:
      fn: The rule as a torch function (the twin runs it).
      kind: Its name in `KIND_IDS` (the kernel runs that rule), or None
        for a rule the kernel does not have; such a rule runs only on the
        CPU.
      consts: Up to five f32 constants of the rule, as the kernel reads
        them (adam: β₁, 1−β₁, β₂, 1−β₂, ε; ftrl: −lr_power, l1, 2·l2).
      num_slots: The slot planes the rule reads after the table.
    """

    fn: RuleFn
    kind: Optional[str] = None
    consts: Tuple[float, ...] = ()
    num_slots: int = 0

    def __call__(self, *args):
        return self.fn(*args)


def _u32(value: Union[int, Tensor]) -> Union[int, Tensor]:
    """An int32 (or any integer) as the uint32 with the same low bits."""
    return value & _M32


def hash_u32(pos: Tensor, seed: Union[int, Tensor],
             stream: Union[int, Tensor]) -> Tensor:
    """The murmur3-finalizer counter hash of `counter_random_u32`.

    `pos` is an integer tensor of positions (wrapped to 32 bits); `seed`
    and `stream` are int32 values, reinterpreted as uint32. Returns the
    uint32 bits as int64 values in `[0, 2³²)`.
    """
    x = _mul32(_u32(pos.to(torch.int64)), 0x9E3779B9)
    key = (_mul32(torch.as_tensor(_u32(seed), dtype=torch.int64), 0x85EBCA6B)
           + _mul32(torch.as_tensor(_u32(stream), dtype=torch.int64),
                    0xC2B2AE35)) & _M32
    x = x ^ key.to(x.device)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_random_u32(
    seed: Union[int, Tensor], stream: Union[int, Tensor],
    shape: Tuple[int, int], device: device_lib.DeviceLike = "cuda",
) -> Tensor:
    """Stateless counter-based random bits for a `[r, c]` block.

    Port of `sparse_apply.py:76`: position `i · c + j` hashed with the
    seed and stream. Returns uint32 values in an int64 tensor on
    `device`.
    """
    device = device_lib.resolve(device)
    r, c = shape
    rows = torch.arange(r, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(c, dtype=torch.int64, device=device)[None, :]
    return hash_u32(rows * c + cols, seed, stream)


def stochastic_round_bf16(x: Tensor, random_u32: Tensor) -> Tensor:
    """f32 → bf16 with probabilistic rounding (unbiased: E[out] = x).

    Adds 16 random bits below the bf16 mantissa boundary and truncates
    (`sparse_apply.py:109`). `random_u32` holds uint32 values (int64).
    """
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = _u32(u)
    u = (u + (random_u32 & 0xFFFF)) & _M32
    u = u & 0xFFFF0000
    u = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
    # The low 16 bits are zero, so the cast to bf16 is exact.
    return u.view(torch.float32).to(torch.bfloat16)


def sorted_segment_sum(
    values: Tensor, segment: Tensor, num_segments: int
) -> Tensor:
    """Sums rows of `values` into `num_segments` rows, each segment in
    order of appearance, starting from zero: `((0 + v₀) + v₁) + …`.

    `segment` is non-decreasing; entries outside `[0, num_segments)` are
    dropped. The order is the one a sequential scatter-add takes, on any
    device (one `index_add_` per rank within a segment, each with unique
    indices).
    """
    n = segment.shape[0]
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    if n == 0:
        return out
    idx = torch.arange(n, device=segment.device)
    first = torch.ones(n, dtype=torch.bool, device=segment.device)
    first[1:] = segment[1:] != segment[:-1]
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank = idx - start
    keep = (segment >= 0) & (segment < num_segments)
    for k in range(int(rank.max()) + 1):
        sel = keep & (rank == k)
        out.index_add_(0, segment[sel], values[sel])
    return out


def fixed_order_index_add_(out: Tensor, rows: Tensor,
                           values: Tensor) -> Tensor:
    """`out[rows[i]] += values[i]` in place, each row's values added in
    the order they appear, `((out + v₀) + v₁) + …`, the same bits run to
    run and on either device.

    On the CPU that is `index_add_`, which runs serially there
    (`index_put_` with `accumulate=True` adds with parallel atomics on
    the CPU). On the card it is `index_put_` with `accumulate=True`,
    which sorts the rows stably and adds each run in order
    (`index_add_` adds with atomics there, in arrival order).
    """
    values = values.to(out.dtype)
    if out.device.type == "cpu":
        return out.index_add_(0, rows, values)
    return out.index_put_((rows,), values, accumulate=True)


def _check_states(states: Sequence[Tensor], d: int) -> None:
    v = states[0].shape[0]
    for i, st in enumerate(states):
        if st.dim() != 2 or st.shape[0] != v or (
            st.shape[1] not in ((d,) if i == 0 else (1, d))
        ):
            raise ValueError(
                f"State plane shape {tuple(st.shape)} is not supported: "
                f"the table is [{v}, {d}] and every slot plane covers its "
                f"rows with width {d} (full) or 1 (rowwise)."
            )
        if st.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"state dtype {st.dtype}: f32 or bf16 only")


def sorted_block_apply(
    states: Sequence[Tensor],
    sorted_ids: Tensor,
    sorted_grads: Tensor,
    block_update: BlockRule,
    *,
    scalars: Optional[Tensor] = None,
    stochastic_round_seed: Optional[int] = None,
    exact_routing: bool = True,
) -> Tuple[Tensor, ...]:
    """Applies a row-sparse optimizer update to touched rows, in place.

    Args:
      states: The table `[V, D]` first, then slot planes `[V, D]` or
        `[V, 1]`; f32 or bf16. Updated in place.
      sorted_ids: `[n]` integer row ids, ascending; ids outside `[0, V)`
        are padding and sort last.
      sorted_grads: `[n, D]` gradients aligned with the ids.
      block_update: The rule (`BlockRule`); the CUDA path needs its
        `kind`.
      scalars: Optional `[k]` f32 runtime scalars passed to the rule.
      stochastic_round_seed: Optional int32 seed; bf16 planes are then
        written with stochastic rounding, else rounded to nearest.
      exact_routing: Accepted for the JAX package's signature; the sums
        are always exact f32 sums.

    Returns:
      The states (the same tensors, updated).
    """
    del exact_routing
    states = tuple(states)
    d = states[0].shape[1]
    _check_states(states, d)
    if sorted_grads.shape != (sorted_ids.shape[0], d):
        raise ValueError(
            f"grads {tuple(sorted_grads.shape)} do not match "
            f"{sorted_ids.shape[0]} ids of width {d}"
        )
    if states[0].device.type == "cpu":
        return sorted_block_apply_reference(
            states, sorted_ids, sorted_grads, block_update,
            scalars=scalars, stochastic_round_seed=stochastic_round_seed,
        )
    return _launch(states, sorted_ids, sorted_grads, block_update, scalars,
                   stochastic_round_seed)


sorted_block_apply.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib = cuda_build.library("sparse_apply")
    fn = lib.sparse_apply_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.sparse_apply_error_string.argtypes = [ctypes.c_int]
    lib.sparse_apply_error_string.restype = ctypes.c_char_p
    return fn, lib.sparse_apply_error_string


def _launch(
    states: Tuple[Tensor, ...],
    sorted_ids: Tensor,
    sorted_grads: Tensor,
    rule: BlockRule,
    scalars: Optional[Tensor],
    seed: Optional[int],
) -> Tuple[Tensor, ...]:
    """Checks the inputs against what the kernel takes and launches it."""
    device = states[0].device
    if device.type != "cuda":
        raise ValueError(f"states on {device}: the kernel needs CUDA")
    if rule.kind not in KIND_IDS:
        raise ValueError(
            f"rule kind {rule.kind!r} has no CUDA kernel; kinds: "
            f"{tuple(KIND_IDS)}"
        )
    if len(states) != 1 + rule.num_slots:
        raise ValueError(
            f"{rule.kind} takes {rule.num_slots} slot plane(s), got "
            f"{len(states) - 1}"
        )
    v, d = states[0].shape
    if d > _MAX_DIM:
        raise ValueError(f"embedding dim {d} > {_MAX_DIM}, the kernel limit")
    for i, st in enumerate(states[1:], start=1):
        want = 1 if rule.kind == "rowwise_adagrad" else d
        if st.shape[1] != want:
            raise ValueError(
                f"{rule.kind}: slot plane {i} has width {st.shape[1]}, "
                f"the kernel takes {want}"
            )
    if scalars is None:
        raise ValueError("the kernel rules read their lr from `scalars`")
    ids = sorted_ids.to(device=device, dtype=torch.int32).contiguous()
    grads = sorted_grads.to(device=device,
                            dtype=torch.float32).contiguous()
    sc = scalars.to(device=device, dtype=torch.float32).contiguous()
    for t in states:
        if t.device != device:
            raise ValueError(f"state on {t.device}, table on {device}")
        if not t.is_contiguous():
            raise ValueError("sorted_block_apply needs contiguous states")
    if v >= 2**31:
        raise ValueError(f"{v} rows exceed the kernel's int32 ids")
    if ids.shape[0] == 0:       # nothing to update: no launch
        return states
    planes = list(states) + [None] * (3 - len(states))
    bf16_mask = sum(1 << i for i, st in enumerate(states)
                    if st.dtype == torch.bfloat16)
    use_sr = seed is not None and bf16_mask != 0
    consts = tuple(rule.consts) + (0.0,) * (5 - len(rule.consts))
    fn, error_string = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            KIND_IDS[rule.kind], ids.data_ptr(), grads.data_ptr(),
            ids.shape[0], v, d,
            *[cuda_build.ptr(p) for p in planes],
            bf16_mask, sc.data_ptr(), *consts,
            int(use_sr), int(seed or 0) & 0xFFFFFFFF, stream,
        )
    cuda_build.raise_on(err, "sparse_apply", error_string)
    sorted_block_apply.launches += 1
    return states


def sorted_block_apply_reference(
    states: Sequence[Tensor],
    sorted_ids: Tensor,
    sorted_grads: Tensor,
    block_update: Union[BlockRule, RuleFn],
    *,
    scalars: Optional[Tensor] = None,
    stochastic_round_seed: Optional[int] = None,
) -> Tuple[Tensor, ...]:
    """Plain PyTorch twin of the kernel (any device), in place.

    Sums each run of equal ids in f32 in sorted order (`sorted_segment_sum`),
    counts it, gathers the touched rows of every state as f32, applies the
    rule to them (rules are elementwise over rows) and writes them back:
    bf16 planes with stochastic rounding when a seed is given, else
    rounded to nearest. Ids outside `[0, V)` are padding.
    """
    states = tuple(states)
    v, d = states[0].shape
    ids = sorted_ids.to(device=states[0].device, dtype=torch.int64)
    valid = (ids >= 0) & (ids < v)
    ids = ids[valid]
    grads = sorted_grads.to(states[0].device)[valid].to(torch.float32)
    n = ids.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    if n:
        first[1:] = ids[1:] != ids[:-1]
    segment = torch.cumsum(first.to(torch.int64), 0) - 1
    rows = ids[first]
    r = rows.shape[0]
    gsum = sorted_segment_sum(grads, segment, r)
    count = sorted_segment_sum(
        torch.ones(n, 1, dtype=torch.float32, device=ids.device), segment, r
    )
    args = [[st[rows].to(torch.float32) for st in states], gsum, count]
    if scalars is not None:
        sc = scalars.to(device=ids.device, dtype=torch.float32)
        args.append(tuple(sc[k] for k in range(sc.shape[0])))
    new_rows = block_update(*args)
    for i, (st, nr) in enumerate(zip(states, new_rows)):
        if stochastic_round_seed is not None and st.dtype == torch.bfloat16:
            col = torch.arange(nr.shape[1], dtype=torch.int64,
                               device=ids.device)
            bits = hash_u32(rows[:, None] * d + col[None, :],
                            stochastic_round_seed, i)
            nr = stochastic_round_bf16(nr, bits)
        st[rows] = nr.to(st.dtype)
    return states
