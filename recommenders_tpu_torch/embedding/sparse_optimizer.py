"""Sparse optimizers for embedding tables.

Port of `recommenders_tpu/embedding/sparse_optimizer.py`. Each optimizer
applies a row-sparse update `(table, slots, ids, row_grads) -> (table,
slots)` that touches only the looked-up rows; no vocabulary-sized
gradient is ever built. Two formulations, with the same per-row math:

  - the scatter path (`apply_sparse`), for all six kinds (sgd, adagrad,
    rowwise_adagrad, adam, ftrl, clippy): fold duplicate ids
    (`dedupe_sum`), gather the rows, update, scatter back;
  - the kernel path (`apply_sparse(use_kernel=True)`) for the five
    `KERNEL_KINDS`: sort the ids (stably, so duplicates sum in batch
    order) and hand them to `ops.sparse_apply.sorted_block_apply`, which
    launches the CUDA kernel for CUDA tables and runs its plain twin for
    CPU tables. bf16 state is written with stochastic rounding on this
    path when a seed is given.

Both paths update the table and slot tensors IN PLACE (the JAX package
returns new arrays) and return them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.ops import sparse_apply

Tensor = torch.Tensor
Slots = Dict[str, Tensor]

PAD_ID = config_lib.PAD_ID

# Optimizer kinds the kernel path supports. Clippy needs a global scalar
# (the least clipping factor over every touched row), which a per-row
# rule cannot compute; it stays on the scatter path.
KERNEL_KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam", "ftrl")


def dedupe_sum(
    ids: Tensor, grads: Tensor, max_unique: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """Folds gradients of duplicate ids into one entry each.

    Returns `(ids, grads)` with each unique id once (ascending) and its
    summed gradient, in the gradients' dtype; the remaining slots are
    `PAD_ID` with zero gradients. `PAD_ID` inputs are padding. With
    `max_unique` (< n) the output has that fixed length, and a step with
    more unique ids drops the updates of the largest ids.
    """
    n = ids.shape[0]
    order = torch.sort(ids, stable=True).indices
    sid = ids[order]
    sgrad = grads[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    segment = torch.cumsum(first.to(torch.int64), 0) - 1
    # PAD_ID sorts first and forms segment 0; shift it out so real ids
    # start at slot 0.
    if n and bool(sid[0] == PAD_ID):
        segment = segment - 1
    m = n if max_unique is None or max_unique >= n else max_unique
    summed = sparse_apply.sorted_segment_sum(sgrad, segment, m)
    out_ids = torch.full((m,), PAD_ID, dtype=ids.dtype, device=ids.device)
    kept = first & (segment >= 0) & (segment < m)
    out_ids[segment[kept]] = sid[kept]
    out_grads = torch.where((out_ids != PAD_ID)[:, None], summed,
                            torch.zeros((), dtype=summed.dtype,
                                        device=summed.device))
    return out_ids, out_grads


def _unique_ids(ids: Tensor, num_rows: int) -> Tensor:
    """Maps PAD slots to distinct out-of-range rows (`num_rows + slot`)."""
    slot = torch.arange(ids.shape[0], dtype=ids.dtype, device=ids.device)
    return torch.where(ids == PAD_ID, num_rows + slot, ids)


def init_slots(
    spec: config_lib.OptimizerSpec, table: Tensor, dtype=None
) -> Slots:
    """Creates the slot tensors for one table, on the table's device.

    `dtype` defaults to f32 whatever the table's dtype: accumulators sum
    many small increments, which bf16 round-to-nearest drops. Pass
    `torch.bfloat16` with stochastic rounding to halve slot memory.
    """
    dtype = torch.float32 if dtype is None else dtype

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=table.device)

    shape = tuple(table.shape)
    if spec.kind == "sgd":
        return {}
    if spec.kind == "adagrad":
        return {"accumulator": full(shape, spec.initial_accumulator_value)}
    if spec.kind == "rowwise_adagrad":
        # One accumulator scalar per row.
        return {"accumulator": full((shape[0], 1),
                                    spec.initial_accumulator_value)}
    if spec.kind == "adam":
        return {"m": full(shape, 0.0), "v": full(shape, 0.0)}
    if spec.kind == "ftrl":
        return {"accumulator": full(shape, spec.initial_accumulator_value),
                "linear": full(shape, 0.0)}
    if spec.kind == "clippy":
        return {"accumulator": full(shape, spec.initial_accumulator_value),
                "clipping_factor": full((), 1.0)}
    raise ValueError(f"Unknown optimizer kind {spec.kind!r}")


def _lr_tensor(spec: config_lib.OptimizerSpec, step: int) -> Tensor:
    """The learning rate at `step` as an f32 scalar (`jnp.asarray(lr,
    f32)`); a schedule gets the step as an int32 scalar tensor."""
    lr = spec.lr_at(torch.tensor(step, dtype=torch.int32))
    return torch.as_tensor(lr, dtype=torch.float32).reshape(())


def _sqrt(x: Tensor) -> Tensor:
    """sqrt(x) rounded once, as the kernel's `__fsqrt_rn`, on any device.

    PyTorch's CPU sqrt is not correctly rounded (on AVX-512 hosts f32
    results are an ulp off for ~0.6 % of inputs, and its float64 sqrt
    varies from call to call). So an f32 root is moved to whichever
    neighbour the exact root is nearest: the midpoints between
    neighbours have 25 significant bits, so their squares and the
    comparisons are exact in float64. A bf16 root from the f32 one is
    already correct (its midpoints lie far from any root of a bf16)."""
    s = torch.sqrt(x)
    if s.dtype != torch.float32:
        return s
    xd = x.double()
    for _ in range(2):   # each pass moves an estimate one ulp
        up = torch.nextafter(s, torch.full_like(s, float("inf")))
        down = torch.nextafter(s, torch.zeros_like(s))
        hi = (s.double() + up.double()) * 0.5
        lo = (s.double() + down.double()) * 0.5
        s = torch.where(xd > hi * hi, up,
                        torch.where(xd < lo * lo, down, s))
    return s


def _rsqrt(x: Tensor) -> Tensor:
    # 1/sqrt(x): two IEEE roundings, the same on the CPU and on the card
    # (torch.rsqrt is an approximation on both).
    return 1.0 / _sqrt(x)


def _kernel_rule(spec: config_lib.OptimizerSpec, step: int):
    """`(slot_names, scalars, rule, needs_count)` for the kernel path.

    Each rule reproduces the scatter path's per-row math, with runtime
    scalars (lr at this step, Adam's bias corrections) in an `[k]` f32
    tensor. Rules are identities for rows with `count == 0`; adam and
    ftrl mask with `count > 0`.
    """
    lr = _lr_tensor(spec, step)

    if spec.kind == "sgd":

        def sgd(states, g, count, sc):
            (table,) = states
            return [table - sc[0] * g]

        return (), lr.reshape(1), sparse_apply.BlockRule(sgd, "sgd"), False

    if spec.kind == "adagrad":

        def adagrad(states, g, count, sc):
            table, accum = states
            new_accum = accum + torch.square(g)
            scale = _rsqrt(new_accum + 1e-12)
            return [table - sc[0] * g * scale, new_accum]

        return (("accumulator",), lr.reshape(1),
                sparse_apply.BlockRule(adagrad, "adagrad", num_slots=1), False)

    if spec.kind == "rowwise_adagrad":

        def rowwise(states, g, count, sc):
            table, accum = states           # accum: [R, 1]
            new_accum = accum + torch.mean(torch.square(g), dim=1,
                                           keepdim=True)
            scale = _rsqrt(new_accum + 1e-12)
            return [table - sc[0] * g * scale, new_accum]

        return (("accumulator",), lr.reshape(1),
                sparse_apply.BlockRule(rowwise, "rowwise_adagrad",
                                       num_slots=1), False)

    if spec.kind == "adam":
        t = torch.tensor(step, dtype=torch.float32) + 1.0
        scalars = torch.stack(
            [lr, 1.0 - spec.beta1 ** t, 1.0 - spec.beta2 ** t]
        )

        def adam(states, g, count, sc, spec=spec):
            table, m, v = states
            lr_t, bc1, bc2 = sc
            touched = count > 0
            m_rows = spec.beta1 * m + (1 - spec.beta1) * g
            v_rows = spec.beta2 * v + (1 - spec.beta2) * torch.square(g)
            delta = -lr_t * (m_rows / bc1) / (
                _sqrt(v_rows / bc2) + spec.epsilon
            )
            return [
                table + torch.where(touched, delta, 0.0),
                torch.where(touched, m_rows, m),
                torch.where(touched, v_rows, v),
            ]

        consts = (spec.beta1, 1 - spec.beta1, spec.beta2, 1 - spec.beta2,
                  spec.epsilon)
        return (("m", "v"), scalars,
                sparse_apply.BlockRule(adam, "adam", consts, num_slots=2),
                True)

    if spec.kind == "ftrl":

        def ftrl(states, g, count, sc, spec=spec):
            table, accum, linear = states
            lr_t = sc[0]
            lrp = spec.learning_rate_power
            l1 = spec.l1_regularization_strength
            l2 = spec.l2_regularization_strength
            touched = count > 0
            n_new = accum + torch.square(g)
            sigma = (torch.pow(n_new, -lrp) - torch.pow(accum, -lrp)) / lr_t
            z_new = linear + g - sigma * table
            denom = torch.pow(n_new, -lrp) / lr_t + 2 * l2
            w_new = torch.where(
                torch.abs(z_new) > l1,
                (torch.sign(z_new) * l1 - z_new) / denom,
                0.0,
            )
            return [
                torch.where(touched, w_new, table),
                torch.where(touched, n_new, accum),
                torch.where(touched, z_new, linear),
            ]

        consts = (-spec.learning_rate_power, spec.l1_regularization_strength,
                  2 * spec.l2_regularization_strength)
        return (("accumulator", "linear"), lr.reshape(1),
                sparse_apply.BlockRule(ftrl, "ftrl", consts, num_slots=2),
                True)

    raise ValueError(f"No kernel rule for optimizer kind {spec.kind!r}")


def _apply_sparse_kernel(
    spec: config_lib.OptimizerSpec,
    table: Tensor,
    slots: Slots,
    ids: Tensor,
    grads: Tensor,
    step: int,
    max_unique: Optional[int],
    sr_seed: Optional[int] = None,
    exact_routing: bool = True,
) -> Tuple[Tensor, Slots]:
    """Kernel-path `apply_sparse`: id mapping, stable sort, K1.

    Ids outside `[0, V)` map to the dropped row V. A stable sort keeps
    duplicates in batch order, so their f32 sums follow it. With
    `max_unique` < n, `dedupe_sum` compacts the list first.
    """
    v = table.shape[0]
    slot_names, scalars, rule, _ = _kernel_rule(spec, step)
    if max_unique is not None and max_unique < ids.shape[0]:
        ids, grads = dedupe_sum(ids, grads, max_unique)
        sorted_ids = torch.where((ids < 0) | (ids >= v), v, ids)
        sorted_grads = grads
    else:
        mapped = torch.where((ids < 0) | (ids >= v), v, ids)
        sorted_ids, order = torch.sort(mapped, stable=True)
        sorted_grads = grads[order]
    states = (table,) + tuple(slots[nm] for nm in slot_names)
    new_states = sparse_apply.sorted_block_apply(
        states,
        sorted_ids.to(torch.int32),
        sorted_grads.to(torch.float32),
        rule,
        scalars=scalars,
        stochastic_round_seed=sr_seed,
        exact_routing=exact_routing,
    )
    new_slots = dict(slots)
    for nm, arr in zip(slot_names, new_states[1:]):
        new_slots[nm] = arr
    return new_states[0], new_slots


def _scaled(lr, x: Tensor) -> Tensor:
    """`lr * x` with JAX's promotion: a float keeps x's dtype, an f32
    scalar array (a schedule's value) promotes bf16 x to f32."""
    if torch.is_tensor(lr):
        return lr.to(x.device) * x.to(torch.promote_types(x.dtype,
                                                           torch.float32))
    return lr * x


def apply_sparse(
    spec: config_lib.OptimizerSpec,
    table: Tensor,
    slots: Slots,
    ids: Tensor,
    grads: Tensor,
    step: int,
    max_unique: Optional[int] = None,
    use_kernel: bool = False,
    sr_seed: Optional[int] = None,
    exact_routing: bool = True,
) -> Tuple[Tensor, Slots]:
    """Applies one sparse update, in place. `ids: [n]`, `grads: [n, dim]`.

    With `use_kernel=True` and a kind in `KERNEL_KINDS` the update runs
    the kernel path (K1 on CUDA, its twin on the CPU); `sr_seed` (an
    int32 unique per step and table) then rounds bf16 state
    stochastically. Otherwise the scatter path folds duplicates first and
    rounds bf16 state to nearest. `max_unique` bounds the unique ids
    updated (see `dedupe_sum`).
    """
    if use_kernel and spec.kind in KERNEL_KINDS:
        return _apply_sparse_kernel(
            spec, table, slots, ids, grads, step, max_unique,
            sr_seed=sr_seed, exact_routing=exact_routing,
        )
    ids, grads = dedupe_sum(ids, grads, max_unique)
    v = table.shape[0]
    uids = _unique_ids(ids, v)
    live = uids < v
    rows = uids[live]
    lr = spec.lr_at(torch.tensor(step, dtype=torch.int32))

    def read(buf, fill=0.0):
        out = torch.full((uids.shape[0],) + tuple(buf.shape[1:]), fill,
                         dtype=buf.dtype, device=buf.device)
        out[live] = buf[rows]
        return out

    def add(buf, upd):
        buf[rows] = buf[rows] + upd[live].to(buf.dtype)
        return buf

    def put(buf, upd):
        buf[rows] = upd[live].to(buf.dtype)
        return buf

    if spec.kind == "sgd":
        return add(table, _scaled(-lr, grads)), slots

    if spec.kind == "adagrad":
        accum = add(slots["accumulator"], torch.square(grads))
        scale = _rsqrt(read(accum, fill=1.0) + 1e-12)
        table = add(table, _scaled(-lr, grads) * scale)
        return table, {"accumulator": accum}

    if spec.kind == "rowwise_adagrad":
        accum = add(slots["accumulator"],
                    torch.mean(torch.square(grads), dim=1, keepdim=True))
        scale = _rsqrt(read(accum, fill=1.0) + 1e-12)
        table = add(table, _scaled(-lr, grads) * scale)
        return table, {"accumulator": accum}

    if spec.kind == "adam":
        # Lazy Adam: moments decay only on touched rows.
        m, v_slot = slots["m"], slots["v"]
        m_rows = spec.beta1 * read(m) + (1 - spec.beta1) * grads
        v_rows = spec.beta2 * read(v_slot) + (1 - spec.beta2) * torch.square(
            grads
        )
        t = torch.tensor(step, dtype=torch.float32) + 1.0
        m_hat = m_rows / (1 - spec.beta1 ** t).to(m_rows.device)
        v_hat = v_rows / (1 - spec.beta2 ** t).to(v_rows.device)
        delta = _scaled(-lr, m_hat) / (_sqrt(v_hat) + spec.epsilon)
        return add(table, delta), {"m": put(m, m_rows),
                                   "v": put(v_slot, v_rows)}

    if spec.kind == "clippy":
        # Sparse ClippyAdagrad; padding slots have delta == 0, whose
        # per-element scale is 1, so they never tighten the clip.
        accum = slots["accumulator"]
        if spec.use_standard_accumulator_update:
            accum = add(accum, torch.square(grads))
        w = read(table)
        a = read(accum, fill=1.0)
        precondition = 1.0 / _sqrt(a + spec.epsilon)
        delta = _scaled(lr, grads) * precondition
        max_delta = (
            spec.absolute_threshold
            + torch.abs(w) * spec.variable_relative_threshold
            + precondition * spec.accumulator_relative_threshold
        )
        abs_delta = torch.abs(delta)
        per_element = torch.where(
            delta == 0.0,
            1.0,
            torch.where(abs_delta > 0.0, max_delta / abs_delta, 1.0),
        )
        factor = torch.clamp(torch.min(per_element), max=1.0)
        if not spec.use_standard_accumulator_update:
            acc_update = grads * factor if spec.clip_accumulator_update \
                else grads
            accum = add(accum, torch.square(acc_update))
        table = add(table, -delta * factor)
        clip = slots["clipping_factor"]
        clip.copy_(factor.to(clip.dtype))
        return table, {"accumulator": accum, "clipping_factor": clip}

    if spec.kind == "ftrl":
        accum, linear = slots["accumulator"], slots["linear"]
        lrp = spec.learning_rate_power
        l1 = spec.l1_regularization_strength
        l2 = spec.l2_regularization_strength
        w = read(table)
        n_old = read(accum, fill=1.0)
        n_new = n_old + torch.square(grads)
        lr_t = torch.as_tensor(lr, dtype=torch.float32).to(n_new.device)
        sigma = (torch.pow(n_new, -lrp) - torch.pow(n_old, -lrp)) / lr_t
        z_new = read(linear) + grads - sigma * w
        denom = torch.pow(n_new, -lrp) / lr_t + 2 * l2
        w_new = torch.where(
            torch.abs(z_new) > l1,
            (torch.sign(z_new) * l1 - z_new) / denom,
            0.0,
        )
        return (
            put(table, w_new),
            {"accumulator": put(accum, n_new), "linear": put(linear, z_new)},
        )

    raise ValueError(f"Unknown optimizer kind {spec.kind!r}")
