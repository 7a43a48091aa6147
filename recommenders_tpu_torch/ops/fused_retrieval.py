"""Fused in-batch sampled-softmax retrieval loss (flash-CE, kernel K2).

Port of `recommenders_tpu/ops/fused_retrieval.py`. The loss of
`tasks.Retrieval` for its fused knob set (temperature, log-q correction,
accidental-hit removal, per-query weights, extra negatives C > B) without
the `[B, C]` score matrix: the forward keeps per-row running (max,
sum-exp) and the diagonal logit, and the backward recomputes the score
tiles from the saved log-sum-exp for `dQ` and `dC`.

`fused_retrieval_loss` is the wrapper of the hand-written CUDA kernels
`csrc/fused_retrieval.cu` (forward, dq, dc) behind one
`torch.autograd.Function`. For tensors on the CPU it runs the plain
PyTorch twin `fused_retrieval_loss_reference` (differentiable through
autograd); for CUDA tensors it launches the kernels or raises. The
kernels mask ragged tile edges, so every B, C ≥ B and D ≤ 256 runs on
the kernels (the JAX package falls back to its reference for shapes its
tiles do not divide). With bf16 scores the operands are rounded to bf16
once, in the forward, and the kernels take their products on the tensor
cores, each split over `_parts` pieces of its loop dimension whose
partial results a second small kernel folds in a fixed order. `launches`
counts wrapper launches of a kernel, and `launches_by_kernel` splits
them by kernel and score dtype: keys `("fwd" | "dq" | "dc", "bf16" |
"f32")`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from recommenders_tpu_torch.layers import loss as loss_layers
from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops import scoring

Tensor = torch.Tensor

MIN_FLOAT = loss_layers.MIN_FLOAT

# Widths the kernels take (the f32 path: each thread owns D/16
# accumulator columns; the bf16 path: D padded to 16, at most 32 n-blocks
# of 8 a warp), and the rows of each kernel tile.
_MAX_DIM = 256
_TILE = 64
_BLOCKS_PER_SM = 2


def _check(q: Tensor, c: Tensor, remove_accidental_hits: bool,
           candidate_ids: Optional[Tensor]) -> None:
    if q.dim() != 2 or c.dim() != 2:
        raise ValueError(
            "fused_retrieval_loss expects 2D [B, D] / [C, D] inputs, "
            f"got {tuple(q.shape)} and {tuple(c.shape)}; maxsim queries "
            "use the unfused task."
        )
    if c.shape[0] < q.shape[0] or c.shape[1] != q.shape[1]:
        raise ValueError(
            f"candidates {tuple(c.shape)} must have C >= B rows of the "
            f"queries' width, queries {tuple(q.shape)}"
        )
    if remove_accidental_hits and candidate_ids is None:
        raise ValueError(
            "When accidental hit removal is enabled, candidate ids "
            "must be supplied."
        )


def fused_retrieval_loss(
    query_embeddings: Tensor,
    candidate_embeddings: Tensor,
    sample_weight: Optional[Tensor] = None,
    candidate_sampling_probability: Optional[Tensor] = None,
    candidate_ids: Optional[Tensor] = None,
    *,
    temperature: Optional[float] = None,
    remove_accidental_hits: bool = False,
    score_dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """In-batch sampled-softmax CE loss, summed over the batch.

    Same value and gradients (with respect to the queries and the
    candidates) as `tasks.Retrieval(...)(q, c, ...).loss` for the
    supported knobs.

    Args:
      query_embeddings: `[B, D]` queries.
      candidate_embeddings: `[C, D]` candidates, `C >= B`; row i is the
        positive of query i.
      sample_weight: Optional `[B]` per-query weights.
      candidate_sampling_probability: Optional `[C]` probabilities for
        the log-q correction.
      candidate_ids: `[C]` int ids, required with `remove_accidental_hits`.
      temperature: Optional softmax temperature.
      remove_accidental_hits: Mask negatives sharing the positive's id.
      score_dtype: Optional dtype (`torch.bfloat16`) the products' inputs
        are rounded to; sums are f32.
    """
    q, c = query_embeddings, candidate_embeddings
    _check(q, c, remove_accidental_hits, candidate_ids)
    if q.device.type == "cpu":
        return fused_retrieval_loss_reference(
            q, c, sample_weight, candidate_sampling_probability,
            candidate_ids, temperature=temperature,
            remove_accidental_hits=remove_accidental_hits,
            score_dtype=score_dtype,
        )
    if score_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"score_dtype {score_dtype}: f32 or bf16 only")
    b, d = q.shape
    cn = c.shape[0]
    if d > _MAX_DIM:
        raise ValueError(f"embedding dim {d} > {_MAX_DIM}, the kernel limit")
    device = q.device
    logq = None
    if candidate_sampling_probability is not None:
        logq = torch.log(torch.clamp(candidate_sampling_probability, 1e-6,
                                     1.0)).to(device, torch.float32)
        logq = logq.reshape(cn).contiguous()
    ids = None
    if remove_accidental_hits:
        ids = candidate_ids.to(device, torch.int32).reshape(cn).contiguous()
    w = None
    if sample_weight is not None:
        w = sample_weight.to(device, torch.float32).reshape(b).contiguous()
    inv_temp = 1.0 / temperature if temperature is not None else 1.0
    config = (inv_temp, score_dtype == torch.bfloat16)
    return _FusedRetrievalCE.apply(
        q.to(torch.float32), c.to(torch.float32), logq, ids, w, config,
    )


fused_retrieval_loss.launches = 0
fused_retrieval_loss.launches_by_kernel = {
    (name, scores): 0 for name in ("fwd", "dq", "dc")
    for scores in ("bf16", "f32")}


def _count(name: str, bf16: bool) -> None:
    fused_retrieval_loss.launches += 1
    fused_retrieval_loss.launches_by_kernel[
        name, "bf16" if bf16 else "f32"] += 1


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = cuda_build.library("fused_retrieval")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.fused_retrieval_fwd
    fwd.argtypes = [ptr, ptr, i, i, i, ptr, ptr, i, f, i, i, ptr, ptr, ptr,
                    ptr]
    fwd.restype = i
    bwd = lib.fused_retrieval_bwd
    bwd.argtypes = [i, ptr, ptr, i, i, i, ptr, ptr, i, f, i, ptr, ptr, f, i,
                    ptr, ptr, ptr]
    bwd.restype = i
    lib.fused_retrieval_error_string.argtypes = [i]
    lib.fused_retrieval_error_string.restype = ctypes.c_char_p
    return fwd, bwd, lib.fused_retrieval_error_string


def _score_args(inv_temp: float, bf16: bool):
    """(has_div, divisor, bf16) as the kernels take them: the divisor is
    `1/inv_temp`, so a temperature T divides by 1/(1/T), as the TPU
    kernel does."""
    has_div = inv_temp != 1.0
    return int(has_div), (1.0 / inv_temp) if has_div else 1.0, int(bf16)


def _parts(own_rows: int, loop_rows: int, sms: int) -> int:
    """Pieces the tensor-core kernels split their loop dimension into: a
    block of 4 warps owns 64 rows of the output, and the grid should hold
    `_BLOCKS_PER_SM` blocks an SM (at `bench.py`'s shape 4 were slower
    than 2: more parts to write and fold; `tools/kernel_ab.py k2-parts`),
    without a piece of less than one 64-row tile."""
    blocks = -(-own_rows // _TILE)
    want = -(-_BLOCKS_PER_SM * sms // blocks)
    return max(1, min(-(-loop_rows // _TILE), want))


def _check_operands(q, c, tensors, bf16):
    want = torch.bfloat16 if bf16 else torch.float32
    for t in (q, c):
        if t.dtype != want or not t.is_contiguous():
            raise TypeError(
                f"operands must be contiguous {want} for "
                f"{'bf16' if bf16 else 'f32'} scores, got {t.dtype}"
            )
    for t in (c,) + tuple(tensors):
        if t is not None and t.device != q.device:
            raise ValueError(f"tensor on {t.device}, queries on {q.device}")


def forward_kernel(q, c, logq, ids, config):
    """Launches the forward kernel: `(lse [B], pos [B])` f32.

    `q [B, D]` and `c [C, D]` are contiguous CUDA tensors, bf16 when
    `config = (inv_temp, bf16)` asks for bf16 scores and f32 otherwise;
    `logq` (`[C]` f32) and `ids` (`[C]` int32) may be None.
    """
    inv_temp, bf16 = config
    _check_operands(q, c, (logq, ids), bf16)
    b, d = q.shape
    cn = c.shape[0]
    lse = torch.empty(b, dtype=torch.float32, device=q.device)
    pos = torch.empty(b, dtype=torch.float32, device=q.device)
    parts = _parts(b, cn, cuda_build.sm_count(q.device)) if bf16 else 1
    scratch = (torch.empty(3 * parts * b, dtype=torch.float32,
                           device=q.device) if bf16 else None)
    fwd, _, error_string = _kernel_fns()
    has_div, divisor, bf = _score_args(inv_temp, bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), c.data_ptr(), b, cn, d,
                  cuda_build.ptr(logq), cuda_build.ptr(ids), has_div,
                  divisor, bf, parts, cuda_build.ptr(scratch),
                  lse.data_ptr(), pos.data_ptr(), stream)
    cuda_build.raise_on(err, "fused_retrieval fwd", error_string)
    _count("fwd", bf16)
    return lse, pos


def backward_kernel(name, q, c, logq, ids, w, lse, config):
    """Launches the dq (`name="dq"`, → `[B, D]`) or dc (`"dc"`, →
    `[C, D]`) kernel, f32: the gradient of the summed loss for an
    upstream grad of 1, without dq's per-query weights (dc applies `w`,
    which may be None). Operands as `forward_kernel` takes them."""
    inv_temp, bf16 = config
    _check_operands(q, c, (logq, ids, w, lse), bf16)
    b, d = q.shape
    cn = c.shape[0]
    own, loop = (b, cn) if name == "dq" else (cn, b)
    _, bwd, error_string = _kernel_fns()
    has_div, divisor, bf = _score_args(inv_temp, bf16)
    out = torch.empty((own, d), dtype=torch.float32, device=q.device)
    parts = _parts(own, loop, cuda_build.sm_count(q.device)) if bf16 else 1
    scratch = (torch.empty(parts * own * d, dtype=torch.float32,
                           device=q.device) if bf16 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd({"dq": 0, "dc": 1}[name], q.data_ptr(), c.data_ptr(), b,
                  cn, d, cuda_build.ptr(logq), cuda_build.ptr(ids), has_div,
                  divisor, bf, lse.data_ptr(), cuda_build.ptr(w), inv_temp,
                  parts, cuda_build.ptr(scratch), out.data_ptr(), stream)
    cuda_build.raise_on(err, f"fused_retrieval {name}", error_string)
    _count(name, bf16)
    return out


class _FusedRetrievalCE(torch.autograd.Function):
    """Forward and backward of the fused loss, each a CUDA kernel. With
    bf16 scores the f32 operands are rounded to bf16 once, here (the RN
    rounding the twin applies), and the bf16 copies are what the backward
    keeps."""

    @staticmethod
    def forward(ctx, q, c, logq, ids, w, config):
        dtype = torch.bfloat16 if config[1] else torch.float32
        q, c = q.to(dtype).contiguous(), c.to(dtype).contiguous()
        lse, pos = forward_kernel(q, c, logq, ids, config)
        per_example = lse - pos
        if w is not None:
            per_example = per_example * w
        ctx.save_for_backward(q, c, logq, ids, w, lse)
        ctx.config = config
        return torch.sum(per_example)

    @staticmethod
    def backward(ctx, g):
        q, c, logq, ids, w, lse = ctx.saved_tensors
        dq = backward_kernel("dq", q, c, logq, ids, w, lse, ctx.config)
        dc = backward_kernel("dc", q, c, logq, ids, w, lse, ctx.config)
        wg = g if w is None else (w * g)[:, None]
        return dq * wg, dc * g, None, None, None, None


def fused_retrieval_loss_reference(
    query_embeddings: Tensor,
    candidate_embeddings: Tensor,
    sample_weight: Optional[Tensor] = None,
    candidate_sampling_probability: Optional[Tensor] = None,
    candidate_ids: Optional[Tensor] = None,
    *,
    temperature: Optional[float] = None,
    remove_accidental_hits: bool = False,
    score_dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """Materialized-scores twin of `fused_retrieval_loss` (any device,
    differentiable through autograd): the math of `tasks.Retrieval`
    restricted to the fused knob set, with f32 scores (TF32 off)."""
    q, c = query_embeddings, candidate_embeddings
    _check(q, c, remove_accidental_hits, candidate_ids)
    if score_dtype is not None:
        q = q.to(score_dtype)
        c = c.to(score_dtype)
    s = scoring.reference_scores(q, c)
    b, cn = s.shape
    if temperature is not None:
        s = loss_layers.divide_by_temperature(s, temperature)
    if candidate_sampling_probability is not None:
        s = s - torch.log(torch.clamp(candidate_sampling_probability,
                                      1e-6, 1.0))
    y = torch.eye(b, cn, dtype=torch.float32, device=s.device)
    if remove_accidental_hits:
        pos = candidate_ids[:b]
        dup = (pos[:, None] == candidate_ids[None, :]).to(torch.float32)
        s = s + (dup - y) * MIN_FLOAT
    log_probs = torch.log_softmax(s, dim=-1)
    per_example = -torch.sum(y * log_probs, dim=-1)
    if sample_weight is not None:
        per_example = per_example * torch.reshape(
            sample_weight, per_example.shape
        )
    return torch.sum(per_example)
