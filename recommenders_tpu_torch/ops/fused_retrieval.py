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
tiles do not divide). The kernels take their products on the bf16 tensor
cores: with bf16 scores the operands are rounded to bf16 once, in the
forward; with f32 scores every product runs in split precision, each f32
operand as three bf16 terms and six of their nine term products
(`split_model` models that arithmetic in float64, with its error bound).
Each kernel is split over `_parts` pieces of its loop dimension whose
partial results a second small kernel folds in a fixed order. `launches`
counts wrapper launches of a kernel, and `launches_by_kernel` splits
them by kernel and score dtype: keys `("fwd" | "dq" | "dc", "bf16" |
"f32")`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from recommenders_tpu_torch.layers import loss as loss_layers
from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops import scoring

Tensor = torch.Tensor

MIN_FLOAT = loss_layers.MIN_FLOAT

# Widths the kernels take (D padded to 16, at most 32 n-blocks of 8 a
# warp), and the rows of each kernel's owned tile.
_MAX_DIM = 256
_TILE = 64
_BLOCKS_PER_SM = 2
# Blocks an SM the f32 kernels' parts are sized for: None asks the runtime
# how many of the launching kernel an SM holds (three at D = 64), a number
# overrides it (`tools/kernel_ab.py k2-parts --f32`).
_F32_BLOCKS_PER_SM: Optional[float] = None


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
    occupancy = lib.fused_retrieval_f32_blocks_per_sm
    occupancy.argtypes = [i, i]
    occupancy.restype = i
    lib.fused_retrieval_error_string.argtypes = [i]
    lib.fused_retrieval_error_string.restype = ctypes.c_char_p
    return fwd, bwd, lib.fused_retrieval_error_string, occupancy


def _score_args(inv_temp: float, bf16: bool):
    """(has_div, divisor, bf16) as the kernels take them: the divisor is
    `1/inv_temp`, so a temperature T divides by 1/(1/T), as the TPU
    kernel does."""
    has_div = inv_temp != 1.0
    return int(has_div), (1.0 / inv_temp) if has_div else 1.0, int(bf16)


def _parts(own_rows: int, loop_rows: int, sms: int,
           blocks_per_sm: Optional[float] = None) -> int:
    """Pieces the tensor-core kernels split their loop dimension into: a
    block of 4 warps owns 64 rows of the output, and no piece is less
    than one 64-row tile. bf16 scores (`blocks_per_sm` None): the grid
    should hold `_BLOCKS_PER_SM` blocks an SM, rounded up (at `bench.py`'s
    shape 4 were slower than 2: more parts to write and fold;
    `tools/kernel_ab.py k2-parts`). f32 scores: as many as one wave of
    `blocks_per_sm` blocks an SM holds, rounded down: a second, partial
    wave of these longer blocks costs a whole block's time (`k2-parts
    --f32`)."""
    blocks = -(-own_rows // _TILE)
    if blocks_per_sm is None:
        want = -(-_BLOCKS_PER_SM * sms // blocks)
    else:
        want = int(blocks_per_sm * sms // blocks)
    return max(1, min(-(-loop_rows // _TILE), want))


@functools.lru_cache(maxsize=None)
def _f32_blocks_per_sm(name: str, d: int, device: torch.device) -> int:
    """Blocks an SM holds of the f32 kernel `name` launches at width d."""
    _, _, error_string, occupancy = _kernel_fns()
    with torch.cuda.device(device):
        blocks = occupancy({"fwd": 0, "dq": 1, "dc": 2}[name], d)
    cuda_build.raise_on(max(-blocks, 0), f"fused_retrieval {name}",
                        error_string)
    if blocks == 0:
        raise RuntimeError(f"fused_retrieval {name}: no f32 block fits an "
                           f"SM at D = {d}")
    return blocks


def _f32_parts(name: str, own_rows: int, loop_rows: int, d: int,
               device: torch.device) -> int:
    per_sm = _F32_BLOCKS_PER_SM
    if per_sm is None:
        per_sm = _f32_blocks_per_sm(name, d, device)
    return _parts(own_rows, loop_rows, cuda_build.sm_count(device), per_sm)


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
    parts = (_parts(b, cn, cuda_build.sm_count(q.device)) if bf16
             else _f32_parts("fwd", b, cn, d, q.device))
    scratch = torch.empty(3 * parts * b, dtype=torch.float32,
                          device=q.device)
    fwd, _, error_string, _ = _kernel_fns()
    has_div, divisor, bf = _score_args(inv_temp, bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), c.data_ptr(), b, cn, d,
                  cuda_build.ptr(logq), cuda_build.ptr(ids), has_div,
                  divisor, bf, parts, scratch.data_ptr(), lse.data_ptr(),
                  pos.data_ptr(), stream)
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
    _, bwd, error_string, _ = _kernel_fns()
    has_div, divisor, bf = _score_args(inv_temp, bf16)
    out = torch.empty((own, d), dtype=torch.float32, device=q.device)
    parts = (_parts(own, loop, cuda_build.sm_count(q.device)) if bf16
             else _f32_parts(name, own, loop, d, q.device))
    scratch = torch.empty(parts * own * d, dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd({"dq": 0, "dc": 1}[name], q.data_ptr(), c.data_ptr(), b,
                  cn, d, cuda_build.ptr(logq), cuda_build.ptr(ids), has_div,
                  divisor, bf, lse.data_ptr(), cuda_build.ptr(w), inv_temp,
                  parts, scratch.data_ptr(), out.data_ptr(), stream)
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


# The f32 coefficient's rounding (2⁻²⁴ relative, 2⁻¹⁵⁰ below f32's normal
# range) before the kernels split it.
_F32_UNIT = 2.0**-24
_F32_SUBNORMAL_HALF_ULP = 2.0**-150


class SplitModel(NamedTuple):
    """`split_model`'s float64 loss, dq and dc, and bounds on their
    distance from the exact ones."""

    loss: Tensor
    dq: Tensor
    dc: Tensor
    loss_bound: Tensor
    dq_bound: Tensor
    dc_bound: Tensor


def split_model(
    query_embeddings: Tensor,
    candidate_embeddings: Tensor,
    sample_weight: Optional[Tensor] = None,
    candidate_sampling_probability: Optional[Tensor] = None,
    candidate_ids: Optional[Tensor] = None,
    *,
    temperature: Optional[float] = None,
    remove_accidental_hits: bool = False,
) -> SplitModel:
    """The f32-score kernels' arithmetic in float64, for small shapes.

    The loss and its gradients as `csrc/fused_retrieval.cu` forms them with
    f32 scores, less the f32 rounding it shares with the plain twin: the
    scores are the sum of the six exact bf16 term products of q and c
    (`scoring.split_scores`), corrected in `_score_tile`'s order; the
    coefficients `P − y` (times `w` for dc) are rounded to f32, as the
    kernels hold them, and multiply c (dq) or q (dc) through the same six
    term products. The rest is exact in float64.

    Bounds against the same function with exact products, from the
    split's dropped terms (`scoring.split_error_bound`, `δ` on a score):
    log P̃_ij lies within the log-softmax of the scores with every other
    score of the row moved by `δ_ik + δ_ij` against it (down, then up),
    which bounds |P̃ − P| and each loss term −log P_ii without a
    Lipschitz constant (scores may be large); dq and dc add |P̃ − P|·|x|,
    the coefficient's f32 rounding and the coefficient product's own
    dropped terms. Builds `[B, C, C]` float64 intervals: small shapes only.
    """
    q, c = query_embeddings, candidate_embeddings
    _check(q, c, remove_accidental_hits, candidate_ids)
    q = q.to(torch.float32)
    c = c.to(torch.float32)
    b, cn = q.shape[0], c.shape[0]
    inv_temp = 1.0 / temperature if temperature is not None else 1.0
    # The kernels divide by the f32 `1/inv_temp` (`_score_args`).
    divisor = float(torch.tensor(1.0 / inv_temp, dtype=torch.float32))
    s = scoring.split_scores(q, c)
    delta = scoring.split_error_bound(q, c)
    if temperature is not None:
        s = s / divisor
        delta = delta / divisor
    if candidate_sampling_probability is not None:
        logq = torch.log(torch.clamp(candidate_sampling_probability.to(
            torch.float32), 1e-6, 1.0))
        s = s - logq.double()[None, :]
    y = torch.eye(b, cn, dtype=torch.float64)
    if remove_accidental_hits:
        dup = candidate_ids[:b, None] == candidate_ids[None, :]
        s = s + (dup.double() - y) * MIN_FLOAT
    w = (torch.ones(b, dtype=torch.float64) if sample_weight is None
         else sample_weight.reshape(b).double())

    log_p = torch.log_softmax(s, dim=1)
    diag = torch.arange(b)
    loss = -(w * log_p[diag, diag]).sum()
    # log P̃_ij = −LSE_k(s_ik − s_ij), k = j contributing exactly 0.
    diff = s[:, None, :] - s[:, :, None]
    move = (delta[:, None, :] + delta[:, :, None]) * (
        1 - torch.eye(cn, dtype=torch.float64))
    lo = -torch.logsumexp(diff + move, dim=2)
    hi = -torch.logsumexp(diff - move, dim=2)
    p = log_p.exp()
    p_bound = torch.maximum(hi.exp() - p, p - lo.exp()).clamp_min(0)
    loss_bound = (w.abs() * torch.maximum(
        log_p[diag, diag] - lo[diag, diag],
        hi[diag, diag] - log_p[diag, diag]).clamp_min(0)).sum()

    coef = p - y
    coef_q = coef.float()
    coef_c = (coef * w[:, None]).float()
    dq = inv_temp * scoring.split_scores(coef_q, c.T) * w[:, None]
    dc = inv_temp * scoring.split_scores(coef_c.T, q.T)
    rounding = lambda x: _F32_UNIT * x.abs() + _F32_SUBNORMAL_HALF_ULP
    dq_bound = inv_temp * w.abs()[:, None] * (
        (p_bound + rounding(coef)) @ c.double().abs()
        + scoring.split_error_bound(coef_q, c.T))
    dc_bound = inv_temp * (
        ((p_bound * w.abs()[:, None]) + rounding(coef * w[:, None])).T
        @ q.double().abs()
        + scoring.split_error_bound(coef_c.T, q.T))
    return SplitModel(loss, dq, dc, loss_bound, dq_bound, dc_bound)
