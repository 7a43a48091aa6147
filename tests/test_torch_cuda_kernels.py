"""The CUDA kernel against its plain twin, on the card.

Marked `cuda`; each test skips when `torch.cuda.is_available()` is
false (decided inside the test, never at import). This file imports
only torch and the port, so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Tolerance: the kernel and the twin take the same products in f32 in a
different order, so scores agree to |Δ| ≤ D·2⁻²³·Σ|q||c| of each winner
(the a-priori bound of an f32 sum), and ids are equal wherever the
twin's bucket winner beats its runner-up by more than twice that.
"""

import pytest
import torch

from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring

pytestmark = pytest.mark.cuda

FORMATS = ("f32", "bf16", "int8", "int4")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(fmt, q, n, d, device):
    g = torch.Generator(device=device).manual_seed(0)
    queries = torch.randn(q, d, device=device, generator=g)
    corpus = torch.randn(n, d, device=device, generator=g)
    if fmt == "f32":
        return queries, corpus, None, False, corpus
    if fmt == "bf16":
        return (queries.bfloat16(), corpus.bfloat16(), None, False,
                corpus.bfloat16().float())
    bits = 4 if fmt == "int4" else 8
    scales, codes = quantization.quantize_rows_device(corpus, 0.2, bits=bits)
    deq = codes.float() * scales[:, None]
    if bits == 4:
        codes = quantization.pack_nibbles(codes)
    return queries, codes, scales, bits == 4, deq


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("q,n,buckets,valid", [
    (40, 8192, 256, 8000), (64, 4096, 512, 4096), (8, 1024, 1024, 300),
])
def test_kernel_matches_twin(device, fmt, q, n, buckets, valid):
    queries, stored, scales, packed4, deq = _inputs(fmt, q, n, 128, device)
    chunk = buckets
    if packed4:  # int4 needs the buckets to divide chunk/2.
        buckets = min(buckets, n // 2)
        chunk = 2 * buckets
    before = scoring.bucketed_scores.launches
    vals, rows = scoring.bucketed_scores(
        queries, stored, scales, buckets=buckets, chunk=chunk,
        query_tile=q, valid_rows=valid, packed4=packed4,
    )
    torch.cuda.synchronize()
    assert scoring.bucketed_scores.launches == before + 1
    ref_v, ref_r = scoring.bucketed_scores_reference(
        queries, stored, scales, buckets=buckets, valid_rows=valid,
        packed4=packed4,
    )
    qf = queries.float()
    if scales is not None:
        qf = queries.bfloat16().float()
    abs_dot = (qf.abs()[:, None, :] * deq.abs()[ref_r.long()]).sum(-1)
    tol = 128 * 2.0**-23 * abs_dot + 1e-30
    assert ((vals - ref_v).abs() <= tol).all()
    scores = (qf @ deq.T).masked_fill(
        torch.arange(n, device=device) >= valid, scoring.MIN_FLOAT
    ).view(q, n // buckets, buckets)
    top2 = scores.topk(min(2, n // buckets), dim=1).values
    separated = (top2[:, 0] - top2[:, -1] > 2 * tol) | (n // buckets == 1)
    live = torch.arange(buckets, device=device) < valid
    separated &= live
    assert separated.sum() >= 0.9 * live.sum()
    assert (rows[separated] == ref_r[separated]).all()


def test_kernel_refuses_bad_inputs(device):
    queries, stored, _, _, _ = _inputs("f32", 8, 1024, 128, device)
    with pytest.raises(TypeError, match="share a dtype"):
        scoring.bucketed_scores(queries.bfloat16(), stored, buckets=256,
                                chunk=1024)
    with pytest.raises(ValueError, match="contiguous"):
        scoring.bucketed_scores(queries, stored.T.contiguous().T,
                                buckets=256, chunk=1024)


# --- K1: sorted sparse apply ------------------------------------------------
#
# The kernel takes the twin's IEEE operations in the twin's order and the
# same stochastic-rounding bits, so sgd, adagrad, adam and ftrl (pow at
# exponent 0.5 is a square root on both) come out bit-equal;
# rowwise_adagrad's row mean is a warp tree sum there, held to 2 f32 ulps
# of the row's scale (1 bf16 ulp for bf16 states).

K1_KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam", "ftrl")


def _k1_case(kind, dtype, v, d, n, device):
    from recommenders_tpu_torch.embedding import config
    from recommenders_tpu_torch.embedding import sparse_optimizer

    g = torch.Generator(device=device).manual_seed(1)
    widths = {"sgd": [], "adagrad": [d], "rowwise_adagrad": [1],
              "adam": [d, d], "ftrl": [d, d]}[kind]
    states = [torch.randn(v, d, device=device, generator=g)] + [
        torch.rand(v, w, device=device, generator=g) * 2 + 0.05
        for w in widths
    ]
    states = [s.to(dtype) for s in states]
    ids = torch.randint(0, v, (n,), device=device, generator=g)
    ids[: n // 3] = ids[torch.randint(0, n, (n // 3,), device=device,
                                      generator=g)]
    ids[-5:] = v + 3
    ids = torch.sort(ids, stable=True).values.to(torch.int32)
    grads = torch.randn(n, d, device=device, generator=g)
    _, scalars, rule, _ = sparse_optimizer._kernel_rule(
        config.OptimizerSpec(kind=kind, learning_rate=0.1), 4)
    return states, ids, grads, rule, scalars


@pytest.mark.parametrize("kind", K1_KINDS)
@pytest.mark.parametrize("dtype,seed", [(torch.float32, None),
                                        (torch.bfloat16, None),
                                        (torch.bfloat16, 2**31 + 77)])
@pytest.mark.parametrize("v,d,n", [(4096, 64, 512), (1000, 8, 300),
                                   (300, 200, 64)])
def test_sparse_apply_kernel_matches_twin(device, kind, dtype, seed, v, d,
                                          n):
    from recommenders_tpu_torch.ops import sparse_apply

    states, ids, grads, rule, scalars = _k1_case(kind, dtype, v, d, n,
                                                 device)
    got = [s.clone() for s in states]
    want = [s.clone() for s in states]
    before = sparse_apply.sorted_block_apply.launches
    sparse_apply.sorted_block_apply(got, ids, grads, rule, scalars=scalars,
                                    stochastic_round_seed=seed)
    torch.cuda.synchronize()
    assert sparse_apply.sorted_block_apply.launches == before + 1
    sparse_apply.sorted_block_apply_reference(
        want, ids, grads, rule, scalars=scalars, stochastic_round_seed=seed)
    for g, w, b in zip(got, want, states):
        if kind != "rowwise_adagrad":
            assert torch.equal(g, w)
            continue
        scale = torch.maximum(torch.maximum(g.float().abs(),
                                            w.float().abs()),
                              b.float().abs())
        ulp = torch.pow(2.0, torch.floor(torch.log2(scale.clamp(
            min=2.0**-126))) - (7 if dtype == torch.bfloat16 else 23))
        limit = 1 if dtype == torch.bfloat16 else 2
        assert ((g.float() - w.float()).abs() <= limit * ulp).all()


def test_sparse_apply_kernel_refuses_bad_inputs(device):
    from recommenders_tpu_torch.ops import sparse_apply

    states, ids, grads, rule, scalars = _k1_case(
        "adagrad", torch.float32, 64, 8, 16, device)
    with pytest.raises(ValueError, match="slot plane"):
        sparse_apply.sorted_block_apply(states[:1], ids, grads, rule,
                                        scalars=scalars)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        sparse_apply.sorted_block_apply(
            states, ids, grads, sparse_apply.BlockRule(rule.fn),
            scalars=scalars)


def test_sparse_apply_kernel_empty_update_launches_nothing(device):
    from recommenders_tpu_torch.ops import sparse_apply

    states, ids, grads, rule, scalars = _k1_case(
        "adagrad", torch.float32, 64, 8, 16, device)
    got = [s.clone() for s in states]
    before = sparse_apply.sorted_block_apply.launches
    sparse_apply.sorted_block_apply(got, ids[:0], grads[:0], rule,
                                    scalars=scalars)
    assert sparse_apply.sorted_block_apply.launches == before
    for g, s in zip(got, states):
        assert torch.equal(g, s)


# --- K2: fused retrieval CE ---------------------------------------------------
#
# Loss to rtol 1e-5 (the kernel's online log-sum-exp against a
# materialized log-softmax); grads, sums of C terms in another order, to
# 1e-4 of their largest magnitude. With bf16 scores the kernel rounds the
# backward's probability coefficients to bf16, as the TPU kernel does,
# where the twin's autograd keeps them f32: grads to 2e-2 relative plus
# 2e-3 of their largest magnitude.


@pytest.mark.parametrize("score_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("b,c,d", [(256, 256, 64), (100, 333, 40),
                                   (64, 64, 256)])
@pytest.mark.parametrize("knobs", ["none", "all"])
def test_fused_retrieval_kernels_match_twin(device, score_dtype, b, c, d,
                                            knobs):
    from recommenders_tpu_torch.ops import fused_retrieval

    g = torch.Generator(device=device).manual_seed(2)
    q = torch.randn(b, d, device=device, generator=g) * d ** -0.25
    cand = torch.randn(c, d, device=device, generator=g) * d ** -0.25
    kw = dict(score_dtype=score_dtype)
    if knobs == "all":
        kw.update(
            temperature=0.3, remove_accidental_hits=True,
            candidate_ids=torch.randint(0, 20, (c,), device=device,
                                        generator=g),
            candidate_sampling_probability=torch.rand(
                c, device=device, generator=g) + 0.01,
            sample_weight=torch.rand(b, device=device, generator=g) + 0.5,
        )

    def run(fn):
        qq = q.clone().requires_grad_(True)
        cc = cand.clone().requires_grad_(True)
        loss = fn(qq, cc, **kw)
        loss.backward()
        return loss.detach(), qq.grad, cc.grad

    before = dict(fused_retrieval.fused_retrieval_loss.launches_by_kernel)
    loss, dq, dc = run(fused_retrieval.fused_retrieval_loss)
    torch.cuda.synchronize()
    after = fused_retrieval.fused_retrieval_loss.launches_by_kernel
    assert all(after[k] == before[k] + 1 for k in before)
    tloss, tdq, tdc = run(fused_retrieval.fused_retrieval_loss_reference)
    assert abs(float(loss - tloss)) <= 1e-5 * abs(float(tloss))
    for got, want in ((dq, tdq), (dc, tdc)):
        scale = float(want.abs().max())
        if score_dtype is None:
            tol = 1e-5 * want.abs() + 1e-4 * scale
        else:
            tol = 2e-2 * want.abs() + 2e-3 * scale
        assert ((got - want).abs() <= tol).all()
