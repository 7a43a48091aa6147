"""The CUDA kernel against its plain twin, on the card.

Marked `cuda`; each test skips when `torch.cuda.is_available()` is
false (decided inside the test, never at import). This file imports
only torch and the port, so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Tolerance: the kernel and the twin take the same products in f32 in a
different order (on the tensor cores, whose f32 sums may truncate; f32
rows as six exact bf16 term products, which drop at most
1.006·2⁻²³·Σ|q||c|, `csrc/bucketed_scores.cu`), so scores agree to
|Δ| ≤ D·2⁻²³·Σ|q||c| of each winner (the a-priori bound of an f32 sum
that truncates), and ids
are equal wherever the twin's bucket winner beats its runner-up by more
than twice that. Every case launches twice and needs bit-identical
results.
"""

import math

import pytest
import torch

from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring
from torch_threads import torch_threads  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda

FORMATS = ("f32", "bf16", "int8", "int4")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(fmt, q, n, d, device, values="randn"):
    """Queries and a corpus in `fmt`; with values "integers", both drawn
    from the integers -3 .. 3, so that every body's sums are exact and the
    kernel must equal its twin bit for bit."""
    g = torch.Generator(device=device).manual_seed(0)
    if values == "integers":
        queries = torch.randint(-3, 4, (q, d), device=device,
                                generator=g).float()
        corpus = torch.randint(-3, 4, (n, d), device=device,
                               generator=g).float()
    else:
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


def _inputs_with_ties(fmt, q, n, buckets, d, device, late=None):
    """`_inputs` whose every row group repeats group 0, so every score
    ties across the groups of its bucket. With `late`, the queries are
    integers, group 0's rows too, and every group from `late` on doubles
    group 0 (its rows, or for codes its scales), so a positive score's best
    first appears there and ties with every later group."""
    g = torch.Generator(device=device).manual_seed(0)
    if late is None:
        queries = torch.randn(q, d, device=device, generator=g)
        base = torch.randn(buckets, d, device=device, generator=g)
    else:
        queries = torch.randint(-3, 4, (q, d), device=device,
                                generator=g).float()
        base = torch.randint(-3, 4, (buckets, d), device=device,
                             generator=g).float()
    times = torch.ones(n // buckets, device=device)
    if late is not None:
        times[late:] = 2.0
    if fmt in ("f32", "bf16"):
        dtype = torch.float32 if fmt == "f32" else torch.bfloat16
        corpus = (base.to(dtype)[None] * times[:, None, None].to(dtype))
        return queries.to(dtype), corpus.reshape(n, d), None, False
    bits = 4 if fmt == "int4" else 8
    scales, codes = quantization.quantize_rows_device(base, 0.2, bits=bits)
    codes = codes.repeat(n // buckets, 1)
    scales = (scales[None] * times[:, None]).reshape(n)
    if bits == 4:
        codes = quantization.pack_nibbles(codes)
    return queries, codes, scales, bits == 4


@pytest.mark.parametrize("values", ["randn", "integers"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("q,n,buckets,valid,d", [
    (40, 8192, 256, 8000, 128), (64, 4096, 512, 4096, 128),
    (8, 1024, 1024, 300, 128),
    (1024, 65536, 2048, 65536, 128),  # the tensor-core bodies split the walk
    (130, 12800, 160, 12700, 128),    # ragged query and bucket tiles
    (48, 4096, 256, 4000, 384),       # f32: 64-query tiles (D 256 .. 384)
    (70, 4096, 256, 4000, 640),       # D > 512: 64-query tiles, 5 stages a group
    (40, 2048, 128, 2000, 768),       # the widest D (f32: 32-query tiles)
    (100, 8960, 320, 8900, 256),      # int8: a ragged 128-query tile
    (200, 9984, 96, 9900, 512),       # int8: 128-query tiles, 3 stages
    # int8: each query tile at each width a tile holds, ragged tiles and
    # masked rows in the last group, one walk or split walks:
    (96, 8192, 256, 8100, 128),       # 128-query tile at D = 128
    (256, 16384, 256, 16000, 256),    # 256-query tile at D = 256
    (33, 8192, 256, 8100, 256),       # 64-query tile at D = 256
    (128, 8192, 128, 8000, 512),      # 128-query tile at D = 512
    (64, 4096, 128, 4000, 512),       # 64-query tile at D = 512
    # int8: walks of 1,060 groups, past the fast fold's first 1,024
    (32, 8_960_000, 64, 8_959_990, 128),
])
def test_kernel_matches_twin(device, fmt, q, n, buckets, valid, d, values):
    """The kernel against its twin: within the sums' tolerance on normal
    values, and bit for bit (values and rows) on integers, whose sums are
    exact in every body, where ties are many and go to the lowest row."""
    queries, stored, scales, packed4, deq = _inputs(fmt, q, n, d, device,
                                                     values)
    chunk = buckets
    if packed4:  # int4 needs the buckets to divide chunk/2, 128 | chunk/2.
        buckets = min(buckets, n // 2)
        chunk = 2 * math.lcm(buckets, 128)
    before = scoring.bucketed_scores.launches
    kw = dict(buckets=buckets, chunk=chunk, query_tile=q, valid_rows=valid,
              packed4=packed4)
    vals, rows = scoring.bucketed_scores(queries, stored, scales, **kw)
    again_v, again_r = scoring.bucketed_scores(queries, stored, scales, **kw)
    torch.cuda.synchronize()
    assert scoring.bucketed_scores.launches == before + 2
    assert torch.equal(vals, again_v) and torch.equal(rows, again_r)
    ref_v, ref_r = scoring.bucketed_scores_reference(
        queries, stored, scales, buckets=buckets, valid_rows=valid,
        packed4=packed4,
    )
    if values == "integers":
        assert torch.equal(vals, ref_v) and torch.equal(rows, ref_r)
        return
    qf = queries.float()
    if scales is not None:
        qf = queries.bfloat16().float()
    abs_dot = (qf.abs()[:, None, :] * deq.abs()[ref_r.long()]).sum(-1)
    tol = d * 2.0**-23 * abs_dot + 1e-30
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


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("q,n,buckets,valid,d,late", [
    (64, 8192, 512, 8192, 128, None), (256, 16384, 128, 16384, 128, None),
    (130, 16640, 160, 16500, 256, None),    # ragged tiles, masked rows
    (72, 8192, 512, 8000, 512, None),
    # Integer queries, groups from `late` on doubled: a positive score's
    # best first appears in a later group (a later split's walk, or, at
    # 9M rows, past the fast fold's first 1,024 groups of the last walk)
    # and ties with every group after it.
    (64, 8192, 512, 8192, 128, 11), (130, 16640, 160, 16500, 256, 57),
    (256, 16384, 128, 16384, 128, 100), (72, 8192, 512, 8000, 512, 9),
    (32, 8_960_000, 64, 8_960_000, 128, 139_969),
])
def test_kernel_ties_go_to_the_lowest_row(device, fmt, q, n, buckets, valid,
                                          d, late):
    """Every group repeats group 0, so each bucket's best score ties over
    all its rows (split walks and merges included): the kernel must
    report group 0's row, with the twin's value. With `late`, a positive
    score's best is the first doubled group's row, a negative one's group
    0's, bit for bit the twin's."""
    queries, stored, scales, packed4 = _inputs_with_ties(
        fmt, q, n, buckets, d, device, late)
    vals, rows = scoring.bucketed_scores(
        queries, stored, scales, buckets=buckets,
        chunk=2 * math.lcm(buckets, 128) if packed4 else buckets,
        query_tile=q, valid_rows=valid, packed4=packed4)
    torch.cuda.synchronize()
    ref_v, ref_r = scoring.bucketed_scores_reference(
        queries, stored, scales, buckets=buckets, valid_rows=valid,
        packed4=packed4)
    want = torch.arange(buckets, dtype=torch.int32, device=device)
    if late is not None:
        want = torch.where(vals > 0, want + late * buckets, want)
        assert bool((vals > 0).any()) and bool((vals < 0).any())
        assert torch.equal(vals, ref_v) and torch.equal(rows, ref_r)
        assert torch.equal(rows, want)
        return
    assert torch.equal(rows, want.expand(q, buckets))
    qf = queries.bfloat16().float() if scales is not None else queries.float()
    deq = (quantization.unpack_nibbles(stored) if packed4 else stored).float()
    if scales is not None:
        deq = deq * scales[:, None]
    tol = d * 2.0**-23 * (qf.abs() @ deq[:buckets].abs().T)
    assert ((vals - ref_v).abs() <= tol).all()


def _adversarial_f32(kind, shape, g, device):
    """f32 values whose split terms are all busy: `residues` (m and l as
    large as rounding to nearest lets them be, one sign), `ones` (all 24
    significant bits set), `spread` (exponents from 2⁻³⁰ to 2³⁰) or
    `subnormal` (half the values below 2⁻¹¹⁰, many of them f32
    subnormals, where the split rounds onto bf16's subnormal grid)."""
    exps = lambda lo, hi: torch.exp2(torch.randint(
        lo, hi + 1, shape, device=device, generator=g).double())
    sign = torch.randint(0, 2, shape, device=device, generator=g) * 2.0 - 1
    mantissa = 1 + torch.rand(shape, device=device, generator=g,
                              dtype=torch.float64)
    if kind == "residues":
        h = 1 + torch.randint(0, 32, shape, device=device,
                              generator=g).double() * 2.0**-7
        x = (h + (2.0**-8 - 2.0**-16) + (2.0**-17 - 2.0**-23)) * exps(-4, 4)
    elif kind == "ones":
        x = sign * (2 - 2.0**-23) * exps(-4, 4)
    elif kind == "spread":
        x = sign * mantissa * exps(-30, 30)
    else:
        tiny = torch.rand(shape, device=device, generator=g) < 0.5
        x = sign * mantissa * torch.where(tiny, exps(-149, -111),
                                          exps(-4, 4))
    return x.float()


@pytest.mark.parametrize("kind", ["residues", "ones", "spread"])
@pytest.mark.parametrize("q,n,buckets,d", [(64, 8192, 512, 128),
                                           (40, 2048, 128, 768)])
def test_f32_kernel_on_adversarial_values(device, kind, q, n, buckets, d):
    """The split-precision f32 body on values that keep all three bf16
    terms of every operand busy: within D·2⁻²³·Σ|q||c| of the twin and of
    a float64 dot, rows equal wherever the winner is separated."""
    g = torch.Generator(device=device).manual_seed(5)
    queries = _adversarial_f32(kind, (q, d), g, device)
    corpus = _adversarial_f32(kind, (n, d), g, device)
    kw = dict(buckets=buckets, chunk=buckets, query_tile=q, valid_rows=n)
    vals, rows = scoring.bucketed_scores(queries, corpus, None, **kw)
    again = scoring.bucketed_scores(queries, corpus, None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(vals, again[0]) and torch.equal(rows, again[1])
    ref_v, ref_r = scoring.bucketed_scores_reference(
        queries, corpus, None, buckets=buckets, valid_rows=n)
    exact = queries.double() @ corpus.double().T
    abs_dot = queries.double().abs() @ corpus.double().abs().T
    tol = d * 2.0**-23 * abs_dot + 1e-30
    win_tol = torch.gather(tol, 1, rows.long())
    assert ((vals.double() - ref_v.double()).abs() <= win_tol).all()
    assert ((vals.double() - torch.gather(exact, 1, rows.long())).abs()
            <= win_tol).all()
    top2 = exact.view(q, n // buckets, buckets).topk(2, dim=1).values
    separated = (top2[:, 0] - top2[:, 1]) > 2 * torch.gather(
        tol, 1, ref_r.long())
    assert separated.double().mean() >= 0.9
    assert torch.equal(rows[separated], ref_r[separated])


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


def _k1_case(kind, dtype, v, d, n, device, run=0):
    """States, sorted ids (a third duplicated, 5 padding; with `run`, the
    first `run` entries one id) and grads for one K1 case."""
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
    ids[:run] = v // 2
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
@pytest.mark.parametrize("v,d,n,run", [
    (4096, 64, 512, 0), (1000, 8, 300, 0), (300, 200, 64, 0),
    (500, 33, 200, 0),       # odd D: one column a lane, not pairs
    (4096, 64, 3500, 3000),  # one run of 3000 ids, past the window and tiles
    (131072, 64, 4093, 0),   # the step's shape, n not a multiple of 8
    (4096, 16, 1024, 0),     # D = 16: column pairs on 8 of 32 lanes
    (1000000, 16, 106496, 0),  # the hybrid DLRM step's width and ids
])
def test_sparse_apply_kernel_matches_twin(device, kind, dtype, seed, v, d,
                                          n, run):
    from recommenders_tpu_torch.ops import sparse_apply

    states, ids, grads, rule, scalars = _k1_case(kind, dtype, v, d, n,
                                                 device, run)
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


# --- K2: fused retrieval CE --------------------------------------------------
#
# Loss to rtol 1e-5 (the kernel's online log-sum-exp against a
# materialized log-softmax); grads, sums of C terms in another order, to
# 1e-4 of their largest magnitude. With bf16 scores the kernel rounds the
# backward's probability coefficients to bf16, as the TPU kernel does,
# where the twin's autograd keeps them f32: grads to 2e-2 relative plus
# 2e-3 of their largest magnitude.


@pytest.mark.parametrize("score_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("b,c,d", [(256, 256, 64), (100, 333, 40),
                                   (64, 64, 256), (4096, 4096, 64),
                                   (129, 4099, 72), (70, 200, 36)])
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
    again = run(fused_retrieval.fused_retrieval_loss)
    torch.cuda.synchronize()
    after = fused_retrieval.fused_retrieval_loss.launches_by_kernel
    scores = "f32" if score_dtype is None else "bf16"
    assert all(after[k] == before[k] + (2 if k[1] == scores else 0)
               for k in before)
    # Parts fold in a fixed order, without atomics: bit-identical runs.
    assert all(torch.equal(x, y) for x, y in zip((loss, dq, dc), again))
    tloss, tdq, tdc = run(fused_retrieval.fused_retrieval_loss_reference)
    assert abs(float(loss - tloss)) <= 1e-5 * abs(float(tloss))
    for got, want in ((dq, tdq), (dc, tdc)):
        scale = float(want.abs().max())
        if score_dtype is None:
            tol = 1e-5 * want.abs() + 1e-4 * scale
        else:
            tol = 2e-2 * want.abs() + 2e-3 * scale
        assert ((got - want).abs() <= tol).all()


def _k2_adversarial(kind, shape, g, device):
    """f32 values of `tests/test_torch_k2_split.py`'s kinds at the scale a
    softmax takes (|x| ≤ 1): `residues`, `ones`, `spread` (exponents
    2⁻⁴⁰ … 2⁻¹) and `subnormal` (half the values below 2⁻¹¹⁰), every
    split term busy."""
    exps = lambda lo, hi: torch.exp2(torch.randint(
        lo, hi + 1, shape, device=device, generator=g).double())
    sign = torch.randint(0, 2, shape, device=device, generator=g) * 2.0 - 1
    mantissa = 1 + torch.rand(shape, device=device, generator=g,
                              dtype=torch.float64)
    if kind == "residues":
        h = 1 + torch.randint(0, 32, shape, device=device,
                              generator=g).double() * 2.0**-7
        x = (h + (2.0**-8 - 2.0**-16) + (2.0**-17 - 2.0**-23)) * exps(-5, -1)
    elif kind == "ones":
        x = sign * (2 - 2.0**-23) * exps(-5, -1)
    elif kind == "spread":
        x = sign * mantissa * exps(-40, -1)
    else:
        tiny = torch.rand(shape, device=device, generator=g) < 0.5
        x = sign * mantissa * torch.where(tiny, exps(-149, -111),
                                          exps(-5, -1))
    return x.float()


@pytest.mark.parametrize("kind", ["ones", "residues", "spread", "subnormal"])
@pytest.mark.parametrize("b,c,d", [(256, 1024, 64), (129, 4099, 72)])
def test_fused_retrieval_f32_kernels_on_adversarial_values(device, kind, b,
                                                           c, d):
    """The split-precision f32 bodies on values that keep all three bf16
    terms of every operand busy, every knob: the twin's f32 tolerance,
    f32 launches only, and two launches bit-identical."""
    from recommenders_tpu_torch.ops import fused_retrieval

    g = torch.Generator(device=device).manual_seed(7)
    q = _k2_adversarial(kind, (b, d), g, device)
    cand = _k2_adversarial(kind, (c, d), g, device)
    kw = dict(
        temperature=0.2, remove_accidental_hits=True,
        candidate_ids=torch.randint(0, 64, (c,), device=device, generator=g),
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
    got = run(fused_retrieval.fused_retrieval_loss)
    again = run(fused_retrieval.fused_retrieval_loss)
    torch.cuda.synchronize()
    after = fused_retrieval.fused_retrieval_loss.launches_by_kernel
    assert all(after[k] == before[k] + (2 if k[1] == "f32" else 0)
               for k in before)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = run(fused_retrieval.fused_retrieval_loss_reference)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert abs(float(got[0] - want[0])) <= 1e-5 * abs(float(want[0]))
    for x, t in zip(got[1:], want[1:]):
        tol = 1e-5 * t.abs() + 1e-4 * float(t.abs().max())
        assert ((x - t).abs() <= tol).all()


@pytest.mark.parametrize("d,offset", [(37, 0), (64, 1)])
def test_fused_retrieval_f32_kernels_take_unaligned_rows(device, d, offset):
    """f32 rows that are not 16-byte aligned (D % 4 != 0, or operands
    that start 4 bytes past an aligned address) are staged with 4-byte
    copies: the twin's f32 tolerance, as aligned rows."""
    from recommenders_tpu_torch.ops import fused_retrieval

    g = torch.Generator(device=device).manual_seed(3)
    b, c = 70, 200
    data = [torch.randn(n * d + offset, device=device, generator=g)
            * d ** -0.25 for n in (b, c)]
    kw = dict(temperature=0.3, sample_weight=torch.rand(
        b, device=device, generator=g) + 0.5)

    def run(fn):
        bases = [x.clone().requires_grad_(True) for x in data]
        q, cand = (x[offset:].view(n, d) for x, n in zip(bases, (b, c)))
        loss = fn(q, cand, **kw)
        loss.backward()
        return loss.detach(), bases[0].grad, bases[1].grad

    got = run(fused_retrieval.fused_retrieval_loss)
    assert all(x[offset:].data_ptr() % 16 != 0 for x in data) or d % 4
    want = run(fused_retrieval.fused_retrieval_loss_reference)
    assert abs(float(got[0] - want[0])) <= 1e-5 * abs(float(want[0]))
    for x, t in zip(got[1:], want[1:]):
        tol = 1e-5 * t.abs() + 1e-4 * float(t.abs().max())
        assert ((x - t).abs() <= tol).all()


# --- K4 and K5: probed leaf scoring ------------------------------------------
#
# Kernel and twin take the same products in f32 in another order (the query
# rounded to bf16 for int8 and int4, the scale after the dot), so a score
# agrees to D·2⁻²³·Σ|q||c||s| plus two roundings of the scale multiply; a
# K5 bucket's row must be equal wherever the twin's winner beats the
# bucket's best candidate of another row by more than twice that.

LEAF_FORMATS = ("f32", "bf16", "int8", "int4")
F32_EPS = 2.0 ** -23


def _leaf_case(fmt, num_leaves, cap, d, device, seed=0):
    """(stored leaves, scales, packed4, dequantized f32 leaves, rows)."""
    g = torch.Generator(device=device).manual_seed(seed)
    embs = torch.randn(num_leaves, cap, d, device=device, generator=g)
    rows = torch.randperm(num_leaves * cap, device=device, generator=g)
    rows = rows.view(num_leaves, cap).to(torch.int32)
    rows[:, -3:] = -1                                   # padding slots
    if fmt == "f32":
        return embs, None, False, embs, rows
    if fmt == "bf16":
        return embs.bfloat16(), None, False, embs.bfloat16().float(), rows
    bits = 4 if fmt == "int4" else 8
    scales, codes = quantization.quantize_rows_device(
        embs.view(-1, d), 0.2, bits=bits)
    scales = scales.view(num_leaves, cap)
    codes = codes.view(num_leaves, cap, d)
    deq = codes.float() * scales[..., None]
    if bits == 4:
        codes = quantization.pack_nibbles(codes)
    return codes, scales, bits == 4, deq, rows


def _scored(queries, scales):
    return queries.bfloat16().float() if scales is not None else queries


@pytest.mark.parametrize("fmt", LEAF_FORMATS)
@pytest.mark.parametrize("q,num_leaves,cap,d,p", [
    (16, 8, 256, 128, 3), (5, 6, 94, 40, 4), (7, 5, 130, 200, 2),
    # bf16 rows: 128-column stages up to D = 384, 64-column from D = 385
    (9, 5, 130, 384, 3), (9, 5, 130, 392, 3), (6, 4, 100, 512, 3),
])
def test_probed_leaf_kernel_matches_twin(device, fmt, q, num_leaves, cap, d,
                                         p):
    from recommenders_tpu_torch.ops import leaf_scoring

    leaves, scales, packed4, deq, _ = _leaf_case(fmt, num_leaves, cap, d,
                                                 device)
    g = torch.Generator(device=device).manual_seed(1)
    queries = torch.randn(q, d, device=device, generator=g)
    probes = torch.randint(0, num_leaves, (q, p), device=device, generator=g)
    probes[0, :2] = probes[0, 0]                       # a repeated probe
    before = dict(leaf_scoring.probed_leaf_scores.launches_by_format)
    got = leaf_scoring.probed_leaf_scores(queries, leaves, scales, probes,
                                          packed4=packed4)
    again = leaf_scoring.probed_leaf_scores(queries, leaves, scales, probes,
                                            packed4=packed4)
    torch.cuda.synchronize()
    after = leaf_scoring.probed_leaf_scores.launches_by_format
    assert after[fmt] == before[fmt] + 2
    assert torch.equal(got, again)
    want = leaf_scoring.probed_scores_reference(queries, leaves, scales,
                                                probes, packed4=packed4)
    abs_dot = leaf_scoring.probed_scores_reference(
        _scored(queries, scales).abs(), deq.abs(), None, probes)
    tol = d * F32_EPS * abs_dot + 2 * F32_EPS * want.abs()
    assert got.shape == (q, p * cap)
    assert ((got - want).abs() <= tol).all()


def test_probed_leaf_kernel_masks_out_of_range_probes(device):
    from recommenders_tpu_torch.ops import leaf_scoring

    leaves, _, _, _, _ = _leaf_case("f32", 4, 64, 32, device)
    queries = torch.randn(2, 32, device=device)
    probes = torch.tensor([[0, 4], [-1, 3]], device=device)
    got = leaf_scoring.probed_leaf_scores(queries, leaves, None, probes)
    torch.cuda.synchronize()
    assert (got[0, 64:] == leaf_scoring.MIN_FLOAT).all()
    assert (got[1, :64] == leaf_scoring.MIN_FLOAT).all()
    want = leaf_scoring.probed_scores_reference(
        queries[:1], leaves, None, probes[:1, :1])
    assert torch.allclose(got[:1, :64], want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fmt", LEAF_FORMATS)
@pytest.mark.parametrize("tiles,tile,num_leaves,cap,d,buckets,p", [
    (3, 1, 8, 256, 128, 128, 4),      # one query a tile, two groups a leaf
    (3, 8, 8, 384, 128, 256, 3),      # partial tail group
    (3, 70, 6, 94, 40, 40, 5),        # ragged D, cap, B; two query blocks
    (3, 64, 16, 1280, 128, 1280, 6),  # the served shape, one group a leaf
    # 80 blocks: the walk splits, and P = 29 (prime) is no multiple of
    # the split count
    (4, 64, 16, 1280, 128, 1280, 29),
    # bf16 rows: 128-column stages up to D = 384, 64-column from D = 385
    (3, 8, 6, 130, 384, 64, 5), (3, 8, 6, 130, 392, 64, 5),
    (3, 8, 5, 100, 512, 48, 4),
    # the catalog's T = 32 and the smoke's T = 64, cap no multiple of B
    # (three and two groups a leaf), few leaves: each probed by many tiles
    (8, 32, 12, 300, 128, 128, 7), (5, 64, 10, 200, 128, 96, 6),
])
def test_probed_bucketed_kernel_matches_twin(device, fmt, tiles, tile,
                                             num_leaves, cap, d, buckets, p):
    from recommenders_tpu_torch.ops import cuda_build
    from recommenders_tpu_torch.ops import leaf_scoring

    if p == 29:
        assert 1 < leaf_scoring.bucketed_splits(
            tiles, tile, buckets, p, cuda_build.sm_count(device)) < p
    leaves, scales, packed4, deq, rows = _leaf_case(fmt, num_leaves, cap, d,
                                                    device)
    g = torch.Generator(device=device).manual_seed(2)
    queries = torch.randn(tiles * tile, d, device=device, generator=g)
    probes = torch.randint(0, num_leaves, (tiles, p), device=device,
                           generator=g)
    probes[0, 1] = probes[0, 0]                    # adjacent duplicate
    probes = torch.sort(probes, dim=1).values.to(torch.int32)
    rows[probes[1, 0]] = -1                        # an empty probed leaf
    probes[2, 1] = -1                              # probes outside [0, L):
    probes[-1, -1] = num_leaves                    # skipped
    before = dict(leaf_scoring.probed_bucketed_scores.launches_by_format)
    vals, got_rows = leaf_scoring.probed_bucketed_scores(
        queries, leaves, scales, rows, probes, buckets, query_tile=tile,
        packed4=packed4)
    again = leaf_scoring.probed_bucketed_scores(
        queries, leaves, scales, rows, probes, buckets, query_tile=tile,
        packed4=packed4)
    torch.cuda.synchronize()
    after = leaf_scoring.probed_bucketed_scores.launches_by_format
    assert after[fmt] == before[fmt] + 2
    assert torch.equal(vals, again[0]) and torch.equal(got_rows, again[1])
    _check_bucketed(queries, *_with_empty_leaf(leaves, scales, deq, rows,
                                               probes), packed4=packed4,
                    buckets=buckets, tile=tile, vals=vals,
                    got_rows=got_rows)


def _with_empty_leaf(leaves, scales, deq, rows, probes):
    """(leaves, scales, deq, rows, probes) for the twin, which reads
    every probe: one more leaf, all padding, in place of each probe
    outside [0, L), which the kernel skips."""
    num_leaves = leaves.shape[0]
    outside = (probes < 0) | (probes >= num_leaves)
    pad = lambda t, v: torch.cat([t, torch.full_like(t[:1], v)])
    return (pad(leaves, 0), None if scales is None else pad(scales, 0),
            pad(deq, 0), pad(rows, -1),
            probes.masked_fill(outside, num_leaves))


def _check_bucketed(queries, leaves, scales, deq, rows, probes, packed4,
                    buckets, tile, vals, got_rows):
    """K5's result against its twin: scores within the bound, empty
    buckets MIN_FLOAT / -1, rows equal in every separated bucket."""
    from recommenders_tpu_torch.ops import leaf_scoring

    d = queries.shape[1]
    ref_v, ref_r = leaf_scoring.probed_bucketed_reference(
        queries, leaves, scales, rows, probes, buckets, query_tile=tile,
        packed4=packed4)
    cand, cand_rows = leaf_scoring.probed_bucket_candidates(
        queries, leaves, scales, rows, probes, buckets, query_tile=tile,
        packed4=packed4)
    abs_cand, _ = leaf_scoring.probed_bucket_candidates(
        _scored(queries, scales).abs(), deq.abs(), None, rows, probes,
        buckets, query_tile=tile)
    best = cand.argmax(dim=1, keepdim=True)
    abs_dot = torch.gather(abs_cand, 1, best).squeeze(1).clamp(min=0)
    tol = d * F32_EPS * abs_dot + 2 * F32_EPS * ref_v.abs()
    empty = ref_v <= leaf_scoring.MIN_FLOAT
    assert (vals[empty] == leaf_scoring.MIN_FLOAT).all()
    assert (got_rows[empty] == -1).all()
    assert ((vals - ref_v).abs()[~empty] <= tol[~empty]).all()
    # The runner-up is the best candidate of another row: a duplicate
    # probe repeats the winner's own slot.
    win_row = torch.gather(cand_rows, 1, best)
    runner_up = cand.masked_fill(cand_rows == win_row, leaf_scoring.MIN_FLOAT
                                 ).amax(dim=1)
    separated = (ref_v - runner_up > 2 * tol) & ~empty
    assert separated.sum() >= 0.9 * (~empty).sum()
    assert torch.equal(got_rows[separated], ref_r[separated])


@pytest.mark.parametrize("fmt", LEAF_FORMATS)
@pytest.mark.parametrize("cap,d", [(94, 40), (256, 128)])
def test_probed_leaf_kernel_splits_a_crowded_leaf_into_groups(device, fmt,
                                                              cap, d):
    """Every query probes leaf 2 first (200 pairs: four groups of at most
    64), some probe it twice, some probe outside [0, L): each span is the
    twin's, or MIN_FLOAT for the out-of-range probes."""
    from recommenders_tpu_torch.ops import leaf_scoring

    num_leaves, q, p = 6, 200, 4
    leaves, scales, packed4, deq, _ = _leaf_case(fmt, num_leaves, cap, d,
                                                 device)
    g = torch.Generator(device=device).manual_seed(4)
    queries = torch.randn(q, d, device=device, generator=g)
    probes = torch.randint(0, num_leaves, (q, p), device=device, generator=g)
    probes[:, 0] = 2
    probes[::3, 1] = 2                                  # repeated probes
    probes[1::7, 2] = -1                                # out of range
    probes[2::11, 3] = num_leaves
    got = leaf_scoring.probed_leaf_scores(queries, leaves, scales, probes,
                                          packed4=packed4)
    again = leaf_scoring.probed_leaf_scores(queries, leaves, scales, probes,
                                            packed4=packed4)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    outside = (probes < 0) | (probes >= num_leaves)
    safe = probes.masked_fill(outside, 0)
    want = leaf_scoring.probed_scores_reference(queries, leaves, scales,
                                                safe, packed4=packed4)
    abs_dot = leaf_scoring.probed_scores_reference(
        _scored(queries, scales).abs(), deq.abs(), None, safe)
    tol = d * F32_EPS * abs_dot + 2 * F32_EPS * want.abs()
    span = outside.repeat_interleave(cap, dim=1)
    assert (got[span] == leaf_scoring.MIN_FLOAT).all()
    assert ((got - want).abs()[~span] <= tol[~span]).all()


@pytest.mark.parametrize("fmt", LEAF_FORMATS)
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_probed_bucketed_first_maximum_wins_across_splits(device, monkeypatch,
                                                          fmt, splits):
    """All eight probed leaves hold the same codes and scales, so every
    bucket ties across the probes; the first probe's leaf must win
    however the walk is split and ordered (tile 1 lists its probes out of
    leaf order)."""
    from recommenders_tpu_torch.ops import leaf_scoring

    num_leaves, cap, d, buckets, tile = 8, 64, 128, 64, 64
    leaves, scales, packed4, deq, _ = _leaf_case(fmt, 1, cap, d, device)
    leaves = leaves.expand(num_leaves, *leaves.shape[1:]).contiguous()
    deq = deq.expand(num_leaves, cap, d)
    if scales is not None:
        scales = scales.expand(num_leaves, cap).contiguous()
    slots = torch.arange(cap, dtype=torch.int32, device=device)
    rows = torch.stack([(num_leaves - l) * cap + slots
                        for l in range(num_leaves)])
    probes = torch.tensor([list(range(num_leaves)), [5, 2, 7, 0, 3, 6, 1, 4]],
                          dtype=torch.int32, device=device)
    queries = torch.randn(2 * tile, d, device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(6))
    monkeypatch.setattr(leaf_scoring, "k5_splits", lambda *args: splits)
    vals, got_rows = leaf_scoring.probed_bucketed_scores(
        queries, leaves, scales, rows, probes, buckets, query_tile=tile,
        packed4=packed4)
    torch.cuda.synchronize()
    # One slot a bucket in each leaf: slot b of probe 0's leaf must win.
    assert torch.equal(got_rows[:tile], rows[0].expand(tile, buckets))
    assert torch.equal(got_rows[tile:], rows[5].expand(tile, buckets))
    ref_v, _ = leaf_scoring.probed_bucketed_reference(
        queries, leaves, scales, rows, probes, buckets, query_tile=tile,
        packed4=packed4)
    abs_cand, _ = leaf_scoring.probed_bucket_candidates(
        _scored(queries, scales).abs(), deq.abs().contiguous(), None, rows,
        probes, buckets, query_tile=tile)
    tol = d * F32_EPS * abs_cand.amax(dim=1) + 2 * F32_EPS * ref_v.abs()
    assert ((vals - ref_v).abs() <= tol).all()


def _leaf_rows(num_leaves, cap, device, g):
    """A `[L, cap]` int32 table of distinct global rows, padding at the
    end of every leaf."""
    rows = torch.randperm(num_leaves * cap, device=device, generator=g)
    rows = rows.view(num_leaves, cap).to(torch.int32)
    rows[:, -3:] = -1
    return rows


def _probed_f32_against_twins(queries, leaves, g, p, tile, buckets):
    """K4 and K5 with f32 rows, two launches each (bit-identical, counted
    as f32): K4's scores within D·2⁻²³·Σ|q||c| + 2ε|want| of the twin and
    of a float64 dot, K5's as `_check_bucketed` holds them."""
    from recommenders_tpu_torch.ops import leaf_scoring

    device = queries.device
    num_leaves, cap, d = leaves.shape
    q = queries.shape[0]
    probes = torch.randint(0, num_leaves, (q, p), device=device, generator=g)
    before = (leaf_scoring.probed_leaf_scores.launches_by_format["f32"],
              leaf_scoring.probed_bucketed_scores.launches_by_format["f32"])
    got = leaf_scoring.probed_leaf_scores(queries, leaves, None, probes)
    assert torch.equal(got, leaf_scoring.probed_leaf_scores(
        queries, leaves, None, probes))
    want = leaf_scoring.probed_scores_reference(queries, leaves, None,
                                                probes)
    picked = leaves[probes.long()].double()                 # [Q, P, cap, D]
    exact = torch.einsum("qd,qpcd->qpc", queries.double(), picked)
    abs_dot = torch.einsum("qd,qpcd->qpc", queries.double().abs(),
                           picked.abs())
    tol = (d * F32_EPS * abs_dot.reshape(q, -1) + 2 * F32_EPS * want.abs()
           + 1e-30)
    assert bool(torch.isfinite(got).all())
    assert ((got - want).abs() <= tol).all()
    assert ((got.double() - exact.reshape(q, -1)).abs() <= tol).all()

    rows = _leaf_rows(num_leaves, cap, device, g)
    tiles = q // tile
    tile_probes = torch.sort(probes[:tiles], dim=1).values.to(torch.int32)
    vals, got_rows = leaf_scoring.probed_bucketed_scores(
        queries, leaves, None, rows, tile_probes, buckets, query_tile=tile)
    again = leaf_scoring.probed_bucketed_scores(
        queries, leaves, None, rows, tile_probes, buckets, query_tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(vals, again[0]) and torch.equal(got_rows, again[1])
    after = (leaf_scoring.probed_leaf_scores.launches_by_format["f32"],
             leaf_scoring.probed_bucketed_scores.launches_by_format["f32"])
    assert after == (before[0] + 2, before[1] + 2)
    _check_bucketed(queries, leaves, None, leaves, rows, tile_probes, False,
                    buckets, tile, vals, got_rows)


@pytest.mark.parametrize("kind", ["ones", "residues", "spread", "subnormal"])
@pytest.mark.parametrize("d", [128, 512])
def test_probed_f32_kernels_on_adversarial_values(device, kind, d):
    """K4's and K5's split-precision f32 bodies on values that keep all
    three bf16 terms of every operand busy (at D = 128: 128-column stages;
    at D = 512: 32-column stages in a ring of two)."""
    g = torch.Generator(device=device).manual_seed(11)
    leaves = _adversarial_f32(kind, (6, 200, d), g, device)
    queries = _adversarial_f32(kind, (128, d), g, device)
    _probed_f32_against_twins(queries, leaves, g, p=3, tile=64, buckets=64)


@pytest.mark.parametrize("d,offset", [(37, 0), (64, 1), (300, 1)])
def test_probed_f32_kernels_take_unaligned_rows(device, d, offset):
    """f32 leaves whose rows are not 16-byte aligned (D % 8 != 0, or a
    table that starts 4 bytes past an aligned address) are staged by plain
    loads: the same tolerance as aligned rows."""
    g = torch.Generator(device=device).manual_seed(12)
    num_leaves, cap = 5, 130
    base = torch.randn(num_leaves * cap * d + offset, device=device,
                       generator=g)
    leaves = base[offset:].view(num_leaves, cap, d)
    assert leaves.is_contiguous()
    assert leaves.data_ptr() % 16 != 0 or d % 8
    queries = torch.randn(70, d, device=device, generator=g)
    _probed_f32_against_twins(queries, leaves, g, p=4, tile=35, buckets=40)


def test_probed_kernels_refuse_bad_inputs(device):
    from recommenders_tpu_torch.ops import leaf_scoring

    leaves, scales, _, _, rows = _leaf_case("int8", 4, 64, 32, device)
    queries = torch.randn(4, 32, device=device)
    probes = torch.zeros((4, 2), dtype=torch.int32, device=device)
    with pytest.raises(TypeError, match="scales must be float32"):
        leaf_scoring.probed_leaf_scores(queries, leaves, scales.double(),
                                        probes)
    with pytest.raises(ValueError, match="contiguous"):
        leaf_scoring.probed_bucketed_scores(
            queries, leaves.transpose(0, 1).contiguous().transpose(0, 1),
            scales, rows, probes[:1], 32, query_tile=4)
    with pytest.raises(ValueError, match="kernel limit"):
        leaf_scoring.probed_leaf_scores(
            torch.randn(1, 600, device=device),
            torch.zeros(2, 8, 600, device=device), None,
            torch.zeros((1, 1), dtype=torch.int32, device=device))


@pytest.mark.parametrize("settings", [
    dict(quantize="int8", num_reordering_candidates=40),
    dict(leaf_dtype=torch.bfloat16),
    dict(),                                     # f32 leaves (K4 f32)
    dict(scoring_buckets=256, probe_tile=8),    # f32 leaves (K5 f32)
    dict(quantize="int4", scoring_buckets=256, probe_tile=8,
         num_leaves_to_search=12),
])
def test_scann_kernel_path_matches_cpu_twin_path(device, settings):
    """The whole query path on the card (the kernels) against the same
    index copied to the CPU (the twins): equal id sets per query, or
    scores equal within the bound where ids differ by a tie."""
    from recommenders_tpu_torch.layers import approximate
    from recommenders_tpu_torch.utils import convert

    g = torch.Generator(device=device).manual_seed(3)
    centers = torch.randn(32, 128, device=device, generator=g) * 3
    pick = torch.randint(0, 32, (6000,), device=device, generator=g)
    corpus = centers[pick] + torch.randn(6000, 128, device=device,
                                         generator=g)
    queries = centers[pick[:40]] + torch.randn(40, 128, device=device,
                                               generator=g)
    kw = dict(dict(k=10, num_leaves=24, num_leaves_to_search=4,
                   training_iterations=4), **settings)
    card = approximate.ScaNN(device=device, **kw).index(corpus)
    host = convert.scann_state_from_numpy(
        approximate.ScaNN(device="cpu", **kw),
        convert.scann_state_to_numpy(card))
    cs, ci = card(queries)
    hs, hi = host(queries.cpu())
    cs, ci = cs.cpu(), ci.cpu()
    tol = 128 * F32_EPS * (queries.abs().amax() * corpus.abs().amax() * 128
                           ).cpu()
    for a, b, sa, sb in zip(ci, hi, cs, hs):
        if set(a.tolist()) != set(b.tolist()):
            assert ((sa - sb).abs() <= tol).all()


# --- K3, K4 and K5 as dispatcher ops, in eager calls and exports -----------

def test_serving_kernels_launch_through_the_dispatcher_ops(device):
    """The wrappers launch K3, K4 and K5 through
    `torch.ops.recommenders_tpu_torch.*`; the op library counts each
    launch by op and format; an op given CPU tensors finds no kernel
    (the CPU takes the plain twins before an op is reached)."""
    from recommenders_tpu_torch.ops import cuda_build, leaf_scoring

    op = scoring._op()
    leaf_op, bucketed_op = leaf_scoring._ops()
    assert op is torch.ops.recommenders_tpu_torch.bucketed_scores
    assert leaf_op is torch.ops.recommenders_tpu_torch.probed_leaf_scores
    assert (bucketed_op
            is torch.ops.recommenders_tpu_torch.probed_bucketed_scores)
    cuda_build.reset_op_launches()
    before = scoring.bucketed_scores.launches_by_format["int8"]
    by_tile = dict(scoring.bucketed_scores.launches_by_int8_tile)
    cuda_build.k3_fold_counts(reset=True)
    q, codes, scales, _, _ = _inputs("int8", 64, 4096, 128, device)
    scoring.bucketed_scores(q, codes, scales, buckets=512, chunk=512,
                            query_tile=64)
    assert scoring.bucketed_scores.launches_by_format["int8"] == before + 1
    assert cuda_build.op_launches()["bucketed_scores"]["int8"] == 1
    # 64 queries take the 64-query instance; a walk of 8 groups never
    # reaches the fast fold.
    by_tile[64] += 1
    assert scoring.bucketed_scores.launches_by_int8_tile == by_tile
    assert cuda_build.k3_fold_counts() == {"checked": 0, "updated": 0}
    with pytest.raises(RuntimeError):
        op(q.bfloat16().cpu(), codes.cpu(), scales.cpu(), 1, 512, 4096,
           64, 1, scoring.MIN_FLOAT)


def _export_trial(tmp_path, index, queries, k=10):
    from recommenders_tpu_torch.ops import cuda_build
    from recommenders_tpu_torch.utils import export

    path = str(tmp_path / "export")
    export.export_index(path, index, queries, k)
    assert export.read_manifest(path)["ops"]
    program = export.load_program(path)
    targets = {str(n.target) for n in program.graph.nodes}
    assert any(t.startswith("recommenders_tpu_torch.") for t in targets)
    want = index(queries)
    cuda_build.reset_op_launches()    # count the loaded program's alone
    got = export.load_index(path)(queries)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return path, cuda_build.op_launches()


def test_exported_bucketed_index_runs_k3_and_equals_the_index(device,
                                                              tmp_path):
    from recommenders_tpu_torch.layers import factorized_top_k

    g = torch.Generator(device=device).manual_seed(1)
    corpus = torch.randn(8192, 128, device=device, generator=g)
    queries = torch.randn(64, 128, device=device, generator=g)
    index = factorized_top_k.Bucketed(k=10, buckets=512, chunk=1024,
                                      quantize="int8",
                                      device=device).index(corpus)
    launches_before = scoring.bucketed_scores.launches
    _, counts = _export_trial(tmp_path, index, queries)
    assert counts["bucketed_scores"]["int8"] == 1   # load_index's call
    # Tracing launched nothing: only the eager comparison call counts.
    assert scoring.bucketed_scores.launches == launches_before + 1


@pytest.mark.parametrize("settings,op", [
    (dict(quantize="int8", scoring_buckets=256, probe_tile=8),
     "probed_bucketed_scores"),
    (dict(quantize="int8", num_reordering_candidates=40),
     "probed_leaf_scores"),
])
def test_exported_scann_runs_k4_or_k5_and_equals_the_index(
        device, tmp_path, settings, op):
    from recommenders_tpu_torch.layers import approximate

    g = torch.Generator(device=device).manual_seed(2)
    corpus = torch.randn(6000, 128, device=device, generator=g)
    queries = torch.randn(32, 128, device=device, generator=g)
    index = approximate.ScaNN(k=10, num_leaves=16, num_leaves_to_search=4,
                              device=device, **settings).index(corpus)
    _, counts = _export_trial(tmp_path, index, queries)
    assert counts[op]["int8"] >= 1


def test_serving_host_runs_a_cuda_package_bit_equal_to_python(device,
                                                              tmp_path):
    """The C++ host on the package of a Bucketed int8 export: bit-equal
    to the package in Python, K3 launched inside it."""
    from recommenders_tpu_torch.layers import factorized_top_k
    from recommenders_tpu_torch.utils import native_serving as ns

    g = torch.Generator(device=device).manual_seed(4)
    corpus = torch.randn(8192, 128, device=device, generator=g)
    queries = torch.randn(64, 128, device=device, generator=g)
    index = factorized_top_k.Bucketed(k=10, buckets=512, chunk=1024,
                                      quantize="int8",
                                      device=device).index(corpus)
    path, _ = _export_trial(tmp_path, index, queries)
    result = ns.serve_exported_index(path, queries, repeat=3)
    want = ns.load_package(path)(
        queries, *[a.to(device) for a in ns.host_arguments(path)])
    for got, ref in zip(result.outputs, want):
        assert torch.equal(got, ref.cpu())
    assert result.launches["bucketed_scores"]["int8"] == 3
