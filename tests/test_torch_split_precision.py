"""The numerics of K3's f32 body, on the CPU: its split-precision model.

The CUDA body (`csrc/bucketed_scores.cu`) splits each f32 query and corpus
value into three bf16 terms, x = h + m + l (`tc::split3`), and sums six of
the nine term products (hh, hm, mh, hl, lh, mm), each exact in f32, on the
tensor cores. `ops/scoring.py` models that split in plain PyTorch
(`split3`, `split_scores`, `split_error_bound`). Here, against float64:

  - the terms are bf16 values that rebuild x exactly in the normal range,
    and miss it by at most 2⁻¹³⁴ below 2⁻¹¹⁰;
  - the split dot stays within the source note's bound of a float64 dot
    on adversarial inputs (all-ones mantissas, mantissas whose m and l
    terms are as large as rounding allows, exponents spread from 2⁻⁶⁰ to
    2⁶⁰, subnormals) at D = 128 and 768;
  - that bound plus the plain twin's f32 error fits in the tolerance the
    kernel is held to on the card, D·2⁻²³·Σ|q||c| (plus 1e-30).

The port's f32 twin is also held against the JAX package's bucketed
scoring (its Pallas kernel in interpret mode) on one such input.
"""

import numpy as np
import pytest
import torch

from recommenders_tpu.ops import scoring as jax_scoring
from recommenders_tpu_torch.ops import scoring

F32_EPS = 2.0 ** -23
# The GPU tests' absolute term (tests/test_torch_cuda_kernels.py).
ABS_TOL = 1e-30
KINDS = ("ones", "residues", "spread", "subnormal")


def _exponents(rng, shape, lo, hi):
    return np.exp2(rng.integers(lo, hi + 1, shape)).astype(np.float64)


def _values(kind, shape, rng, lo=-4, hi=4):
    """f32 values of one adversarial kind (NumPy)."""
    sign = rng.choice([-1.0, 1.0], shape)
    if kind == "ones":
        # All 24 significant bits set: x = (2 − 2⁻²³)·2ᵉ.
        x = sign * (2 - 2.0**-23) * _exponents(rng, shape, lo, hi)
    elif kind == "residues":
        # x = h + m + l with m and l as large as rounding to nearest lets
        # them be (|m| just under half an ulp of h, |l| just under half an
        # ulp of m), all of one sign, so the dropped products add up.
        h = 1 + rng.integers(0, 32, shape) * 2.0**-7
        m = 2.0**-8 - 2.0**-16
        l = 2.0**-17 - 2.0**-23
        x = (h + m + l) * _exponents(rng, shape, lo, hi)
    elif kind == "spread":
        x = (sign * rng.uniform(1, 2, shape)
             * _exponents(rng, shape, -60, 60))
    elif kind == "subnormal":
        # Half the values below 2⁻¹¹⁰, many of them f32 subnormals.
        tiny = rng.integers(-149, -110, shape)
        x = sign * rng.uniform(1, 2, shape) * np.where(
            rng.random(shape) < 0.5, np.exp2(tiny),
            _exponents(rng, shape, lo, hi))
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


def _problem(kind, d, seed=0, q=8, n=48):
    """Queries and corpus rows of one kind; for `spread`, each corpus
    value's exponent is capped so no product passes 2¹⁰⁰ (sums of D of
    them stay finite in f32)."""
    rng = np.random.default_rng(seed)
    queries = _values(kind, (q, d), rng)
    corpus = _values(kind, (n, d), rng)
    if kind == "spread":
        cap = np.exp2(100 - np.ceil(np.log2(np.abs(queries).max(0))))
        corpus = np.clip(corpus, -cap, cap).astype(np.float32)
    if kind == "subnormal":
        # Normal partners: the tiny values' misses stay far below 1e-30.
        corpus = _values("ones", (n, d), rng)
    return torch.from_numpy(queries), torch.from_numpy(corpus)


def _abs_dot(q, c):
    return q.double().abs() @ c.double().abs().T


@pytest.mark.parametrize("kind", KINDS)
def test_split_terms_are_bf16_and_rebuild_the_value(kind):
    x = _problem(kind, 128)[0].flatten()
    h, m, l = scoring.split3(x)
    for t in (h, m, l):
        assert torch.equal(t.to(torch.bfloat16).to(torch.float32), t)
    err = (h.double() + m.double() + l.double() - x.double()).abs()
    normal = x.abs() >= scoring.SPLIT_TINY
    assert bool(normal.any())
    assert float(err[normal].max()) == 0.0
    assert float(err.max()) <= scoring.SPLIT_ABS_BOUND
    ax = x[normal].double().abs()
    assert (m[normal].double().abs() <= (1 + 2.0**-8) * 2.0**-8 * ax).all()
    assert (l[normal].double().abs() <= 2.0**-16 * ax).all()
    if kind == "subnormal":
        assert bool((err > 0).any())   # the subnormal grid is reached


def test_residue_values_split_into_their_construction():
    """The `residues` kind really has m and l at their largest."""
    x = _problem("residues", 128)[0].flatten()
    h, m, l = scoring.split3(x)
    assert (m.double().abs() / x.double().abs() > 2.0**-9).all()
    assert (l.double().abs() / x.double().abs() > 2.0**-18).all()


@pytest.mark.parametrize("d", [128, 768])
@pytest.mark.parametrize("kind", KINDS)
def test_split_dot_within_its_bound_of_a_float64_dot(kind, d):
    q, c = _problem(kind, d)
    exact = q.double() @ c.double().T
    got = scoring.split_scores(q, c)
    # float64's own rounding of both sums, far below the bound.
    slack = 2 * d * 2.0**-53 * _abs_dot(q, c)
    bound = scoring.split_error_bound(q, c)
    err = (got - exact).abs()
    assert (err <= bound + slack).all()
    if kind == "residues":
        # One-signed dropped terms: the bound is reached within 4x.
        assert float((err / bound).max()) > 0.25


@pytest.mark.parametrize("d", [128, 768])
def test_split_bound_and_twin_error_fit_the_tolerance(d):
    """A priori: the split's relative bound and the twin's f32 dot
    (γ_D = D·u/(1 − D·u), u = 2⁻²⁴) stay inside D·2⁻²³ units."""
    u = 2.0**-24
    gamma = d * u / (1 - d * u)
    assert scoring.SPLIT_REL_BOUND + gamma <= d * F32_EPS
    # The split's share: 1.006 units of 2⁻²³, 1/D of the tolerance.
    assert scoring.SPLIT_REL_BOUND <= 1.006 * F32_EPS


@pytest.mark.parametrize("d", [128, 768])
@pytest.mark.parametrize("kind", KINDS)
def test_split_and_twin_errors_fit_the_tolerance_on_adversarial_inputs(
        kind, d):
    q, c = _problem(kind, d)
    exact = q.double() @ c.double().T
    abs_dot = _abs_dot(q, c)
    twin = scoring.reference_scores(q, c).double()
    assert bool(torch.isfinite(twin).all())
    split_err = scoring.split_error_bound(q, c)
    twin_err = (twin - exact).abs()
    assert (twin_err <= d * 2.0**-24 * abs_dot + ABS_TOL).all()
    assert (split_err + twin_err <= d * F32_EPS * abs_dot + ABS_TOL).all()
    got = scoring.split_scores(q, c)
    assert ((got - twin).abs() <= d * F32_EPS * abs_dot + ABS_TOL).all()


@pytest.mark.parametrize("kind", ["residues", "ones"])
def test_f32_twin_matches_the_jax_kernel_on_adversarial_inputs(kind):
    """The port's f32 twin against the JAX package's bucketed scoring
    (Pallas, interpret mode): values within D·2⁻²³·Σ|q||c| of the
    winner, rows equal wherever the winner is separated by twice that."""
    d, buckets, chunk, valid = 128, 256, 512, 2000
    q, c = _problem(kind, d, seed=3, q=16, n=2048)
    want_v, want_r = jax_scoring.bucketed_scores(
        q.numpy(), c.numpy(), buckets=buckets, chunk=chunk, query_tile=16,
        interpret=True, valid_rows=valid)
    got_v, got_r = scoring.bucketed_scores(
        q, c, buckets=buckets, chunk=chunk, query_tile=16, valid_rows=valid)
    want_v = torch.from_numpy(np.array(want_v))
    want_r = torch.from_numpy(np.array(want_r)).long()
    tol = d * F32_EPS * _abs_dot(q, c)
    tol_win = torch.gather(tol, 1, got_r.long()).float()
    assert ((got_v - want_v).abs() <= tol_win).all()
    scores = (q.double() @ c.double().T)
    scores[:, valid:] = -np.inf
    top2 = scores.view(16, -1, buckets).topk(2, dim=1).values
    separated = (top2[:, 0] - top2[:, 1]) > 2 * tol_win.double()
    assert float(separated.double().mean()) >= 0.9
    assert torch.equal(got_r.long()[separated], want_r[separated])
