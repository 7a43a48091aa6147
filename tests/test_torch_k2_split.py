"""The numerics of K2's f32-score bodies, on the CPU: their split model.

With f32 scores the CUDA kernels (`csrc/fused_retrieval.cu`) take both
products of every body in split precision: each f32 operand as three
bf16 terms x = h + m + l (`tc::split3`) and six of the nine term products
(hh, hm, mh, hl, lh, mm), each exact in f32, on the tensor cores; the
score product q·cᵀ and the coefficient product, P·c (dq) and (P∘w)ᵀ·q
(dc), whose f32 coefficients are split in registers.
`ops/fused_retrieval.split_model` is that arithmetic in float64, with a
bound on its distance from the exact loss and gradients. Here, against
float64 autograd of the loss, on adversarial inputs (all-ones mantissas,
m and l terms as large as rounding allows and of one sign, exponents
spread over 2⁻⁴⁰ … 2⁻¹, subnormals), at B = 40, C = 64, D ∈ {36, 64},
without and with every knob of the fused loss:

  - the model stays within its bound;
  - that bound plus the plain twin's own f32 error fits the tolerance the
    kernels are held to against the twin on the card (the loss to rtol
    1e-5; dq and dc to 1e-5 relative plus 1e-4 of their largest
    magnitude), and so does the model's distance from the twin.

The values sit at scales where scores are of order 1-10, as a softmax
takes them: the split's error scales with the values, and the mantissa
patterns, not the exponents, are what make it large. The port's f32 twin
is also held against the JAX package's fused loss (its Pallas kernels in
interpret mode, and its reference) on one such input.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.ops import fused_retrieval as jax_fused
from recommenders_tpu_torch.layers import loss as loss_layers
from recommenders_tpu_torch.ops import fused_retrieval
from torch_threads import torch_threads  # noqa: F401 (autouse)

KINDS = ("ones", "residues", "spread", "subnormal")
TEMPERATURE = 0.2
B, C = 40, 64
# float64's own rounding in the model and the exact sums, far below any
# bound: a share of the magnitudes summed.
SLACK = 2.0**-40


def _values(kind, shape, rng):
    """f32 values of one adversarial kind (NumPy), of magnitude ≤ 1."""
    sign = rng.choice([-1.0, 1.0], shape)
    exps = lambda lo, hi: np.exp2(rng.integers(lo, hi + 1, shape))
    if kind == "ones":
        # All 24 significant bits set: x = (2 − 2⁻²³)·2ᵉ.
        x = sign * (2 - 2.0**-23) * exps(-5, -1)
    elif kind == "residues":
        # m just under half an ulp of h, l just under half an ulp of m,
        # all of one sign, so the dropped term products add up.
        h = 1 + rng.integers(0, 32, shape) * 2.0**-7
        x = (h + (2.0**-8 - 2.0**-16) + (2.0**-17 - 2.0**-23)) * exps(-5, -1)
    elif kind == "spread":
        x = sign * rng.uniform(1, 2, shape) * exps(-40, -1)
    elif kind == "subnormal":
        # Half the values below 2⁻¹¹⁰, many of them f32 subnormals.
        tiny = np.exp2(rng.integers(-149, -110, shape))
        x = sign * rng.uniform(1, 2, shape) * np.where(
            rng.random(shape) < 0.5, tiny, exps(-5, -1))
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


def _problem(kind, d, knobs, seed=0):
    rng = np.random.default_rng(seed)
    data = dict(q=_values(kind, (B, d), rng), c=_values(kind, (C, d), rng))
    kw = {}
    if knobs == "all":
        kw = dict(
            temperature=TEMPERATURE,
            candidate_sampling_probability=rng.uniform(
                0.01, 1.0, C).astype(np.float32),
            remove_accidental_hits=True,
            candidate_ids=rng.integers(0, 16, C).astype(np.int32),
            sample_weight=rng.uniform(0.1, 2.0, B).astype(np.float32),
        )
    return data, kw


def _torch_kw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _value_and_grads(fn, data, kw, dtype=torch.float32):
    q = torch.from_numpy(data["q"]).to(dtype).requires_grad_(True)
    c = torch.from_numpy(data["c"]).to(dtype).requires_grad_(True)
    loss = fn(q, c, **_torch_kw(kw))
    loss.backward()
    return loss.detach().double(), q.grad.double(), c.grad.double()


def _exact(q, c, sample_weight=None, candidate_sampling_probability=None,
           candidate_ids=None, temperature=None,
           remove_accidental_hits=False):
    """The fused loss's function in float64 (f32 inputs), written out."""
    s = q @ c.T
    if temperature is not None:
        s = s / float(torch.tensor(temperature, dtype=torch.float32))
    if candidate_sampling_probability is not None:
        s = s - torch.log(torch.clamp(candidate_sampling_probability,
                                      1e-6, 1.0)).double()
    y = torch.eye(q.shape[0], c.shape[0], dtype=torch.float64)
    if remove_accidental_hits:
        dup = candidate_ids[:q.shape[0], None] == candidate_ids[None, :]
        s = s + (dup.double() - y) * loss_layers.MIN_FLOAT
    per_example = -torch.sum(y * torch.log_softmax(s, dim=-1), dim=-1)
    if sample_weight is not None:
        per_example = per_example * sample_weight.double()
    return per_example.sum()


def _magnitudes(data, kw):
    """Σ|terms| of the loss and of every dq / dc element (float64, exact
    coefficients): the scales of float64's own rounding."""
    q = torch.from_numpy(data["q"]).double()
    c = torch.from_numpy(data["c"]).double()
    t = torch.tensor(kw.get("temperature", 1.0), dtype=torch.float32)
    s = (q @ c.T) / float(t)
    p = torch.softmax(s, dim=1)
    w = (torch.from_numpy(kw["sample_weight"]).double()
         if "sample_weight" in kw else torch.ones(B, dtype=torch.float64))
    coef = (p + torch.eye(B, C, dtype=torch.float64)) / float(t)
    loss = float((w.abs() * (s.abs().max(1).values + np.log(C))).sum())
    return (loss, w.abs()[:, None] * (coef @ c.abs()),
            (coef * w.abs()[:, None]).T @ q.abs())


@functools.lru_cache(maxsize=None)
def _case(kind, d, knobs):
    """(data, kw, the split model, the float64 loss and grads) of one
    problem, shared by the tests below."""
    data, kw = _problem(kind, d, knobs)
    model = fused_retrieval.split_model(
        torch.from_numpy(data["q"]), torch.from_numpy(data["c"]),
        **_torch_kw(kw))
    return data, kw, model, _value_and_grads(_exact, data, kw, torch.float64)


@pytest.mark.parametrize("knobs", ["none", "all"])
@pytest.mark.parametrize("d", [36, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_split_model_within_its_bound_of_float64(kind, d, knobs):
    data, kw, model, exact = _case(kind, d, knobs)
    scales = _magnitudes(data, kw)
    for got, want, bound, scale in zip(
            (model.loss, model.dq, model.dc), exact,
            (model.loss_bound, model.dq_bound, model.dc_bound), scales):
        assert bool(torch.isfinite(got).all())
        assert bool(torch.isfinite(bound).all())
        err = (got - want).abs()
        assert bool((err <= bound + SLACK * scale + 1e-300).all()), (
            float((err - bound).max()))
    # The split is really lossy on these inputs: the model is not the
    # exact function.
    assert not torch.equal(model.dq, exact[1])


@pytest.mark.parametrize("knobs", ["none", "all"])
@pytest.mark.parametrize("d", [36, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_split_bound_and_twin_error_fit_the_card_tolerance(kind, d, knobs):
    """The kernel is held to the twin on the card: the split's bound plus
    the twin's own distance from the exact function must fit that
    tolerance, or a right kernel could fail it; the model must meet it."""
    data, kw, model, exact = _case(kind, d, knobs)
    twin = _value_and_grads(
        fused_retrieval.fused_retrieval_loss_reference, data, kw)
    assert all(bool(torch.isfinite(t).all()) for t in twin)
    loss_tol = 1e-5 * twin[0].abs()
    assert model.loss_bound + (twin[0] - exact[0]).abs() <= loss_tol
    assert (model.loss - twin[0]).abs() <= loss_tol
    for got, want, bound, t in ((model.dq, exact[1], model.dq_bound,
                                 twin[1]),
                                (model.dc, exact[2], model.dc_bound,
                                 twin[2])):
        tol = 1e-5 * t.abs() + 1e-4 * t.abs().max()
        assert bool((bound + (t - want).abs() <= tol).all())
        assert bool(((got - t).abs() <= tol).all())


def test_f32_twin_matches_the_jax_kernel_on_an_adversarial_input():
    """The port's f32 twin against the JAX package's fused loss (Pallas
    in interpret mode, 16 × 16 tiles, and its reference), every knob, on
    `residues` values: the tolerances of
    `tests/test_torch_fused_retrieval.py`."""
    data, kw = _problem("residues", 64, "all", seed=3)
    data = dict(q=data["q"][:32], c=data["c"][:48])
    kw["sample_weight"] = kw["sample_weight"][:32]
    kw["candidate_sampling_probability"] = (
        kw["candidate_sampling_probability"][:48])
    kw["candidate_ids"] = kw["candidate_ids"][:48]
    got = _value_and_grads(
        fused_retrieval.fused_retrieval_loss_reference, data, kw)

    def jax_value_and_grads(fn, **extra):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        loss, grads = jax.value_and_grad(
            lambda q, c: fn(q, c, **jkw, **extra), (0, 1))(
                jnp.asarray(data["q"]), jnp.asarray(data["c"]))
        return (float(loss),) + tuple(np.asarray(g) for g in grads)

    kernel = jax_value_and_grads(jax_fused.fused_retrieval_loss,
                                 interpret=True, block_q=16, block_c=16)
    reference = jax_value_and_grads(jax_fused.fused_retrieval_loss_reference)
    for want, rtol, atol in ((kernel, 1e-3, 1e-4), (reference, 1e-5, 1e-5)):
        np.testing.assert_allclose(float(got[0]), want[0], rtol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                       atol=atol * np.abs(w).max())
