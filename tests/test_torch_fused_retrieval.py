"""K2's plain twin against the JAX package's fused loss, on the CPU.

`ops/fused_retrieval.fused_retrieval_loss_reference` (the port's twin of
the CUDA kernels, differentiated by autograd) against JAX's Pallas
kernels in interpret mode (16 × 16 tiles, as `tests/test_fused_retrieval.py`
runs them) and against JAX's own reference under `jax.value_and_grad`,
on the same NumPy inputs, for every knob the fused loss takes.

Tolerances: the loss to rtol 1e-5 (f32 sums in another order; the
kernel's online log-sum-exp). Grads, whose elements are sums of C terms
taken in another order, to an absolute error at the scale of the
largest grad: rtol 1e-3 / atol 1e-4·max|grad| against the kernel (its
tile-wise sums, as the JAX test allows) and rtol 1e-5 / atol
1e-5·max|grad| against the reference. With bf16 `score_dtype` the JAX
kernel also rounds the backward's probability coefficients to bf16
(~2⁻⁹ relative), so its grads are held to rtol 2e-2 / atol
2e-3·max|grad| there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.ops import fused_retrieval as jax_fused
from recommenders_tpu_torch.ops import fused_retrieval

KNOBS = [
    dict(),
    dict(temperature=0.2),
    dict(logq=True),
    dict(hits=True),
    dict(weights=True),
    dict(temperature=0.7, logq=True, hits=True, weights=True),
]


def _data(seed=0, b=32, c=48, d=64):
    rng = np.random.RandomState(seed)
    return dict(
        q=rng.normal(size=(b, d)).astype(np.float32),
        c=rng.normal(size=(c, d)).astype(np.float32),
        ids=rng.randint(0, 10, size=(c,)).astype(np.int32),
        probs=rng.uniform(0.01, 1.0, size=(c,)).astype(np.float32),
        w=rng.uniform(0.1, 2.0, size=(b,)).astype(np.float32),
    )


def _kwargs(knobs, data, to):
    kw = {}
    if "temperature" in knobs:
        kw["temperature"] = knobs["temperature"]
    if knobs.get("logq"):
        kw["candidate_sampling_probability"] = to(data["probs"])
    if knobs.get("hits"):
        kw["remove_accidental_hits"] = True
        kw["candidate_ids"] = to(data["ids"])
    if knobs.get("weights"):
        kw["sample_weight"] = to(data["w"])
    return kw


def _jax_value_and_grads(fn, data, knobs, **extra):
    kw = _kwargs(knobs, data, jnp.asarray)
    loss, (dq, dc) = jax.value_and_grad(
        lambda q, c: fn(q, c, **kw, **extra), (0, 1)
    )(jnp.asarray(data["q"]), jnp.asarray(data["c"]))
    return float(loss), np.asarray(dq), np.asarray(dc)


def port_value_and_grads(data, knobs, fn=None, **extra):
    fn = fn or fused_retrieval.fused_retrieval_loss_reference
    q = torch.from_numpy(data["q"]).requires_grad_(True)
    c = torch.from_numpy(data["c"]).requires_grad_(True)
    loss = fn(q, c, **_kwargs(knobs, data, torch.from_numpy), **extra)
    loss.backward()
    return float(loss.detach()), q.grad.numpy(), c.grad.numpy()


def _assert_close(got, want, loss_rtol, rtol, atol):
    """Loss to `loss_rtol`; grads to `rtol` and `atol` times the grad's
    largest magnitude (sums of C terms reordered: an absolute error at
    the scale of the largest terms)."""
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol * np.abs(w).max())


@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("b,c", [(32, 48), (32, 32)])
def test_twin_matches_jax_kernel_and_reference(knobs, b, c):
    data = _data(b=b, c=c)
    got = port_value_and_grads(data, knobs)
    kernel = _jax_value_and_grads(jax_fused.fused_retrieval_loss, data,
                                  knobs, interpret=True, block_q=16,
                                  block_c=16)
    reference = _jax_value_and_grads(
        jax_fused.fused_retrieval_loss_reference, data, knobs)
    _assert_close(got, kernel, 1e-5, 1e-3, 1e-4)
    _assert_close(got, reference, 1e-5, 1e-5, 1e-5)


@pytest.mark.parametrize("knobs", [KNOBS[0], KNOBS[-1]])
def test_bf16_score_dtype(knobs):
    data = _data(seed=1)
    got = port_value_and_grads(data, knobs, score_dtype=torch.bfloat16)
    reference = _jax_value_and_grads(
        jax_fused.fused_retrieval_loss_reference, data, knobs,
        score_dtype=jnp.bfloat16)
    kernel = _jax_value_and_grads(
        jax_fused.fused_retrieval_loss, data, knobs, interpret=True,
        block_q=16, block_c=16, score_dtype=jnp.bfloat16)
    # The grads pass through the cast to bf16, whose rounding flips by
    # one bf16 ulp (≤ 2⁻⁷ relative) where the f32 grads differ in their
    # last bits.
    _assert_close(got, reference, 1e-5, 2.0**-7, 1e-5)
    _assert_close(got, kernel, 1e-5, 2e-2, 2e-3)


def test_wrapper_runs_the_twin_on_cpu_tensors():
    data = _data(seed=2)
    knobs = KNOBS[-1]
    before = fused_retrieval.fused_retrieval_loss.launches
    got = port_value_and_grads(data, knobs,
                               fn=fused_retrieval.fused_retrieval_loss)
    want = port_value_and_grads(data, knobs)
    assert fused_retrieval.fused_retrieval_loss.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rejects_bad_inputs():
    q = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="candidate ids"):
        fused_retrieval.fused_retrieval_loss(q, q,
                                             remove_accidental_hits=True)
    with pytest.raises(ValueError, match="2D"):
        fused_retrieval.fused_retrieval_loss(torch.zeros(8, 2, 16), q)
    with pytest.raises(ValueError, match="C >= B"):
        fused_retrieval.fused_retrieval_loss(q, torch.zeros(4, 16))
