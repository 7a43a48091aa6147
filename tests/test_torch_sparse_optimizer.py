"""The port's sparse optimizers against the JAX package's, on the CPU.

`dedupe_sum` (with and without `max_unique`), `init_slots`, the scatter
path of `apply_sparse` for all six kinds and its kernel path (the K1
twin on CPU tensors) for the five kernel kinds, each fed the same NumPy
inputs as the JAX function.

Tolerances: `dedupe_sum` sums in the same sequential order as XLA's
scatter-add, so it is bit-equal; `init_slots` is exact. The updates are
held at f32 tolerance (rtol 1e-5, atol 1e-6): the rules' `rsqrt`, `pow`
and row means differ by an ulp between XLA's CPU code and PyTorch's
(see `test_torch_sparse_apply.py`), and JAX's kernel path routes grads
through a bf16 hi + lo split (~2⁻¹⁶ relative to each grad, so about
1e-5 absolute on these O(1) rows after cancellation), and ftrl's σ
cancellation scales ulps by |w| / lr: atol 1e-4 for both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.embedding import config as jax_config
from recommenders_tpu.embedding import sparse_optimizer as jax_opt
from recommenders_tpu_torch.embedding import config
from recommenders_tpu_torch.embedding import sparse_optimizer as opt
from torch_threads import torch_threads  # noqa: F401 (autouse)

V, D, N = 64, 8, 48
PAD = config.PAD_ID


def _spec_args(name):
    return {
        "sgd": dict(kind="sgd", learning_rate=0.3),
        "adagrad": dict(kind="adagrad", learning_rate=0.2,
                        initial_accumulator_value=0.1),
        "rowwise_adagrad": dict(kind="rowwise_adagrad", learning_rate=0.2,
                                initial_accumulator_value=0.1),
        "adam": dict(kind="adam", learning_rate=0.05),
        "ftrl": dict(kind="ftrl", learning_rate=0.1,
                     l1_regularization_strength=0.01,
                     l2_regularization_strength=0.02),
        "clippy": dict(kind="clippy", learning_rate=0.5,
                       variable_relative_threshold=0.05),
    }[name]


def _specs(name):
    if name == "schedule":
        return (
            jax_config.OptimizerSpec(
                kind="adagrad",
                learning_rate=lambda s: 0.5 / (1.0 + s.astype(jnp.float32))),
            config.OptimizerSpec(
                kind="adagrad",
                learning_rate=lambda s: 0.5 / (1.0 + s.to(torch.float32))),
        )
    args = _spec_args(name)
    return jax_config.OptimizerSpec(**args), config.OptimizerSpec(**args)


def _problem(seed, n=N, v=V, d=D):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, v, size=n).astype(np.int32)
    ids[: n // 4] = ids[rng.randint(0, n, n // 4)]  # duplicates
    ids[-3:] = PAD
    grads = rng.normal(size=(n, d)).astype(np.float32)
    grads[ids == PAD] = 0.0
    table = rng.normal(size=(v, d)).astype(np.float32)
    return ids, grads, table


@pytest.mark.parametrize("max_unique", [None, 64, 20])
def test_dedupe_sum_bit_equal(max_unique):
    ids, grads, _ = _problem(0)
    want_ids, want_g = jax_opt.dedupe_sum(
        jnp.asarray(ids), jnp.asarray(grads), max_unique)
    got_ids, got_g = opt.dedupe_sum(
        torch.from_numpy(ids), torch.from_numpy(grads), max_unique)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    if max_unique == 20:
        # The largest ids' updates are the ones dropped.
        kept = got_ids.numpy()
        real = np.unique(ids[ids != PAD])
        np.testing.assert_array_equal(kept, real[:20])


@pytest.mark.parametrize("name", ["sgd", "adagrad", "rowwise_adagrad",
                                  "adam", "ftrl", "clippy"])
def test_init_slots_match(name):
    jspec, tspec = _specs(name)
    table = np.zeros((V, D), np.float32)
    want = jax_opt.init_slots(jspec, jnp.asarray(table))
    got = opt.init_slots(tspec, torch.from_numpy(table))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    bf16 = opt.init_slots(tspec, torch.from_numpy(table), torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in bf16.values())


def _apply_both(name, max_unique, use_kernel, jax_use_kernel, step=3,
                seed=0):
    jspec, tspec = _specs(name)
    ids, grads, table = _problem(seed)
    jslots = jax_opt.init_slots(jspec, jnp.asarray(table))
    t_want, s_want = jax_opt.apply_sparse(
        jspec, jnp.asarray(table), dict(jslots), jnp.asarray(ids),
        jnp.asarray(grads), jnp.asarray(step, jnp.int32),
        max_unique=max_unique, use_kernel=jax_use_kernel,
    )
    ttable = torch.from_numpy(table.copy())
    tslots = opt.init_slots(tspec, ttable)
    t_got, s_got = opt.apply_sparse(
        tspec, ttable, tslots, torch.from_numpy(ids),
        torch.from_numpy(grads), step, max_unique=max_unique,
        use_kernel=use_kernel,
    )
    assert t_got is ttable                      # in place
    return t_got, s_got, t_want, s_want


def _close(got, want, name, split=False):
    atol = 1e-4 if name == "ftrl" or split else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "rowwise_adagrad",
                                  "adam", "ftrl", "clippy", "schedule"])
@pytest.mark.parametrize("max_unique", [None, 24])
def test_scatter_path_matches_jax(name, max_unique):
    t_got, s_got, t_want, s_want = _apply_both(name, max_unique, False,
                                               False)
    _close(t_got, t_want, name)
    assert set(s_got) == set(s_want)
    for k in s_want:
        _close(s_got[k], s_want[k], name)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "rowwise_adagrad",
                                  "adam", "ftrl", "schedule"])
@pytest.mark.parametrize("max_unique", [None, 24])
@pytest.mark.parametrize("jax_use_kernel", [False, True])
def test_kernel_path_matches_jax(name, max_unique, jax_use_kernel):
    t_got, s_got, t_want, s_want = _apply_both(name, max_unique, True,
                                               jax_use_kernel)
    _close(t_got, t_want, name, split=jax_use_kernel)
    for k in s_want:
        _close(s_got[k], s_want[k], name, split=jax_use_kernel)


def test_kernel_path_and_scatter_path_agree_with_out_of_range_ids():
    """Ids < 0 or ≥ V update nothing on either path."""
    spec = config.OptimizerSpec(kind="adagrad", learning_rate=0.2)
    ids, grads, table = _problem(4)
    ids[:2] = [V, V + 5]
    outs = []
    for use_kernel in (False, True):
        t = torch.from_numpy(table.copy())
        s = opt.init_slots(spec, t)
        outs.append(opt.apply_sparse(
            spec, t, s, torch.from_numpy(ids), torch.from_numpy(grads), 0,
            use_kernel=use_kernel)[0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-6,
                               atol=1e-7)
    touched = np.isin(np.arange(V), ids[(ids >= 0) & (ids < V)])
    np.testing.assert_array_equal(outs[1].numpy()[~touched],
                                  table[~touched])


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="Unknown optimizer kind"):
        opt.init_slots(config.OptimizerSpec(kind="nope"), torch.zeros(2, 2))
    with pytest.raises(ValueError, match="No kernel rule"):
        opt._kernel_rule(config.OptimizerSpec(kind="clippy"), 0)


@pytest.mark.parametrize("spread", ["unit", "wide"])
def test_sqrt_is_correctly_rounded(spread):
    """The rules' root equals IEEE f32 sqrt (NumPy's, as the kernel's
    `__fsqrt_rn`) bit for bit, on every call: PyTorch's own CPU sqrt is
    an ulp off for some inputs, so the CPU twin and the card would part."""
    rng = np.random.RandomState(3)
    if spread == "unit":
        x = rng.uniform(0.05, 2.05, 1 << 20).astype(np.float32)
    else:
        with np.errstate(over="ignore"):
            x = np.exp(rng.normal(0, 20, 1 << 20)).astype(np.float32)
        x[:9] = [0.0, 1e-45, 1e-40, 2.0 ** -126, 0.25, 1.0, 4.0, 3.4e38,
                 np.inf]
    for _ in range(3):
        got = opt._sqrt(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.sqrt(x))
    assert torch.isnan(opt._sqrt(torch.tensor([-1.0, float("nan")]))).all()
