"""The training slice end to end: the `bench.py` step, port against JAX.

The step `bench.py` times, at a small shape: two tables (512 users and
1024 items, width 16) on the embedding engine with adagrad at lr 0.1,
batches of 64 uniform (user, item) pairs, `Retrieval` on the looked-up
activations, activation grads, and the engine's sparse update. Plain
(`grad_and_update`) and pipelined (`pipelined_grad_and_update` +
`flush`), unfused and `fused=True`. The JAX engine makes the initial
state; `utils.convert` carries it across.

Tolerances: f32 tables and f32 scores over 5 steps, losses per step and
final tables and slots to rtol 1e-5 (atol 1e-6): rsqrt and sum orders
differ by ulps between XLA and PyTorch. bf16 tables, bf16 slots with
stochastic rounding and bf16 scores (`bench.py`'s numerics), one step:
every element within one bf16 ulp of the JAX engine's (its interpreted
kernel draws SR bits from a block-local hash, and the activation grads
pass through a bf16 rounding that may fall one ulp apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu import tasks as jax_tasks
from recommenders_tpu.embedding import config as jax_config
from recommenders_tpu.embedding import engine as jax_engine
from recommenders_tpu_torch import tasks
from recommenders_tpu_torch.embedding import config
from recommenders_tpu_torch.embedding import engine
from recommenders_tpu_torch.utils import convert

from test_torch_sparse_apply import assert_ulp_close, to_f32
from torch_threads import torch_threads  # noqa: F401 (autouse)

USERS, ITEMS, DIM, BATCH = 512, 1024, 16, 64


def _engine(pkg, mod, **kw):
    spec = pkg.OptimizerSpec(kind="adagrad", learning_rate=0.1)
    return mod.EmbeddingEngine(
        (pkg.FeatureConfig(pkg.TableConfig(USERS, DIM, name="user"),
                           name="user_id"),
         pkg.FeatureConfig(pkg.TableConfig(ITEMS, DIM, name="item"),
                           name="item_id")),
        optimizer=spec, **kw)


def _setup(bf16, fused):
    jeng = _engine(jax_config, jax_engine, lane_pack=False,
                   dtype=jnp.bfloat16 if bf16 else jnp.float32,
                   slot_dtype=jnp.bfloat16 if bf16 else None,
                   # bf16 + SR needs JAX's kernel path (interpreted here).
                   sparse_update_kernel=True if bf16 else None)
    teng = _engine(config, engine, device="cpu",
                   dtype=torch.bfloat16 if bf16 else torch.float32,
                   slot_dtype=torch.bfloat16 if bf16 else None)
    jstate = jeng.init(jax.random.PRNGKey(0))
    tstate = convert.engine_state_from_logical(
        teng, jax.tree.map(np.asarray, jeng.logical_state(jstate)))
    jtask = jax_tasks.Retrieval(score_dtype=jnp.bfloat16 if bf16 else None,
                                fused=fused)
    ttask = tasks.Retrieval(score_dtype=torch.bfloat16 if bf16 else None,
                            fused=fused)
    return (jeng, jstate, lambda a: jtask(a["user_id"], a["item_id"]).loss,
            teng, tstate, lambda a: ttask(a["user_id"], a["item_id"]).loss)


def _batches(steps):
    rng = np.random.RandomState(7)
    return [{"user_id": rng.randint(0, USERS, BATCH).astype(np.int32),
             "item_id": rng.randint(0, ITEMS, BATCH).astype(np.int32)}
            for _ in range(steps)]


def _train(eng, state, loss_fn, batches, pipelined, to, step_fn=None):
    losses, pending = [], None
    for batch in batches:
        b = {k: to(v) for k, v in batch.items()}
        if pipelined:
            state, pending, loss, _ = (step_fn or (
                lambda s, p, b: eng.pipelined_grad_and_update(
                    s, p, b, loss_fn)))(state, pending, b)
        else:
            state, loss, _ = (step_fn or (
                lambda s, b: eng.grad_and_update(s, b, loss_fn)))(state, b)
        losses.append(float(loss))
    if pipelined:
        state = eng.flush(state, pending)
    return state, losses


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_five_f32_steps_match_jax(pipelined, fused):
    jeng, jstate, jloss, teng, tstate, tloss = _setup(False, fused)
    batches = _batches(5)
    if pipelined:
        jit_step = jax.jit(lambda s, p, b: jeng.pipelined_grad_and_update(
            s, p, b, jloss))

        def jstep(s, p, b):     # The first step's `None` is static.
            if p is None:
                return jeng.pipelined_grad_and_update(s, p, b, jloss)
            return jit_step(s, p, b)
    else:
        jstep = jax.jit(lambda s, b: jeng.grad_and_update(s, b, jloss))
    jstate, jlosses = _train(jeng, jstate, jloss, batches, pipelined,
                             jnp.asarray, jstep)
    tstate, tlosses = _train(teng, tstate, tloss, batches, pipelined,
                             torch.from_numpy)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = jax.tree.map(np.asarray, jeng.logical_state(jstate))
    got = teng.logical_state(tstate)
    assert got["step"] == int(want["step"]) == 5
    for name in ("user", "item"):
        np.testing.assert_allclose(got["tables"][name].numpy(),
                                   want["tables"][name], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            got["slots"][name]["accumulator"].numpy(),
            want["slots"][name]["accumulator"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_one_bf16_sr_step_within_one_ulp(pipelined, fused):
    jeng, jstate, jloss, teng, tstate, tloss = _setup(True, fused)
    batches = _batches(1)
    jstate, jlosses = _train(jeng, jstate, jloss, batches, pipelined,
                             jnp.asarray)
    tstate, tlosses = _train(teng, tstate, tloss, batches, pipelined,
                             torch.from_numpy)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = jax.tree.map(np.asarray, jeng.logical_state(jstate))
    got = teng.logical_state(tstate)
    for name in ("user", "item"):
        assert got["tables"][name].dtype == torch.bfloat16
        assert_ulp_close(got["tables"][name], want["tables"][name],
                         bf16=True, max_ulp=1)
        assert_ulp_close(got["slots"][name]["accumulator"],
                         want["slots"][name]["accumulator"], bf16=True,
                         max_ulp=1)
        # The update moved the touched rows.
        assert (to_f32(got["tables"][name])
                != to_f32(jax.tree.map(np.asarray, jeng.logical_state(
                    jeng.init(jax.random.PRNGKey(0))))["tables"][name])
                ).any()
