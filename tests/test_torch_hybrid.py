"""The port's `HybridTrainer` against the JAX package's, on the CPU.

A DLRM head (bottom MLP → dot interaction over the engine's activations
and the dense embedding → top MLP → BCE) under Adam, over a stacked
`EmbeddingEngine` with f32 adagrad tables; plain and pipelined, 3 steps
plus `finalize`, from one set of weights: the head's carried with
`utils.convert`, the engine's with `engine_state_from_logical`. The
port's engine runs K1's plain twin (its kernel path on CPU tensors), the
JAX engine its scatter path (f32 segment sums).

Tolerances: losses to rtol 1e-5; the engine's tables and accumulators
to rtol 1e-5 and atol 1e-6 (XLA's rsqrt and the port's 1/sqrt an ulp
apart); the head's weights to rtol 1e-5 and atol 1e-6 (`optax.adam`
takes its bias corrections in f32, `torch.optim.Adam` in float64:
≤ ~1e-5 of an update, ≤ 4e-7 over 3 steps at lr 1e-2).
"""

import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from recommenders_tpu import models as jax_models
from recommenders_tpu.embedding import config as jax_config
from recommenders_tpu.embedding import engine as jax_engine
from recommenders_tpu.layers import blocks as jax_blocks
from recommenders_tpu.layers.feature_interaction import (
    dot_interaction as jax_dot,
)
from recommenders_tpu.tasks import ranking as jax_ranking_task
from recommenders_tpu_torch import models
from recommenders_tpu_torch import tasks
from recommenders_tpu_torch.embedding import config
from recommenders_tpu_torch.embedding import engine
from recommenders_tpu_torch.layers.feature_interaction import (
    dot_interaction,
)
from recommenders_tpu_torch.models import ranking
from recommenders_tpu_torch.utils import convert

B, DENSE, DIM = 32, 4, 8
VOCABS = {"user": 500, "item": 200, "tag": 60}
FEATURES = ("user_id", "item_id", "tags")
STEPS = 3
ENGINE_LR, HEAD_LR = 0.1, 1e-2


def _configs(pkg):
    spec = pkg.OptimizerSpec(kind="adagrad", learning_rate=ENGINE_LR)
    tables = {name: pkg.TableConfig(v, DIM, name=name, optimizer=spec,
                                    combiner="sum")
              for name, v in VOCABS.items()}
    return (pkg.FeatureConfig(tables["user"], name="user_id"),
            pkg.FeatureConfig(tables["item"], name="item_id"),
            pkg.FeatureConfig(tables["tag"], name="tags"))


def _batches(seed, count):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        dense = rng.randn(B, DENSE).astype(np.float32)
        item = rng.randint(0, VOCABS["item"], B).astype(np.int32)
        tags = rng.randint(0, VOCABS["tag"], (B, 3)).astype(np.int32)
        tags[rng.rand(B, 3) < 0.3] = config.PAD_ID
        logit = 2.0 * dense[:, 0] + ((item % 2) - 0.5)
        out.append({
            "user_id": rng.randint(0, VOCABS["user"], B).astype(np.int32),
            "item_id": item, "tags": tags, "dense_features": dense,
            "clicked": (rng.rand(B) < 1 / (1 + np.exp(-logit))).astype(
                np.float32)})
    return out


class JaxHead(fnn.Module):
    def setup(self):
        self._bottom = jax_blocks.MLP(units=(16, DIM),
                                      final_activation="relu")
        self._interaction = jax_dot.DotInteraction(skip_gather=True)
        self._top = jax_blocks.MLP(units=(16, 1), final_activation="sigmoid")

    def __call__(self, batch, acts):
        dense = self._bottom(batch["dense_features"])
        x = self._interaction([acts[n] for n in FEATURES] + [dense])
        pred = self._top(jnp.concatenate([dense, x], -1))[:, 0]
        out = jax_ranking_task.Ranking()(batch["clicked"], pred)
        return out.loss, out.predictions


class Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.bottom = ranking.mlp_stack((16, DIM), "relu")(DENSE, "cpu")
        self.interaction = dot_interaction.DotInteraction(skip_gather=True)
        self.top = ranking.mlp_stack((16, 1), "sigmoid")(
            DIM + (len(FEATURES) + 1) ** 2, "cpu")
        self.task = tasks.Ranking()

    def forward(self, batch, acts):
        dense = self.bottom(batch["dense_features"])
        x = self.interaction([acts[n] for n in FEATURES] + [dense])
        pred = self.top(torch.cat([dense, x], -1))[:, 0]
        out = self.task(batch["clicked"], pred)
        return out.loss, out.predictions


@functools.lru_cache(maxsize=None)
def _jax_trainer(pipelined):
    """The JAX trainer and its initial state as NumPy copies, once per
    process (its step donates the state it is given)."""
    jeng = jax_engine.EmbeddingEngine(_configs(jax_config), stack_tables=True,
                                      lane_pack=False,
                                      sparse_update_kernel=False)
    trainer = jax_models.HybridTrainer(JaxHead(), jeng, optax.adam(HEAD_LR),
                                       pipelined=pipelined)
    sample = {k: jnp.asarray(v) for k, v in _batches(0, 1)[0].items()}
    return trainer, jax.tree.map(
        np.array, trainer.init(jax.random.PRNGKey(0), sample))


def _pair(pipelined):
    jtrainer, jstate = _jax_trainer(pipelined)
    jstate = jax.tree.map(jnp.array, jstate)
    head = Head()
    params = jax.tree.map(np.asarray, jstate.params)
    for part in ("bottom", "top"):
        convert.load_flax_params(getattr(head, part), params[f"_{part}"])
    teng = engine.EmbeddingEngine(_configs(config), stack_tables=True,
                                  device="cpu")
    trainer = models.HybridTrainer(
        head, teng, lambda p: torch.optim.Adam(p, lr=HEAD_LR),
        pipelined=pipelined)
    tstate = trainer.init(engine_state=convert.engine_state_from_logical(
        teng, jax.tree.map(np.asarray,
                           jtrainer.engine.logical_state(jstate.engine_state))))
    return jtrainer, jstate, trainer, tstate


def _assert_states(jtrainer, jstate, trainer, tstate):
    want = jax.tree.map(np.asarray,
                        jtrainer.engine.logical_state(jstate.engine_state))
    got = trainer.engine.logical_state(tstate.engine_state)
    assert got["step"] == int(want["step"])
    for name in want["tables"]:
        np.testing.assert_allclose(got["tables"][name].numpy(),
                                   want["tables"][name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        for slot, plane in want["slots"][name].items():
            np.testing.assert_allclose(got["slots"][name][slot].numpy(),
                                       plane, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}/{slot}")
    params = jax.tree.map(np.asarray, jstate.params)
    for part in ("bottom", "top"):
        got = convert.to_flax_params(getattr(trainer.model, part))
        for path, w in jax.tree_util.tree_leaves_with_path(
                params[f"_{part}"]):
            g = got
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-6,
                err_msg=part + jax.tree_util.keystr(path))


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["plain", "pipelined"])
def test_three_steps_match_the_jax_hybrid_trainer(pipelined):
    jtrainer, jstate, trainer, tstate = _pair(pipelined)
    assert trainer.engine._storage_members == {
        "stacked:user+item+tag": ["user", "item", "tag"]}
    for batch in _batches(1, STEPS):
        jstate, jloss, jpred = jtrainer.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tloss, tpred = trainer.train_step(tstate, batch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(tpred.detach().numpy(), np.asarray(jpred),
                                   rtol=1e-5, atol=1e-6)
        assert (tstate.pending is not None) == pipelined
    if pipelined:
        # One step stale: the last update is still pending.
        assert tstate.engine_state.step == STEPS - 1
        jstate = jtrainer.finalize(jstate)
        tstate = trainer.finalize(tstate)
        assert tstate.pending is None
    assert tstate.engine_state.step == STEPS
    _assert_states(jtrainer, jstate, trainer, tstate)
    batch = _batches(2, 1)[0]
    jloss, _ = jtrainer.eval_loss(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _ = trainer.eval_loss(tstate, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_pipelined_step_reads_the_tables_before_the_pending_update():
    """A pipelined step's activations are the rows as they were before
    its pending update (gathered copies), and the update then lands."""
    _, _, trainer, state = _pair(True)
    batches = _batches(3, 2)
    first = {k: torch.from_numpy(batches[0][k]) for k in FEATURES}
    second = {k: torch.from_numpy(batches[1][k]) for k in FEATURES}
    state, _, _ = trainer.train_step(state, batches[0])
    pending_rows = trainer.engine.lookup(state.engine_state, first)
    before = trainer.engine.lookup(state.engine_state, second)
    seen = {}

    def spy(module, args):
        seen.update({k: v.detach().clone() for k, v in args[1].items()})

    handle = trainer.model.register_forward_pre_hook(spy)
    state, _, _ = trainer.train_step(state, batches[1])
    handle.remove()
    for k in FEATURES:
        assert torch.equal(seen[k], before[k]), k
    # The first step's update landed during the second step.
    landed = trainer.engine.lookup(state.engine_state, first)
    assert state.engine_state.step == 1
    for k in FEATURES:
        assert not torch.equal(landed[k], pending_rows[k]), k
    assert state.params["bottom.layers.0.weight"] is (
        trainer.model.bottom.layers[0].weight)


def test_init_starts_from_a_given_state():
    """`init(engine_state=..., optimizer_state=...)` takes a run on where
    it was saved: the same next step, bit for bit."""
    _, _, trainer, state = _pair(False)
    batches = _batches(4, 3)
    for batch in batches[:2]:
        state, _, _ = trainer.train_step(state, batch)
    teng = trainer.engine
    saved_engine = copy.deepcopy(teng.logical_state(state.engine_state))
    saved_opt = copy.deepcopy(state.opt_state.state_dict())
    saved_params = {k: v.detach().clone()
                    for k, v in trainer.model.state_dict().items()}
    state, loss, _ = trainer.train_step(state, batches[2])
    want = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    want_tables = teng.logical_state(state.engine_state)["tables"]
    trainer.model.load_state_dict(saved_params)
    resumed = trainer.init(
        engine_state=convert.engine_state_from_logical(teng, saved_engine),
        optimizer_state=saved_opt)
    assert resumed.opt_state is not state.opt_state
    resumed, again, _ = trainer.train_step(resumed, batches[2])
    assert torch.equal(loss, again)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    got_tables = teng.logical_state(resumed.engine_state)["tables"]
    for name, table in want_tables.items():
        assert torch.equal(got_tables[name], table), name
