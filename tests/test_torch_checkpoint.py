"""`utils.checkpoint`: the port's counterpart of `tests/test_checkpoint.py`.

Round trips restore every saved tensor exactly (tolerance: none), and a
state resumed from a checkpoint trains bit for bit as the one that was
never saved. The JAX test's cross-mesh restore becomes a cross-layout
one here: a stacked engine's `HybridState` restores into an unstacked
engine and back. A JAX `Trainer`'s parameters, carried into the port
with `utils.convert`, come back equal after a save and restore.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from recommenders_tpu import models as jax_models
from recommenders_tpu_torch import models
from recommenders_tpu_torch import optimizers
from recommenders_tpu_torch import tasks
from recommenders_tpu_torch.embedding import config
from recommenders_tpu_torch.embedding import engine
from recommenders_tpu_torch.utils import checkpoint as ckpt_lib
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

USERS, ITEMS, DIM, B = 120, 300, 8, 32


def _model(seed=0):
    """Two towers (one with an MLP), extra negatives drawn from the
    state's generator each step, so a resume must restore it too."""
    gen = torch.Generator().manual_seed(seed)
    return models.TwoTowerRetrieval(
        models.EmbeddingTower(USERS, DIM, mlp_units=(16, DIM), device="cpu",
                              generator=gen),
        models.EmbeddingTower(ITEMS, DIM, device="cpu", generator=gen),
        num_extra_negatives=16, candidate_vocab_size=ITEMS)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"user_id": rng.randint(0, USERS, B).astype(np.int32),
            "movie_id": rng.randint(0, ITEMS, B).astype(np.int32)}


def _trainer(seed=0, optimizer=None):
    trainer = models.Trainer(_model(seed), optimizer or (
        lambda p: torch.optim.Adam(p, lr=0.01)))
    state = trainer.init(torch.Generator().manual_seed(seed), _batch(0))
    return trainer, state


def _assert_train_states_equal(a, b):
    assert a.step == b.step
    for name in a.params:
        torch.testing.assert_close(a.params[name], b.params[name], rtol=0,
                                   atol=0)
    sa, sb = a.opt_state.state_dict(), b.opt_state.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for got, want in ((sa["state"], sb["state"]),
                      (a.metric_states, b.metric_states),
                      (a.loss_states, b.loss_states)):
        flat_a, flat_b = _flat(got), _flat(want)
        assert list(flat_a) == list(flat_b) and flat_a
        for k in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_a[k]),
                                          np.asarray(flat_b[k]), err_msg=k)


def _flat(tree, prefix=""):
    """Leaves of nested dicts by path (keys of mixed types allowed)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key in sorted(tree, key=str):
        out.update(_flat(tree[key], f"{prefix}/{key}"))
    return out


def test_save_restore_roundtrip(tmp_path):
    trainer, state = _trainer()
    for i in (1, 2):
        state, _ = trainer.train_step(state, _batch(i))
    path = str(tmp_path / "ckpt")
    ckpt_lib.save(path, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]

    other, template = _trainer(seed=5)          # other weights, step 0
    restored = ckpt_lib.restore(path, template)
    _assert_train_states_equal(restored, state)
    # Parameters are restored into the model in place.
    assert restored.params["query_tower.embedding.weight"] is \
        other.model.query_tower.embedding.weight
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())


def test_resume_training_is_bit_exact(tmp_path):
    trainer, state = _trainer()
    state, _ = trainer.train_step(state, _batch(1))
    path = str(tmp_path / "ckpt")
    ckpt_lib.save(path, state)

    # Branch A: continue. Branch B: restore into another model, continue.
    losses_a = []
    for i in range(2, 6):
        state, loss = trainer.train_step(state, _batch(i))
        losses_a.append(float(loss))
    resumer, template = _trainer(seed=9)
    resumed = ckpt_lib.restore(path, template)
    losses_b = []
    for i in range(2, 6):
        resumed, loss = resumer.train_step(resumed, _batch(i))
        losses_b.append(float(loss))
    assert losses_a == losses_b
    _assert_train_states_equal(resumed, state)


def test_manager_retention_and_latest(tmp_path):
    trainer, state = _trainer()
    with ckpt_lib.CheckpointManager(str(tmp_path / "run"),
                                    max_to_keep=2) as mgr:
        for step in (1, 2, 3):
            state, _ = trainer.train_step(state, _batch(step))
            assert mgr.save(step, state)
        assert mgr.latest_step() == 3
        assert mgr.all_steps() == [2, 3]  # max_to_keep=2 dropped step 1.
        _, template = _trainer(seed=3)
        _assert_train_states_equal(mgr.restore(template=template), state)
        _, template = _trainer(seed=3)
        assert mgr.restore(template=template, step=2).step == 2


def test_restore_missing_raises(tmp_path):
    _, state = _trainer()
    with ckpt_lib.CheckpointManager(str(tmp_path / "empty")) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(template=state)
    with pytest.raises(FileNotFoundError):
        ckpt_lib.restore(str(tmp_path / "nothing"), state)


def test_manager_save_interval_policy(tmp_path):
    _, state = _trainer()
    with ckpt_lib.CheckpointManager(str(tmp_path / "interval"),
                                    save_interval_steps=5,
                                    max_to_keep=None) as mgr:
        saved = [step for step in range(11) if mgr.save(step, state)]
        assert saved == [0, 5, 10]
        assert mgr.all_steps() == [0, 5, 10]


def test_an_interrupted_save_never_becomes_a_checkpoint(tmp_path,
                                                        monkeypatch):
    trainer, state = _trainer()
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "run"))
    assert mgr.save(1, state)
    state, _ = trainer.train_step(state, _batch(1))

    def cut(*args, **kwargs):
        raise KeyboardInterrupt("cut while writing")

    monkeypatch.setattr(ckpt_lib.torch, "save", cut)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, state)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(1, state)                    # over an existing step
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == ["1"]
    monkeypatch.undo()
    _, template = _trainer(seed=2)
    assert mgr.restore(template).step == 0


def test_restore_takes_the_templates_dtypes_and_checks_shapes(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [np.arange(4, dtype=np.int64), 3.5, None, "name"],
            "c": (torch.ones(2, dtype=torch.bfloat16),)}
    path = str(tmp_path / "tree")
    ckpt_lib.save(path, tree)
    template = {"a": torch.zeros(2, 3, dtype=torch.float64),
                "b": [np.zeros(4, np.int32), 0.0, None, ""],
                "c": (torch.zeros(2, dtype=torch.float32),)}
    got = ckpt_lib.restore(path, template)
    assert got["a"].dtype == torch.float64
    torch.testing.assert_close(got["a"], tree["a"].double())
    assert got["b"][0].dtype == np.int32
    np.testing.assert_array_equal(got["b"][0], np.arange(4))
    assert got["b"][1:] == [3.5, None, "name"]
    assert got["c"][0].dtype == torch.float32 and isinstance(got["c"], tuple)
    with pytest.raises(ValueError, match="template"):
        ckpt_lib.restore(path, {**template, "a": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="entries"):
        ckpt_lib.restore(path, {"a": template["a"]})
    _, state = _trainer()
    with pytest.raises(ValueError, match="holds a tree"):
        ckpt_lib.restore(path, state)


def test_a_learning_rate_schedule_is_kept_from_the_template(tmp_path):
    """A weights-only file holds no function: a param group's schedule
    is saved as a marker and restored from the template's optimizer."""
    def schedule(step):
        return 0.05 / (1.0 + step)

    trainer, state = _trainer(optimizer=lambda p: optimizers.ClippyAdagrad(
        p, lr=schedule))
    state, _ = trainer.train_step(state, _batch(1))
    path = str(tmp_path / "ckpt")
    ckpt_lib.save(path, state)
    other, template = _trainer(seed=4, optimizer=lambda p:
                               optimizers.ClippyAdagrad(p, lr=schedule))
    restored = ckpt_lib.restore(path, template)
    assert restored.opt_state.param_groups[0]["lr"] is schedule
    _assert_train_states_equal(restored, state)
    a, _ = trainer.train_step(state, _batch(2))
    b, _ = other.train_step(restored, _batch(2))
    _assert_train_states_equal(a, b)


# --- HybridState across engine layouts --------------------------------------


class _Head(nn.Module):
    def __init__(self, seed):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dense = nn.Linear(3 * DIM, 1)
        with torch.no_grad():
            self.dense.weight.normal_(0.0, 0.1, generator=gen)
        self.task = tasks.Ranking()

    def forward(self, batch, acts):
        x = torch.cat([acts[n] for n in ("user_id", "item_id", "tags")], -1)
        pred = torch.sigmoid(self.dense(x)[:, 0])
        return self.task(batch["clicked"], pred).loss


def _hybrid(stacked, seed, pipelined):
    spec = config.OptimizerSpec(kind="adagrad", learning_rate=0.1)
    tables = [config.TableConfig(v, DIM, name=n, optimizer=spec,
                                 combiner="sum")
              for n, v in (("user", 500), ("item", 200), ("tag", 60))]
    features = (config.FeatureConfig(tables[0], name="user_id"),
                config.FeatureConfig(tables[1], name="item_id"),
                config.FeatureConfig(tables[2], name="tags"))
    eng = engine.EmbeddingEngine(features, stack_tables=stacked,
                                 device="cpu")
    trainer = models.HybridTrainer(
        _Head(seed), eng, lambda p: torch.optim.Adam(p, lr=1e-2),
        pipelined=pipelined)
    return trainer, trainer.init(torch.Generator().manual_seed(seed))


def _hybrid_batch(seed):
    rng = np.random.RandomState(seed)
    tags = rng.randint(0, 60, (B, 3)).astype(np.int32)
    tags[rng.rand(B, 3) < 0.3] = config.PAD_ID
    return {"user_id": rng.randint(0, 500, B).astype(np.int32),
            "item_id": rng.randint(0, 200, B).astype(np.int32), "tags": tags,
            "clicked": (rng.rand(B) < 0.5).astype(np.float32)}


def _logical(trainer, state):
    return jax.tree.map(np.asarray, convert.engine_state_to_logical(
        trainer.engine, state.engine_state))


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("stacked_first", [True, False])
def test_hybrid_state_restores_across_stacking_layouts(tmp_path, pipelined,
                                                       stacked_first):
    """A stacked engine's checkpoint restores into an unstacked one and
    the other way round (f32 tables: the two layouts train bit-equal),
    pending update included; both then continue identically."""
    trainer, state = _hybrid(stacked_first, 0, pipelined)
    for i in range(3):
        state, _, _ = trainer.train_step(state, _hybrid_batch(i))
    path = str(tmp_path / "hybrid")
    ckpt_lib.save(path, state, engine=trainer.engine)
    other, template = _hybrid(not stacked_first, 7, pipelined)
    restored = ckpt_lib.restore(path, template, engine=other.engine)
    assert (restored.pending is None) == (not pipelined)
    a, b = _logical(trainer, state), _logical(other, restored)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    for i in range(3, 5):
        state, loss_a, _ = trainer.train_step(state, _hybrid_batch(i))
        restored, loss_b, _ = other.train_step(restored, _hybrid_batch(i))
        assert float(loss_a) == float(loss_b)
    state, restored = trainer.finalize(state), other.finalize(restored)
    for x, y in zip(jax.tree.leaves(_logical(trainer, state)),
                    jax.tree.leaves(_logical(other, restored))):
        np.testing.assert_array_equal(x, y)
    for name, value in state.params.items():
        torch.testing.assert_close(restored.params[name], value, rtol=0,
                                   atol=0)


def test_engine_state_alone_needs_its_engine(tmp_path):
    trainer, state = _hybrid(True, 0, False)
    path = str(tmp_path / "engine")
    with pytest.raises(ValueError, match="engine"):
        ckpt_lib.save(path, state.engine_state)
    ckpt_lib.save(path, state.engine_state, engine=trainer.engine)
    other, _ = _hybrid(False, 1, False)
    got = ckpt_lib.restore(path, state.engine_state, engine=other.engine)
    assert set(got.tables) == {"user", "item", "tag"}
    for x, y in zip(jax.tree.leaves(_logical(trainer, state)),
                    jax.tree.leaves(_logical(
                        other, dataclasses.replace(state,
                                                   engine_state=got)))):
        np.testing.assert_array_equal(x, y)


# --- A JAX TrainState's parameters ------------------------------------------


def test_jax_trainer_params_carried_saved_and_restored_equal(tmp_path):
    jax_model = jax_models.TwoTowerRetrieval(
        query_tower=lambda: jax_models.EmbeddingTower(USERS, DIM,
                                                      mlp_units=(16, DIM)),
        candidate_tower=lambda: jax_models.EmbeddingTower(ITEMS, DIM),
    )
    jax_trainer = jax_models.Trainer(jax_model, optax.adagrad(0.1))
    jax_state = jax_trainer.init(jax.random.PRNGKey(3), _batch(0))
    jax_state, _ = jax_trainer.train_step(jax_state, _batch(1))
    params = jax.tree.map(np.asarray, jax_state.params)

    trainer, state = _trainer()
    convert.load_flax_params(trainer.model, params)
    path = str(tmp_path / "carried")
    ckpt_lib.save(path, state)
    other, template = _trainer(seed=8)
    ckpt_lib.restore(path, template)
    back = convert.to_flax_params(other.model)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want)
    for key, value in flat_back:
        np.testing.assert_array_equal(value, flat_want[key])
