"""The port's ranking stack against the JAX package, on the CPU.

Same NumPy inputs through `recommenders_tpu` and `recommenders_tpu_torch`:
`tasks.ranking`, `DotInteraction`, `Cross`, `MultiLayerDCN`,
`TpuEmbedding`, `PartialEmbedding`, `models.Ranking` (forward, and 3
Adagrad steps of the `Trainer` with its metrics), `embedding_param_labels`
and the `convert` round trip.

Tolerances: elementwise f32 losses and interactions to rtol 1e-6 (the
same operations; reductions in another order); matmul outputs to rtol
1e-5 and atol 1e-6; embedding lookups and their gradients exactly (a
gather and a scatter-add of equal terms); the Ranking trainer as in
`test_torch_trainer.py`: `optax.adagrad(lr)` ↔ `torch.optim.Adagrad(lr,
initial_accumulator_value=0.1, eps=0)`, ≤ 5e-7 relative apart a step, so
losses and metrics to rtol 1e-5, weights to rtol 1e-5 and atol 2e-6
after 3 steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from recommenders_tpu import models as jax_models
from recommenders_tpu.embedding import config as jax_cfg
from recommenders_tpu.embedding import embedding as jax_embedding
from recommenders_tpu.embedding import partial as jax_partial
from recommenders_tpu.layers import blocks as jax_blocks
from recommenders_tpu.layers.feature_interaction import dcn as jax_dcn
from recommenders_tpu.layers.feature_interaction import (
    dot_interaction as jax_dot,
)
from recommenders_tpu.models import ranking as jax_ranking
from recommenders_tpu.tasks import ranking as jax_task
from recommenders_tpu_torch import models
from recommenders_tpu_torch.embedding import config as cfg
from recommenders_tpu_torch.embedding import embedding as embedding_lib
from recommenders_tpu_torch.embedding import partial
from recommenders_tpu_torch.layers.feature_interaction import dcn
from recommenders_tpu_torch.layers.feature_interaction import (
    dot_interaction,
)
from recommenders_tpu_torch.models import ranking
from recommenders_tpu_torch.tasks import ranking as task
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

B, DENSE, DIM = 32, 5, 8
VOCABS = {"user": 300, "item": 50, "genre": 20}
LR = 0.1
STEPS = 3


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return np.asarray(x)


# --- tasks/ranking.py -------------------------------------------------------


def _bce_inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(*shape) < 0.4).astype(np.float32)
    probs = rng.rand(*shape).astype(np.float32)
    # Edges: exactly 0 and 1 (clipped) and within 1e-7 of them.
    probs.flat[:4] = [0.0, 1.0, 3e-8, 1 - 3e-8]
    logits = (rng.randn(*shape) * 4).astype(np.float32)
    weight = rng.rand(shape[0]).astype(np.float32)
    return labels, probs, logits, weight


@pytest.mark.parametrize("shape", [(B,), (B, 3)])
@pytest.mark.parametrize("weighted", [False, True])
def test_bce_and_mse_match_jax(shape, weighted):
    labels, probs, logits, weight = _bce_inputs(shape)
    w = weight if weighted else None
    tw = _t(weight) if weighted else None
    for from_logits, preds in ((False, probs), (True, logits)):
        want = jax_task.binary_crossentropy(
            labels, preds, w, from_logits=from_logits)
        got = task.binary_crossentropy(_t(labels), _t(preds), tw,
                                       from_logits=from_logits)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want = jax_task.mean_squared_error(labels * 5, probs * 5, w)
    got = task.mean_squared_error(_t(labels * 5), _t(probs * 5), tw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_bce_grads_match_jax():
    labels, probs, logits, weight = _bce_inputs((B,), seed=1)
    probs = np.clip(probs, 0.01, 0.99)   # inside the clip: grads exist
    for from_logits, preds in ((False, probs), (True, logits)):
        want = jax.grad(lambda p: jax_task.binary_crossentropy(
            labels, p, weight, from_logits=from_logits))(jnp.asarray(preds))
        p = _t(preds).requires_grad_(True)
        task.binary_crossentropy(_t(labels), p, _t(weight),
                                 from_logits=from_logits).backward()
        np.testing.assert_allclose(p.grad.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-8)


def test_bce_clips_where_torch_clamps_the_log():
    """The reference clips p to [1e-7, 1 - 1e-7] before the log;
    `F.binary_cross_entropy` clamps the log at -100 instead: they part
    at 0 and 1 (a difference by design, ROADMAP Queue C)."""
    labels = torch.tensor([1.0, 0.0])
    probs = torch.tensor([0.0, 1.0])
    got = task.binary_crossentropy(labels, probs)
    want = jax_task.binary_crossentropy(np.array([1.0, 0.0], np.float32),
                                        np.array([0.0, 1.0], np.float32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    clip_lo, clip_hi = np.float32(1e-7), np.float32(1 - 1e-7)
    np.testing.assert_allclose(
        float(got), -(np.log(clip_lo) + np.log1p(-clip_hi)) / 2, rtol=1e-5)
    assert float(F.binary_cross_entropy(probs, labels)) == 100.0


def test_ranking_task_passes_labels_and_predictions_through():
    labels, probs, _, weight = _bce_inputs((B,))
    out = task.Ranking()(_t(labels), _t(probs), _t(weight))
    want = jax_task.Ranking()(labels, probs, weight)
    np.testing.assert_allclose(float(out.loss), float(want.loss), rtol=1e-6)
    assert torch.equal(out.labels, _t(labels))
    assert torch.equal(out.predictions, _t(probs))
    mse = task.Ranking(loss_fn=task.mean_squared_error)(_t(labels),
                                                        _t(probs))
    np.testing.assert_allclose(
        float(mse.loss), float(jax_task.mean_squared_error(labels, probs)),
        rtol=1e-6)


# --- layers/feature_interaction ---------------------------------------------


def _features(num, dim=DIM, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, dim).astype(dtype) for _ in range(num)]


@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("skip_gather", [False, True])
@pytest.mark.parametrize("num", [2, 5])
def test_dot_interaction_matches_jax(self_interaction, skip_gather, num):
    feats = _features(num)
    jmod = jax_dot.DotInteraction(self_interaction=self_interaction,
                                  skip_gather=skip_gather)
    want = jmod.apply({}, [jnp.asarray(f) for f in feats])
    got = dot_interaction.DotInteraction(self_interaction, skip_gather)(
        [_t(f) for f in feats])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)
    if skip_gather:
        full = got.reshape(B, num, num)
        keep = torch.tril(torch.ones(num, num, dtype=torch.bool),
                          0 if self_interaction else -1)
        assert bool((full[:, ~keep] == 0).all())


def test_dot_interaction_accumulates_in_f32_for_bf16_inputs():
    feats = _features(4, dim=64, seed=3)
    jmod = jax_dot.DotInteraction()
    want = jmod.apply({}, [jnp.asarray(f, jnp.bfloat16) for f in feats])
    got = dot_interaction.DotInteraction()(
        [_t(f).to(torch.bfloat16) for f in feats])
    assert got.dtype == torch.bfloat16
    # Both round one f32 sum of exact bf16 products to bf16: within one
    # bf16 ulp (the sums' order differs).
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_dot_interaction_rejects_unequal_shapes():
    with pytest.raises(ValueError, match="must be equal"):
        dot_interaction.DotInteraction()([torch.zeros(2, 3),
                                          torch.zeros(2, 4)])


CROSS_CASES = {
    "full": dict(),
    "low_rank": dict(projection_dim=3),
    "diag_scale": dict(diag_scale=0.5),
    "preactivation": dict(projection_dim=2, preactivation="relu"),
    "no_bias": dict(use_bias=False),
    "low_rank_no_bias": dict(projection_dim=2, use_bias=False),
}


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
@pytest.mark.parametrize("two_inputs", [False, True])
def test_cross_matches_jax(case, two_inputs):
    kw = CROSS_CASES[case]
    x0, x = _features(2, dim=12, seed=4)
    args = (jnp.asarray(x0),) + ((jnp.asarray(x),) if two_inputs else ())
    jmod = jax_dcn.Cross(**kw)
    params = jmod.init(jax.random.PRNGKey(1), *args)
    want = jmod.apply(params, *args)
    mod = dcn.Cross(12, device="cpu", **kw)
    convert.load_flax_params(mod, jax.tree.map(np.asarray, params["params"]))
    got = mod(_t(x0), _t(x) if two_inputs else None)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-6)


def test_cross_checks_its_arguments():
    with pytest.raises(ValueError, match="diag_scale"):
        dcn.Cross(4, diag_scale=-1.0, device="cpu")
    with pytest.raises(ValueError, match="last dimension"):
        dcn.Cross(4, device="cpu")(torch.zeros(2, 4), torch.zeros(2, 3))


@pytest.mark.parametrize("layers,proj,bias", [(3, 1, True), (2, 4, False)])
def test_multi_layer_dcn_matches_jax_with_grads(layers, proj, bias):
    (x0,) = _features(1, dim=12, seed=5)
    jmod = jax_dcn.MultiLayerDCN(num_layers=layers, projection_dim=proj,
                                 use_bias=bias)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x0))
    want, jgrad = jax.value_and_grad(
        lambda x: jnp.sum(jmod.apply(params, x) ** 2))(jnp.asarray(x0))
    mod = dcn.MultiLayerDCN(12, projection_dim=proj, num_layers=layers,
                            use_bias=bias, device="cpu")
    convert.load_flax_params(mod, jax.tree.map(np.asarray, params["params"]))
    x = _t(x0).requires_grad_(True)
    got = torch.sum(mod(x) ** 2)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), _np(jgrad), rtol=1e-4,
                               atol=1e-5)


# --- embedding: TpuEmbedding, PartialEmbedding -------------------------------


def _tables():
    return {name: cfg.TableConfig(v, DIM, name=name, combiner=comb)
            for (name, v), comb in zip(VOCABS.items(),
                                       ("mean", "sum", "sqrtn"))}


def _jax_tables():
    return {name: jax_cfg.TableConfig(v, DIM, name=name, combiner=comb)
            for (name, v), comb in zip(VOCABS.items(),
                                       ("mean", "sum", "sqrtn"))}


def _feature_configs(module, tables):
    """Scalar, multivalent (weighted and not), sequence; a shared table."""
    return (
        module.FeatureConfig(tables["user"], name="user_id"),
        module.FeatureConfig(tables["item"], name="item_id"),
        module.FeatureConfig(tables["item"], name="history",
                             max_sequence_length=4),
        module.FeatureConfig(tables["genre"], name="genres"),
        module.FeatureConfig(tables["user"], name="friends"),
    )


def _sparse_inputs(seed=0):
    rng = np.random.RandomState(seed)
    hist = rng.randint(0, VOCABS["item"], (B, 4)).astype(np.int32)
    hist[:, 3] = -1
    genres = rng.randint(0, VOCABS["genre"], (B, 3)).astype(np.int32)
    genres[::3, 1:] = -1
    friends = rng.randint(0, VOCABS["user"], (B, 2)).astype(np.int32)
    weights = rng.rand(B, 2).astype(np.float32)
    user = rng.randint(0, VOCABS["user"], B).astype(np.int32)
    user[:2] = -1
    return {"user_id": user,
            "item_id": rng.randint(0, VOCABS["item"], B).astype(np.int32),
            "history": hist, "genres": genres,
            "friends": (friends, weights)}


def _to(inputs, fn):
    return {k: tuple(fn(x) for x in v) if isinstance(v, tuple) else fn(v)
            for k, v in inputs.items()}


def test_tpu_embedding_matches_jax_with_dense_grads():
    jfcs = _feature_configs(jax_cfg, _jax_tables())
    jmod = jax_embedding.TpuEmbedding(feature_configs=jfcs,
                                      shard_tables=False)
    inputs = _sparse_inputs()
    jin = _to(inputs, jnp.asarray)
    params = jmod.init(jax.random.PRNGKey(0), jin)["params"]
    tables = {k: np.asarray(v) for k, v in params.items()}
    assert {k: v.shape for k, v in tables.items()} == {
        "user": (384, DIM), "item": (128, DIM), "genre": (128, DIM)}

    def loss(p):
        out = jmod.apply({"params": p}, jin)
        return sum(jnp.sum(v * (i + 1)) for i, v in
                   enumerate(out[k] for k in sorted(out))), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    mod = embedding_lib.TpuEmbedding(_feature_configs(cfg, _tables()),
                                     shard_tables=False, device="cpu")
    assert [n for n, _ in mod.named_parameters()] == ["user", "item",
                                                      "genre"]
    convert.load_flax_params(mod, tables)
    got = mod(_to(inputs, _t))
    total = sum(torch.sum(got[k] * (i + 1))
                for i, k in enumerate(sorted(got)))
    total.backward()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for name, param in mod.table_dict().items():
        assert param.grad.layout == torch.strided     # dense, as optax's
        np.testing.assert_allclose(param.grad.numpy(), _np(jgrads[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_tpu_embedding_checks_its_configs_and_features():
    tables = _tables()
    other = cfg.TableConfig(10, DIM, name="user")
    with pytest.raises(ValueError, match="share the name"):
        embedding_lib.TpuEmbedding(
            (cfg.FeatureConfig(tables["user"], name="a"),
             cfg.FeatureConfig(other, name="b")), device="cpu")
    mod = embedding_lib.TpuEmbedding(_feature_configs(cfg, tables),
                                     device="cpu")
    assert mod.shard_tables
    with pytest.raises(ValueError, match="no FeatureConfig"):
        mod({"nope": torch.zeros(2, dtype=torch.int32)})


@pytest.mark.parametrize("threshold,sharded", [
    (0, {"user", "item", "genre"}), (None, set()), (100, {"user"}),
])
def test_partial_embedding_routes_like_jax(threshold, sharded):
    jfcs = _feature_configs(jax_cfg, _jax_tables())
    jmod = jax_partial.PartialEmbedding(feature_configs=jfcs,
                                        size_threshold=threshold)
    inputs = _sparse_inputs(seed=2)
    jin = _to(inputs, jnp.asarray)
    # The sharded partition's tables arrive boxed as `Partitioned`.
    params = jax.tree.map(
        lambda x: np.asarray(x.unbox() if hasattr(x, "unbox") else x),
        jmod.init(jax.random.PRNGKey(0), jin)["params"],
        is_leaf=lambda x: hasattr(x, "unbox"))
    want = jmod.apply({"params": params}, jin)
    mod = partial.PartialEmbedding(_feature_configs(cfg, _tables()),
                                   size_threshold=threshold, device="cpu")
    names = {n for n, _ in mod.named_parameters()}
    assert names == {f"sharded_embedding.{t}" for t in sharded} | {
        f"dense_embedding.{t}" for t in set(VOCABS) - sharded}
    convert.load_flax_params(mod, params)
    got = mod(_to(inputs, _t))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    with pytest.raises(ValueError, match="no FeatureConfig"):
        mod({"nope": torch.zeros(2, dtype=torch.int32)})


# --- models/ranking.py --------------------------------------------------------


def _ranking_configs(module):
    return (
        module.FeatureConfig(module.TableConfig(300, DIM, name="user"),
                             name="user_id"),
        module.FeatureConfig(module.TableConfig(50, DIM, name="item"),
                             name="item_id"),
        module.FeatureConfig(module.TableConfig(20, DIM, name="genre"),
                             name="genre_id"),
    )


def _ranking_batches(seed, count):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        dense = rng.randn(B, DENSE).astype(np.float32)
        item = rng.randint(0, 50, B).astype(np.int32)
        logit = 1.5 * dense[:, 0] + ((item % 2) - 0.5)
        out.append({
            "dense_features": dense,
            "user_id": rng.randint(0, 300, B).astype(np.int32),
            "item_id": item,
            "genre_id": rng.randint(0, 20, B).astype(np.int32),
            "clicked": (rng.rand(B) < 1 / (1 + np.exp(-logit))).astype(
                np.float32),
            "sample_weight": rng.rand(B).astype(np.float32) + 0.5,
        })
    return out


INTERACTIONS = {
    # name: (JAX factory, port factory, interaction_takes_list)
    "dot": (jax_ranking.default_interaction, ranking.default_interaction,
            True),
    "dot_gather": (lambda: jax_dot.DotInteraction(self_interaction=True),
                   lambda d, dev, g=None: dot_interaction.DotInteraction(
                       self_interaction=True), True),
    "cross": (jax_ranking.cross_interaction(projection_dim=4),
              ranking.cross_interaction(projection_dim=4), False),
    "multi_layer_dcn": (jax_ranking.multi_layer_dcn_interaction(),
                        ranking.multi_layer_dcn_interaction(), False),
}


@functools.lru_cache(maxsize=None)
def _jax_ranking(interaction):
    """The JAX trainer and its initial state as NumPy copies (its step
    donates the state it is given), built once per process so its jitted
    steps compile once."""
    jfac, _, takes_list = INTERACTIONS[interaction]
    jmodel = jax_models.Ranking(
        feature_configs=_ranking_configs(jax_cfg),
        bottom_stack=lambda: jax_blocks.MLP(units=(16, DIM),
                                            final_activation="relu"),
        feature_interaction=jfac, interaction_takes_list=takes_list,
        top_stack=lambda: jax_blocks.MLP(units=(16, 1),
                                         final_activation="sigmoid"),
        size_threshold=100)
    jtrainer = jax_models.Trainer(jmodel, optax.adagrad(LR))
    sample = {k: jnp.asarray(v) for k, v in _ranking_batches(0, 1)[0].items()}
    return jtrainer, jax.tree.map(
        np.array, jtrainer.init(jax.random.PRNGKey(0), sample))


def _ranking_pair(interaction):
    """(JAX trainer, its initial state, port trainer, its state), the
    port's weights loaded from the JAX state."""
    _, tfac, takes_list = INTERACTIONS[interaction]
    jtrainer, jstate = _jax_ranking(interaction)
    jstate = jax.tree.map(jnp.array, jstate)
    model = models.Ranking(
        _ranking_configs(cfg), DENSE,
        bottom_stack=ranking.mlp_stack((16, DIM), "relu"),
        feature_interaction=tfac, interaction_takes_list=takes_list,
        top_stack=ranking.mlp_stack((16, 1), "sigmoid"),
        size_threshold=100, device="cpu")
    convert.load_flax_params(model, jax.tree.map(np.asarray, jstate.params))
    ttrainer = models.Trainer(model, lambda p: torch.optim.Adagrad(
        p, lr=LR, initial_accumulator_value=0.1, eps=0.0))
    return jtrainer, jstate, ttrainer, ttrainer.init()


def _assert_params(jparams, model, atol):
    want = jax.tree.map(np.asarray, jparams)
    got = convert.to_flax_params(model)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("interaction", sorted(INTERACTIONS))
def test_ranking_forward_matches_jax(interaction):
    jtrainer, jstate, ttrainer, _ = _ranking_pair(interaction)
    batch = _ranking_batches(1, 1)[0]
    want = jax.jit(jtrainer.model.apply)(
        {"params": jstate.params},
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = ttrainer.model({k: _t(v) for k, v in batch.items()})
    assert tuple(got.shape) == want.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("interaction", ["dot", "multi_layer_dcn"])
def test_ranking_three_adagrad_steps_match_jax(interaction):
    jtrainer, jstate, ttrainer, tstate = _ranking_pair(interaction)
    for batch in _ranking_batches(2, STEPS):
        jstate, jl = jtrainer.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tl = ttrainer.train_step(tstate, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params(jstate.params, ttrainer.model, atol=2e-6)
    want = jtrainer.metric_results(jstate)
    got = ttrainer.metric_results(tstate)
    assert set(got) == set(want) == {
        "auc", "accuracy", "label_mean", "prediction_mean", "loss",
        "regularization_loss", "total_loss"}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_ranking_checks_its_batch():
    _, _, ttrainer, _ = _ranking_pair("dot")
    batch = {k: _t(v) for k, v in _ranking_batches(3, 1)[0].items()}
    del batch["genre_id"]
    with pytest.raises(KeyError, match="genre_id"):
        ttrainer.model(batch)


def test_ranking_convert_round_trip_and_labels():
    _, jstate, ttrainer, _ = _ranking_pair("multi_layer_dcn")
    params = jax.tree.map(np.asarray, jstate.params)
    back = convert.to_flax_params(ttrainer.model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        assert np.array_equal(g, w), jax.tree_util.keystr(path)
    # Labels: the flax tree's, by the port's parameter names.
    want = {}
    for path, label in jax.tree_util.tree_leaves_with_path(
            jax_ranking.embedding_param_labels(jstate.params)):
        want["/".join(k.key for k in path)] = label
    got = ranking.embedding_param_labels(ttrainer.model)
    leaves = {leaf.name: "/".join(leaf.path)
              for leaf in convert._leaves(ttrainer.model)}
    assert set(got) == set(leaves)
    assert {leaves[name]: label for name, label in got.items()} == want
    assert got["embedding.sharded_embedding.user"] == "embedding"
    assert got["top.layers.0.weight"] == "dense"
    # A missing leaf raises.
    del params["_top"]["Dense_1"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        convert.load_flax_params(ttrainer.model, params)
