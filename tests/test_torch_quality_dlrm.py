"""`tools/quality_parity.py`'s prebuilt DLRM against the JAX package.

A small run of `tools/reference_parity_ctr.py::run_ours_dlrm` (`:293-358`):
the same data (the port's `make_ctr` gives the JAX tool's arrays bit for
bit), the JAX model's initial weights carried into the port's through
`utils/convert.load_flax_params`, the same four batches in the same order
under Adam 0.01 (eps 1e-7). Tolerances: per-step losses to rtol 1e-5
(`optax.adam` takes its bias corrections in f32, which moves an update
~1e-5 relative a step); the test split's predictions after two steps to
atol 1e-5; test AUC after four steps within 0.002. Predictions are held
after two steps, not four: Adam's first steps move a weight by about lr
whatever the size of its gradient, so from the third step on a gradient
near zero that rounds to the other sign in one framework moves a few
weights by up to twice lr (0.01 apart after four steps here, the
predictions 7e-5).
"""

import importlib.util
import os
from pathlib import Path
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from recommenders_tpu import data as jax_data
from recommenders_tpu import models as jax_models
from recommenders_tpu.embedding import config as jax_config
from recommenders_tpu.layers import blocks as jax_blocks
from recommenders_tpu.models import ranking as jax_ranking
from recommenders_tpu_torch import models
from recommenders_tpu_torch.tools import quality_parity as qp
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _args():
    return qp.parse_args(["--device", "cpu", "--examples", "3000",
                          "--dlrm-epochs", "1", "--batch", "512"])


def _jax_tool():
    """`tools/reference_parity_ctr.py` as a module, its environment
    settings (`CUDA_VISIBLE_DEVICES`, `JAX_PLATFORMS`, `:40-43`) undone
    after the import."""
    spec = importlib.util.spec_from_file_location(
        "reference_parity_ctr", ROOT / "tools" / "reference_parity_ctr.py")
    module = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(module)
    return module


def _jax_dlrm():
    """`run_ours_dlrm`'s model (`:306-336`)."""
    glorot = fnn.initializers.glorot_uniform()
    return jax_ranking.Ranking(
        feature_configs=tuple(
            jax_config.FeatureConfig(
                table=jax_config.TableConfig(v, qp.DLRM_DIM,
                                             name=f"t_{name}"),
                name=name)
            for name, v in qp.DLRM_VOCABS.items()),
        size_threshold=500,
        bottom_stack=lambda: jax_blocks.MLP(
            units=(256, 64, 16), final_activation="relu",
            kernel_init=glorot),
        top_stack=lambda: jax_blocks.MLP(
            units=(512, 256, 1), final_activation="sigmoid",
            kernel_init=glorot))


def test_make_ctr_is_the_jax_tools():
    args = _args()
    tool = _jax_tool()
    assert os.environ.get("JAX_PLATFORMS") == "cpu"      # conftest's own
    assert tool.DLRM_VOCABS == qp.DLRM_VOCABS
    assert tool.DLRM_DIM == qp.DLRM_DIM
    ours, theirs = qp.make_ctr(args), tool.make_ctr(args)
    for got, want in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert ours[0][0]["dense"].shape == (2400, qp.DLRM_DENSE)


def test_glorot_stack_draws_keras_dense_limits():
    gen = torch.Generator().manual_seed(0)
    mlp = qp.glorot_stack((256, 64), "relu")(8, torch.device("cpu"), gen)
    for layer, (fan_in, fan_out) in zip(mlp.layers, ((8, 256), (256, 64))):
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        drawn = float(layer.weight.detach().abs().max())
        assert 0.9 * limit < drawn <= limit
        assert not layer.bias.any()


def test_dlrm_matches_jax_from_the_same_weights():
    args = _args()
    train, test = qp.make_ctr(args)
    jtrainer = jax_models.Trainer(_jax_dlrm(),
                                  optax.adam(qp.DLRM_LR, eps=1e-7))
    batches = jax_data.batched(qp._ctr_batch(train), args.batch,
                               shuffle=True, seed=args.seed)
    jstate = jtrainer.init(jax.random.PRNGKey(args.seed), next(batches()))
    params = jax.tree.map(np.array, fnn.meta.unbox(jstate.params))

    model = qp.dlrm_model(args)
    convert.load_flax_params(model, params)
    trainer = models.Trainer(model, lambda p: torch.optim.Adam(
        p, lr=qp.DLRM_LR, eps=1e-7))
    state = trainer.init()
    split = qp._ctr_batch(test)
    apply = jax.jit(jtrainer.model.apply)
    steps = 0
    for _ in range(args.dlrm_epochs):
        for batch in batches():
            jstate, jloss = jtrainer.train_step(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            state, loss = trainer.train_step(state, batch)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            steps += 1
            if steps == 2:
                want = apply({"params": jstate.params},
                             {k: jnp.asarray(v) for k, v in split.items()})
                with torch.no_grad():
                    got = model({k: torch.from_numpy(v)
                                 for k, v in split.items()})
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-5)
    assert steps == 4                       # 2,400 train rows / 512
    jax_auc = jtrainer.evaluate(jstate, jax_data.batched(
        split, args.batch, drop_remainder=False))["auc"]
    auc = trainer.evaluate(state, qp.data.batched(
        split, args.batch, drop_remainder=False))["auc"]
    assert abs(auc - jax_auc) <= 0.002


def test_train_dlrm_reports_the_auc_its_bound_reads():
    args = _args()
    got = qp.run_ours_dlrm(*qp.make_ctr(args), args)
    assert set(got) == {"dlrm_auc", "losses", "train_seconds"}
    assert len(got["losses"]) == args.dlrm_epochs
    assert 0.0 < got["dlrm_auc"] < 1.0
    assert (qp.RECORDED["dlrm_auc"], qp.BOUNDS["dlrm_auc"]) == (0.6625, 0.015)
    assert qp.quality_failures({"dlrm": {"dlrm_auc": 0.6625 + 0.0149}}) == []
    assert qp.quality_failures({"dlrm": {"dlrm_auc": 0.6625 - 0.0151}})
    defaults = qp.parse_args([])
    assert (defaults.dlrm_epochs, qp.DLRM_LR, defaults.examples) == (
        8, 0.01, 200_000)
