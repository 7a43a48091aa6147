"""Helpers of the tests that hold the port's examples against the JAX
examples (`tests/test_torch_examples_*.py`): the JAX example loaded by
path, weights carried with `utils.convert`, one optimizer step of each
package compared, and each single-process example's tiny size for the
end-to-end runs (`CASES`, `run_main`).

One step of each example's optimizer is compared on the parameters'
change, relative to the JAX step's change (‖Δport − Δjax‖ / ‖Δjax‖),
within `STEP_GAP`: adagrad 1e-5 (the optimizer pair is ≤ 5e-7 apart on
equal gradients; the gradients of two f32 implementations add up to
~6e-6), Adam 2e-5 (optax takes `1 − β^t` in f32: ~7e-6 a step here),
Clippy Adagrad + Adam as Adam. A parameter the loss does not depend on
(ListMLE's last bias, attention's key bias: both shift every score of a
softmax alike) has a gradient of rounding noise that Adam's first step
scales up to the learning rate, differently in each package: it is held
to that bound instead.
"""

import importlib
import importlib.util
import math
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import torch

from recommenders_tpu import data as jax_data
from recommenders_tpu import models as jax_models
from recommenders_tpu_torch import models
from recommenders_tpu_torch.utils import convert

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
B = 256
STEP_GAP = {"adagrad": 1e-5, "adam": 2e-5}


def jax_example(name: str):
    """`examples/<name>.py`, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def numpy_params(params) -> dict:
    return jax.tree.map(np.array, fnn.meta.unbox(params))


def flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float64)
    return out


def step_gap(start: dict, got: dict, want: dict, skip=()) -> float:
    """‖(got − start) − (want − start)‖ / ‖want − start‖ over every leaf
    but those in `skip`."""
    start, got, want = flat(start), flat(got), flat(want)
    assert got.keys() == want.keys() == start.keys()
    keys = [k for k in want if k not in skip]
    num = sum(float(np.square(got[k] - want[k]).sum()) for k in keys)
    den = sum(float(np.square(want[k] - start[k]).sum()) for k in keys)
    assert den > 0
    return (num / den) ** 0.5


def movielens_batch(seed: int = 0, n: int = B) -> dict:
    ds = jax_data.synthetic_movielens(num_interactions=20_000, seed=seed)
    rows = np.random.RandomState(seed).choice(len(ds), n, replace=False)
    return {k: v[rows] for k, v in ds.as_dict().items()}, ds


def trainer_parity(jax_model, port_model, batch, jax_opt, port_opt,
                   kind: str, outputs, invariant=None):
    """Carries the JAX trainer's init into the port's model; checks the
    loss and `outputs(params) -> [(jax array, port tensor)]`, then one
    trainer step of each.

    `invariant` names a leaf the loss does not depend on: its gradient
    is zero up to rounding, which Adam's first step scales up to as
    much as the learning rate in each package apart. It is held to
    that bound instead of the gap."""
    trainer = jax_models.Trainer(jax_model, jax_opt)
    state = trainer.init(jax.random.PRNGKey(0), batch)
    start = numpy_params(state.params)
    convert.load_flax_params(port_model, start)
    jax_loss, _ = jax_model.apply({"params": start}, batch,
                                  method="compute_loss")
    port_model.eval()
    with torch.no_grad():
        port_loss, _ = port_model.compute_loss(to_torch(batch))
    np.testing.assert_allclose(float(port_loss), float(jax_loss), rtol=1e-5)
    for want, got in outputs(start):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    state, _ = trainer.train_step(state, batch)
    port_trainer = models.Trainer(port_model, port_opt)
    port_state = port_trainer.init()
    port_trainer.train_step(port_state, batch)
    got, want = convert.to_flax_params(port_model), numpy_params(
        state.params)
    skip = () if invariant is None else (invariant,)
    gap = step_gap(start, got, want, skip)
    assert gap <= STEP_GAP[kind], gap
    for leaf in skip:
        lr = float(port_state.opt_state.param_groups[0]["lr"])
        for tree in (got, want):
            change = flat(tree)[leaf] - flat(start)[leaf]
            assert np.abs(change).max() <= lr * (1 + 1e-6), (leaf, change)


def ranking_outputs(jax_model, port_model, batch):
    def outputs(params):
        _, jax_aux = jax_model.apply({"params": params}, batch,
                                     method="compute_loss")
        with torch.no_grad():
            _, aux = port_model.compute_loss(to_torch(batch))
        if "ranking" in jax_aux:
            jax_aux, aux = jax_aux["ranking"]._asdict(), aux["ranking"]._asdict()
        return [(jax_aux["predictions"], aux["predictions"])]
    return outputs


def tower_outputs(jax_model, port_model, batch):
    def outputs(params):
        got = []
        for method in ("query_embeddings", "candidate_embeddings"):
            want = jax_model.apply({"params": params}, batch, method=method)
            with torch.no_grad():
                got.append((want, getattr(port_model, method)(
                    to_torch(batch))))
        return got
    return outputs


# Every single-process example's tiny size (`main`'s keyword arguments)
# and the keys of what it returns that the end-to-end tests check.
CASES = {
    "basic_ranking": ({"epochs": 1}, ["rmse", "total_loss"]),
    "deep_ranking_dcn": ({"epochs": 1, "projection_dim": 16},
                         ["rmse", "total_loss"]),
    "deep_recommenders": ({"epochs": 1}, ["embedding-only",
                                          "1 hidden layer"]),
    "context_features": ({"epochs": 1}, ["epochs"]),
    "featurization": ({"epochs": 1}, ["epochs"]),
    "sequential_retrieval": ({"epochs": 1, "encoder": "attention"},
                             ["epochs"]),
    "listwise_ranking": ({"epochs": 1}, ["mse", "pairwise", "lambdarank",
                                         "list_mle", "approx_ndcg"]),
    "multitask": ({"epochs": 1}, ["rating", "retrieval", "joint"]),
    "prebuilt_dlrm": ({"epochs": 1, "optimizer": "clippy_composite"},
                      ["epochs"]),
    "unified_embedding": ({"epochs": 1}, ["collisionless", "unified"]),
    "hybrid_dlrm": ({"steps": 3}, ["losses", "engine_steps", "final_loss"]),
    "full_pipeline": ({"epochs": 1}, [
        "factorized_top_k/top_10_categorical_accuracy",
        "factorized_top_k/top_100_categorical_accuracy", "loss"]),
}


def numbers(value) -> list:
    """Every int and float inside `value` (dicts and lists walked)."""
    if isinstance(value, dict):
        return [x for v in value.values() for x in numbers(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in numbers(v)]
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return [value]
    return []


def run_main(name: str) -> None:
    """`examples.<name>.main(device="cpu", ...)` at its tiny size: the
    keys it must return are there and every number under them finite."""
    kwargs, keys = CASES[name]
    torch.manual_seed(0)
    module = importlib.import_module(f"recommenders_tpu_torch.examples.{name}")
    out = module.main(device="cpu", **kwargs)
    for key in keys:
        assert key in out, (key, sorted(out))
    got = numbers({k: out[k] for k in keys})
    assert got and all(math.isfinite(x) for x in got), got
