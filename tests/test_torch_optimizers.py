"""The port's dense optimizers against the JAX package's optax ones, on
the CPU: `ClippyAdagrad` (every accumulator mode, a schedule, clipping
that binds, a parameter without a gradient at some steps) and `composite_optimizer` (ClippyAdagrad + Adam by path)
over 5 steps of the same gradients, plus `shrink_by_references` and the
composite's `state_dict` round trip.

Tolerances: `shrink_by_references` to rtol 1e-6. ClippyAdagrad after
5 steps: parameters and accumulators to rtol 1e-5 and atol 1e-7,
clipping factors to rtol 1e-5 (XLA's CPU `rsqrt` approximates within 2
ulps where the port takes `1/sqrt` with two IEEE roundings). The
composite's Adam half to atol 1e-6: `optax.adam` takes its bias
corrections `1 - β^t` in f32, where `f32(0.999)` puts `1 - β₂` 1.3e-5
off, and `torch.optim.Adam` in float64, so an update differs by up to
~1e-5 relative, ≤ 6.5e-7 over 5 steps at lr 1e-2 (ROADMAP Queue C).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommenders_tpu.optimizers import clippy_adagrad as jax_clippy_adagrad
from recommenders_tpu.optimizers import composite_optimizer as jax_composite
from recommenders_tpu.optimizers import path_contains as jax_path_contains
from recommenders_tpu.optimizers import (
    shrink_by_references as jax_shrink_by_references,
)
from recommenders_tpu_torch import optimizers

STEPS = 5
SHAPES = {"embedding": {"table": (40, 8)},
          "dense": {"kernel": (8, 4), "bias": (4,)}}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {group: {name: (rng.randn(*shape) * 0.1).astype(np.float32)
                    for name, shape in leaves.items()}
            for group, leaves in SHAPES.items()}


def _grads(seed, step):
    rng = np.random.RandomState(1000 * seed + step)
    out = {}
    for group, leaves in SHAPES.items():
        out[group] = {}
        for name, shape in leaves.items():
            g = rng.randn(*shape).astype(np.float32)
            g[rng.rand(*shape) < 0.2] = 0.0      # exact zeros
            out[group][name] = g
    return out


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield ".".join(prefix + (key,)), value


def _torch_params(params):
    return {name: torch.nn.Parameter(torch.from_numpy(value.copy()))
            for name, value in _flat(params)}


def _run(jax_opt, torch_opt, tparams, seed, missing=frozenset()):
    """5 steps of both optimizers on the same gradients; returns the JAX
    params and state. At the steps in `missing` the dense kernel has no
    gradient in torch, and a zero one in JAX (as optax sees a parameter
    the loss does not reach)."""
    params = jax.tree.map(jnp.asarray, _params(seed))
    state = jax_opt.init(params)
    for step in range(STEPS):
        grads = _grads(seed, step)
        if step in missing:
            grads["dense"]["kernel"] = np.zeros_like(
                grads["dense"]["kernel"])
        updates, state = jax_opt.update(jax.tree.map(jnp.asarray, grads),
                                        state, params)
        params = optax.apply_updates(params, updates)
        torch_opt.zero_grad()
        for name, g in _flat(grads):
            if not (step in missing and name == "dense.kernel"):
                tparams[name].grad = torch.from_numpy(g.copy())
        torch_opt.step()
    return params, state


CLIPPY_CASES = {
    "delayed": dict(learning_rate=0.05),
    "standard": dict(learning_rate=0.05,
                     use_standard_accumulator_update=True),
    "clip_accumulator": dict(learning_rate=0.5, clip_accumulator_update=True),
    "binding": dict(learning_rate=2.0, variable_relative_threshold=0.01),
    "accumulator_relative": dict(learning_rate=0.5,
                                 accumulator_relative_threshold=0.05,
                                 initial_accumulator_value=0.5),
    "schedule": dict(learning_rate=lambda count: 0.3 / (1.0 + count)),
    # The dense kernel without a gradient at steps 1 and 4 (a zero one
    # in optax): one step count for the whole optimizer drives the
    # schedule, and a step without a gradient resets the factor to 1.
    "schedule_missing_grads": dict(
        learning_rate=lambda count: 2.0 / (1.0 + count),
        variable_relative_threshold=0.01),
}
MISSING_STEPS = {"schedule_missing_grads": frozenset({1, 4})}


@pytest.mark.parametrize("case", sorted(CLIPPY_CASES))
def test_clippy_adagrad_matches_optax(case):
    kw = CLIPPY_CASES[case]
    tparams = _torch_params(_params(1))
    tkw = dict(kw)
    tkw["lr"] = tkw.pop("learning_rate")
    opt = optimizers.ClippyAdagrad(list(tparams.values()), **tkw)
    params, state = _run(jax_clippy_adagrad(**kw), opt, tparams, 1,
                         MISSING_STEPS.get(case, frozenset()))
    accum = dict(_flat(jax.tree.map(np.asarray, state.accumulator)))
    factors = dict(_flat(jax.tree.map(np.asarray, state.clipping_factors)))
    assert int(state.count) == STEPS
    assert opt.state["count"] == STEPS
    clipped = []
    for name, want in _flat(jax.tree.map(np.asarray, params)):
        p = tparams[name]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        s = opt.state[p]
        np.testing.assert_allclose(s["accumulator"].numpy(), accum[name],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(float(s["clipping_factor"]),
                                   float(factors[name]), rtol=1e-5,
                                   err_msg=name)
        clipped.append(float(factors[name]) < 1.0)
    if case == "binding":
        assert all(clipped)
    if case in MISSING_STEPS:
        # The last step gave the kernel no gradient: its factor is 1,
        # where the other two bind.
        assert float(opt.state[tparams["dense.kernel"]]
                     ["clipping_factor"]) == 1.0
        assert sum(clipped) == 2


def test_clippy_adagrad_rejects_both_accumulator_modes():
    with pytest.raises(ValueError, match="cannot both"):
        optimizers.ClippyAdagrad([torch.nn.Parameter(torch.zeros(2))],
                                 clip_accumulator_update=True,
                                 use_standard_accumulator_update=True)


@pytest.mark.parametrize("absolute", [0.0, 1e-3])
def test_shrink_by_references_matches_jax(absolute):
    rng = np.random.RandomState(3)
    tensor = rng.randn(6, 5).astype(np.float32)
    tensor[0] = 0.0
    refs = [rng.randn(6, 5).astype(np.float32) * 0.1,
            rng.rand(6, 5).astype(np.float32)]
    want, wscale = jax_shrink_by_references(tensor, refs, [0.1, 0.2],
                                                   absolute)
    got, scale = optimizers.shrink_by_references(
        torch.from_numpy(tensor), [torch.from_numpy(r) for r in refs],
        [0.1, 0.2], absolute)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(float(scale), float(wscale), rtol=1e-6)
    assert 0 < float(scale) <= 1
    for args, match in (((torch.ones(2), [torch.ones(2)], [-1.0], 0.0),
                         "non-negative"),
                        ((torch.ones(2), [torch.ones(2)], [1.0], -1.0),
                         "non-negative"),
                        ((torch.ones(2), [torch.ones(2)], [], 0.0),
                         "same length")):
        with pytest.raises(ValueError, match=match):
            optimizers.shrink_by_references(*args)


def _composite(tparams):
    return optimizers.composite_optimizer(
        [(lambda p: optimizers.ClippyAdagrad(p, lr=0.05),
          optimizers.path_contains("embedding")),
         (lambda p: torch.optim.Adam(p, lr=1e-2), lambda path: True)],
        tparams.items())


def test_composite_matches_optax_multi_transform():
    jax_opt = jax_composite(
        [(jax_clippy_adagrad(0.05),
          jax_path_contains("embedding")),
         (optax.adam(1e-2), lambda path: True)])
    tparams = _torch_params(_params(2))
    opt = _composite(tparams)
    assert isinstance(opt, torch.optim.Optimizer)
    assert [len(g["params"]) for g in opt.param_groups] == [1, 2]
    params, _ = _run(jax_opt, opt, tparams, 2)
    for name, want in _flat(jax.tree.map(np.asarray, params)):
        np.testing.assert_allclose(tparams[name].detach().numpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    clippy = opt.optimizers[0]
    assert clippy.state["count"] == STEPS


def test_composite_state_dict_round_trip():
    """Two steps, a saved state, three more: a fresh composite loaded
    from the state takes the same three steps bit for bit."""
    tparams = _torch_params(_params(4))
    opt = _composite(tparams)

    def step(params, optimizer, i):
        optimizer.zero_grad()
        for name, g in _flat(_grads(4, i)):
            params[name].grad = torch.from_numpy(g.copy())
        optimizer.step()

    for i in range(2):
        step(tparams, opt, i)
    # A copy, as `torch.save` would write: a state dict holds the
    # optimizer's live tensors.
    saved = copy.deepcopy(opt.state_dict())
    twin = {k: torch.nn.Parameter(v.detach().clone())
            for k, v in tparams.items()}
    other = _composite(twin)
    other.load_state_dict(saved)
    for i in range(2, 5):
        step(tparams, opt, i)
        step(twin, other, i)
    for name in tparams:
        assert torch.equal(tparams[name], twin[name]), name
    opt.zero_grad()
    assert all(p.grad is None for p in tparams.values())


def test_composite_checks_its_routing():
    tparams = _torch_params(_params(5))
    with pytest.raises(ValueError, match="can't be empty"):
        optimizers.composite_optimizer([], tparams.items())
    with pytest.raises(ValueError, match="not handled by any optimizer"):
        optimizers.composite_optimizer(
            [(lambda p: torch.optim.SGD(p, lr=0.1),
              optimizers.path_contains("embedding"))], tparams.items())
    # A predicate that matches nothing holds no optimizer.
    opt = optimizers.composite_optimizer(
        [(lambda p: torch.optim.SGD(p, lr=0.1),
          optimizers.path_contains("nothing")),
         (lambda p: torch.optim.SGD(p, lr=0.1), lambda path: True)],
        tparams.items())
    assert opt.optimizers[0] is None
    with pytest.raises(ValueError, match="routes parameters differently"):
        opt.load_state_dict({"optimizers": [{}, None]})
    assert optimizers.path_contains("embed")(("embedding", "table"))
    assert not optimizers.path_contains("embed")(("dense", "kernel"))
