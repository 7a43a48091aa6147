"""The port's `EmbeddingEngine` against the JAX engine, on the CPU.

State is made by the JAX engine and carried across with
`utils.convert.engine_state_from_logical`; features and the loss are the
same NumPy inputs on both sides.

Tolerances:
  - lookups are gathers and the same combiner arithmetic: equal;
  - f32 training over 5 steps: losses and tables to rtol 1e-5. The
    rules' rsqrt differs by an ulp between XLA and PyTorch, and JAX's
    kernel path (`sparse_update_kernel=True`, run interpreted) routes
    grads through a bf16 hi + lo split (~2⁻¹⁶ relative), so tables also
    get atol 1e-6 (5e-5 against that kernel path);
  - bf16 tables and slots with stochastic rounding, one step: within one
    bf16 ulp (JAX's interpreted kernel draws its bits from a
    block-local hash, the port from the reference twin's);
  - the `logical_state` round trip: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.embedding import config as jax_config
from recommenders_tpu.embedding import engine as jax_engine
from recommenders_tpu_torch.embedding import config
from recommenders_tpu_torch.embedding import engine
from recommenders_tpu_torch.utils import convert

from test_torch_sparse_apply import assert_ulp_close, to_f32

PAD = config.PAD_ID
U, I, D, B = 512, 1024, 16, 32


def _features(pkg, spec_kw=None):
    """(features, optimizer) of a two-table model in package `pkg`."""
    user = pkg.TableConfig(U, D, name="user", combiner="sum")
    item = pkg.TableConfig(I, D, name="item", combiner="mean")
    tag = pkg.TableConfig(300, D, name="tag", combiner="sqrtn")
    fcs = (
        pkg.FeatureConfig(user, name="user_id"),
        pkg.FeatureConfig(item, name="item_id"),
        pkg.FeatureConfig(item, name="history", max_sequence_length=4),
        pkg.FeatureConfig(tag, name="tags"),
        pkg.FeatureConfig(user, name="friends"),
    )
    return fcs, pkg.OptimizerSpec(**(spec_kw or dict(kind="adagrad",
                                                     learning_rate=0.1)))


def _engines(spec_kw=None, dtype="f32", slot_bf16=False, jax_kernel=False,
             port_kernel=None):
    jfcs, jspec = _features(jax_config, spec_kw)
    tfcs, tspec = _features(config, spec_kw)
    jeng = jax_engine.EmbeddingEngine(
        jfcs, optimizer=jspec, lane_pack=False,
        dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32,
        slot_dtype=jnp.bfloat16 if slot_bf16 else None,
        sparse_update_kernel=jax_kernel,
    )
    teng = engine.EmbeddingEngine(
        tfcs, optimizer=tspec, device="cpu",
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
        slot_dtype=torch.bfloat16 if slot_bf16 else None,
        sparse_update_kernel=port_kernel,
    )
    jstate = jeng.init(jax.random.PRNGKey(0))
    tstate = convert.engine_state_from_logical(
        teng, jax.tree.map(np.asarray, jeng.logical_state(jstate)))
    return jeng, jstate, teng, tstate


def _batch(rng):
    """NumPy features: scalar, multivalent (sum/mean/sqrtn, weighted,
    padded with PAD_ID) and sequence ids."""
    hist = rng.randint(0, I, (B, 4)).astype(np.int32)
    hist[rng.rand(B, 4) < 0.3] = PAD
    tags = rng.randint(0, 300, (B, 3)).astype(np.int32)
    tags[rng.rand(B, 3) < 0.3] = PAD
    friends = rng.randint(0, U, (B, 5)).astype(np.int32)
    friends[rng.rand(B, 5) < 0.4] = PAD
    user = rng.randint(0, U, B).astype(np.int32)
    user[:2] = PAD
    return {
        "user_id": user,
        "item_id": rng.randint(0, I, B).astype(np.int32),
        "history": hist,
        "tags": tags,
        "friends": (friends,
                    rng.uniform(0.5, 2.0, (B, 5)).astype(np.float32)),
    }


def _to(batch, fn):
    return {k: tuple(fn(x) for x in v) if isinstance(v, tuple) else fn(v)
            for k, v in batch.items()}


# Sums of squares: no cancellation, so the loss itself is well
# conditioned and its rtol measures the state, not the sum order.
def _jax_loss(acts):
    x = ((acts["user_id"] + acts["item_id"]) ** 2).sum()
    x = x + (jnp.sin(acts["history"]) ** 2).sum() + (acts["tags"] ** 2).sum()
    return x + ((acts["friends"] - acts["user_id"]) ** 2).sum() * 0.5


def _torch_loss(acts):
    x = ((acts["user_id"] + acts["item_id"]) ** 2).sum()
    x = x + (torch.sin(acts["history"]) ** 2).sum() + (acts["tags"] ** 2).sum()
    return x + ((acts["friends"] - acts["user_id"]) ** 2).sum() * 0.5


def _assert_tables_close(jeng, jstate, teng, tstate, **tol):
    want = jax.tree.map(np.asarray, jeng.logical_state(jstate))
    got = teng.logical_state(tstate)
    for name in want["tables"]:
        np.testing.assert_allclose(to_f32(got["tables"][name]),
                                   to_f32(want["tables"][name]), **tol)
        for slot in want["slots"][name]:
            np.testing.assert_allclose(to_f32(got["slots"][name][slot]),
                                       to_f32(want["slots"][name][slot]),
                                       **tol)


def test_lookup_matches_jax_for_every_feature_kind():
    jeng, jstate, teng, tstate = _engines()
    batch = _batch(np.random.RandomState(0))
    want = jeng.lookup(jstate, _to(batch, jnp.asarray))
    got = teng.lookup(tstate, _to(batch, torch.from_numpy))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    # Padding rows of a scalar feature are zero.
    assert not got["user_id"][:2].any()


def test_lookup_returns_copies_not_views():
    _, _, teng, tstate = _engines()
    ids = torch.tensor([3, 4])
    acts = teng.lookup(tstate, {"user_id": ids})
    before = acts["user_id"].clone()
    tstate.tables["user"][3] += 1.0
    torch.testing.assert_close(acts["user_id"], before, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["adagrad", "rowwise_adagrad"])
@pytest.mark.parametrize("jax_kernel", [False, True])
@pytest.mark.parametrize("pipelined", [False, True])
def test_training_matches_jax_over_five_steps(kind, jax_kernel, pipelined):
    spec_kw = dict(kind=kind, learning_rate=0.1)
    jeng, jstate, teng, tstate = _engines(spec_kw, jax_kernel=jax_kernel)
    rng = np.random.RandomState(1)
    if pipelined:
        jstep = jax.jit(lambda s, p, b: jeng.pipelined_grad_and_update(
            s, p, b, _jax_loss)[:3])
    else:
        jstep = jax.jit(lambda s, b: jeng.grad_and_update(
            s, b, _jax_loss)[:2])
    jpend = tpend = None
    for _ in range(5):
        batch = _batch(rng)
        jb, tb = _to(batch, jnp.asarray), _to(batch, torch.from_numpy)
        if pipelined:
            if jpend is None:
                jstate, jpend, jloss, _ = jeng.pipelined_grad_and_update(
                    jstate, None, jb, _jax_loss)
            else:
                jstate, jpend, jloss = jstep(jstate, jpend, jb)
            tstate, tpend, tloss, _ = teng.pipelined_grad_and_update(
                tstate, tpend, tb, _torch_loss)
        else:
            jstate, jloss = jstep(jstate, jb)
            tstate, tloss, _ = teng.grad_and_update(tstate, tb, _torch_loss)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    if pipelined:
        jstate = jeng.flush(jstate, jpend)
        tstate = teng.flush(tstate, tpend)
    assert tstate.step == int(jstate.step)
    # JAX's interpreted kernel splits each grad into bf16 hi + lo
    # (~2⁻¹⁶ relative): a few 1e-5 on these O(1) rows after 5 steps.
    _assert_tables_close(jeng, jstate, teng, tstate, rtol=1e-5,
                         atol=5e-5 if jax_kernel else 1e-6)


def test_port_scatter_path_matches_jax():
    jeng, jstate, teng, tstate = _engines(port_kernel=False)
    rng = np.random.RandomState(2)
    for _ in range(2):
        batch = _batch(rng)
        jstate, jloss, _ = jeng.grad_and_update(
            jstate, _to(batch, jnp.asarray), _jax_loss)
        tstate, tloss, _ = teng.grad_and_update(
            tstate, _to(batch, torch.from_numpy), _torch_loss)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_tables_close(jeng, jstate, teng, tstate, rtol=1e-5, atol=1e-6)


def test_bf16_tables_and_slots_with_sr_one_step_within_one_ulp():
    spec_kw = dict(kind="adagrad", learning_rate=0.1)
    jeng, jstate, teng, tstate = _engines(spec_kw, dtype="bf16",
                                          slot_bf16=True, jax_kernel=True)
    # Scalar features, as the training step has: XLA computes chains of
    # bf16 ops (the multivalent combiners) in f32 and rounds once, where
    # PyTorch rounds every op.
    full = _batch(np.random.RandomState(3))
    batch = {k: full[k] for k in ("user_id", "item_id")}

    def jax_loss(acts):
        u, i = (acts[k].astype(jnp.float32) for k in ("user_id", "item_id"))
        return ((u + i) ** 2).sum()

    def torch_loss(acts):
        u, i = (acts[k].float() for k in ("user_id", "item_id"))
        return ((u + i) ** 2).sum()

    jstate, jloss, _ = jeng.grad_and_update(
        jstate, _to(batch, jnp.asarray), jax_loss)
    acts = teng.lookup(tstate, _to(batch, torch.from_numpy))
    assert acts["user_id"].dtype == torch.bfloat16
    tstate, tloss, _ = teng.grad_and_update(
        tstate, _to(batch, torch.from_numpy), torch_loss)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = jax.tree.map(np.asarray, jeng.logical_state(jstate))
    got = teng.logical_state(tstate)
    for name in want["tables"]:
        assert got["tables"][name].dtype == torch.bfloat16
        assert_ulp_close(got["tables"][name], want["tables"][name],
                         bf16=True, max_ulp=1)
        for slot in want["slots"][name]:
            assert_ulp_close(got["slots"][name][slot],
                             want["slots"][name][slot], bf16=True,
                             max_ulp=1)


def test_activation_grads_keep_the_bf16_dtype():
    _, _, teng, tstate = _engines(dtype="bf16")
    batch = _to(_batch(np.random.RandomState(4)), torch.from_numpy)
    acts = teng.lookup(tstate, batch)
    _, _, grads = teng._value_and_grad(_torch_loss, acts)
    assert all(g.dtype == torch.bfloat16 for g in grads.values())


def test_sr_seed_is_int32_step_times_1000003_plus_table_index():
    _, _, teng, tstate = _engines()
    seen = []
    real = engine.sparse_optimizer.apply_sparse

    def spy(*args, **kw):
        seen.append(kw["sr_seed"])
        return real(*args, **kw)

    engine.sparse_optimizer.apply_sparse = spy
    try:
        tstate.step = 5000
        batch = _to(_batch(np.random.RandomState(5)), torch.from_numpy)
        teng.grad_and_update(tstate, batch, _torch_loss)
    finally:
        engine.sparse_optimizer.apply_sparse = real
    # Tables in sorted name order: item, tag, user.
    base = np.int32(np.int64(5000 * 1000003 + 2**31) % 2**32 - 2**31)
    assert seen == [int(base), int(base) + 1, int(base) + 2]


def test_logical_state_round_trip_bit_equal():
    jeng, jstate, teng, tstate = _engines(dtype="bf16", slot_bf16=True)
    logical = jax.tree.map(np.asarray, jeng.logical_state(jstate))
    back = convert.engine_state_to_logical(teng, tstate)
    bf16 = logical["tables"]["user"].dtype
    for name in logical["tables"]:
        np.testing.assert_array_equal(
            back["tables"][name].view(np.uint16),
            logical["tables"][name].view(np.uint16))
        for slot in logical["slots"][name]:
            np.testing.assert_array_equal(
                back["slots"][name][slot].view(np.uint16),
                logical["slots"][name][slot].view(np.uint16))
    again = jeng.state_from_logical(jax.tree.map(
        lambda a: a.view(bf16) if a.dtype == np.uint16 else a, back))
    for name in logical["tables"]:
        np.testing.assert_array_equal(
            np.asarray(again.tables[name]).view(np.uint16),
            logical["tables"][name].view(np.uint16))


@pytest.mark.parametrize("kwargs,match", [
    (dict(lane_pack=True), "lane_pack"),
    # Stacking is ported; with the mod permutation it is refused, as in
    # the JAX engine.
    (dict(stack_tables=True, row_sharding="mod"), "stack_tables"),
    # The meshed engine is ported; it takes a `parallel.Mesh`.
    (dict(mesh=object()), "meshed"),
])
def test_unported_layouts_raise(kwargs, match):
    fcs, spec = _features(config)
    error = {"row_sharding": ValueError, "mesh": TypeError}.get(
        next(iter(kwargs)) if len(kwargs) == 1 else "row_sharding",
        NotImplementedError)
    with pytest.raises(error, match=match):
        engine.EmbeddingEngine(fcs, optimizer=spec, device="cpu", **kwargs)


def test_config_checks():
    with pytest.raises(ValueError, match="combiner"):
        config.TableConfig(10, 4, name="t", combiner="max")
    with pytest.raises(ValueError, match="positive"):
        config.TableConfig(0, 4, name="t")
    with pytest.raises(ValueError, match="max_unique_ids"):
        config.TableConfig(10, 4, name="t", max_unique_ids=0)
    t = config.TableConfig(10, 4, name="t")
    with pytest.raises(ValueError, match="share the name"):
        engine.EmbeddingEngine(
            (config.FeatureConfig(t, "a"),
             config.FeatureConfig(config.TableConfig(11, 4, name="t"), "b")),
            device="cpu")
    init = config.default_initializer(16)(
        torch.Generator().manual_seed(0), (4096, 16), device="cpu")
    assert float(init.abs().max()) <= 2.0 / 4.0 + 1e-6
