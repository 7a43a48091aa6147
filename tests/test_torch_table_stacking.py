"""Table stacking in the port's `EmbeddingEngine`, on the CPU.

Mirrors `tests/test_table_stacking.py`: tables that share (dim,
optimizer) live as row ranges of one storage tensor, and the stacked
engine must equal the unstacked one: the same initial tables from one
generator, the same lookups, and the same state after updates, for every
rule, on the kernel path (K1's twin here) and the scatter path. The
layout round trip moves state, slots included, between the two layouts.

Against the JAX package: its stacked engine's state is carried across
with `utils.convert`, and the port's stacked engine must match it.

Tolerances:
  - port stacked against port unstacked, f32: bit-equal (the stable sort
    keeps each table's duplicate grads in the same order);
  - port against the JAX stacked engine, f32, two steps: rtol 1e-5 and
    atol 1e-6 (XLA's rsqrt differs from 1/sqrt by an ulp);
  - bf16 tables and slots with stochastic rounding, one step, against the
    JAX stacked engine's interpreted kernel: within one bf16 ulp (the
    seed `step·1000003 + t_idx` indexes storages in sorted name order in
    both packages; the JAX kernel draws its bits from a block-local hash,
    the port from the reference twin's).
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

OPTS = {
    "adagrad": dict(kind="adagrad", learning_rate=0.1),
    "rowwise_adagrad": dict(kind="rowwise_adagrad", learning_rate=0.1),
    "adam": dict(kind="adam", learning_rate=0.05),
    "sgd": dict(kind="sgd", learning_rate=0.1),
    "ftrl": dict(kind="ftrl", learning_rate=0.1,
                 l1_regularization_strength=0.01),
}


def _configs(pkg, dim=8, extra_dim=4, opt=None, max_unique=None):
    """Three dim-`dim` tables (two stackable + one shared by two
    features) and one dim-`extra_dim` table that must stay solo."""
    opt = None if opt is None else pkg.OptimizerSpec(**OPTS[opt])
    t_user = pkg.TableConfig(40, dim, name="user", optimizer=opt)
    t_item = pkg.TableConfig(72, dim, name="item", optimizer=opt,
                             max_unique_ids=max_unique)
    t_tag = pkg.TableConfig(24, dim, name="tag", combiner="sum",
                            optimizer=opt)
    t_ctx = pkg.TableConfig(16, extra_dim, name="ctx")
    return (
        pkg.FeatureConfig(table=t_user, name="uid"),
        pkg.FeatureConfig(table=t_item, name="iid"),
        pkg.FeatureConfig(table=t_item, name="hist"),
        pkg.FeatureConfig(table=t_tag, name="tags"),
        pkg.FeatureConfig(table=t_ctx, name="ctx"),
    )


def _features(rng, batch=16):
    """NumPy features: scalar ids, multivalent ids with padding on a
    shared table (mean) and on a sum table."""
    hist = rng.randint(0, 72, (batch, 5)).astype(np.int32)
    hist[rng.rand(batch, 5) < 0.2] = config.PAD_ID
    tags = rng.randint(0, 24, (batch, 3)).astype(np.int32)
    tags[rng.rand(batch, 3) < 0.3] = config.PAD_ID
    return {
        "uid": rng.randint(0, 40, batch).astype(np.int32),
        "iid": rng.randint(0, 72, batch).astype(np.int32),
        "hist": hist,
        "tags": tags,
        "ctx": rng.randint(0, 16, batch).astype(np.int32),
    }


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss(acts):
    return sum(torch.sum(torch.square(a.float())) for a in acts.values())


def _jax_loss(acts):
    return sum(jnp.sum(jnp.square(a.astype(jnp.float32)))
               for a in acts.values())


def _pair(opt=None, use_kernel=None, **kw):
    fcs = _configs(config, opt=opt, **kw)
    plain = engine.EmbeddingEngine(fcs, sparse_update_kernel=use_kernel,
                                   device="cpu")
    stacked = engine.EmbeddingEngine(fcs, sparse_update_kernel=use_kernel,
                                     stack_tables=True, device="cpu")
    return plain, stacked


def _assert_state_equal(a, b):
    for name in a["tables"]:
        torch.testing.assert_close(a["tables"][name], b["tables"][name],
                                   rtol=0, atol=0, msg=name)
        assert set(a["slots"][name]) == set(b["slots"][name])
        for slot in a["slots"][name]:
            torch.testing.assert_close(a["slots"][name][slot],
                                       b["slots"][name][slot], rtol=0,
                                       atol=0, msg=f"{name}/{slot}")


def test_grouping():
    _, stacked = _pair()
    storages = {s for s, _ in stacked._storage.values()}
    # user+item+tag stack (dim 8, same default optimizer); ctx is solo.
    assert storages == {"stacked:user+item+tag", "ctx"}
    assert stacked._storage_members["stacked:user+item+tag"] == [
        "user", "item", "tag"]
    # Each member at the padded rows before it (128 each).
    assert [stacked._storage[n][1] for n in ("user", "item", "tag")] == [
        0, 128, 256]
    assert stacked._storage["ctx"] == ("ctx", 0)
    state = stacked.init(torch.Generator().manual_seed(0))
    assert state.tables["stacked:user+item+tag"].shape == (384, 8)
    assert state.slots["stacked:user+item+tag"]["accumulator"].shape == (
        384, 8)


def test_grouping_matches_the_jax_engine():
    ours = engine.EmbeddingEngine(_configs(config), stack_tables=True,
                                  device="cpu")
    theirs = jax_engine.EmbeddingEngine(_configs(jax_config),
                                        stack_tables=True, lane_pack=False)
    assert ours._storage == theirs._storage
    assert ours._storage_members == theirs._storage_members


def test_max_unique_tables_stay_solo():
    _, stacked = _pair(max_unique=8)
    assert stacked._storage["item"] == ("item", 0)
    assert stacked._storage_members["stacked:user+tag"] == ["user", "tag"]


def test_mod_sharding_rejected():
    with pytest.raises(ValueError, match="stack_tables"):
        engine.EmbeddingEngine(_configs(config), stack_tables=True,
                               row_sharding="mod", device="cpu")


def test_init_identical_per_table():
    plain, stacked = _pair()
    sp = plain.init(torch.Generator().manual_seed(7))
    ss = stacked.init(torch.Generator().manual_seed(7))
    _assert_state_equal(plain.logical_state(sp), stacked.logical_state(ss))


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "scatter"])
@pytest.mark.parametrize("opt", [None, *OPTS])
def test_lookup_and_updates_match_unstacked(opt, use_kernel):
    plain, stacked = _pair(opt=opt, use_kernel=use_kernel)
    sp = plain.init(torch.Generator().manual_seed(0))
    ss = stacked.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    for _ in range(3):
        feats = _torch(_features(rng))
        ap, as_ = plain.lookup(sp, feats), stacked.lookup(ss, feats)
        for k in ap:
            torch.testing.assert_close(ap[k], as_[k], rtol=0, atol=0, msg=k)
        sp, lp, _ = plain.grad_and_update(sp, feats, _loss)
        ss, ls, _ = stacked.grad_and_update(ss, feats, _loss)
        assert float(lp) == float(ls)
    assert sp.step == ss.step == 3
    _assert_state_equal(plain.logical_state(sp), stacked.logical_state(ss))


def test_pipelined_steps_match_unstacked():
    plain, stacked = _pair()
    sp = plain.init(torch.Generator().manual_seed(4))
    ss = stacked.init(torch.Generator().manual_seed(4))
    rng = np.random.RandomState(8)
    pp = ps = None
    for _ in range(3):
        feats = _torch(_features(rng))
        sp, pp, lp, _ = plain.pipelined_grad_and_update(sp, pp, feats, _loss)
        ss, ps, ls, _ = stacked.pipelined_grad_and_update(ss, ps, feats,
                                                          _loss)
        assert float(lp) == float(ls)
    sp, ss = plain.flush(sp, pp), stacked.flush(ss, ps)
    _assert_state_equal(plain.logical_state(sp), stacked.logical_state(ss))


def test_one_sparse_update_per_storage(monkeypatch):
    """The kernel path runs once a step for the whole stacked group (K1
    launches once on the card): two storages, where unstacked has four."""
    plain, stacked = _pair()
    feats = _torch(_features(np.random.RandomState(1)))
    calls = []
    real = engine.sparse_optimizer.apply_sparse

    def spy(spec, table, *args, **kw):
        calls.append((table.shape[0], kw["sr_seed"]))
        return real(spec, table, *args, **kw)

    monkeypatch.setattr(engine.sparse_optimizer, "apply_sparse", spy)
    state = stacked.init(torch.Generator().manual_seed(0))
    state.step = 3
    stacked.grad_and_update(state, feats, _loss)
    # Sorted storage names: "ctx" (t_idx 0), then the stacked group.
    assert calls == [(128, 3 * 1000003), (384, 3 * 1000003 + 1)]
    calls.clear()
    plain.grad_and_update(plain.init(torch.Generator().manual_seed(0)),
                          feats, _loss)
    assert len(calls) == 4


def test_out_of_range_ids_stay_in_their_table():
    """An id past a member's rows is dropped by `update` (as for a solo
    table), never applied to the next member's rows."""
    plain, stacked = _pair(use_kernel=True)
    sp = plain.init(torch.Generator().manual_seed(2))
    ss = stacked.init(torch.Generator().manual_seed(2))
    ids = torch.tensor([3, 128 + 5, 500, 7], dtype=torch.int32)
    grads = {"uid": torch.ones(4, 8)}
    sp = plain.update(sp, {"uid": ids}, grads)
    ss = stacked.update(ss, {"uid": ids}, grads)
    _assert_state_equal(plain.logical_state(sp), stacked.logical_state(ss))
    with pytest.raises(IndexError):
        stacked.lookup(ss, {"uid": torch.tensor([200])})


@pytest.mark.parametrize("kind", ["adagrad", "adam"])
def test_logical_roundtrip_moves_between_layouts(kind):
    """`logical_state` of either layout loads into the other, slots
    included, and comes back bit-equal after a step on each side."""
    plain, stacked = _pair(opt=kind)
    ss = stacked.init(torch.Generator().manual_seed(5))
    feats = _torch(_features(np.random.RandomState(6)))
    ss, _, _ = stacked.grad_and_update(ss, feats, _loss)
    logical = stacked.logical_state(ss)
    sp = plain.state_from_logical(logical)
    for name in sp.tables:
        torch.testing.assert_close(sp.tables[name],
                                   logical["tables"][name], rtol=0, atol=0)
    back = stacked.state_from_logical(plain.logical_state(sp))
    for sname in ss.tables:
        torch.testing.assert_close(back.tables[sname], ss.tables[sname],
                                   rtol=0, atol=0)
        for slot in ss.slots[sname]:
            torch.testing.assert_close(back.slots[sname][slot],
                                       ss.slots[sname][slot], rtol=0, atol=0)
    # Both continue identically from the moved state.
    feats = _torch(_features(np.random.RandomState(7)))
    sp, _, _ = plain.grad_and_update(sp, feats, _loss)
    back, _, _ = stacked.grad_and_update(back, feats, _loss)
    _assert_state_equal(plain.logical_state(sp), stacked.logical_state(back))
    assert back.step == 2


def _jax_pair(dtype="f32", slot_bf16=False):
    """The JAX stacked engine (kernel path, interpreted) and the port's,
    the port's state carried from JAX's through `utils.convert`."""
    jeng = jax_engine.EmbeddingEngine(
        _configs(jax_config), stack_tables=True, lane_pack=False,
        sparse_update_kernel=True,
        dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32,
        slot_dtype=jnp.bfloat16 if slot_bf16 else None)
    teng = engine.EmbeddingEngine(
        _configs(config), stack_tables=True, device="cpu",
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
        slot_dtype=torch.bfloat16 if slot_bf16 else None)
    jstate = jeng.init(jax.random.PRNGKey(0))
    tstate = convert.engine_state_from_logical(
        teng, jax.tree.map(np.asarray, jeng.logical_state(jstate)))
    return jeng, jstate, teng, tstate


def test_stacked_f32_matches_the_jax_stacked_engine():
    jeng, jstate, teng, tstate = _jax_pair()
    rng = np.random.RandomState(12)
    for step in range(2):
        batch = _features(rng)
        want = jeng.lookup(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        got = teng.lookup(tstate, _torch(batch))
        for k in want:
            # Equal on the same state; after a step, the tables' tolerance.
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0 if step == 0 else 1e-5,
                                       atol=0 if step == 0 else 5e-5,
                                       err_msg=k)
        jstate, jloss, _ = jeng.grad_and_update(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            _jax_loss)
        tstate, tloss, _ = teng.grad_and_update(tstate, _torch(batch),
                                                _loss)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = jax.tree.map(np.asarray, jeng.logical_state(jstate))
    got = teng.logical_state(tstate)
    for name in want["tables"]:
        # The JAX interpreted kernel splits grads into bf16 hi + lo.
        np.testing.assert_allclose(got["tables"][name].numpy(),
                                   want["tables"][name], rtol=1e-5,
                                   atol=5e-5)
        for slot in want["slots"][name]:
            np.testing.assert_allclose(got["slots"][name][slot].numpy(),
                                       want["slots"][name][slot],
                                       rtol=1e-5, atol=5e-5)


def test_stacked_bf16_with_sr_matches_the_jax_stacked_engine():
    jeng, jstate, teng, tstate = _jax_pair(dtype="bf16", slot_bf16=True)
    # Scalar features: XLA computes chains of bf16 ops (the multivalent
    # combiners) in f32 and rounds once, where PyTorch rounds every op.
    full = _features(np.random.RandomState(13))
    batch = {k: full[k] for k in ("uid", "iid", "ctx")}
    jstate, jloss, _ = jeng.grad_and_update(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, _jax_loss)
    tstate, tloss, _ = teng.grad_and_update(tstate, _torch(batch), _loss)
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


def test_convert_round_trip_of_a_stacked_engine():
    """`engine_state_to_logical` / `engine_state_from_logical` carry a
    stacked engine's state out and back bit for bit (bf16 as bits)."""
    _, _, teng, tstate = _jax_pair(dtype="bf16", slot_bf16=True)
    out = convert.engine_state_to_logical(teng, tstate)
    assert set(out["tables"]) == {"user", "item", "tag", "ctx"}
    back = convert.engine_state_from_logical(teng, out)
    for sname in tstate.tables:
        assert torch.equal(back.tables[sname].view(torch.int16),
                           tstate.tables[sname].view(torch.int16))
        for slot in tstate.slots[sname]:
            assert torch.equal(back.slots[sname][slot].view(torch.int16),
                               tstate.slots[sname][slot].view(torch.int16))
    assert to_f32(back.tables["ctx"]).shape == (128, 4)
