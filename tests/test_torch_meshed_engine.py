"""The meshed `EmbeddingEngine` on gloo ranks: K1's twin per shard,
against the port's unsharded engine and the JAX meshed engine
(`sparse_update_kernel=True` inside `shard_map` on a 4-device mesh;
mirrors `tests/test_meshed_kernel.py`).

Tolerances:
  - meshed vs the port's unsharded engine, f32: bit-equal. Each shard
    sums a row's duplicates in the global batch's order, as the
    unsharded update does; adam's count of a row whose updates all
    belong to other shards stays untouched there;
  - vs the JAX meshed engine, f32: rtol 1e-5, atol 5e-5 (the rules'
    rsqrt differs by an ulp between XLA and PyTorch, and JAX's
    interpreted kernel routes grads through a bf16 hi + lo split,
    `tests/test_torch_engine.py`);
  - bf16 + stochastic rounding, one step: within one bf16 ulp of the
    JAX meshed engine, whose shards draw with seed + shard·7919 as the
    port's do;
  - `max_unique_ids`: bit-equal to the unsharded engine, including a
    step with more unique ids than the bound (the reference's meshed
    rebase lets foreign ids reach the fold, ROADMAP.md Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.embedding import config as jax_config
from recommenders_tpu.embedding import engine as jax_engine
from recommenders_tpu.parallel import mesh as jax_mesh

from test_torch_sparse_apply import assert_ulp_close, to_f32
import torch_rank_workers as workers

PAD = -1


def _jax_fcs(maxu=None):
    a = jax_config.TableConfig(4000, 32, name="a", max_unique_ids=maxu)
    b = jax_config.TableConfig(9000, 32, name="b")
    return (jax_config.FeatureConfig(table=a, name="fa"),
            jax_config.FeatureConfig(table=b, name="fb"),
            jax_config.FeatureConfig(table=b, name="fb_hist"))


def _batches(steps=3, seed=7, narrow_a=None, scalar_only=False):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        hist = r.randint(0, 9000, (64, 3)).astype(np.int32)
        hist[r.rand(64, 3) < 0.3] = PAD
        a_hi = narrow_a or 4000
        out.append({"fa": r.randint(0, a_hi, 64).astype(np.int32),
                    "fb": r.randint(0, 9000, 64).astype(np.int32),
                    "fb_hist": hist})
        if scalar_only:
            del out[-1]["fb_hist"]
    return out


def _jax_engine(kind, mesh, stacked, bf16_sr, sharding="div", maxu=None):
    return jax_engine.EmbeddingEngine(
        _jax_fcs(maxu), optimizer=jax_config.OptimizerSpec(
            kind=kind, learning_rate=0.05),
        mesh=mesh, dtype=jnp.bfloat16 if bf16_sr else jnp.float32,
        slot_dtype=jnp.bfloat16 if bf16_sr else None,
        stack_tables=stacked, sparse_update_kernel=True, lane_pack=False,
        stochastic_rounding=bf16_sr, row_sharding=sharding)


def _logical(kind, bf16_sr=False):
    eng = _jax_engine(kind, None, False, bf16_sr)
    return jax.tree.map(np.asarray, eng.logical_state(
        eng.init(jax.random.PRNGKey(1))))


def _bits(logical):
    """bf16 planes as uint16 bits (what the port's convert takes)."""
    return jax.tree.map(
        lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
        logical)


def _bf16(bits):
    """A torch bf16 tensor from bf16 bits (or a NumPy bf16 array)."""
    return torch.from_numpy(
        np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _jax_run(kind, stacked, bf16_sr=False, sharding="div", steps=3,
             scalar_only=False):
    mesh = jax_mesh.create_mesh(shape=(4,), axis_names=("model",),
                                devices=jax.devices()[:4])
    eng = _jax_engine(kind, mesh, stacked, bf16_sr, sharding)
    if sharding == "div":
        st = eng.state_from_logical(_logical(kind, bf16_sr))
    else:
        # The mod layout draws the same logical tables from the key.
        st = eng.init(jax.random.PRNGKey(1))

    def loss_of(acts):
        return sum(jnp.sum(jnp.square(a.astype(jnp.float32)))
                   for a in acts.values())

    step = jax.jit(lambda s, b: eng.grad_and_update(s, b, loss_of))
    for batch in _batches(steps, scalar_only=scalar_only):
        st, loss, _ = step(st, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"tables": {k: np.asarray(v) for k, v in
                       eng.logical_tables(st).items()}}


KINDS = ["sgd", "adagrad", "rowwise_adagrad", "adam"]
# (case, (kind, shape, sharding, stacked, bf16_sr, maxu, batches kwargs))
SPECS = {}
for _kind in KINDS:
    SPECS[f"{_kind}-1"] = (_kind, None, "div", True, False, None, {})
    SPECS[f"{_kind}-4"] = (_kind, (4,), "div", True, False, None, {})
SPECS["unstacked-1"] = ("adagrad", None, "div", False, False, None, {})
SPECS["unstacked-4"] = ("adagrad", (4,), "div", False, False, None, {})
SPECS["data-model"] = ("adagrad", (2, 2), "div", False, False, None, {})
SPECS["mod-4"] = ("adagrad", (4,), "mod", False, False, None, {})
# One step: the JAX interpreted kernel draws its rounding bits from a
# block-local hash, the port from the reference twin's, so the two part
# by an ulp at most after a step; scalar features only, since XLA runs a
# bf16 combiner's chain in f32 and rounds once, where PyTorch rounds
# every op (`tests/test_torch_engine.py`).
SPECS["sr-4"] = ("adagrad", (4,), "div", True, True, None,
                 {"steps": 1, "scalar_only": True})
# max_unique_ids: a roomy bound, and one the steps exceed (fa draws
# from 200 ids, ~55 unique of 64 a step, bound 40).
SPECS["maxu-1"] = ("adagrad", None, "div", False, False, 40,
                   {"narrow_a": 200})
SPECS["maxu-4"] = ("adagrad", (4,), "div", False, False, 40,
                   {"narrow_a": 200})
SPECS["maxu-22"] = ("adam", (2, 2), "div", False, False, 40,
                    {"narrow_a": 200})
SPECS["maxu-adam-1"] = ("adam", None, "div", False, False, 40,
                        {"narrow_a": 200})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    items, names = [], []
    for name, (kind, shape, sh, stk, sr, maxu, bkw) in SPECS.items():
        ckpt = (str(tmp_path_factory.mktemp("ckpt") / "engine")
                if name == "unstacked-4" else None)
        logical = _bits(_logical(kind, sr))
        items.append(("engine_run", (kind, shape, sh, stk, sr, maxu,
                                     logical, _batches(**bkw), ckpt)))
        names.append(name)
    # A one-rank world runs the unsharded engine identically on each
    # rank; the meshed cases need four.
    out = workers.cases((4, items))
    return {n: [r[i] for r in out] for i, n in enumerate(names)}


def _assert_equal_states(a, b):
    for part in ("tables", "slots"):
        for name in a[part]:
            if part == "tables":
                np.testing.assert_array_equal(a[part][name], b[part][name],
                                              err_msg=name)
                continue
            for slot in a[part][name]:
                np.testing.assert_array_equal(
                    a[part][name][slot], b[part][name][slot],
                    err_msg=f"{name}/{slot}")


@pytest.mark.parametrize("kind", KINDS)
def test_meshed_kernel_matches_single_device(ranks, kind):
    # adam covers the decay rule's count mask across shards: rows whose
    # updates all belong to OTHER shards must not decay locally.
    base = ranks[f"{kind}-1"][0]
    for r in ranks[f"{kind}-4"]:
        _assert_equal_states(r["state"], base["state"])
        assert r["losses"] == base["losses"]
    want = _jax_run(kind, stacked=True)
    got = ranks[f"{kind}-4"][0]["state"]["tables"]
    for name in want["tables"]:
        np.testing.assert_allclose(got[name], want["tables"][name],
                                   rtol=1e-5, atol=5e-5,
                                   err_msg=f"{kind} {name}")


def test_meshed_kernel_state_stays_sharded(ranks):
    for r in ranks["adagrad-4"]:
        (rows,) = r["shard_rows"].values()
        assert rows == (4096 + 9088) // 4
    for r in ranks["unstacked-4"]:
        assert r["shard_rows"] == {"a": 1024, "b": 2272}


def test_meshed_kernel_unstacked_and_data_model_mesh(ranks):
    base = ranks["unstacked-1"][0]
    for case in ("unstacked-4", "data-model"):
        for r in ranks[case]:
            _assert_equal_states(r["state"], base["state"])
    want = _jax_run("adagrad", stacked=False)
    for name, table in want["tables"].items():
        np.testing.assert_allclose(
            ranks["unstacked-4"][0]["state"]["tables"][name], table,
            rtol=1e-5, atol=5e-5)


def test_mod_row_sharding_matches_div_and_jax(ranks):
    base = ranks["unstacked-1"][0]
    for r in ranks["mod-4"]:
        _assert_equal_states(r["state"], base["state"])
    want = _jax_run("adagrad", stacked=False, sharding="mod")
    for name, table in want["tables"].items():
        np.testing.assert_allclose(
            ranks["mod-4"][0]["state"]["tables"][name], table,
            rtol=1e-5, atol=5e-5)


def test_meshed_sr_bits_match_jax_meshed_sr(ranks):
    """bf16 + stochastic rounding, seeded seed + shard·7919 per shard:
    within one bf16 ulp of the JAX meshed engine after a step."""
    want = _jax_run("adagrad", stacked=True, bf16_sr=True, steps=1,
                    scalar_only=True)
    got = ranks["sr-4"]
    for name, table in want["tables"].items():
        for r in got:
            np.testing.assert_array_equal(
                r["state"]["tables"][name],
                got[0]["state"]["tables"][name])
        assert_ulp_close(_bf16(got[0]["state"]["tables"][name]),
                         _bf16(table), bf16=True, max_ulp=1)
    for v in got[0]["state"]["tables"].values():
        assert np.isfinite(to_f32(_bf16(v))).all()


@pytest.mark.parametrize("case", ["maxu-4", "maxu-22"])
def test_max_unique_ids_matches_the_unsharded_engine(ranks, case):
    """Every id outside a shard's rows is padding before the fold; the
    fold is global, so a step past the bound drops the same ids."""
    base = ranks["maxu-adam-1" if case == "maxu-22" else "maxu-1"][0]
    for r in ranks[case]:
        _assert_equal_states(r["state"], base["state"])


def test_meshed_checkpoint_round_trip(ranks):
    """Rank 0 writes the logical state; every rank restores its shard."""
    assert all(r["restored_equal"] for r in ranks["unstacked-4"])
