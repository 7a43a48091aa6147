"""The port's mesh, collectives, `distributed_top_k` and
`cross_replica_concat` on four gloo ranks, against the JAX package on a
4-device CPU mesh.

The ranks run through `parallel.launch.run_ranks` (spawned processes, a
`file://` store, `torch_rank_workers`, which imports no JAX). Top-k and
the pooled rows are copies, so they must be equal; the pooled gradient is
a sum of ±1-weighted terms of exact f32 values: equal to a float64
oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from recommenders_tpu.ops import topk as jax_topk
from recommenders_tpu.tasks import retrieval as jax_retrieval
from recommenders_tpu_torch.parallel import launch
from recommenders_tpu_torch.parallel import mesh as mesh_lib

import torch_rank_workers as workers

K = 7


def _inputs():
    rng = np.random.RandomState(0)
    scores = rng.normal(size=(5, 64)).astype(np.float32)
    ids = rng.permutation(1000)[:64].astype(np.int32)[None].repeat(5, 0)
    rows = rng.normal(size=(8, 3)).astype(np.float32)
    weights = rng.choice([-1.0, 1.0], size=(4, 8, 3)).astype(np.float32)
    return scores, ids, rows, weights


@pytest.fixture(scope="module")
def ranks():
    scores, ids, rows, weights = _inputs()
    return launch.run_ranks(workers.mesh_basics, 4, "gloo", "cpu", scores,
                            ids, K, rows, weights, threads=1)


def test_mesh_coordinates_follow_the_device_mesh(ranks):
    # Row-major (data, model), as a JAX mesh lays out its devices.
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        d = r["coords"][0]
        np.testing.assert_array_equal(r["gathered_model"],
                                      [2 * d, 2 * d + 1])


def test_shard_batch_slices_the_data_axis_and_replicates_ragged(ranks):
    for r in ranks:
        d = r["coords"][0]
        np.testing.assert_array_equal(r["shard"]["a"],
                                      np.arange(4 * d, 4 * d + 4))
        np.testing.assert_array_equal(
            r["shard"]["b"][0], np.arange(16).reshape(8, 2)[4 * d:4 * d + 4])
        np.testing.assert_array_equal(r["shard"]["b"][1],
                                      np.arange(4 * d, 4 * d + 4))
        np.testing.assert_array_equal(r["shard"]["ragged"], np.arange(7))


def test_distributed_top_k_matches_jax(ranks):
    scores, ids, _, _ = _inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("model",))
    fn = jax.jit(jax.shard_map(
        lambda s, i: jax_topk.distributed_top_k(s, i, K, "model"),
        mesh=mesh, in_specs=(P(None, "model"), P(None, "model")),
        out_specs=(P(), P()), check_vma=False))
    want_s, want_i = (np.asarray(x) for x in fn(jnp.asarray(scores),
                                                 jnp.asarray(ids)))
    for r in ranks:
        got_s, got_i = r["topk"]
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_i, want_i)


def test_cross_replica_concat_roll_ordering_matches_jax(ranks):
    """Own rows first after the concat (identity labels hold)."""
    _, _, rows, _ = _inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    fn = jax.jit(jax.shard_map(
        lambda x: jax_retrieval.cross_replica_concat(x, "data"), mesh=mesh,
        in_specs=P("data"), out_specs=P("data"), check_vma=False))
    want = np.asarray(fn(jnp.asarray(rows))).reshape(4, 8, 3)
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["pooled"], want[i])
        np.testing.assert_array_equal(r["pooled"][:2], rows[2 * i:2 * i + 2])


def test_cross_replica_concat_gradient_is_the_all_gather_transpose(ranks):
    _, _, rows, weights = _inputs()
    # d/dx_i of Σ_r Σ W_r · roll(gather(x), -2r): every rank's weight on
    # rank i's rows.
    want = np.zeros((8, 3), np.float64)
    for r in range(4):
        want += np.roll(weights[r].astype(np.float64), 2 * r, axis=0)
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["pooled_grad"],
                                      want[2 * i:2 * i + 2].astype(np.float32))


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.run_ranks(workers.failing_rank, 2, "gloo", "cpu", timeout=120)


def test_run_ranks_defaults_to_cuda_and_checks_for_it(monkeypatch):
    """The launcher's device defaults to "cuda" through
    `utils.device.resolve`, which refuses it without CUDA before any
    rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.run_ranks(workers.failing_rank, 2)


def test_one_process_helpers_without_a_mesh():
    batch = {"a": np.arange(6)}
    assert mesh_lib.shard_batch(batch, None) is batch
    assert mesh_lib.axis_size(None, "data") == 1
    assert mesh_lib.axis_index(None, "model") == 0
    with pytest.raises(TypeError, match="meshed"):
        mesh_lib.check_mesh(object(), "Thing")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.create_mesh((1, 1))
