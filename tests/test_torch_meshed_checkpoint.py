"""Checkpoints of a `Trainer(mesh)` state whose `TpuEmbedding` tables
are row-sharded, on two gloo ranks.

The JAX package saves the global array of every sharded leaf through
orbax and restores it re-sharded like its template
(`recommenders_tpu/utils/checkpoint.py:9-13,36-60`); the port gathers
each sharded table and its Adagrad slot into the logical `[V, D]`
layout, rank 0 writes, and `restore` hands each rank its rows, or the
whole table to a template without a mesh. Everything is held bit for
bit: a resume from the checkpoint against the uninterrupted run, the
file's tables against the gathered ones, and a one-device restore
against the gathered state.
"""

import numpy as np
import pytest
import torch

from recommenders_tpu_torch.utils import checkpoint

import torch_rank_workers as workers
from test_torch_meshed_trainer import RANKING_FCS, _ranking_batches
from torch_threads import torch_threads  # noqa: F401 (autouse)

SEED = 21
DENSE = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("meshed") / "ckpt")
    batches = _ranking_batches(steps=6)
    cases = [("meshed_checkpoint", ((1, 2), RANKING_FCS, DENSE, batches,
                                    SEED, path))]
    out = workers.cases((2, cases))
    return path, batches, [r[0] for r in out]


def test_resume_from_a_checkpoint_is_bit_equal_to_the_straight_run(ranks):
    _, _, out = ranks
    for r in out:
        assert r["restored_step"] == 3
        assert r["resumed"] == r["straight"]
        for name, value in r["straight_params"].items():
            np.testing.assert_array_equal(r["resumed_params"][name], value,
                                          err_msg=name)


def test_the_file_holds_the_logical_tables_and_slots(ranks):
    path, _, out = ranks
    saved = torch.load(f"{path}/{checkpoint.STATE_FILE}", map_location="cpu",
                       weights_only=True)
    sharded = sorted(out[0]["shard_rows"])
    assert sharded, "no table was row-sharded"
    params = list(saved["params"])
    for name in sharded:
        logical = out[0]["saved"][name]
        # Each rank held half of the rows.
        assert out[0]["shard_rows"][name] * 2 == logical.shape[0]
        np.testing.assert_array_equal(saved["params"][name].numpy(), logical)
        slot = saved["opt_state"]["state"][params.index(name)]["sum"]
        np.testing.assert_array_equal(slot.numpy(),
                                      out[0]["saved_sums"][name])
    for name, value in out[0]["saved"].items():
        np.testing.assert_array_equal(saved["params"][name].numpy(), value)
    # Both ranks' metric states are kept, each its own.
    assert len(saved["metric_states"]["by_rank"]) == 2


def test_a_one_device_template_restores_the_gathered_state(ranks):
    path, batches, out = ranks
    model, trainer = workers._checkpoint_ranking(
        torch.device("cpu"), None, RANKING_FCS, DENSE, SEED + 2)
    state = checkpoint.restore(path, trainer.init())
    assert state.step == 3
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      out[0]["saved"][name], err_msg=name)
    slots = {name: state.opt_state.state[p]["sum"].numpy()
             for name, p in model.named_parameters()}
    for name, value in out[0]["saved_sums"].items():
        np.testing.assert_array_equal(slots[name], value)
