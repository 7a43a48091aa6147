"""Hybrid DLRM: engine-managed big tables + dense head under a torch
optimizer.

Port of `examples/hybrid_dlrm.py`. The production-scale configuration
(the reference achieves this split with the TPU embedding engine behind
`TPUEmbedding` + `CompositeOptimizer`): a 500k-row user table updated by
the engine's row-sparse Adagrad (the CUDA kernel K1,
`csrc/sparse_apply.cu`, one launch a table a step) while the dense
interaction head trains with Adam, optionally with the engine's update
applied one step stale (pipelined).

    python -m recommenders_tpu_torch.examples.hybrid_dlrm [--device cpu]
"""

import numpy as np
import torch
from torch import nn

from recommenders_tpu_torch import models, tasks
from recommenders_tpu_torch.embedding import config as cfg
from recommenders_tpu_torch.embedding import engine as engine_lib
from recommenders_tpu_torch.examples import adam, dense, parse_args
from recommenders_tpu_torch.utils import device as device_lib

SEED = 0
HEAD_LEARNING_RATE = 1e-2


class DLRMHead(nn.Module):
    """Dense features through Dense(16) + relu, concatenated with the
    user and item activations, then Dense(64) + relu, Dense(1), sigmoid
    and the BCE ranking task. `flax_names` maps its layers to the JAX
    example's compact names (`utils.convert.load_flax_params`)."""

    flax_names = {"dense": "Dense_0", "out": "Dense_1", "hidden": "Dense_2"}

    def __init__(self, num_dense: int = 8, dim: int = 16, device="cuda",
                 generator=None):
        super().__init__()
        self.dense = dense(num_dense, 16, device, generator)
        self.hidden = dense(2 * dim + 16, 64, device, generator)
        self.out = dense(64, 1, device, generator)
        self.task = tasks.Ranking()

    def forward(self, batch, acts):
        dense = torch.relu(self.dense(batch["dense_features"]))
        x = torch.cat([acts["user_id"], acts["item_id"], dense], dim=-1)
        pred = torch.sigmoid(self.out(torch.relu(self.hidden(x)))[:, 0])
        out = self.task(batch["clicked"], pred)
        return out.loss, out.predictions


def build_engine(device) -> engine_lib.EmbeddingEngine:
    return engine_lib.EmbeddingEngine(
        (
            cfg.FeatureConfig(
                table=cfg.TableConfig(
                    500_000, 16, name="user",
                    optimizer=cfg.OptimizerSpec(
                        kind="adagrad", learning_rate=0.1
                    ),
                ),
                name="user_id",
            ),
            cfg.FeatureConfig(
                table=cfg.TableConfig(
                    10_000, 16, name="item",
                    optimizer=cfg.OptimizerSpec(
                        kind="adagrad", learning_rate=0.1
                    ),
                ),
                name="item_id",
            ),
        ),
        device=device,
    )


def make_batches(rng, n_batches, batch_size=4096):
    for _ in range(n_batches):
        item = rng.randint(0, 10_000, batch_size)
        dense = rng.normal(size=(batch_size, 8)).astype(np.float32)
        logit = 2.0 * dense[:, 0] + ((item % 2) - 0.5)
        clicked = (
            rng.uniform(size=batch_size)
            < 1.0 / (1.0 + np.exp(-logit))
        ).astype(np.float32)
        yield {
            "user_id": rng.randint(0, 500_000, batch_size).astype(
                np.int32
            ),
            "item_id": item.astype(np.int32),
            "dense_features": dense,
            "clicked": clicked,
        }


def main(steps: int = 30, pipelined: bool = True, device="cuda"):
    device = device_lib.resolve(device)
    generator = torch.Generator(device).manual_seed(SEED)
    engine = build_engine(device)
    trainer = models.HybridTrainer(
        DLRMHead(device=device, generator=generator), engine,
        adam(HEAD_LEARNING_RATE),
        pipelined=pipelined,
    )
    rng = np.random.RandomState(0)
    batches = list(make_batches(rng, steps))
    state = trainer.init(generator, batches[0])
    losses = []
    for i, batch in enumerate(batches):
        state, loss, _ = trainer.train_step(state, batch)
        losses.append(loss)
        if i % 10 == 0:
            print(f"step {i}: loss={float(loss):.4f}")
    state = trainer.finalize(state)
    losses = [float(x) for x in losses]
    print(
        f"done: {int(state.engine_state.step)} engine steps, "
        f"final loss {losses[-1]:.4f}"
    )
    return {"losses": losses, "engine_steps": int(state.engine_state.step),
            "final_loss": losses[-1], "tables": len(engine._storage_rows)}


if __name__ == "__main__":
    main(device=parse_args().device)
