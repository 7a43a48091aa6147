"""Large-scale embedding training with the decoupled engine.

Port of `examples/tpu_embedding.py` (the counterpart of
`docs/examples/tpu_embedding_layer.ipynb`): declare table/feature configs
with per-table sparse optimizers, shard tables over the mesh's model
axis, and train with the decoupled engine (no dense vocab-sized
gradients; every update is the row-sparse kernel K1,
`csrc/sparse_apply.cu`, on each rank's shard), optionally with the update
applied one step stale.

One rank a card by default (NCCL); `--ranks N` runs N ranks, sharing the
cards over gloo when there are fewer cards than ranks.

    python -m recommenders_tpu_torch.examples.tpu_embedding [--device cpu] [--ranks N]
"""

import numpy as np
import torch

from recommenders_tpu_torch import parallel
from recommenders_tpu_torch.embedding import config as cfg
from recommenders_tpu_torch.embedding import engine as engine_lib
from recommenders_tpu_torch.examples import is_first_rank, launch
from recommenders_tpu_torch.examples import parse_args


def build_engine(mesh, device) -> engine_lib.EmbeddingEngine:
    watches_table = cfg.TableConfig(
        vocabulary_size=1_000_000,
        dim=32,
        name="watches",
        combiner="mean",
        optimizer=cfg.OptimizerSpec(kind="adagrad", learning_rate=0.1),
    )
    user_table = cfg.TableConfig(
        vocabulary_size=100_000,
        dim=32,
        name="user",
        optimizer=cfg.OptimizerSpec(kind="adam", learning_rate=0.01),
    )
    return engine_lib.EmbeddingEngine(
        (
            cfg.FeatureConfig(table=user_table, name="user_id"),
            cfg.FeatureConfig(table=watches_table, name="watch_history"),
        ),
        mesh=mesh,
        device=device,
    )


def row_splits(engine, state) -> dict:
    """Each table's rows as this rank holds them over the model axis (the
    JAX example prints the tables' `sharding.spec`)."""
    shards = parallel.mesh.axis_size(engine.mesh, engine.table_axis)
    return {
        name: f"{tuple(t.shape)} of {engine._storage_rows[name]} rows, "
              f"row-split over {engine.table_axis} ({shards})"
        for name, t in state.tables.items()
    }


def loss_of_acts(acts):
    # Pull each user's embedding toward their watch-history summary.
    return torch.mean(
        torch.sum(
            torch.square(acts["user_id"] - acts["watch_history"].detach()),
            dim=-1,
        )
    )


def run(device: torch.device, steps: int = 20, pipelined: bool = True):
    """One rank's body: the mesh over every rank of the default group,
    `(1, ranks)` (data, model)."""
    import torch.distributed as dist

    mesh = parallel.create_mesh(
        shape=(1, dist.get_world_size()), device_type=device.type,
    )
    engine = build_engine(mesh, device)
    state = engine.init(torch.Generator(device).manual_seed(0))
    splits = row_splits(engine, state)
    printing = is_first_rank()
    if printing:
        print("table shardings:", splits)

    rng = np.random.RandomState(0)

    def batch(i):
        history = rng.randint(0, 1_000_000, size=(512, 10)).astype(np.int32)
        history[rng.uniform(size=history.shape) < 0.2] = cfg.PAD_ID
        return {
            "user_id": torch.from_numpy(
                rng.randint(0, 100_000, 512).astype(np.int32)).to(device),
            "watch_history": torch.from_numpy(history).to(device),
        }

    losses = []
    if pipelined:
        pending = None
        for i in range(steps):
            state, pending, loss, _ = engine.pipelined_grad_and_update(
                state, pending, batch(i), loss_of_acts
            )
            losses.append(loss)
            if i % 5 == 0 and printing:
                print(f"step {i}: loss={float(loss):.4f}")
        state = engine.flush(state, pending)
    else:
        for i in range(steps):
            state, loss, _ = engine.grad_and_update(
                state, batch(i), loss_of_acts
            )
            losses.append(loss)
            if i % 5 == 0 and printing:
                print(f"step {i}: loss={float(loss):.4f}")
    if printing:
        print(f"done: {int(state.step)} engine steps")
    return {"losses": [float(x) for x in losses],
            "engine_steps": int(state.step), "shardings": splits,
            "tables": len(state.tables)}


def main(steps: int = 20, pipelined: bool = True, device="cuda",
         ranks=None):
    from recommenders_tpu_torch.examples import tpu_embedding

    return launch(tpu_embedding.run, device, ranks, steps, pipelined)


if __name__ == "__main__":
    args = parse_args(ranks=True)
    main(device=args.device, ranks=args.ranks)
