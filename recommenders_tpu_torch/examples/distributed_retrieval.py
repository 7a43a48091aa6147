"""Distributed training + corpus-sharded evaluation over a device mesh.

Port of `examples/distributed_retrieval.py` (the counterpart of
`docs/examples/diststrat_retrieval.ipynb`, MirroredStrategy on two
GPUs): here the strategy IS the mesh. Data-parallel training splits each
global batch over the mesh's data axis (`Trainer(mesh=...)`), and corpus
evaluation shards the corpus rows over the ranks with a distributed
top-k reduction (`parallel.ShardedBruteForce`).

One rank a card by default (NCCL); `--ranks N` runs N ranks, sharing the
cards over gloo when there are fewer cards than ranks.

    python -m recommenders_tpu_torch.examples.distributed_retrieval [--device cpu] [--ranks N]
"""

import torch

from recommenders_tpu_torch import data, metrics, models, parallel
from recommenders_tpu_torch.examples import is_first_rank, launch
from recommenders_tpu_torch.examples import adagrad, parse_args


def build_model(num_users: int, num_movies: int, device,
                generator=None) -> models.TwoTowerRetrieval:
    return models.TwoTowerRetrieval(
        query_tower=models.EmbeddingTower(num_users, 64, device=device,
                                          generator=generator),
        candidate_tower=models.EmbeddingTower(num_movies, 64, device=device,
                                              generator=generator),
        query_key="user_id",
        candidate_key="movie_id",
    )


def run(device: torch.device, epochs: int = 2):
    """One rank's body: every rank on the data axis."""
    import torch.distributed as dist

    printing = is_first_rank()
    if printing:
        print(f"devices: {dist.get_world_size()}")
    mesh = parallel.create_mesh(device_type=device.type)
    train, test = data.synthetic_movielens().split(0.8)

    generator = torch.Generator(device).manual_seed(0)
    model = build_model(train.num_users, train.num_movies, device, generator)
    trainer = models.Trainer(model, adagrad(0.5), mesh=mesh)
    batcher = data.batched(train.as_dict(), 8192, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, history = trainer.fit(state, batcher, epochs=epochs,
                                 verbose=printing)

    # Evaluation with the corpus sharded across all ranks.
    with torch.no_grad():
        model.eval()
        candidates = model.candidate_embeddings(
            {"movie_id": torch.arange(train.num_movies, device=device)})
        index = parallel.ShardedBruteForce(k=100, device=device).index(
            candidates)
        metric = metrics.FactorizedTopK(candidates=index, ks=(10, 100))
        queries = model.query_embeddings(
            {"user_id": torch.from_numpy(test.user_ids[:4096]).to(device)})
        true = candidates[torch.from_numpy(test.movie_ids[:4096]).to(device)]
        mstate = metric.update(metric.init(), queries, true)
    results = {name: float(value)
               for name, value in metric.result(mstate).items()}
    if printing:
        for name, value in results.items():
            print(f"{name}: {value:.4f}")
    return {**results, "ranks": dist.get_world_size(),
            "loss": history["epochs"][-1]["loss"]}


def main(epochs: int = 2, device="cuda", ranks=None):
    from recommenders_tpu_torch.examples import distributed_retrieval

    return launch(distributed_retrieval.run, device, ranks, epochs)


if __name__ == "__main__":
    args = parse_args(ranks=True)
    main(device=args.device, ranks=args.ranks)
