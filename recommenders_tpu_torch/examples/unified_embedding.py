"""Unified embeddings: feature multiplexing into shared hashed tables.

Port of `examples/unified_embedding.py` (the counterpart of
`docs/examples/uet.ipynb`, Unified Embedding, Coleman et al.): several
categorical features share round-robin hashed tables with per-feature
multi-chunk lookups, trading collision noise for memory. Compares
collisionless against unified embeddings on a synthetic CTR task.

    python -m recommenders_tpu_torch.examples.unified_embedding [--device cpu]
"""

import numpy as np
import torch

from recommenders_tpu_torch import data, metrics, models, tasks
from recommenders_tpu_torch.embedding import unified
from recommenders_tpu_torch.examples import adagrad, embed, parse_args
from recommenders_tpu_torch.examples import sequential
from recommenders_tpu_torch.utils import device as device_lib


def synthetic_ctr(n=60_000, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 10_000, n).astype(np.int32)
    b = rng.randint(0, 5_000, n).astype(np.int32)
    logit = ((a % 3) - 1.0) + ((b % 2) - 0.5)
    clicked = (
        rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))
    ).astype(np.float32)
    return {"ad_id": a, "site_id": b, "clicked": clicked}


class UnifiedCTR(models.Model):
    """Ad and site ids embedded either collisionless (two tables of
    width 32) or unified (two shared hashed tables of 4,000 x 16, two
    chunks a feature), then Dense(64) relu Dense(1), sigmoid, BCE."""

    def __init__(self, use_unified: bool = True, device="cuda",
                 generator=None):
        super().__init__()
        self.use_unified = use_unified
        if use_unified:
            config = unified.UnifiedEmbeddingConfig(
                buckets_per_table=4_000,
                dim_per_table=16,
                num_tables=2,
                name="shared",
            )
            config.add_feature("ad_id", num_chunks=2)
            config.add_feature("site_id", num_chunks=2)
            self.embedding = unified.UnifiedEmbedding(
                config=config, device=device, generator=generator)
            self.flax_names = {"embedding": "embedding", "head": "head"}
        else:
            self.ad_emb = embed(10_000, 32, device, generator)
            self.site_emb = embed(5_000, 32, device, generator)
            self.flax_names = {"ad_emb": "ad_emb", "site_emb": "site_emb",
                               "head": "head"}
        self.head = sequential(64, (64, 1), device, generator)
        self.task = tasks.Ranking()

    def compute_loss(self, batch, training=False, generator=None):
        if self.use_unified:
            embs = self.embedding(
                {"ad_id": batch["ad_id"], "site_id": batch["site_id"]}
            )
            x = torch.cat(embs, dim=-1)
        else:
            x = torch.cat(
                [
                    self.ad_emb(batch["ad_id"]),
                    self.site_emb(batch["site_id"]),
                ],
                dim=-1,
            )
        pred = torch.sigmoid(self.head(x)[:, 0])
        out = self.task(batch["clicked"], pred)
        return out.loss, {"labels": out.labels, "predictions": out.predictions}

    def metrics(self):
        return {"auc": metrics.AUC()}

    def update_metrics(self, states, batch, aux):
        return {
            "auc": metrics.AUC().update(
                states["auc"], aux["labels"], aux["predictions"]
            )
        }


def build_model(use_unified: bool, device, generator=None) -> UnifiedCTR:
    return UnifiedCTR(use_unified, device, generator)


def run(use_unified: bool, epochs: int = 3, device="cuda"):
    device = device_lib.resolve(device)
    ctr = synthetic_ctr()
    generator = torch.Generator(device).manual_seed(0)
    model = build_model(use_unified, device, generator)
    trainer = models.Trainer(model, adagrad(0.1))
    batcher = data.batched(ctr, 4096, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, history = trainer.fit(
        state, batcher, epochs=epochs, verbose=False
    )
    kind = "unified" if use_unified else "collisionless"
    print(f"{kind:>14}: AUC={history['epochs'][-1]['auc']:.4f}")
    return history


def main(epochs: int = 3, device="cuda"):
    return {kind: run(kind == "unified", epochs, device)["epochs"][-1]
            for kind in ("collisionless", "unified")}


if __name__ == "__main__":
    main(device=parse_args().device)
