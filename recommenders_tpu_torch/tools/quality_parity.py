"""Quality parity: the port trained on the head-to-head tools' data.

The port's counterpart of the "ours" half of `tools/reference_parity.py`
(`run_ours_retrieval`, `run_ours_ranking`, `:189-319`) and
`tools/reference_parity_ctr.py` (`run_ours_dlrm`, `:293-358`, and
`run_ours_uet`, `:361-463`), with both tools' defaults (`:331-356`,
`:466-493`) except the CTR runs' size, which is the recorded run's. It
uses neither TensorFlow nor JAX: it holds the port to the JAX package's
recorded means (`RECORDED`, from `docs/PARITY_HEAD_TO_HEAD.md`) on the
same synthetic data, which the port makes identically from the seed.

  - retrieval: two `EmbeddingTower`s (width 32, Keras-uniform init)
    under Adagrad 0.1, 3 epochs of 8,192, corpus-level top-10/50/100
    accuracy over `BruteForce` (unfused as the JAX tool runs it, or
    `fused=True` through K2);
  - ranking: the rating model (two embeddings, Dense 64, relu, Dense 1)
    under MSE, test RMSE;
  - prebuilt DLRM: `models.Ranking` over three 16-wide tables on
    synthetic CTR data, glorot-uniform kernels, Adam 0.01 (eps 1e-7),
    test AUC, at the recorded run's size (200,000 examples, 8 epochs);
  - unified embedding: collisionless vs hash-trick vs `UnifiedEmbedding`
    on heavy-collision CTR data under Adam 0.01, test AUC, at the size
    of the recorded study (200,000 examples, 8 epochs).

Usage:
  python -m recommenders_tpu_torch.tools.quality_parity [--device cuda]
      [--interactions 100000] [--epochs 3] [--examples 200000]
      [--dlrm-epochs 8] ...

Exit code 1 if a metric falls outside its bound (`quality_failures`).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from recommenders_tpu_torch import data
from recommenders_tpu_torch import metrics
from recommenders_tpu_torch import models
from recommenders_tpu_torch import tasks
from recommenders_tpu_torch.embedding import config as emb_config
from recommenders_tpu_torch.embedding import unified
from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.models import ranking
from recommenders_tpu_torch.models import retrieval
from recommenders_tpu_torch.ops import hashing

# The JAX package's means over 3 model seeds, `docs/PARITY_HEAD_TO_HEAD.md
# :7-11` (retrieval and ranking at tools/reference_parity.py's defaults:
# 100,000 interactions, 3 epochs), `:22` (the prebuilt DLRM) and `:33-35`
# (the unified-embedding study; both CTR runs from the command at `:16`,
# 200,000 examples for 8 epochs).
RECORDED = {
    "top_10": 0.1926, "top_50": 0.6650, "top_100": 0.8589, "rmse": 0.8662,
    "collisionless": 0.7279, "unified": 0.7376, "hash": 0.5841,
    "dlrm_auc": 0.6625,
}

# How far each metric may land from `RECORDED`: top-100 and RMSE within
# 0.003 (ROADMAP.md, Queue A step 8's acceptance), top-10 / top-50 within
# 0.01, each unified-embedding AUC within 0.015 (the JAX package's spread
# over its seeds is 0.001-0.004, `docs/PARITY_HEAD_TO_HEAD.md:33-35`),
# the DLRM AUC within 0.015: about three times the JAX package's spread
# over its seeds (0.0048, `:22`), since one run at one seed is held to a
# mean of three. Fixed here, not options: they hold at the defaults only.
BOUNDS = {
    "top_10": 0.01, "top_50": 0.01, "top_100": 0.003, "rmse": 0.003,
    "collisionless": 0.015, "unified": 0.015, "hash": 0.015,
    "dlrm_auc": 0.015,
}
# The published ordering (`docs/PARITY_HEAD_TO_HEAD.md:33-35`): both
# collisionless - hash and unified - hash above this.
UET_MARGIN = 0.10

UET_VOCABS = {"movie": 4000, "user": 1500, "occupation": 50, "zip": 300}
UET_BUCKETS = {"movie": 400, "user": 200, "occupation": 20, "zip": 50}
UET_DIM = 16
UET_KINDS = ("collisionless", "hash", "unified")

DLRM_VOCABS = {"cat_a": 2000, "cat_b": 800, "cat_c": 400}
DLRM_DIM = 16
DLRM_DENSE = 8
# The prebuilt DLRM's Adam rate: the JAX tool's `--lr` default
# (tools/reference_parity_ctr.py:471), at which BOUNDS["dlrm_auc"] holds.
DLRM_LR = 0.01


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The tools' defaults; `parse_args([])` gives them all."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    # tools/reference_parity.py:331-338
    p.add_argument("--users", type=int, default=943)
    p.add_argument("--movies", type=int, default=1682)
    p.add_argument("--interactions", type=int, default=100_000)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    # tools/reference_parity_ctr.py:468-473, but the size of the command
    # behind RECORDED's DLRM and unified-embedding means
    # (docs/PARITY_HEAD_TO_HEAD.md:16): at the tool's own 120,000 examples
    # and 4 epochs the JAX package reads other AUCs (PERF.md, section 4).
    p.add_argument("--examples", type=int, default=200_000)
    p.add_argument("--uet-epochs", type=int, default=8)
    p.add_argument("--uet-lr", type=float, default=0.01)
    p.add_argument("--dlrm-epochs", type=int, default=8)
    return p.parse_args(argv)


def movielens_split(args: argparse.Namespace):
    """`tools/reference_parity.py::_dataset`: the shared 0.8 split."""
    ds = data.synthetic_movielens(
        num_users=args.users, num_movies=args.movies,
        num_interactions=args.interactions, num_clusters=20,
        seed=args.seed)
    return ds.split(train_fraction=0.8, seed=17)


def keras_uniform_(weight: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
    """Keras' `Embedding` default init, `RandomUniform(-0.05, 0.05)`, in
    place (the JAX tool's `keras_uniform`)."""
    return weight.uniform_(-0.05, 0.05, generator=generator)


def adagrad(lr: float):
    """`optax.adagrad(lr)`'s counterpart: accumulators from 0.1, no
    epsilon (optax's 1e-7 under the root moves an update ≤ 5e-7)."""
    return lambda params: torch.optim.Adagrad(
        params, lr=lr, initial_accumulator_value=0.1, eps=0.0)


def _fit(model: models.Model, optimizer, batches, epochs: int, seed: int,
         device):
    """`Trainer.init` on the factory's first batch (which, shuffled,
    uses up epoch 0's order, as the JAX tools do), then `fit`; returns
    (trainer, state, per-epoch losses, seconds of `fit`)."""
    trainer = models.Trainer(model, optimizer)
    state = trainer.init(torch.Generator(device).manual_seed(seed),
                         next(batches()))
    start = time.perf_counter()
    state, history = trainer.fit(state, batches, epochs=epochs,
                                 verbose=False)
    seconds = time.perf_counter() - start
    return trainer, state, [e["loss"] for e in history["epochs"]], seconds


# --- Retrieval (tools/reference_parity.py:189-240) -------------------------


def retrieval_model(num_users: int, num_movies: int,
                    args: argparse.Namespace, score_dtype=None,
                    fused: bool = False) -> models.TwoTowerRetrieval:
    device = torch.device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    return models.TwoTowerRetrieval(
        models.EmbeddingTower(num_users, args.dim, device=device,
                              generator=gen, embedding_init=keras_uniform_),
        models.EmbeddingTower(num_movies, args.dim, device=device,
                              generator=gen, embedding_init=keras_uniform_),
        score_dtype=score_dtype, fused=fused)


def train_retrieval(model: models.TwoTowerRetrieval, train, test,
                    args: argparse.Namespace) -> Dict:
    """Adagrad fit, then top-10/50/100 over `BruteForce` of the corpus."""
    batches = data.batched(train.as_dict(), args.batch, shuffle=True,
                           seed=args.seed)
    trainer, state, losses, seconds = _fit(
        model, adagrad(args.lr), batches, args.epochs, args.seed,
        args.device)
    results = retrieval.evaluate_with_corpus_metrics(
        trainer, state, data.batched(test.as_dict(), args.batch),
        {"movie_id": np.arange(train.num_movies, dtype=np.int32)},
        ks=(10, 50, 100))
    out = {f"top_{k}": results[
        f"factorized_top_k/top_{k}_categorical_accuracy"]
        for k in (10, 50, 100)}
    return {**out, "losses": losses, "train_seconds": seconds}


def run_ours_retrieval(train, test, args: argparse.Namespace,
                       score_dtype=None, fused: bool = False) -> Dict:
    return train_retrieval(retrieval_model(
        train.num_users, train.num_movies, args, score_dtype, fused),
        train, test, args)


# --- Ranking (tools/reference_parity.py:243-319) ----------------------------


class RatingModel(models.Model):
    """Two Keras-uniform embeddings → Dense 64 → relu → Dense 1, MSE."""

    def __init__(self, num_users: int, num_movies: int, dim: int,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.user_emb = nn.Embedding(num_users, dim, device=device)
        self.movie_emb = nn.Embedding(num_movies, dim, device=device)
        self.dense1 = nn.Linear(2 * dim, 64, device=device)
        self.dense2 = nn.Linear(64, 1, device=device)
        with torch.no_grad():
            keras_uniform_(self.user_emb.weight, generator)
            keras_uniform_(self.movie_emb.weight, generator)
            for dense in (self.dense1, self.dense2):
                blocks.lecun_normal_(dense.weight, generator)
                nn.init.zeros_(dense.bias)
        self.task = tasks.Ranking(loss_fn=tasks.mean_squared_error)

    def compute_loss(self, batch, training=False, generator=None):
        x = torch.cat([self.user_emb(batch["user_id"]),
                       self.movie_emb(batch["movie_id"])], dim=-1)
        pred = self.dense2(torch.relu(self.dense1(x)))[:, 0]
        out = self.task(batch["rating"], pred)
        return out.loss, {"ranking": out}

    def metrics(self):
        return {"rmse": metrics.RootMeanSquaredError()}

    def update_metrics(self, states, batch, aux):
        out = aux["ranking"]
        return {"rmse": metrics.RootMeanSquaredError().update(
            states["rmse"], out.labels, out.predictions)}


def ranking_model(num_users: int, num_movies: int,
                  args: argparse.Namespace) -> RatingModel:
    device = torch.device(args.device)
    return RatingModel(num_users, num_movies, args.dim, device,
                       torch.Generator(device).manual_seed(args.seed))


def train_ranking(model: RatingModel, train, test,
                  args: argparse.Namespace) -> Dict:
    batches = data.batched(train.as_dict(), args.batch, shuffle=True,
                           seed=args.seed)
    trainer, state, losses, seconds = _fit(
        model, adagrad(args.lr), batches, args.epochs, args.seed,
        args.device)
    results = trainer.evaluate(state, data.batched(test.as_dict(),
                                                   args.batch))
    return {"rmse": results["rmse"], "losses": losses,
            "train_seconds": seconds}


def run_ours_ranking(train, test, args: argparse.Namespace) -> Dict:
    return train_ranking(ranking_model(train.num_users, train.num_movies,
                                       args), train, test, args)


# --- Shared CTR data (tools/reference_parity_ctr.py:53-97) --------------------


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _split(features, label, frac=0.8):
    n = label.shape[0]
    cut = int(n * frac)
    train = {k: v[:cut] for k, v in features.items()}
    test = {k: v[cut:] for k, v in features.items()}
    return (train, label[:cut]), (test, label[cut:])


# --- Prebuilt DLRM (tools/reference_parity_ctr.py:65-79,293-358) -------------


def make_ctr(args: argparse.Namespace):
    """CTR data with per-id latent weights and a dense signal; the same
    arrays as the JAX tool's `make_ctr`."""
    rng = np.random.RandomState(args.seed)
    n = args.examples
    dense = rng.uniform(size=(n, DLRM_DENSE)).astype(np.float32)
    ids = {
        name: rng.randint(0, v, n).astype(np.int32)
        for name, v in DLRM_VOCABS.items()
    }
    logit = 2.0 * (dense.mean(axis=1) - 0.5)
    for name, v in DLRM_VOCABS.items():
        w = rng.normal(scale=0.6, size=v).astype(np.float32)
        logit = logit + w[ids[name]]
    label = (rng.uniform(size=n) < _sigmoid(logit)).astype(np.float32)
    return _split({"dense": dense, **ids}, label)


def glorot_stack(units, final_activation) -> ranking.ModuleFactory:
    """`blocks.MLP` with Keras Dense's initialisation, as the JAX tool
    sets it (`kernel_init=glorot_uniform`): glorot-uniform kernels, zero
    biases."""

    def make(in_features, device, generator=None) -> nn.Module:
        mlp = blocks.MLP(in_features, tuple(units),
                         final_activation=final_activation, device=device)
        for layer in mlp.layers:
            nn.init.xavier_uniform_(layer.weight, generator=generator)
            nn.init.zeros_(layer.bias)
        return mlp

    return make


def dlrm_model(args: argparse.Namespace) -> models.Ranking:
    """The JAX tool's prebuilt DLRM: three tables of width 16 (the two
    above 500 rows in the sharded partition), bottom MLP (256, 64, 16)
    relu, the default dot interaction, top MLP (512, 256, 1) sigmoid."""
    device = torch.device(args.device)
    feature_configs = tuple(
        emb_config.FeatureConfig(
            table=emb_config.TableConfig(v, DLRM_DIM, name=f"t_{name}"),
            name=name)
        for name, v in DLRM_VOCABS.items())
    return models.Ranking(
        feature_configs, DLRM_DENSE,
        bottom_stack=glorot_stack((256, 64, 16), "relu"),
        top_stack=glorot_stack((512, 256, 1), "sigmoid"),
        size_threshold=500, device=device,
        generator=torch.Generator(device).manual_seed(args.seed))


def _ctr_batch(split):
    feats, label = split
    return {"dense_features": feats["dense"],
            **{name: feats[name] for name in DLRM_VOCABS},
            "clicked": label}


def train_dlrm(model: models.Ranking, train, test,
               args: argparse.Namespace) -> Dict:
    """Adam (Keras' eps 1e-7) fit, then AUC over the whole test split."""
    batches = data.batched(_ctr_batch(train), args.batch, shuffle=True,
                           seed=args.seed)
    trainer, state, losses, seconds = _fit(
        model, lambda params: torch.optim.Adam(params, lr=DLRM_LR,
                                               eps=1e-7),
        batches, args.dlrm_epochs, args.seed, args.device)
    results = trainer.evaluate(state, data.batched(
        _ctr_batch(test), args.batch, drop_remainder=False))
    return {"dlrm_auc": results["auc"], "losses": losses,
            "train_seconds": seconds}


def run_ours_dlrm(train, test, args: argparse.Namespace) -> Dict:
    return train_dlrm(dlrm_model(args), train, test, args)


# --- Unified embedding (tools/reference_parity_ctr.py:82-97,361-463) -------


def make_uet(args: argparse.Namespace):
    """Per-id-signal data where hashing into small tables collides hard
    (vocab/bucket ratios 7.5-10x), the regime the unified embedding
    exists for; the same arrays as the JAX tool's `make_uet`."""
    rng = np.random.RandomState(args.seed + 1)
    n = args.examples
    ids = {
        name: rng.randint(0, v, n).astype(np.int32)
        for name, v in UET_VOCABS.items()
    }
    logit = np.zeros(n, np.float32)
    for name, v in UET_VOCABS.items():
        w = rng.normal(scale=0.7, size=v).astype(np.float32)
        logit = logit + w[ids[name]]
    label = (rng.uniform(size=n) < _sigmoid(logit)).astype(np.float32)
    return _split(ids, label)


class UETModel(models.Model):
    """One arm of the three-way study: per-feature embeddings over the
    full vocabularies ("collisionless"), over hashed small tables
    ("hash"), or one `UnifiedEmbedding` of two shared tables ("unified"),
    then Dense 128 → 64 → 1 and a sigmoid, BCE."""

    def __init__(self, kind: str, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in UET_KINDS:
            raise ValueError(f"kind must be one of {UET_KINDS}, got {kind!r}")
        self.kind = kind
        if kind == "unified":
            config = unified.UnifiedEmbeddingConfig(
                buckets_per_table=sum(UET_BUCKETS.values()),
                dim_per_table=UET_DIM // 2, num_tables=2, name="unified")
            for name in UET_VOCABS:
                config.add_feature(name, 2)
            self.embedding = unified.UnifiedEmbedding(
                config, shard_tables=False, device=device,
                generator=generator)
        else:
            self.embs = nn.ModuleDict({
                name: nn.Embedding(
                    UET_BUCKETS[name] if kind == "hash" else v, UET_DIM,
                    device=device)
                for name, v in UET_VOCABS.items()})
            with torch.no_grad():
                for emb in self.embs.values():
                    # Flax `Embed`'s default: normal, variance 1/dim.
                    emb.weight.normal_(0.0, UET_DIM ** -0.5,
                                       generator=generator)
        self.head = blocks.MLP(len(UET_VOCABS) * UET_DIM, (128, 64, 1),
                               device=device)
        self.head.reset_parameters(generator)
        self.task = tasks.Ranking()

    def compute_loss(self, batch, training=False, generator=None):
        if self.kind == "unified":
            parts = self.embedding({n: batch[n] for n in UET_VOCABS})
        else:
            parts = []
            for i, name in enumerate(UET_VOCABS):
                ids = batch[name]
                if self.kind == "hash":
                    ids = hashing.hash_bucket(ids, UET_BUCKETS[name], (i, 0))
                parts.append(self.embs[name](ids))
        pred = torch.sigmoid(self.head(torch.cat(parts, dim=-1))[:, 0])
        out = self.task(batch["label"], pred)
        return out.loss, {"labels": out.labels,
                          "predictions": out.predictions}

    def metrics(self):
        return {"auc": metrics.AUC()}

    def update_metrics(self, states, batch, aux):
        return {"auc": metrics.AUC().update(
            states["auc"], aux["labels"], aux["predictions"])}


def uet_model(kind: str, args: argparse.Namespace) -> UETModel:
    device = torch.device(args.device)
    return UETModel(kind, device,
                    torch.Generator(device).manual_seed(args.seed))


def _uet_batch(split):
    feats, label = split
    return {**feats, "label": label}


def train_uet(model: UETModel, train, test,
              args: argparse.Namespace) -> Dict:
    batches = data.batched(_uet_batch(train), args.batch, shuffle=True,
                           seed=args.seed)
    trainer, state, losses, seconds = _fit(
        model, lambda params: torch.optim.Adam(params, lr=args.uet_lr),
        batches, args.uet_epochs, args.seed, args.device)
    results = trainer.evaluate(state, data.batched(
        _uet_batch(test), args.batch, drop_remainder=False))
    return {"auc": results["auc"], "losses": losses,
            "train_seconds": seconds}


def run_ours_uet(train, test, args: argparse.Namespace) -> Dict[str, float]:
    return {kind: train_uet(uet_model(kind, args), train, test, args)["auc"]
            for kind in UET_KINDS}


# --- Bounds ---------------------------------------------------------------


def quality_failures(results: Dict[str, Dict[str, float]]) -> List[str]:
    """What falls outside its bound: each metric of each run (top-k of
    every run whose key starts "retrieval", RMSE, the DLRM AUC, the UET
    AUCs) farther
    from `RECORDED` than `BOUNDS` allows, and a UET margin over hashing
    not above `UET_MARGIN`."""
    failures = []
    for run, values in results.items():
        for key, value in values.items():
            if key in BOUNDS and abs(value - RECORDED[key]) > BOUNDS[key]:
                failures.append(
                    f"{run} {key} {value:.4f}: more than {BOUNDS[key]} "
                    f"from the JAX package's {RECORDED[key]}")
    uet = results.get("uet")
    if uet is not None:
        for kind in ("collisionless", "unified"):
            if uet[kind] - uet["hash"] <= UET_MARGIN:
                failures.append(
                    f"uet {kind} - hash {uet[kind] - uet['hash']:.4f} is "
                    f"not above {UET_MARGIN}")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    train, test = movielens_split(args)
    print(f"dataset: {len(train)} train / {len(test)} test interactions, "
          f"{train.num_users} users x {train.num_movies} movies on "
          f"{args.device}", flush=True)
    results = {
        "retrieval": run_ours_retrieval(train, test, args),
        "retrieval fused": run_ours_retrieval(train, test, args,
                                              fused=True),
        "ranking": run_ours_ranking(train, test, args),
        "dlrm": run_ours_dlrm(*make_ctr(args), args),
        "uet": run_ours_uet(*make_uet(args), args),
    }
    for run, values in results.items():
        print(f"{run}: " + ", ".join(
            f"{k} {v:.4f} (JAX {RECORDED[k]})" for k, v in values.items()
            if k in RECORDED))
    failures = quality_failures(results)
    for failure in failures:
        print(f"FAILED: {failure}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
