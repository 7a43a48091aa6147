"""MovieLens-style synthetic data + offline evaluation utilities.

The port's own copy of `recommenders_tpu/data/movielens.py`: all of it is
NumPy, so for one seed both packages give identical arrays and batch
order, and `evaluate` stays a host function (its `argsort` tie order is
part of the result).

Benchmarks and tests run without network access, so they use a
synthetic dataset with MovieLens-100K-like shape (943 users, 1682 movies,
100K interactions) and *learnable* latent structure: users and movies get
latent cluster assignments, and interactions are sampled with strong
within-cluster affinity, so a two-tower model can meaningfully beat a
popularity baseline.

Also provides the counterparts of the reference's example utilities
(`tensorflow_recommenders/examples/movielens.py:26,101,129`):
`evaluate` (precision/recall@k with train-watch exclusion) and
`sample_listwise` (listwise example sampler).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class SyntheticMovieLens:
    """A synthetic interactions dataset with latent cluster structure."""

    user_ids: np.ndarray  # [n] int32
    movie_ids: np.ndarray  # [n] int32
    ratings: np.ndarray  # [n] float32 in [1, 5]
    timestamps: np.ndarray  # [n] int64
    num_users: int
    num_movies: int

    def __len__(self) -> int:
        return len(self.user_ids)

    def as_dict(self) -> Batch:
        return {
            "user_id": self.user_ids,
            "movie_id": self.movie_ids,
            "rating": self.ratings,
            "timestamp": self.timestamps,
        }

    def split(
        self, train_fraction: float = 0.8, seed: int = 17
    ) -> Tuple["SyntheticMovieLens", "SyntheticMovieLens"]:
        rng = np.random.RandomState(seed)
        n = len(self)
        perm = rng.permutation(n)
        cut = int(n * train_fraction)
        take = lambda idx: SyntheticMovieLens(  # noqa: E731
            user_ids=self.user_ids[idx],
            movie_ids=self.movie_ids[idx],
            ratings=self.ratings[idx],
            timestamps=self.timestamps[idx],
            num_users=self.num_users,
            num_movies=self.num_movies,
        )
        return take(perm[:cut]), take(perm[cut:])


def synthetic_movielens(
    num_users: int = 943,
    num_movies: int = 1682,
    num_interactions: int = 100_000,
    num_clusters: int = 20,
    affinity: float = 0.85,
    seed: int = 42,
) -> SyntheticMovieLens:
    """Generates interactions with within-cluster affinity.

    Each user/movie belongs to one of `num_clusters` latent clusters; a
    user interacts within their own cluster with probability `affinity`
    and uniformly otherwise. Movie popularity within a cluster is
    Zipf-distributed, mimicking MovieLens' long tail.
    """
    rng = np.random.RandomState(seed)
    user_cluster = rng.randint(0, num_clusters, size=num_users)
    movie_cluster = rng.randint(0, num_clusters, size=num_movies)

    movies_by_cluster = [
        np.where(movie_cluster == c)[0] for c in range(num_clusters)
    ]
    # Guarantee every cluster has movies.
    for c in range(num_clusters):
        if len(movies_by_cluster[c]) == 0:
            movies_by_cluster[c] = np.asarray([c % num_movies])

    users = rng.randint(0, num_users, size=num_interactions)
    in_cluster = rng.uniform(size=num_interactions) < affinity
    movies = np.empty(num_interactions, dtype=np.int64)

    zipf_cache = {}

    def zipf_probs(n):
        if n not in zipf_cache:
            w = 1.0 / np.arange(1, n + 1) ** 0.8
            zipf_cache[n] = w / w.sum()
        return zipf_cache[n]

    for c in range(num_clusters):
        mask = in_cluster & (user_cluster[users] == c)
        pool = movies_by_cluster[c]
        movies[mask] = rng.choice(
            pool, size=mask.sum(), p=zipf_probs(len(pool))
        )
    out_mask = ~in_cluster
    movies[out_mask] = rng.randint(0, num_movies, size=out_mask.sum())

    same = (user_cluster[users] == movie_cluster[movies]).astype(np.float32)
    ratings = np.clip(
        np.round(3.0 + 1.2 * same + rng.normal(scale=0.8, size=num_interactions)),
        1.0,
        5.0,
    ).astype(np.float32)
    timestamps = rng.randint(
        880_000_000, 893_000_000, size=num_interactions
    ).astype(np.int64)

    return SyntheticMovieLens(
        user_ids=users.astype(np.int32),
        movie_ids=movies.astype(np.int32),
        ratings=ratings,
        timestamps=timestamps,
        num_users=num_users,
        num_movies=num_movies,
    )


def load_movielens(
    path: str,
    num_users: Optional[int] = None,
    num_movies: Optional[int] = None,
) -> SyntheticMovieLens:
    """Loads real MovieLens interaction files into the dataset container.

    Supports the two public formats:
      - ML-100K `u.data`: tab-separated `user item rating timestamp`;
      - ML-1M `ratings.dat`: `user::item::rating::timestamp`.

    Ids are 1-based in the files and shifted to 0-based here. The tests
    read synthetic files in both formats; point it at a real download to
    reproduce the reference's published quality numbers
    (BASELINE.md: top-100 ≈ 0.27, multitask RMSE ≈ 1.11).
    """
    sep = "::" if path.endswith(".dat") else "\t"
    users, movies, ratings, timestamps = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            u, m, r, t = line.split(sep)[:4]
            users.append(int(u) - 1)
            movies.append(int(m) - 1)
            ratings.append(float(r))
            timestamps.append(int(t))
    users = np.asarray(users, np.int32)
    movies = np.asarray(movies, np.int32)
    return SyntheticMovieLens(
        user_ids=users,
        movie_ids=movies,
        ratings=np.asarray(ratings, np.float32),
        timestamps=np.asarray(timestamps, np.int64),
        num_users=num_users or int(users.max()) + 1,
        num_movies=num_movies or int(movies.max()) + 1,
    )


def batched(
    data: Batch,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Callable[[], Iterator[Batch]]:
    """Returns a factory yielding dict batches (re-iterable per epoch)."""
    n = len(next(iter(data.values())))
    state = {"epoch": 0}

    def factory() -> Iterator[Batch]:
        order = np.arange(n)
        if shuffle:
            rng = np.random.RandomState(seed + state["epoch"])
            rng.shuffle(order)
            state["epoch"] += 1
        end = n - (n % batch_size) if drop_remainder else n
        for start in range(0, end, batch_size):
            idx = order[start : start + batch_size]
            yield {k: v[idx] for k, v in data.items()}

    return factory


def evaluate(
    user_embeddings: np.ndarray,
    movie_embeddings: np.ndarray,
    test_user_ids: np.ndarray,
    test_movie_ids: np.ndarray,
    train_user_ids: Optional[np.ndarray] = None,
    train_movie_ids: Optional[np.ndarray] = None,
    k: int = 10,
) -> Dict[str, float]:
    """Offline precision/recall@k by full scoring with train exclusion.

    Counterpart of the reference's `examples/movielens.py:26` `evaluate`:
    scores every user against every movie, excludes train watches, and
    reports precision@k and recall@k against the test watches.
    """
    num_users = user_embeddings.shape[0]
    scores = user_embeddings @ movie_embeddings.T

    if train_user_ids is not None:
        scores = scores.copy()
        scores[train_user_ids, train_movie_ids] = -np.inf

    top_k = np.argsort(-scores, axis=1)[:, :k]

    test_sets: Dict[int, set] = {}
    for u, m in zip(test_user_ids, test_movie_ids):
        test_sets.setdefault(int(u), set()).add(int(m))

    precisions, recalls = [], []
    for u in range(num_users):
        truth = test_sets.get(u)
        if not truth:
            continue
        retrieved = set(top_k[u].tolist())
        hits = len(retrieved & truth)
        precisions.append(hits / k)
        recalls.append(hits / len(truth))
    return {
        f"precision_at_{k}": float(np.mean(precisions)),
        f"recall_at_{k}": float(np.mean(recalls)),
    }


def sample_listwise(
    user_ids: np.ndarray,
    movie_ids: np.ndarray,
    ratings: np.ndarray,
    num_list_per_user: int = 10,
    num_examples_per_list: int = 10,
    seed: int = 42,
) -> Dict[str, np.ndarray]:
    """Samples fixed-length per-user movie lists for listwise losses.

    Counterpart of the reference's `examples/movielens.py:129`
    `sample_listwise`: users with fewer than `num_examples_per_list`
    rated movies are skipped; each list is a uniform sample without
    replacement.

    Returns:
      Dict with `user_id [n]`, `movie_id [n, L]`, `rating [n, L]`.
    """
    rng = np.random.RandomState(seed)
    by_user: Dict[int, list] = {}
    for u, m, r in zip(user_ids, movie_ids, ratings):
        by_user.setdefault(int(u), []).append((int(m), float(r)))

    out_users, out_movies, out_ratings = [], [], []
    for u, pairs in sorted(by_user.items()):
        if len(pairs) < num_examples_per_list:
            continue
        for _ in range(num_list_per_user):
            sel = rng.choice(
                len(pairs), size=num_examples_per_list, replace=False
            )
            out_users.append(u)
            out_movies.append([pairs[i][0] for i in sel])
            out_ratings.append([pairs[i][1] for i in sel])

    return {
        "user_id": np.asarray(out_users, np.int32),
        "movie_id": np.asarray(out_movies, np.int32),
        "rating": np.asarray(out_ratings, np.float32),
    }
