"""The port's retrieval examples' own towers against the JAX examples',
on the CPU: context_features' `ContextQueryTower` and
sequential_retrieval's GRU and attention towers, as
`tests/test_torch_examples_ranking.py` holds the ranking models: the
flax init carried with `utils.convert.load_flax_params`, the loss to
rtol 1e-5, the query and candidate embeddings to rtol 1e-5 (atol 1e-6),
one optimizer step within `STEP_GAP`.
"""

import numpy as np
import optax
import pytest
import torch

from recommenders_tpu import data as jax_data
from recommenders_tpu import models as jax_models
from recommenders_tpu_torch.examples import context_features
from recommenders_tpu_torch.examples import sequential_retrieval
from torch_examples_common import (B, CPU, jax_example, movielens_batch,
                                   tower_outputs, trainer_parity)
from torch_threads import torch_threads  # noqa: F401 (autouse)


def test_context_query_tower():
    example = jax_example("context_features")
    batch, ds = movielens_batch()
    batch["timestamp_bucket"] = (np.arange(B) % 100).astype(np.int32)
    jax_model = jax_models.TwoTowerRetrieval(
        query_tower=lambda: example.ContextQueryTower(
            num_users=ds.num_users),
        candidate_tower=lambda: jax_models.EmbeddingTower(ds.num_movies, 32),
        query_key=("user_id", "timestamp_bucket"),
        candidate_key="movie_id",
        batch_metric_ks=(10, 100),
    )
    port_model = context_features.build_model(ds.num_users, ds.num_movies,
                                              CPU)
    trainer_parity(jax_model, port_model, batch, optax.adagrad(0.3),
                   lambda p: torch.optim.Adagrad(
                       p, lr=0.3, initial_accumulator_value=0.1, eps=0.0),
                   "adagrad", tower_outputs(jax_model, port_model, batch))


@pytest.mark.parametrize("encoder", ["gru", "attention"])
def test_sequence_towers(encoder):
    example = jax_example("sequential_retrieval")
    ds = jax_data.synthetic_movielens(num_interactions=5_000)
    examples = example.sequences_from_interactions(ds)
    np.testing.assert_array_equal(
        examples["history"],
        sequential_retrieval.sequences_from_interactions(ds)["history"])
    batch = {k: v[:B] for k, v in examples.items()}
    jax_model = jax_models.TwoTowerRetrieval(
        query_tower=lambda: jax_models.SequenceTower(
            vocab_size=ds.num_movies, embedding_dim=32, encoder=encoder),
        candidate_tower=lambda: jax_models.EmbeddingTower(ds.num_movies, 32),
        query_key="history",
        candidate_key="next_movie",
        batch_metric_ks=(1, 10, 100),
    )
    port_model = sequential_retrieval.build_model(ds.num_movies, encoder,
                                                  CPU)
    key_bias = ("_query", "SelfAttentionEncoder_0",
                "MultiHeadDotProductAttention_0", "key", "bias")
    trainer_parity(jax_model, port_model, batch, optax.adam(5e-3),
                   lambda p: torch.optim.Adam(p, lr=5e-3), "adam",
                   tower_outputs(jax_model, port_model, batch),
                   invariant=key_bias if encoder == "attention" else None)
