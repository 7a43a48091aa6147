"""`embedding.unified` against the JAX package's `UnifiedEmbedding`.

The JAX module's tables are carried into the port with
`utils.convert.load_flax_params`; the same NumPy ids go to both. The
forward is a gather of hashed ids (bit-equal hashes), so outputs must be
equal; table gradients are scatter-adds of the same cotangents, summed
in another order, so they agree to 1e-6 relative (plus 1e-7 absolute).
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from recommenders_tpu.embedding import unified as jax_unified
from recommenders_tpu_torch.embedding import unified
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

FEATURES = {"movie": (4000, 2), "user": (1500, 3), "zip": (300, 12)}


def _configs(module, buckets=97, dim=4, tables=3):
    config = module.UnifiedEmbeddingConfig(
        buckets_per_table=buckets, dim_per_table=dim, num_tables=tables,
        name="unified")
    for name, (_, chunks) in FEATURES.items():
        config.add_feature(name, chunks)
    return config


def _ids(batch=64, seed=0):
    rng = np.random.RandomState(seed)
    return {name: rng.randint(0, vocab, batch).astype(np.int32)
            for name, (vocab, _) in FEATURES.items()}


def test_config_matches_jax():
    ours, theirs = _configs(unified), _configs(jax_unified)
    assert [(t.name, t.vocabulary_size, t.dim) for t in ours.table_configs] \
        == [(t.name, t.vocabulary_size, t.dim) for t in theirs.table_configs]
    assert ours.hashing_config == theirs.hashing_config
    assert list(ours.embedding_config) == list(theirs.embedding_config)
    for name in FEATURES:
        assert {k: fc.table.name for k, fc in
                ours.embedding_config[name].items()} == {
            k: fc.table.name for k, fc in
            theirs.embedding_config[name].items()}
    # Round-robin: 17 chunks over 3 tables.
    tables = [fc.table.name for chunks in ours.embedding_config.values()
              for fc in chunks.values()]
    assert tables == [f"unified_{i % 3}" for i in range(17)]
    # Salts are (feature index, chunk index).
    assert ours.hashing_config["zip"]["unified_zip_lookup_11"] == (97,
                                                                   (2, 11))


def test_twelve_chunks_concatenate_in_lexicographic_key_order():
    config = _configs(unified)
    module = unified.UnifiedEmbedding(config, device="cpu",
                                      generator=torch.Generator())
    ids = {k: torch.from_numpy(v) for k, v in _ids().items()}
    out = module(ids)
    hashed = {}
    for chunk, (bins, salt) in config.hashing_config["zip"].items():
        hashed[chunk] = module.shared_tables(
            {chunk: unified.hashing.hash_bucket(ids["zip"], bins, salt)}
        )[chunk]
    order = sorted(hashed)
    assert order[:4] == ["unified_zip_lookup_0", "unified_zip_lookup_1",
                         "unified_zip_lookup_10", "unified_zip_lookup_11"]
    torch.testing.assert_close(out[2], torch.cat([hashed[k] for k in order],
                                                 -1), rtol=0, atol=0)


@pytest.mark.parametrize("shard_tables", [False, True])
def test_forward_and_grads_match_jax(shard_tables):
    ids = _ids(seed=1)
    jax_module = jax_unified.UnifiedEmbedding(
        config=_configs(jax_unified), shard_tables=shard_tables)
    variables = jax_module.init(jax.random.PRNGKey(0),
                                {k: jnp.asarray(v) for k, v in ids.items()})
    params = jax.tree.map(np.asarray, jax.lax.stop_gradient(
        nn.meta.unbox(variables["params"])))
    port = unified.UnifiedEmbedding(_configs(unified),
                                    shard_tables=shard_tables, device="cpu")
    convert.load_flax_params(port, params)
    assert set(dict(port.named_parameters())) == {
        "shared_tables.unified_0", "shared_tables.unified_1",
        "shared_tables.unified_2"}

    rng = np.random.RandomState(2)
    cot = [rng.normal(size=(64, 4 * chunks)).astype(np.float32)
           for _, chunks in FEATURES.values()]

    def jax_loss(p):
        outs = jax_module.apply({"params": p},
                                {k: jnp.asarray(v) for k, v in ids.items()})
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs

    (_, jax_outs), jax_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        params)
    outs = port({k: torch.from_numpy(v) for k, v in ids.items()})
    sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, cot)
        ).backward()
    for got, want in zip(outs, jax_outs):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    back = convert.to_flax_params(port)["shared_tables"]
    for table, value in params["shared_tables"].items():
        np.testing.assert_array_equal(back[table], value)
    flat = dict(port.named_parameters())
    for table in ("unified_0", "unified_1", "unified_2"):
        np.testing.assert_allclose(
            flat[f"shared_tables.{table}"].grad.numpy(),
            np.asarray(jax_grads["shared_tables"][table]),
            rtol=1e-6, atol=1e-7)
