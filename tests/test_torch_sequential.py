"""The port's sequence encoders and `SequenceTower` against flax, on the
CPU.

Flax weights are drawn by `init` and carried into the port with
`utils.convert`; the same NumPy ids (padding in the middle of a history,
at its end, and a row of padding only) and float inputs go to both.
Tolerances: outputs to rtol 1e-5 and atol 1e-6 (f32 matmuls and
reductions in another order), gradients to rtol 1e-4 and atol 1e-6 of
their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import sequential as jax_sequential
from recommenders_tpu.models import retrieval as jax_retrieval
from recommenders_tpu_torch.layers import sequential
from recommenders_tpu_torch.models import retrieval
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

VOCAB, DIM, B, L = 60, 8, 6, 7
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
PAD = -1


def _ids(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, L)).astype(np.int32)
    ids[0, 2:4] = PAD          # padding in the middle of a history
    ids[1, 5:] = PAD           # at its end
    ids[2, :] = PAD            # a row of padding only
    ids[3, 0] = PAD            # at its start
    return ids


def _towers(encoder, encoder_units=None, mlp_units=()):
    jtower = jax_retrieval.SequenceTower(
        vocab_size=VOCAB, embedding_dim=DIM, encoder=encoder,
        encoder_units=encoder_units, mlp_units=mlp_units)
    params = jax.tree.map(np.asarray, jtower.init(
        jax.random.PRNGKey(3), jnp.asarray(_ids()))["params"])
    ttower = retrieval.SequenceTower(VOCAB, DIM, encoder, encoder_units,
                                     mlp_units, device="cpu")
    convert.load_flax_params(ttower, params)
    return jtower, params, ttower


CASES = [("gru", None, ()), ("gru", 12, (6,)), ("attention", None, ()),
         ("attention", 12, (5, 3))]


@pytest.mark.parametrize("encoder,units,mlp", CASES)
def test_sequence_tower_matches_flax(encoder, units, mlp):
    jtower, params, ttower = _towers(encoder, units, mlp)
    for seed in (0, 1):
        ids = _ids(seed)
        want = jtower.apply({"params": params}, jnp.asarray(ids))
        got = ttower(torch.from_numpy(ids))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **OUT_TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("encoder", ["gru", "attention"])
def test_encoders_match_flax_on_float_inputs(encoder):
    """The encoders alone, on float inputs and masks with an all-false
    row: the GRU returns its zero carry there, attention a uniform
    average pooled through max(Σw, 1e-12) (zero)."""
    _, params, ttower = _towers(encoder)
    rng = np.random.RandomState(5)
    x = rng.normal(size=(B, L, DIM)).astype(np.float32)
    mask = rng.rand(B, L) < 0.7
    mask[2] = False
    if encoder == "gru":
        jenc = jax_sequential.GRUEncoder(units=DIM)
        sub = params["GRUEncoder_0"]
    else:
        jenc = jax_sequential.SelfAttentionEncoder()
        sub = params["SelfAttentionEncoder_0"]
    want = jenc.apply({"params": sub}, jnp.asarray(x), jnp.asarray(mask))
    got = ttower.encoder(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    assert not got[2].any()
    # No mask: every position is valid.
    want = jenc.apply({"params": sub}, jnp.asarray(x))
    got = ttower.encoder(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)


@pytest.mark.parametrize("encoder", ["gru", "attention"])
def test_gradients_match_flax(encoder):
    jtower, params, ttower = _towers(encoder, 12, (6,))
    ids = _ids(2)

    def jloss(p):
        out = jtower.apply({"params": p}, jnp.asarray(ids))
        return jnp.sum(jnp.sin(out) ** 2)

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(params))
    out = ttower(torch.from_numpy(ids))
    (torch.sin(out) ** 2).sum().backward()
    grads = {n: p.grad for n, p in ttower.named_parameters()}
    leaves = {leaf.path: leaf for leaf in convert._leaves(ttower)}
    flat = {tuple(k.key for k in path): v for path, v in
            jax.tree_util.tree_leaves_with_path(jgrads)}
    assert set(flat) == {p for p in leaves if p is not None}
    for path, want in flat.items():
        leaf = leaves[path]
        g = grads[leaf.name]
        if leaf.rows is not None:
            g = g[leaf.rows]
        np.testing.assert_allclose(leaf.to_flax(g.numpy()), want, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(want).max(), 1.0),
                                   err_msg=leaf.name)
    if encoder == "gru":
        # The recurrent r and z biases flax lacks get no gradient.
        assert not grads["encoder.cell.bias_hh"][:24].any()


def test_gru_training_keeps_the_missing_biases_at_zero():
    _, _, ttower = _towers("gru")
    opt = torch.optim.Adagrad(ttower.parameters(), lr=0.5)
    for seed in range(3):
        opt.zero_grad()
        ttower(torch.from_numpy(_ids(seed))).pow(2).sum().backward()
        opt.step()
    bias = ttower.encoder.cell.bias_hh.detach()
    assert not bias[:2 * DIM].any()
    assert bias[2 * DIM:].any()


@pytest.mark.parametrize("encoder,units,mlp", CASES)
def test_params_round_trip(encoder, units, mlp):
    _, params, ttower = _towers(encoder, units, mlp)
    back = convert.to_flax_params(ttower)
    flat_in = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat_in) == set(flat_out)
    for path, array in flat_in.items():
        np.testing.assert_array_equal(flat_out[path], array)


def test_convert_rejects_a_missing_gru_leaf():
    _, params, ttower = _towers("gru")
    cell = params["GRUEncoder_0"]["Scan_Step_0"]["GRUCell_0"]
    broken = dict(params, GRUEncoder_0={"Scan_Step_0": {"GRUCell_0": {
        k: v for k, v in cell.items() if k != "hz"}}})
    with pytest.raises(ValueError, match="missing.*weight_hh"):
        convert.load_flax_params(ttower, broken)


def test_two_tower_with_a_sequence_query_tower_matches_flax():
    """`TwoTowerRetrieval(SequenceTower, EmbeddingTower)`: the loss and
    the query embeddings against the JAX model."""
    jmodel = jax_retrieval.TwoTowerRetrieval(
        query_tower=lambda: jax_retrieval.SequenceTower(
            vocab_size=VOCAB, embedding_dim=DIM, encoder="attention"),
        candidate_tower=lambda: jax_retrieval.EmbeddingTower(VOCAB, DIM),
        query_key="history", candidate_key="movie_id")
    rng = np.random.RandomState(7)
    batch = {"history": _ids(4),
             "movie_id": rng.randint(0, VOCAB, B).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(1), jbatch,
                         method="compute_loss")["params"]
    model = retrieval.TwoTowerRetrieval(
        retrieval.SequenceTower(VOCAB, DIM, "attention", device="cpu"),
        retrieval.EmbeddingTower(VOCAB, DIM, device="cpu"),
        query_key="history", candidate_key="movie_id")
    convert.load_flax_params(model, jax.tree.map(np.asarray, params))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jmodel.apply({"params": params}, jbatch, method="compute_loss")[0]
    got, _ = model.compute_loss(tbatch)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        model.query_embeddings(tbatch).detach().numpy(),
        np.asarray(jmodel.apply({"params": params}, jbatch,
                                method="query_embeddings")), **OUT_TOL)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="encoder"):
        retrieval.SequenceTower(VOCAB, DIM, "lstm", device="cpu")
    with pytest.raises(ValueError, match="num_heads"):
        sequential.SelfAttentionEncoder(6, num_heads=4, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, L, D\]"):
        sequential.GRUEncoder(DIM, DIM, device="cpu")(torch.zeros(2, DIM))
    with pytest.raises(ValueError, match=r"\[B, L, D\]"):
        sequential.SelfAttentionEncoder(DIM, device="cpu")(torch.zeros(2,
                                                                       DIM))


def test_initial_weights_follow_flax_defaults():
    enc = sequential.GRUEncoder(DIM, 16, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    w = enc.cell.weight_hh.detach()
    for g in range(3):
        block = w[g * 16:(g + 1) * 16]
        torch.testing.assert_close(block @ block.T, torch.eye(16),
                                   rtol=0, atol=1e-5)
    assert not enc.cell.bias_ih.any() and not enc.cell.bias_hh.any()
    att = sequential.SelfAttentionEncoder(
        DIM, device="cpu", generator=torch.Generator().manual_seed(0))
    assert float(att.attention.query.weight.detach().abs().max()) <= 2 * DIM ** -0.5 / \
        0.87962566103423978 + 1e-6
