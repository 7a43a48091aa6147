"""The port's loss layers, retrieval task and `compute_loss` against JAX.

Same NumPy inputs on both sides. Tolerances:
  - `take_along_rows`, hard-negative mining and accidental-hit removal
    are gathers, compares and one multiply-add: equal;
  - the log-q correction's `log` may differ by an ulp: rtol 1e-6;
  - the task's loss, logits and grads with respect to q and c: rtol 1e-5
    (f32 products summed in another order; grads, sums of C terms, also
    atol 1e-5·max|grad|). With bf16 `score_dtype` the grads pass through
    the cast to bf16, which may round one bf16 ulp apart (rtol 2⁻⁷).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu import tasks as jax_tasks
from recommenders_tpu.layers import loss as jax_loss
from recommenders_tpu.models import retrieval as jax_retrieval
from recommenders_tpu_torch import tasks
from recommenders_tpu_torch.layers import loss
from recommenders_tpu_torch.models import retrieval
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

B, C, D = 16, 24, 32


def _data(seed=0, heads=0):
    rng = np.random.RandomState(seed)
    qshape = (B, heads, D) if heads else (B, D)
    return dict(
        q=rng.normal(size=qshape).astype(np.float32),
        c=rng.normal(size=(C, D)).astype(np.float32),
        ids=rng.randint(0, 6, size=(C,)).astype(np.int32),
        probs=rng.uniform(0.01, 1.0, size=(C,)).astype(np.float32),
        w=rng.uniform(0.1, 2.0, size=(B,)).astype(np.float32),
        mask=rng.rand(B, C) > 0.2,
    )


def test_loss_layers_match_jax():
    d = _data()
    logits = d["q"] @ d["c"].T
    labels = np.eye(B, C, dtype=np.float32)
    cols = np.random.RandomState(1).randint(0, C, (B, 5))
    np.testing.assert_array_equal(
        loss.take_along_rows(torch.from_numpy(logits),
                             torch.from_numpy(cols)).numpy(),
        np.asarray(jax_loss.take_along_rows(jnp.asarray(logits),
                                            jnp.asarray(cols))))
    for got, want in zip(
        loss.hard_negative_mining(torch.from_numpy(logits),
                                  torch.from_numpy(labels), 4),
        jax_loss.hard_negative_mining(jnp.asarray(logits),
                                      jnp.asarray(labels), 4),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        loss.remove_accidental_hits(torch.from_numpy(labels),
                                    torch.from_numpy(logits),
                                    torch.from_numpy(d["ids"])).numpy(),
        np.asarray(jax_loss.remove_accidental_hits(
            jnp.asarray(labels), jnp.asarray(logits), jnp.asarray(d["ids"]))))
    np.testing.assert_allclose(
        loss.sampling_probability_correction(
            torch.from_numpy(logits), torch.from_numpy(d["probs"])).numpy(),
        np.asarray(jax_loss.sampling_probability_correction(
            jnp.asarray(logits), jnp.asarray(d["probs"]))), rtol=1e-6)
    assert loss.MIN_FLOAT == float(jax_loss.MIN_FLOAT)
    assert loss.MAX_FLOAT == float(jax_loss.MAX_FLOAT)
    with pytest.raises(ValueError, match="2D"):
        loss.take_along_rows(torch.zeros(3), torch.zeros(3, 1))


KNOBS = {
    "plain": dict(),
    "temperature": dict(task=dict(temperature=0.3)),
    "logq": dict(call=("probs",)),
    "hits": dict(task=dict(remove_accidental_hits=True), call=("ids",)),
    "mask": dict(call=("mask",)),
    "hard_negatives": dict(task=dict(num_hard_negatives=5)),
    "weights": dict(call=("w",)),
    "maxsim": dict(heads=3),
    "bf16": dict(task=dict(score_dtype="bf16")),
    "all": dict(task=dict(temperature=0.5, remove_accidental_hits=True,
                          num_hard_negatives=7),
                call=("probs", "ids", "mask", "w")),
}
CALL_NAMES = {"probs": "candidate_sampling_probability",
              "ids": "candidate_ids", "mask": "score_mask",
              "w": "sample_weight"}


def _task_kwargs(task_kw, pkg_dtype):
    kw = dict(task_kw)
    if kw.get("score_dtype") == "bf16":
        kw["score_dtype"] = pkg_dtype
    return kw


@pytest.mark.parametrize("name", list(KNOBS))
def test_unfused_task_matches_jax(name):
    knobs = KNOBS[name]
    d = _data(heads=knobs.get("heads", 0))
    jtask = jax_tasks.Retrieval(**_task_kwargs(knobs.get("task", {}),
                                               jnp.bfloat16))
    ttask = tasks.Retrieval(**_task_kwargs(knobs.get("task", {}),
                                           torch.bfloat16))
    jcall = {CALL_NAMES[k]: jnp.asarray(d[k]) for k in knobs.get("call", ())}
    tcall = {CALL_NAMES[k]: torch.from_numpy(d[k])
             for k in knobs.get("call", ())}

    def jloss(q, c):
        out = jtask(q, c, **jcall)
        return out.loss, out

    (jl, jout), (jdq, jdc) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(d["q"]), jnp.asarray(d["c"]))
    q = torch.from_numpy(d["q"]).requires_grad_(True)
    c = torch.from_numpy(d["c"]).requires_grad_(True)
    tout = ttask(q, c, **tcall)
    tout.loss.backward()
    np.testing.assert_allclose(float(tout.loss.detach()), float(jl),
                               rtol=1e-5)
    for field in ("logits", "labels", "scores"):
        np.testing.assert_allclose(
            getattr(tout, field).detach().numpy(),
            np.asarray(getattr(jout, field)), rtol=1e-5, atol=1e-5,
            err_msg=field)
    rtol = 2.0**-7 if name == "bf16" else 1e-5
    for g, w in ((q.grad, jdq), (c.grad, jdc)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=1e-5 * np.abs(w).max())


def test_bf16_scores_are_f32_products_of_rounded_inputs():
    d = _data()
    out = tasks.Retrieval(score_dtype=torch.bfloat16)(
        torch.from_numpy(d["q"]), torch.from_numpy(d["c"]))
    assert out.scores.dtype == torch.float32
    q = torch.from_numpy(d["q"]).bfloat16().double()
    c = torch.from_numpy(d["c"]).bfloat16().double()
    exact = (q @ c.T).numpy()
    # f32 sums of exact products: far closer than bf16 rounding would be.
    np.testing.assert_allclose(out.scores.numpy(), exact, rtol=0,
                               atol=D * 2.0**-23 * np.abs(exact).max())


def test_fused_task_rejects_knobs_it_cannot_take():
    d = _data()
    q, c = torch.from_numpy(d["q"]), torch.from_numpy(d["c"])
    with pytest.raises(ValueError, match="fused=True"):
        tasks.Retrieval(fused=True, num_hard_negatives=3)(q, c)
    with pytest.raises(ValueError, match="fused=True"):
        tasks.Retrieval(fused=True)(q, c, score_mask=torch.ones(B, C,
                                                                dtype=bool))
    with pytest.raises(ValueError, match="fused=True"):
        tasks.Retrieval(fused=True)(torch.zeros(B, 2, D), c)
    with pytest.raises(ValueError, match="fused=True"):
        tasks.Retrieval(fused=True, loss_fn=lambda *a: 0)(q, c)
    with pytest.raises(ValueError, match="candidate ids"):
        tasks.Retrieval(remove_accidental_hits=True)(q, c)


def test_fused_task_matches_unfused_loss_and_grads():
    d = _data()
    kw = dict(temperature=0.5, remove_accidental_hits=True)
    outs = []
    for fused in (False, True):
        q = torch.from_numpy(d["q"]).requires_grad_(True)
        c = torch.from_numpy(d["c"]).requires_grad_(True)
        out = tasks.Retrieval(fused=fused, **kw)(
            q, c, candidate_ids=torch.from_numpy(d["ids"]),
            sample_weight=torch.from_numpy(d["w"]))
        out.loss.backward()
        outs.append((float(out.loss.detach()), q.grad, c.grad, out))
    (lu, dqu, dcu, _), (lf, dqf, dcf, fout) = outs
    np.testing.assert_allclose(lf, lu, rtol=1e-6)
    torch.testing.assert_close(dqf, dqu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dcf, dcu, rtol=1e-5, atol=1e-6)
    assert fout.logits is None and fout.labels is None and fout.scores is None


@pytest.mark.parametrize("fused", [False, True])
def test_compute_loss_on_slice_one_towers_matches_jax(fused):
    users, items, dim, mlp = 40, 60, 32, (48, 32)
    kw = dict(temperature=0.2, remove_accidental_hits=True)
    jmodel = jax_retrieval.TwoTowerRetrieval(
        query_tower=lambda: jax_retrieval.EmbeddingTower(users, dim,
                                                         mlp_units=mlp),
        candidate_tower=lambda: jax_retrieval.EmbeddingTower(items, dim),
        **kw)
    rng = np.random.RandomState(3)
    batch = {
        "user_id": rng.randint(0, users, 16).astype(np.int32),
        "movie_id": rng.randint(0, 8, 16).astype(np.int32),  # hits
        "sample_weight": rng.uniform(0.5, 1.5, 16).astype(np.float32),
        "candidate_sampling_probability":
            rng.uniform(0.05, 1.0, 16).astype(np.float32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(0), jbatch,
                         method="compute_loss")["params"]

    def jloss(p):
        return jmodel.apply({"params": p}, jbatch, method="compute_loss")[0]

    jl, jgrads = jax.value_and_grad(jloss)(params)
    model = retrieval.TwoTowerRetrieval(
        retrieval.EmbeddingTower(users, dim, mlp, device="cpu"),
        retrieval.EmbeddingTower(items, dim, device="cpu"),
        fused=fused, **kw)
    convert.load_flax_params(model, jax.tree.map(np.asarray, params))
    tl, aux = model.compute_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert (aux["retrieval"].logits is None) == fused
    grads = {name: p.grad for name, p in model.named_parameters()}
    flat = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    leaves = {leaf.path: leaf for leaf in convert._leaves(model)}
    for path, w in flat.items():
        leaf = leaves[tuple(k.key for k in path)]
        g = leaf.to_flax(grads[leaf.name].numpy())
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=leaf.name)


def test_compute_loss_extra_negatives_draw_from_the_generator():
    model = retrieval.TwoTowerRetrieval(
        retrieval.EmbeddingTower(10, 8, device="cpu"),
        retrieval.EmbeddingTower(30, 8, device="cpu"),
        remove_accidental_hits=True, num_extra_negatives=5,
        candidate_vocab_size=30)
    batch = {"user_id": torch.arange(4), "movie_id": torch.arange(4),
             "candidate_sampling_probability": torch.full((4,), 0.5)}
    losses = [
        float(model.compute_loss(batch, training=True,
                                 generator=torch.Generator().manual_seed(s)
                                 )[0].detach())
        for s in (0, 0, 1)
    ]
    assert losses[0] == losses[1] != losses[2]
    _, aux = model.compute_loss(batch, training=True,
                                generator=torch.Generator().manual_seed(0))
    assert aux["retrieval"].scores.shape == (4, 9)
    with pytest.raises(ValueError, match="candidate_vocab_size"):
        retrieval.TwoTowerRetrieval(
            retrieval.EmbeddingTower(10, 8, device="cpu"),
            retrieval.EmbeddingTower(30, 8, device="cpu"),
            num_extra_negatives=2).compute_loss(batch, training=True)
