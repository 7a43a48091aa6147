"""Rank functions for the port's distributed tests (`run_ranks`).

Spawned ranks import this module by name, so it imports torch and the
port only: the ranks never load JAX. Every function takes the rank's
device first and returns NumPy arrays (or dicts of them).
"""

import numpy as np
import torch
import torch.distributed as dist

from recommenders_tpu_torch.embedding import config
from recommenders_tpu_torch.embedding import embedding as embedding_lib
from recommenders_tpu_torch.embedding import engine as engine_lib
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.ops import topk as topk_ops
from recommenders_tpu_torch.parallel import ann
from recommenders_tpu_torch.parallel import corpus
from recommenders_tpu_torch.parallel import embedding_lookup as exchange
from recommenders_tpu_torch.parallel import mesh as mesh_lib
from recommenders_tpu_torch.tasks import retrieval as retrieval_task


def np_(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    if isinstance(x, dict):
        return {k: np_(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(np_(v) for v in x)
    return x


def run_cases(device, cases):
    """Runs `[(function name, args), ...]` of this module in turn, in one
    process group (one spawn for many cases); returns their results."""
    return [globals()[name](device, *args) for name, args in cases]


def cases(fn_args):
    """`run_ranks` over `run_cases`, for a test module's fixture."""
    from recommenders_tpu_torch.parallel import launch

    world, items = fn_args
    return launch.run_ranks(run_cases, world, "gloo", "cpu", items,
                            threads=1)


# --- mesh, distributed top-k, cross_replica_concat --------------------------

def mesh_basics(device, scores, ids, k, rows, weights):
    out = {"rank": dist.get_rank()}
    mesh = mesh_lib.create_mesh((2, 2), device_type=device.type)
    out["coords"] = (mesh_lib.axis_index(mesh, "data"),
                     mesh_lib.axis_index(mesh, "model"))
    batch = {"a": np.arange(8), "b": (np.arange(16).reshape(8, 2),
                                      np.arange(8)), "ragged": np.arange(7)}
    out["shard"] = mesh_lib.shard_batch(batch, mesh)
    gathered = mesh_lib.all_gather(
        torch.tensor([dist.get_rank()], device=device), mesh, "model")
    out["gathered_model"] = np_(gathered)
    # distributed_top_k over a 4-way model axis.
    mesh4 = mesh_lib.create_mesh((4,), ("model",), device_type=device.type)
    i = mesh_lib.axis_index(mesh4, "model")
    cols = scores.shape[1] // 4
    part = slice(i * cols, (i + 1) * cols)
    got = topk_ops.distributed_top_k(
        torch.as_tensor(scores[:, part], device=device),
        torch.as_tensor(ids[:, part], device=device), k, mesh4, "model")
    out["topk"] = np_(got)
    # cross_replica_concat over a 4-way data axis, and its gradient.
    mesh_d = mesh_lib.create_mesh((4,), ("data",), device_type=device.type)
    i = mesh_lib.axis_index(mesh_d, "data")
    x = torch.as_tensor(rows[2 * i:2 * i + 2], device=device,
                        dtype=torch.float32).requires_grad_(True)
    pooled = retrieval_task.cross_replica_concat(x, mesh_d, "data")
    loss = torch.sum(pooled * torch.as_tensor(weights[i], device=device))
    loss.backward()
    out["pooled"] = np_(pooled)
    out["pooled_grad"] = np_(x.grad)
    return out


def failing_rank(device):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
    return 0


# --- ShardedBruteForce -------------------------------------------------------

def sharded_brute_force(device, queries, corpus_np, k, identifiers,
                        exclusions_cols, shape):
    names = ("model",) if len(shape) == 1 else ("data", "model")
    mesh = mesh_lib.create_mesh(shape, names, device_type=device.type)
    index = corpus.ShardedBruteForce(k=k, mesh=mesh, device=device)
    ids = None if identifiers is None else torch.as_tensor(identifiers)
    index.index(torch.as_tensor(corpus_np), ids)
    q = torch.as_tensor(queries, device=device)
    scores, got = index(q)
    out = {"scores": np_(scores), "ids": np_(got),
           "shard_rows": index._candidates.shape[0]}
    if exclusions_cols:
        ex = got[:, :exclusions_cols]
        out["excluded"] = np_(index.query_with_exclusions(q, ex))
    return out


def sharded_metric(device, queries, corpus_np, true_rows, ks):
    from recommenders_tpu_torch import metrics as metrics_lib

    mesh = mesh_lib.create_mesh((4,), ("model",), device_type=device.type)
    cands = torch.as_tensor(corpus_np, device=device)
    metric = metrics_lib.FactorizedTopK(
        candidates=corpus.ShardedBruteForce(
            k=max(ks), mesh=mesh, device=device).index(cands), ks=ks)
    state = metric.update(metric.init(), torch.as_tensor(queries,
                                                          device=device),
                          cands[torch.as_tensor(true_rows)])
    return {k: float(v) for k, v in metric.result(state).items()}


# --- the embedding exchange ----------------------------------------------------

def exchange_ops(device, table, ids, grads, scale):
    mesh = mesh_lib.create_mesh((2, 2), device_type=device.type)
    shard = corpus.shard_rows(torch.as_tensor(table, device=device), mesh,
                              "model").contiguous()
    local_ids = mesh_lib.shard_batch(torch.as_tensor(ids, device=device),
                                     mesh)
    local_grads = mesh_lib.shard_batch(torch.as_tensor(grads, device=device),
                                       mesh)
    out = {
        "lookup": np_(exchange.sharded_lookup(shard, local_ids, mesh)),
        "gspmd": np_(exchange.gspmd_lookup(shard, local_ids, mesh)),
        "scatter": np_(exchange.sharded_scatter_add(
            shard, local_ids, local_grads, mesh, scale=scale)),
    }
    # ShardedGather's backward: the table shard's gradient of
    # sum(rows · grads) over this rank's data slice.
    leaf = shard.clone().requires_grad_(True)
    rows = exchange.ShardedGather.apply(leaf, torch.clamp(local_ids, min=0),
                                        mesh, "model")
    torch.sum(rows * local_grads).backward()
    out["grad"] = np_(leaf.grad)
    return out


def sharded_tpu_embedding(device, fcs_spec, features, seed):
    """A TpuEmbedding row-sharded over a (2, 2) mesh: its lookups and its
    tables' gradients (summed over the data axis) for this rank's data
    slice, and the unsharded layer's for the global batch."""
    def build(mesh):
        fcs = tuple(
            config.FeatureConfig(
                table=config.TableConfig(v, d, name=t, combiner=c),
                name=f, max_sequence_length=m)
            for f, t, v, d, c, m in fcs_spec)
        return embedding_lib.TpuEmbedding(
            fcs, device=device, mesh=mesh,
            generator=torch.Generator(device).manual_seed(seed))

    mesh = mesh_lib.create_mesh((2, 2), device_type=device.type)
    out = {}
    for name, m in (("sharded", mesh), ("whole", None)):
        layer = build(m)
        feats = {k: torch.as_tensor(v, device=device)
                 for k, v in features.items()}
        if m is not None:
            feats = mesh_lib.shard_batch(feats, mesh)
        acts = layer(feats)
        loss = sum(torch.sum(torch.sin(a) * (1.0 + a)) for a in acts.values())
        loss.backward()
        if m is not None:
            mesh_lib.sum_grads(layer.parameters(), mesh, "data")
        out[name] = {"acts": np_({k: v.detach() for k, v in acts.items()}),
                     "grads": np_({k: p.grad for k, p in
                                   layer.named_parameters()})}
    return out


# --- the meshed engine ----------------------------------------------------------

def _engine_fcs(maxu=None, dims=32):
    return (
        config.FeatureConfig(
            table=config.TableConfig(4000, dims, name="a",
                                     max_unique_ids=maxu), name="fa"),
        config.FeatureConfig(
            table=config.TableConfig(9000, dims, name="b"), name="fb"),
        config.FeatureConfig(
            table=config.TableConfig(9000, dims, name="b"), name="fb_hist",
            max_sequence_length=0),
    )


def engine_run(device, kind, shape, sharding, stacked, bf16_sr, maxu,
               logical, batches, checkpoint_dir=None):
    """Trains a (maybe meshed) engine over `batches` from the logical
    state `logical` (NumPy, the JAX engine's layout); returns the logical
    state after the steps, and the losses."""
    from recommenders_tpu_torch.utils import checkpoint, convert

    mesh = None
    if shape is not None:
        names = ("model",) if len(shape) == 1 else ("data", "model")
        mesh = mesh_lib.create_mesh(shape, names, device_type=device.type)
    eng = engine_lib.EmbeddingEngine(
        _engine_fcs(maxu), optimizer=config.OptimizerSpec(
            kind=kind, learning_rate=0.05),
        mesh=mesh, dtype=torch.bfloat16 if bf16_sr else torch.float32,
        slot_dtype=torch.bfloat16 if bf16_sr else None,
        stack_tables=stacked, row_sharding=sharding,
        stochastic_rounding=bf16_sr, device=device)
    st = convert.engine_state_from_logical(eng, logical)

    def loss_of(acts):
        return sum(torch.sum(torch.square(a.float()))
                   for a in acts.values())

    losses = []
    for batch in batches:
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        b = mesh_lib.shard_batch(b, mesh, "data")
        st, loss, _ = eng.grad_and_update(st, b, loss_of)
        if mesh is not None:
            loss = mesh_lib.all_reduce(loss, mesh, "data")
        losses.append(float(loss))
    out = {"losses": losses,
           "state": convert.engine_state_to_logical(eng, st),
           "shard_rows": {k: v.shape[0] for k, v in st.tables.items()}}
    if checkpoint_dir is not None:
        checkpoint.save(checkpoint_dir, st, engine=eng)
        back = checkpoint.restore(checkpoint_dir, st, engine=eng)
        out["restored_equal"] = all(
            torch.equal(back.tables[k], st.tables[k]) for k in st.tables)
    return out


# --- Trainer(mesh) and pooled negatives ----------------------------------------

def _retrieval_model(device, fused=False, seed=0):
    from recommenders_tpu_torch import models

    g = torch.Generator(device).manual_seed(seed)
    return models.TwoTowerRetrieval(
        query_tower=models.EmbeddingTower(100, 16, device=device,
                                          generator=g),
        candidate_tower=models.EmbeddingTower(200, 16, device=device,
                                              generator=g),
        fused=fused)


def load_params(model, params):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.as_tensor(params[name]))


def pooled_step(device, params, batch, lr, fused, steps):
    from recommenders_tpu_torch.parallel import retrieval_step

    mesh = mesh_lib.create_mesh((dist.get_world_size(),), ("data",),
                                device_type=device.type)
    model = _retrieval_model(device, fused)
    load_params(model, params)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    step = retrieval_step.make_pooled_negatives_train_step(model, opt, mesh)
    losses = []
    for _ in range(steps):
        local = {k: torch.as_tensor(v, device=device)
                 for k, v in mesh_lib.shard_batch(batch, mesh).items()}
        losses.append(float(step(local)))
    return {"losses": losses,
            "params": np_(dict(model.named_parameters()))}


def pooled_trainer(device, data, batch_size, lr):
    from recommenders_tpu_torch.parallel import retrieval_step

    mesh = mesh_lib.create_mesh((dist.get_world_size(),), ("data",),
                                device_type=device.type)
    trainer = retrieval_step.PooledNegativesTrainer(
        _retrieval_model(device), lambda p: torch.optim.Adagrad(
            p, lr=lr, initial_accumulator_value=0.1, eps=0.0), mesh=mesh)
    n = len(data["user_id"])
    batches = [{k: v[i:i + batch_size] for k, v in data.items()}
               for i in range(0, n - batch_size + 1, batch_size)]
    state = trainer.init(sample_batch=batches[0])
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    evaluated = trainer.evaluate(state, lambda: iter(batches[:2]))
    state, history = trainer.fit(state, lambda: iter(batches[:4]),
                                 verbose=False,
                                 validation_data=lambda: iter(batches[:2]))
    return {"losses": losses, "track_stats": trainer.track_stats,
            "evaluated": evaluated, "history": history["epochs"][0]}


def meshed_trainer(device, shape, params, batches, lr):
    """`Trainer(mesh)` on the two-tower model: the losses, metrics and
    parameters after `batches` (global batches)."""
    from recommenders_tpu_torch import models

    mesh = None
    if shape is not None:
        mesh = mesh_lib.create_mesh(shape, ("data",),
                                    device_type=device.type)
    model = _retrieval_model(device)
    load_params(model, params)
    trainer = models.Trainer(
        model, lambda p: torch.optim.SGD(p, lr=lr), mesh=mesh)
    state = trainer.init()
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return {"losses": losses, "metrics": trainer.metric_results(state),
            "params": np_(dict(model.named_parameters()))}


def meshed_ranking(device, shape, fcs_spec, dense_dim, batches, lr, seed):
    """A DLRM `Ranking` whose big tables are row-sharded over the model
    axis, trained with `Trainer(mesh)` on (data, model): its losses, and
    its whole tables and dense weights after the steps."""
    from recommenders_tpu_torch import models
    from recommenders_tpu_torch.models import ranking

    mesh = None
    if shape is not None:
        mesh = mesh_lib.create_mesh(shape, device_type=device.type)
    fcs = tuple(config.FeatureConfig(
        table=config.TableConfig(v, 8, name=t), name=f)
        for f, t, v in fcs_spec)
    model = models.Ranking(
        fcs, dense_dim, bottom_stack=ranking.mlp_stack((16, 8)),
        top_stack=ranking.mlp_stack((16, 1)), size_threshold=500,
        device=device, generator=torch.Generator(device).manual_seed(seed),
        mesh=mesh)
    trainer = models.Trainer(
        model, lambda p: torch.optim.SGD(p, lr=lr), mesh=mesh)
    state = trainer.init()
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    params = {}
    for name, p in model.named_parameters():
        if "sharded_embedding" in name and mesh is not None:
            p = mesh_lib.all_gather(p.detach(), mesh, "model")
        params[name] = np_(p)
    return {"losses": losses, "params": params,
            "metrics": trainer.metric_results(state)}


def _listwise_model(device, loss_name, kernel, bias):
    """Scores `[B, L, F]` features with one dense layer and ranks them
    with a listwise `tasks.Ranking` (the tests' flax model's twin)."""
    from recommenders_tpu_torch import models, tasks
    from recommenders_tpu_torch.tasks import listwise

    class Listwise(models.Model):
        def __init__(self):
            super().__init__()
            self.dense = torch.nn.Linear(kernel.shape[0], 1, device=device)
            with torch.no_grad():
                self.dense.weight.copy_(torch.as_tensor(kernel.T))
                self.dense.bias.copy_(torch.as_tensor(bias))
            self.task = tasks.Ranking(loss_fn=getattr(listwise, loss_name))

        def shard_tasks(self, mesh, axis):
            self.task = self.task.on_mesh(mesh, axis)

        def compute_loss(self, batch, training=False, generator=None):
            scores = self.dense(batch["features"])[..., 0]
            return self.task(batch["labels"], scores,
                             batch.get("weight")).loss

    return Listwise()


def meshed_listwise(device, shape, loss_name, kernel, bias, batches, lr):
    """`Trainer(mesh)` on a listwise ranking model: losses and the dense
    layer after `batches` (global batches)."""
    from recommenders_tpu_torch import models

    mesh = None
    if shape is not None:
        mesh = mesh_lib.create_mesh(shape, ("data",),
                                    device_type=device.type)
    model = _listwise_model(device, loss_name, kernel, bias)
    trainer = models.Trainer(
        model, lambda p: torch.optim.SGD(p, lr=lr), mesh=mesh)
    state = trainer.init()
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return {"losses": losses,
            "params": np_(dict(model.named_parameters()))}


def meshed_refusals(device):
    """What `Trainer(mesh)` and a meshed `Retrieval` refuse: a model
    whose loss they cannot split, and a loss_fn that need not split."""
    from recommenders_tpu_torch import models, tasks

    mesh = mesh_lib.create_mesh((dist.get_world_size(),), ("data",),
                                device_type=device.type)

    class OwnMean(models.Model):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3, device=device))

        def compute_loss(self, batch, training=False, generator=None):
            return torch.mean(self.w * batch["x"])

    out = {}
    try:
        models.Trainer(OwnMean(), lambda p: torch.optim.SGD(p, lr=0.1),
                       mesh=mesh)
    except NotImplementedError as e:
        out["trainer"] = str(e)
    task = tasks.Retrieval(loss_fn=lambda y, x, w: torch.mean(x), mesh=mesh)
    q = torch.ones(4, 2, device=device)
    try:
        task(q, q)
    except ValueError as e:
        out["retrieval"] = str(e)
    return out


# --- ShardedBucketed / ShardedScaNN ------------------------------------------------

def sharded_bucketed(device, queries, corpus_np, k, params, shape,
                     streamed, identifiers=None, string_ids=None,
                     exclusions_cols=0):
    names = ("model",) if len(shape) == 1 else ("data", "model")
    mesh = mesh_lib.create_mesh(shape, names, device_type=device.type)
    index = ann.ShardedBucketed(k=k, mesh=mesh, device=device, **params)
    ids = (string_ids if string_ids is not None
           else None if identifiers is None else torch.as_tensor(
               identifiers))
    n = corpus_np.shape[0]
    if streamed:
        index.index_streamed(
            lambda: (corpus_np[i:i + 700] for i in range(0, n, 700)), n, ids)
    else:
        index.index(corpus_np, ids)
    q = torch.as_tensor(queries, device=device)
    scores, got = index(q)
    out = {"scores": np_(scores), "ids": np_(got),
           "candidates": np_(index._candidates),
           "scales": np_(index._scales), "valid": index._valid_rows,
           "rps": index._rows_per_shard}
    if exclusions_cols:
        out["excluded"] = np_(index.query_with_exclusions(
            q, got[:, :exclusions_cols]))
    return out


def sharded_bucketed_from_jax(device, queries, k, params, arrays):
    """A port ShardedBucketed loaded with a JAX ShardedBucketed's
    stacked arrays (`convert.sharded_bucketed_from_numpy`)."""
    from recommenders_tpu_torch.utils import convert

    mesh = mesh_lib.create_mesh((4,), ("model",), device_type=device.type)
    index = ann.ShardedBucketed(k=k, mesh=mesh, device=device, **params)
    convert.sharded_bucketed_from_numpy(index, arrays)
    scores, got = index(torch.as_tensor(queries, device=device))
    return {"scores": np_(scores), "ids": np_(got)}


def sharded_scann(device, queries, corpus_np, scann_params, shape,
                  streamed=False, identifiers=None, jax_arrays=None,
                  k=None, budget=None):
    mesh = None
    if shape is not None:
        mesh = mesh_lib.create_mesh(shape, ("model",),
                                    device_type=device.type)
    inner = approximate.ScaNN(device=device, **scann_params)
    if mesh is None:
        index = inner
    else:
        index = ann.ShardedScaNN(inner, mesh=mesh)
    ids = None if identifiers is None else torch.as_tensor(identifiers)
    n = corpus_np.shape[0]
    if jax_arrays is not None:
        from recommenders_tpu_torch.utils import convert

        if mesh is None:
            convert.scann_state_from_numpy(index, jax_arrays)
        else:
            convert.sharded_scann_from_numpy(index, jax_arrays)
    elif streamed:
        index.index_streamed(
            lambda: (corpus_np[i:i + 1000] for i in range(0, n, 1000)), n,
            ids)
    elif budget is not None:
        # A host corpus past the build budget takes the streamed build.
        saved, ann.SINGLE_DEVICE_BUILD_BUDGET_BYTES = (
            ann.SINGLE_DEVICE_BUILD_BUDGET_BYTES, budget)
        try:
            index.index(corpus_np, ids)
        finally:
            ann.SINGLE_DEVICE_BUILD_BUDGET_BYTES = saved
    else:
        index.index(torch.as_tensor(corpus_np, device=device), ids)
    scores, got = index(torch.as_tensor(queries, device=device), k=k)
    out = {"scores": np_(scores), "ids": np_(got),
           "corpus_rows": (None if getattr(index, "_corpus", None) is None
                           else index._corpus.shape[0])}
    if mesh is not None:
        out["centroids"] = np_(index._centroids)
        out["leaf_rows"] = np_(index._leaf_rows)
    return out


# --- checkpoints of row-sharded tables ---------------------------------------------

def _checkpoint_ranking(device, mesh, fcs_spec, dense_dim, seed):
    from recommenders_tpu_torch import models
    from recommenders_tpu_torch.models import ranking

    fcs = tuple(config.FeatureConfig(
        table=config.TableConfig(v, 8, name=t), name=f)
        for f, t, v in fcs_spec)
    model = models.Ranking(
        fcs, dense_dim, bottom_stack=ranking.mlp_stack((16, 8)),
        top_stack=ranking.mlp_stack((16, 1)), size_threshold=500,
        device=device, generator=torch.Generator(device).manual_seed(seed),
        mesh=mesh)
    return model, models.Trainer(
        model, lambda p: torch.optim.Adagrad(p, lr=0.1), mesh=mesh)


def _logical(model, mesh):
    out = {}
    for name, p in model.named_parameters():
        if "sharded_embedding" in name and mesh is not None:
            p = mesh_lib.all_gather(p.detach(), mesh, "model")
        out[name] = np.array(np_(p))  # a copy: later steps update p
    return out


def meshed_checkpoint(device, shape, fcs_spec, dense_dim, batches, seed,
                      path):
    """A row-sharded DLRM under `Trainer(mesh)` with Adagrad: steps over
    `batches[:3]`, a checkpoint at `path`, then the rest of the batches
    uninterrupted; and a second model from another seed restored from
    the checkpoint and resumed over the same rest. Returns both runs'
    losses and logical parameters, and the logical state at the save."""
    from recommenders_tpu_torch.utils import checkpoint

    mesh = mesh_lib.create_mesh(shape, device_type=device.type)
    model, trainer = _checkpoint_ranking(device, mesh, fcs_spec, dense_dim,
                                         seed)
    state = trainer.init()
    for batch in batches[:3]:
        state, _ = trainer.train_step(state, batch)
    checkpoint.save(path, state)
    saved = _logical(model, mesh)
    sums = {name: np_(mesh_lib.all_gather(
        state.opt_state.state[p]["sum"], mesh, "model"))
        for name, p in model.named_parameters()
        if "sharded_embedding" in name}
    straight = []
    for batch in batches[3:]:
        state, loss = trainer.train_step(state, batch)
        straight.append(float(loss))
    out = {"saved": saved, "saved_sums": sums, "straight": straight,
           "straight_params": _logical(model, mesh),
           "shard_rows": {name: p.shape[0]
                          for name, p in model.named_parameters()
                          if "sharded_embedding" in name}}
    model, trainer = _checkpoint_ranking(device, mesh, fcs_spec, dense_dim,
                                         seed + 1)
    state = checkpoint.restore(path, trainer.init())
    out["restored_step"] = state.step
    resumed = []
    for batch in batches[3:]:
        state, loss = trainer.train_step(state, batch)
        resumed.append(float(loss))
    out["resumed"] = resumed
    out["resumed_params"] = _logical(model, mesh)
    out["metrics"] = trainer.metric_results(state)
    return out


# --- the port's distributed examples ------------------------------------------

def example_runs(device, runs):
    """Runs each `(example module name, keyword arguments)`'s per-rank
    body (`recommenders_tpu_torch.examples.<name>.run`) in turn in this
    process group; returns their results."""
    import importlib

    return [importlib.import_module(
        f"recommenders_tpu_torch.examples.{name}").run(device, **kwargs)
        for name, kwargs in runs]
