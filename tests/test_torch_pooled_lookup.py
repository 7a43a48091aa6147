"""The pooled lookup (`ops.pooled_lookup`) and the lookups that route
through it.

On the CPU: the kernel's twin against a plain pooling written out pair
by pair (fp16 and f32 tables, bags of 1 to 100 with pads, negative ids
and weights; bit for bit, since both add in f32 in bag order from zero);
which features route through it (`embedding.pool_formats`,
`embedding.poolable`) and what `PartialEmbedding.pooled` checks each
call; f32 tables on the CPU keep `combine`, bit for bit; one op call a
launch group. On the card (marked `cuda`, skips without one; this file
imports no JAX, so `--noconftest` runs it there): the kernel against the
twin bit for bit, one launch a group, one launch a request at
DLRM-DCNv2's widths, and a captured model served from two threads and
a second stream.
"""

import numpy as np
import pytest
import torch

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.embedding import embedding
from recommenders_tpu_torch.embedding import partial
from recommenders_tpu_torch.ops import pooled_lookup
from torch_threads import torch_threads  # noqa: F401 (autouse)

BAGS = (1, 2, 7, 27, 100)


def _features(dtype, dim, weighted, device="cpu", id_dtype=torch.int64,
              seed=0, rows=(50, 4096, 3, 700, 257)):
    """One feature a bag size: a table, ids with pads and a negative id,
    and weights where `weighted`."""
    g = torch.Generator().manual_seed(seed)
    tables, ids, weights = [], [], []
    for bag, n in zip(BAGS, rows):
        tables.append(torch.randn(n, dim, generator=g).to(dtype).to(device))
        x = torch.randint(0, n, (9, bag), generator=g)
        x[torch.rand(9, bag, generator=g) < 0.2] = config_lib.PAD_ID
        x[0, -1] = -5                           # reads row 0
        ids.append(x.to(id_dtype).to(device))
        weights.append(torch.randn(9, bag, generator=g).to(device)
                       if weighted else None)
    return tables, ids, weights


def _plain(tables, ids, weights):
    """Each bag summed pair by pair in f32, in bag order, from zero."""
    out = []
    for t, x, w in zip(tables, ids, weights):
        t = t.float().numpy()
        x = x.long().numpy()
        block = np.zeros((x.shape[0], t.shape[1]), dtype=np.float32)
        for p in range(x.shape[0]):
            for j in range(x.shape[1]):
                if x[p, j] == config_lib.PAD_ID:
                    continue
                row = t[max(x[p, j], 0)]
                if w is not None:
                    row = np.float32(w[p, j].item()) * row
                block[p] = block[p] + row
        out.append(block)
    return torch.from_numpy(np.concatenate(out, axis=1))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_the_twin_is_the_plain_pooling(dtype, weighted):
    tables, ids, weights = _features(dtype, 16, weighted)
    got = pooled_lookup.pooled_lookup(tables, ids, weights)
    assert got.dtype == torch.float32 and got.shape == (9, 16 * len(BAGS))
    assert torch.equal(got, _plain(tables, ids, weights))


def test_the_twin_writes_only_its_columns_of_a_wider_row():
    tables, ids, _ = _features(torch.float16, 8, False)
    out = torch.full((9, 8 * len(BAGS) + 8), 7.0)
    got = pooled_lookup.pooled_lookup(tables, ids, out=out)
    assert got is out
    assert torch.equal(got[:, :-8], _plain(tables, ids, [None] * len(BAGS)))
    assert bool((got[:, -8:] == 7.0).all())


def test_the_twin_raises_on_an_id_past_its_table():
    tables, ids, _ = _features(torch.float16, 8, False)
    ids[0][1, 0] = tables[0].shape[0]
    with pytest.raises(IndexError):
        pooled_lookup.pooled_lookup(tables, ids)


def test_bad_calls_raise():
    tables, ids, _ = _features(torch.float16, 8, False)
    with pytest.raises(ValueError, match="out must be"):
        pooled_lookup.pooled_lookup(tables, ids, out=torch.empty(9, 8))
    with pytest.raises(ValueError, match="one table"):
        pooled_lookup.pooled_lookup(tables, ids[:-1])
    with pytest.raises(ValueError, match="ids must be"):
        pooled_lookup.pooled_lookup(tables[:1], [ids[0][:, 0]])


def test_what_the_kernel_takes():
    takes = pooled_lookup.takes_rows
    assert takes(128, torch.float16) and takes(4, torch.float32)
    assert takes(512, torch.float32) and takes(1024, torch.float16)
    assert not takes(1024, torch.float32)                # 256 vectors
    assert not takes(48, torch.float16)                  # 6 vectors
    assert not takes(4, torch.float16)                   # 8 bytes
    assert not takes(128, torch.bfloat16)
    assert not takes(128, torch.float64)


def _config(combiner="sum", dim=8, rows=300, sequence=0, name="t"):
    table = config_lib.TableConfig(rows, dim, name=name, combiner=combiner)
    return config_lib.FeatureConfig(table, name=f"f_{name}",
                                    max_sequence_length=sequence)


def test_which_features_pool():
    ids = torch.zeros(4, 3, dtype=torch.int64)
    fp16 = torch.zeros(384, 8, dtype=torch.float16)
    poolable, formats = embedding.poolable, embedding.pool_formats
    assert formats(_config()) == {torch.float16, torch.float32}
    assert formats(_config(dim=4)) == {torch.float32}     # 8 B fp16 rows
    assert formats(_config(dim=1024)) == {torch.float16}
    assert formats(_config("mean")) is None
    assert formats(_config(sequence=3)) is None
    assert poolable(fp16, formats(_config()), ids)
    assert poolable(fp16, formats(_config()), (ids, torch.ones(4, 3)))
    assert not poolable(fp16, formats(_config("mean")), ids)
    assert not poolable(fp16, formats(_config(sequence=3)), ids)
    assert not poolable(fp16, formats(_config()), ids[:, 0])
    # f32 on the CPU keeps `combine`; a table that needs its gradient too.
    assert not poolable(torch.zeros(384, 8), formats(_config()), ids)
    trained = torch.nn.Parameter(fp16.clone())
    assert not poolable(trained, formats(_config()), ids)
    with torch.no_grad():
        assert poolable(trained, formats(_config()), ids)


def test_f32_tables_on_the_cpu_keep_combine_bit_for_bit(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("an f32 CPU lookup reached pooled_lookup")

    monkeypatch.setattr(pooled_lookup, "pooled_lookup", refused)
    fcs = [_config(name="a"), _config("mean", name="b")]
    emb = embedding.TpuEmbedding(fcs, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    ids = torch.randint(-1, 300, (6, 5),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = emb({"f_a": ids, "f_b": ids})
        for fc in fcs:
            table = getattr(emb, fc.table.name)
            want = embedding.combine(embedding.gather_rows(table, ids), ids,
                                     fc.table.combiner)
            assert out[fc.name].dtype == torch.float32
            assert torch.equal(out[fc.name], want)


def test_a_partial_embedding_pools_both_partitions_in_one_call(monkeypatch):
    calls = []
    original = pooled_lookup.pooled_lookup

    def counted(tables, *args, **kwargs):
        calls.append(len(tables))
        return original(tables, *args, **kwargs)

    monkeypatch.setattr(pooled_lookup, "pooled_lookup", counted)
    fcs = [_config(rows=20_000, name="big"), _config(name="small"),
           _config("mean", name="averaged"), _config(name="other", dim=16)]
    emb = partial.PartialEmbedding(fcs, device="cpu", dtype=torch.float16,
                                   generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    features = {"f_big": torch.randint(-1, 20_000, (5, 4), generator=g),
                "f_small": torch.randint(-1, 300, (5, 2), generator=g),
                "f_averaged": torch.randint(-1, 300, (5, 3), generator=g),
                "f_other": torch.randint(-1, 300, (5, 6), generator=g)}
    with torch.no_grad():
        out = emb(features)
        assert emb.pooled(features) is None        # "averaged" is a mean
        pooled = {k: v for k, v in features.items() if k != "f_averaged"}
        x = emb.pooled(pooled, out=torch.zeros(5, 40))
    assert calls == [3, 3]
    assert list(out) == list(features)
    assert out["f_averaged"].dtype == torch.float16
    columns = 0
    for name in pooled:
        part = emb.sharded_embedding if name == "f_big" else (
            emb.dense_embedding)
        table = getattr(part, name[2:])
        want = pooled_lookup.pooled_lookup([table], [features[name]])
        assert out[name].dtype == torch.float32
        assert torch.equal(out[name], want)
        assert torch.equal(x[:, columns:columns + table.shape[1]], want)
        columns += table.shape[1]
    assert x.shape == (5, 40)


def _retable(emb):
    emb.dense_embedding.small = torch.nn.Parameter(
        emb.dense_embedding.small.detach() * 2, requires_grad=False)


def _to_bf16(emb):
    emb.dense_embedding.small.data = emb.dense_embedding.small.data.to(
        torch.bfloat16)


@pytest.mark.parametrize("change,pools", [
    ("none", True),
    ("a table replaced", True),
    ("a table's dtype", False),
    ("an ids dtype", True),
    ("the order", True),
    ("weights", True),
    ("a table that trains", False),
])
def test_pooled_follows_what_each_call_holds(change, pools):
    """`PartialEmbedding.pooled` works out each feature's config once and
    checks per call what can change: after each change its sums are
    those of the tables it holds then, or None where a feature no
    longer pools (a bf16 table; a table that needs its gradient)."""
    fcs = [_config(rows=20_000, name="big"), _config(name="small")]
    emb = partial.PartialEmbedding(fcs, device="cpu", dtype=torch.float16,
                                   generator=torch.Generator().manual_seed(0))
    emb.requires_grad_(False)
    g = torch.Generator().manual_seed(3)
    features = {"f_big": torch.randint(-1, 20_000, (5, 4), generator=g),
                "f_small": torch.randint(-1, 300, (5, 2), generator=g)}
    with torch.no_grad():
        assert emb.pooled(features) is not None
    if change == "a table replaced":
        _retable(emb)
    elif change == "a table's dtype":
        _to_bf16(emb)
    elif change == "an ids dtype":
        features["f_small"] = features["f_small"].int()
    elif change == "the order":
        features = dict(reversed(list(features.items())))
    elif change == "weights":
        features["f_small"] = (features["f_small"], torch.rand(5, 2,
                                                               generator=g))
    elif change == "a table that trains":
        emb.dense_embedding.small.requires_grad_(True)
    with torch.set_grad_enabled(change == "a table that trains"):
        got = emb.pooled(features)
    if not pools:
        assert got is None
        return
    tables = {"f_big": emb.sharded_embedding.big,
              "f_small": emb.dense_embedding.small}
    parts = [(tables[n],) + (f if isinstance(f, tuple) else (f, None))
             for n, f in features.items()]
    want = pooled_lookup.pooled_lookup(*map(list, zip(*parts)))
    assert torch.equal(got, want)


def _mixed(device="cpu"):
    """Features of three launch groups: fp16 D = 8 (int64 ids), f32 D = 8
    (int64), fp16 D = 8 with int32 ids, interleaved."""
    f16, i64, w16 = _features(torch.float16, 8, True, seed=1)
    f32, i64b, w32 = _features(torch.float32, 8, False, seed=2)
    tables = [f16[0], f32[0], f16[1], f32[1], f16[2]]
    ids = [i64[0], i64b[0], i64[1].int(), i64b[1], i64[2]]
    weights = [w16[0], None, w16[1], None, None]
    return ([t.to(device) for t in tables], [x.to(device) for x in ids],
            [None if w is None else w.to(device) for w in weights])


def test_the_launch_calls_the_op_once_a_group(monkeypatch):
    """`_launch` hands the op each (table dtype, width, id dtype) group
    in one call, with its own columns, f32 weights or an empty tensor:
    a stand-in op that pools by the twin fills every feature's columns
    as the twin does."""
    tables, ids, weights = _mixed()
    calls = []

    def op(t, i, w, c, out):
        assert len({(x.dtype, x.shape[1]) for x in t}) == 1
        assert len({x.dtype for x in i}) == 1
        assert all(x.dtype == torch.float32 for x in w)
        calls.append(list(c))
        pooled_lookup.pooled_lookup_reference(
            t, i, [x if x.numel() else None for x in w], c, out)

    monkeypatch.setattr(pooled_lookup, "_op", lambda: op)
    groups = {}
    for n, (t, i) in enumerate(zip(tables, ids)):
        groups.setdefault((t.dtype, t.shape[1], i.dtype), []).append(n)
    out = torch.zeros(9, 44)
    pooled_lookup._launch(tables, ids, weights, [0, 8, 16, 24, 32], groups,
                          out)
    assert calls == [[0, 32], [8, 24], [16]]
    want = pooled_lookup.pooled_lookup(tables, ids, weights)
    assert torch.equal(out[:, :40], want) and not out[:, 40:].any()

# --- On the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype,dim", [
    (torch.float16, 8), (torch.float16, 64), (torch.float16, 128),
    (torch.float16, 512), (torch.float16, 1024), (torch.float32, 4),
    (torch.float32, 128), (torch.float32, 256), (torch.float32, 512)])
def test_the_kernel_is_its_twin_bit_for_bit(dtype, dim, weighted, id_dtype,
                                           cuda):
    tables, ids, weights = _features(dtype, dim, weighted, id_dtype=id_dtype,
                                     seed=dim)
    want = pooled_lookup.pooled_lookup(tables, ids, weights)
    before = pooled_lookup.pooled_lookup.launches
    got = pooled_lookup.pooled_lookup(
        [t.to(cuda) for t in tables], [x.to(cuda) for x in ids],
        [None if w is None else w.to(cuda) for w in weights],
        out=torch.zeros(9, dim * len(BAGS) + 4, device=cuda))
    torch.cuda.synchronize()
    assert pooled_lookup.pooled_lookup.launches == before + 1
    assert torch.equal(got[:, :-4].cpu(), want)
    assert not bool(got[:, -4:].any())


@pytest.mark.cuda
def test_the_kernel_skips_an_id_past_its_table(cuda):
    tables, ids, _ = _features(torch.float16, 128, False)
    past = [x.clone() for x in ids]
    past[1][2, 0] = tables[1].shape[0] + 3
    kept = [x.clone() for x in ids]
    kept[1][2, 0] = config_lib.PAD_ID
    got = pooled_lookup.pooled_lookup([t.to(cuda) for t in tables],
                                      [x.to(cuda) for x in past])
    want = pooled_lookup.pooled_lookup(tables, kept)
    assert torch.equal(got.cpu(), want)


def _dlrm(cuda):
    """A DLRM-DCNv2 model at the cell's widths (vocabularies cut to 4,096
    rows, fp16 tables) and a 400-pair request."""
    from recommenders_tpu_torch.models import ranking

    bags = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
            100, 27, 10, 3, 1, 1)
    fcs = [_config(dim=128, rows=4096, name=f"t{i}")
           for i in range(len(bags))]
    model = ranking.Ranking(
        fcs, 13, bottom_stack=ranking.mlp_stack((512, 256, 128), "relu"),
        feature_interaction=ranking.multi_layer_dcn_interaction(3, 512),
        top_stack=ranking.mlp_stack((1024, 1024, 512, 256, 1), None),
        interaction_takes_list=False, concat_dense=False, device=cuda,
        table_dtype=torch.float16).eval().requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {fc.name: torch.randint(0, 4096, (400, bag), generator=g,
                                    device=cuda)
             for fc, bag in zip(fcs, bags)}
    batch["dense_features"] = torch.rand(400, 13, generator=g, device=cuda)
    return model, batch


def _close(got, want):
    # The replay runs the eager path's kernels; cuBLAS may pick another
    # algorithm under capture, so a few f32 ulps apart.
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.cuda
def test_a_dlrm_request_is_one_pooled_launch(cuda):
    """A DLRM-DCNv2 request at the cell's widths (vocabularies cut to
    4,096 rows) through `Ranking.logits`: one launch pools all 26
    features, by the op library's own count."""
    from recommenders_tpu_torch.ops import cuda_build

    model, batch = _dlrm(cuda)
    other = {k: v.flip(0) for k, v in batch.items()}
    small = {k: v[:123] for k, v in batch.items()}
    with torch.inference_mode():
        eager = [model.logits(b) for b in (batch, other, small)]
        model.capture([400, 123])
        torch.cuda.synchronize()
        cuda_build.reset_pool_launches()
        graphed = [model.logits(b) for b in (batch, other, small)]
        torch.cuda.synchronize()
    # One pooled launch a request, eager or replayed.
    assert cuda_build.pool_launches() == {"f32": 0, "f16": 3}
    assert sorted(model._captured.graphs) == [123, 400]
    # Read after all three replays: a replay's answer is the caller's own.
    for got, want in zip(graphed, eager):
        _close(got, want)


@pytest.mark.cuda
def test_a_captured_model_serves_two_threads_and_a_second_stream(cuda):
    """The captured graphs share one static input: two threads that serve
    one captured model each get their own requests' logits (one replay
    at a time), and a call on another stream than the capture's takes
    the eager path."""
    import threading

    model, batch = _dlrm(cuda)
    requests = [{k: v.roll(j, 0) for k, v in batch.items()}
                for j in range(8)]
    with torch.inference_mode():
        eager = [model.logits(b) for b in requests]
        model.capture([400])
        torch.cuda.synchronize()
    got = [None] * len(requests)

    def serve(js):
        with torch.inference_mode():
            for j in js:
                got[j] = model.logits(requests[j])

    threads = [threading.Thread(target=serve, args=(range(k, 8, 2),))
               for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.inference_mode(), torch.cuda.stream(side):
        replays = model._captured.graphs[400][1].clone()
        on_side = model.logits(requests[3])
        unchanged = torch.equal(model._captured.graphs[400][1], replays)
    torch.cuda.synchronize()
    for g, want in zip(got, eager):
        _close(g, want)
    _close(on_side, eager[3])
    assert unchanged      # the side stream's call replayed nothing


@pytest.mark.cuda
def test_mixed_tables_launch_once_a_group_and_equal_the_twin(cuda):
    tables, ids, weights = _mixed()
    want = pooled_lookup.pooled_lookup(tables, ids, weights)
    before = pooled_lookup.pooled_lookup.launches
    got = pooled_lookup.pooled_lookup(*_mixed(cuda))
    torch.cuda.synchronize()
    assert pooled_lookup.pooled_lookup.launches == before + 3
    assert torch.equal(got.cpu(), want)
