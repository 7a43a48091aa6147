"""The int8 bodies' launch plans at the shapes they serve, on the CPU.

K3's int8 body (`csrc/bucketed_scores.cu`, `scoring._int8_plan`) at the
100M catalog's request (phase 38 of `chip_smoke.py`: Q = 256, N =
100,003,840, B = 4,096, D = 128) and at the 1M serving smoke's (Q =
1,024, N = 1,003,520, B = 4,096), on an H100's 132 SMs: the grid is one
wave of one block an SM (two unsplit waves at 1M), the codes are read
once a query tile, and the splits walk every row group exactly once, in
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.ops import leaf_scoring as jax_leaf
from recommenders_tpu_torch.ops import leaf_scoring
from recommenders_tpu_torch.ops import scoring
from torch_threads import torch_threads  # noqa: F401 (autouse)

SMS = 132
SMEM = 232_448

K3_SHAPES = {
    # (queries, rows, D, buckets) -> (query tile, splits)
    "100M": ((256, 100_003_840, 128, 4096), (256, 2)),
    "1M": ((1024, 1_003_520, 128, 4096), (256, 1)),
}


def _group_ranges(groups, splits):
    """Split z's groups [G·z/S, G·(z+1)/S), as the kernel computes them."""
    return [(groups * z // splits, groups * (z + 1) // splits)
            for z in range(splits)]


@pytest.mark.parametrize("shape", sorted(K3_SHAPES))
def test_k3_int8_plan_is_one_wave_that_walks_every_group_once(shape):
    (qn, n, d, buckets), plan = K3_SHAPES[shape]
    tq, splits = scoring._int8_plan(qn, n, d, buckets, SMS)
    assert (tq, splits) == plan
    blocks = -(-buckets // 64) * -(-qn // tq)
    # One wave of one block an SM, as full as it gets; at 1M the 256
    # tiles' blocks are two waves unsplit.
    assert blocks * splits <= SMS or splits == 1
    assert blocks * (splits + 1) > SMS
    # 2 tq bf16 rows of the query tile and two stages of 64 code rows
    # and their f32 scales fit.
    assert 128 + 2 * tq * d + 2 * 64 * (d + 4) <= SMEM
    groups = n // buckets
    walked = [g for lo, hi in _group_ranges(groups, splits)
              for g in range(lo, hi)]
    assert walked == list(range(groups))
    if shape == "100M":
        assert tq == qn                           # one read of the codes


@pytest.mark.parametrize("qn,d,tile", [
    (256, 128, 256), (1024, 128, 256), (100, 128, 128), (40, 128, 64),
    (8, 128, 64), (256, 256, 256), (256, 384, 128), (256, 512, 128),
    (256, 640, 64), (256, 768, 64),
])
def test_k3_int8_query_tile_fits_and_is_no_wider_than_needed(qn, d, tile):
    tq = scoring._int8_tile(qn, d)
    assert tq == tile
    assert 128 + 2 * tq * d + 2 * scoring._int8_stage_bytes(d) <= SMEM
    assert tq == 64 or qn > tq // 2           # halved while it holds Q


@pytest.mark.parametrize("shape", sorted(K3_SHAPES))
def test_k3_int8_ring_keeps_eight_stages_with_the_scales(shape):
    """A stage carries its 64 rows' f32 scales beside their codes; at the
    served shapes the ring still holds its eight stages (the body's
    `int8_smem`: the tile, 128 bytes of barriers, the stages)."""
    (qn, n, d, buckets), _ = K3_SHAPES[shape]
    tq, _ = scoring._int8_plan(qn, n, d, buckets, SMS)
    assert scoring._int8_stage_bytes(d) == 64 * d + 64 * 4
    fixed = 128 + 2 * (tq // 2) * d * 2
    assert (SMEM - fixed) // scoring._int8_stage_bytes(d) >= 8


# K5's int8 body (`csrc/leaf_scoring.cu`, `leaf_scoring.int8_splits`):
# (tiles, query tile, buckets, cap, probes) -> S.
K5_SHAPES = {
    "100M": ((8, 32, 8192, 12_928, 1536), 2),
    "1M": ((16, 64, 1280, 1280, 256), 3),
}


@pytest.mark.parametrize("shape", sorted(K5_SHAPES))
def test_k5_int8_plan_walks_every_unit_once_in_even_blocks(shape):
    """Every (probe, group) unit of every bucket tile is walked once, in
    walk order, by blocks of about P / S units each (a bucket tile with
    two groups a leaf takes twice the splits), each within the probes a
    block stages."""
    (tiles, tile, buckets, cap, num_probes), want = K5_SHAPES[shape]
    splits = leaf_scoring.int8_splits(tiles, tile, buckets, cap,
                                      num_probes, SMS)
    assert splits == want
    groups = leaf_scoring.int8_tile_groups(cap, buckets)
    assert len(groups) == -(-buckets // 64)
    sizes = []
    for g in set(groups):
        ranges = leaf_scoring.int8_units(num_probes, g, splits)
        assert [u for lo, hi in ranges for u in range(lo, hi)] == \
            list(range(num_probes * g))
        sizes += [hi - lo for lo, hi in ranges]
        spans = [(hi - 1) // g - lo // g + 1 for lo, hi in ranges]
        assert max(spans) <= leaf_scoring._INT8_SPAN + 2
    assert max(sizes) - min(sizes) <= 1             # even blocks
    qblocks = -(-tile // leaf_scoring.int8_query_block(tile))
    blocks = tiles * qblocks * splits * sum(groups)
    assert blocks >= leaf_scoring._K5_BLOCKS_PER_SM * SMS or splits == 1
    assert leaf_scoring.int8_query_block(tile) == tile    # no empty rows
    if shape == "100M":
        assert groups.count(2) == 74 and groups.count(1) == 54


def _key_model(cand, cand_rows, probes, tile, walk, parts):
    """The int8 body's fold as plain PyTorch: each tile walks units (p,
    g) of its probes in `walk` order, cut into `parts` contiguous splits;
    each split keeps, per bucket, the best candidate with the lowest key
    p·G + g among equals, and the splits merge by the same rule. Returns
    ([Q, B] values, [Q, B] rows, -1 where no candidate beat MIN_FLOAT)."""
    q_n, c_n, buckets = cand.shape
    num_probes = probes.shape[1]
    groups = c_n // num_probes
    big = torch.iinfo(torch.int64).max
    vals = torch.full((q_n, buckets), leaf_scoring.MIN_FLOAT)
    keys = torch.full((q_n, buckets), big)
    for t in range(probes.shape[0]):
        rows_t = slice(t * tile, (t + 1) * tile)
        units = [int(p) * groups + g for p in walk[t] for g in range(groups)]
        cut = [len(units) * z // parts for z in range(parts + 1)]
        for lo, hi in zip(cut, cut[1:]):
            part = torch.tensor(units[lo:hi], dtype=torch.int64)
            if not len(part):
                continue
            v = cand[rows_t][:, part]                     # [T, u, B]
            best = v.amax(dim=1)
            k = torch.where(v == best[:, None], part[None, :, None],
                            big).amin(dim=1)
            # Merge the split into the running result by the same rule.
            better = (best > vals[rows_t]) | (
                (best == vals[rows_t]) & (k < keys[rows_t]))
            vals[rows_t] = torch.where(better, best, vals[rows_t])
            keys[rows_t] = torch.where(better, k, keys[rows_t])
    rows = torch.gather(cand_rows, 1, keys.clamp(max=c_n - 1)[:, None]
                        ).squeeze(1)
    return vals, torch.where(vals > leaf_scoring.MIN_FLOAT, rows, -1)


def _tie_heavy(seed):
    """Int8 leaves where leaves 0, 2, 4 hold the same codes and scales and
    each leaf's two groups repeat, so buckets tie across probes and
    groups; probes listed out of leaf order."""
    rng = np.random.default_rng(seed)
    num_leaves, cap, d, buckets, tiles, tile = 6, 384, 128, 256, 3, 8
    codes = rng.integers(-127, 128, (num_leaves, cap, d), dtype=np.int8)
    codes[:, buckets:] = codes[:, :cap - buckets]
    codes[2] = codes[4] = codes[0]
    scales = rng.uniform(0.01, 0.02, (num_leaves, cap)).astype(np.float32)
    scales[:, buckets:] = scales[:, :cap - buckets]
    scales[2] = scales[4] = scales[0]
    rows = rng.permutation(num_leaves * cap).reshape(num_leaves, cap)
    rows = rows.astype(np.int32)
    rows[5, -5:] = -1                                  # padding slots
    probes = np.array([[4, 1, 0, 2, 5], [3, 2, 0, 4, 1], [5, 0, 3, 2, 4]],
                      dtype=np.int32)
    queries = rng.normal(size=(tiles * tile, d)).astype(np.float32)
    return queries, codes, scales, rows, probes, buckets, tile


@pytest.mark.parametrize("walk", ["probe", "leaf"])
@pytest.mark.parametrize("parts", [1, 2, 3, 7])
def test_k5_order_key_over_splits_equals_the_fold(walk, parts):
    """The order-key fold over the kernel's walk (probe order), cut into
    any number of splits, equals the twin's first maximum in probe
    order: values and rows, ties included; so does it over a leaf-major
    walk, which the key makes as good a fold order."""
    queries, codes, scales, rows, probes, buckets, tile = _tie_heavy(0)
    args = [torch.from_numpy(a) for a in (queries, codes, scales, rows,
                                          probes)]
    cand, cand_rows = leaf_scoring.probed_bucket_candidates(
        *args, buckets, query_tile=tile)
    want_v, want_r = leaf_scoring.probed_bucketed_reference(
        *args, buckets, query_tile=tile)
    order = (torch.arange(args[-1].shape[1]).expand(args[-1].shape)
             if walk == "probe" else torch.argsort(args[-1], dim=1,
                                                   stable=True))
    got_v, got_r = _key_model(cand, cand_rows, args[-1], tile, order, parts)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_r, want_r)
    tied = (cand == want_v[:, None]).sum(dim=1) > 1
    assert tied.float().mean() > 0.5                 # the ties are there


def test_k5_order_key_holds_to_the_jax_kernel_on_ties():
    """The same model, split three ways, against the JAX package's Pallas K5
    (interpret mode) on the tie-heavy leaves: rows equal wherever the
    winner's value is clear of every other value by twice the tolerance,
    exact ties included, and scores within D·2⁻²³·Σ|q||c|·|s|."""
    queries, codes, scales, rows, probes, buckets, tile = _tie_heavy(1)
    j_vals, j_rows = jax_leaf.probed_bucketed_scores(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(scales),
        jnp.asarray(rows), jnp.asarray(probes), buckets, query_tile=tile,
        interpret=True)
    args = [torch.from_numpy(a) for a in (queries, codes, scales, rows,
                                          probes)]
    cand, cand_rows = leaf_scoring.probed_bucket_candidates(
        *args, buckets, query_tile=tile)
    got_v, got_r = _key_model(cand, cand_rows, args[-1], tile,
                              torch.arange(5).expand(args[-1].shape), 3)
    q_b = args[0].bfloat16().float().abs()
    deq = args[1].float().abs() * args[2][..., None]
    abs_cand, _ = leaf_scoring.probed_bucket_candidates(
        q_b, deq, None, args[3], args[4], buckets, query_tile=tile)
    tol = 128 * 2.0**-23 * abs_cand.amax(dim=1)
    j_vals = torch.from_numpy(np.array(j_vals))
    assert ((got_v - j_vals).abs() <= tol).all()
    runner = cand.masked_fill(cand == got_v[:, None],
                              leaf_scoring.MIN_FLOAT).amax(dim=1)
    clear = got_v - runner > 2 * tol
    assert clear.float().mean() > 0.9
    assert torch.equal(got_r[clear],
                       torch.from_numpy(np.array(j_rows))[clear])
