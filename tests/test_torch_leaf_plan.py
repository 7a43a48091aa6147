"""The plans of the probed leaf kernels (K4, K5), on the CPU.

K4 scores leaf-major: `leaf_scoring.leaf_groups` inverts the `[Q, P]`
probe list into blocks of at most `GROUP` (query, probe) pairs of one leaf,
with probes outside `[0, L)` in runs of their own, on a table of
⌈Q·P/GROUP⌉ + L rows that no host synchronisation sizes. K5 splits each
block's walk over its tile's probes into contiguous ranges
(`probe_splits`, as many as `bucketed_splits` picks) and merges their
partial (max, row) planes in order with strict `>`
(`merge_probe_splits_reference`, the merge kernel's twin), so the first
maximum in fold order still wins. Inputs are drawn with numpy from fixed
seeds; the merge must equal the unsplit twin exactly.
"""

import numpy as np
import pytest
import torch

from recommenders_tpu_torch.ops import leaf_scoring
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _probes(kind, q, p, num_leaves, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        probes = rng.integers(0, num_leaves, (q, p))
    elif kind == "skewed":
        # Most pairs on a few leaves: runs of hundreds of pairs.
        hot = rng.integers(0, num_leaves, 3)
        probes = np.where(rng.random((q, p)) < 0.8,
                          hot[rng.integers(0, 3, (q, p))],
                          rng.integers(0, num_leaves, (q, p)))
    else:  # duplicates and out-of-range ids mixed in
        probes = rng.integers(0, num_leaves, (q, p))
        probes[:, -1] = probes[:, 0]
        probes[rng.random((q, p)) < 0.1] = -1
        probes[rng.random((q, p)) < 0.05] = num_leaves + 3
    return torch.from_numpy(probes)


def group_table(bounds, last, block_leaf):
    """`[3, blocks]` (leaf, first position in `order`, pairs) of each K4
    block, decoded from `leaf_groups`' plan as the kernel decodes it
    (`group_of` in `csrc/leaf_scoring.cu`); 0 pairs past the live
    groups."""
    group = leaf_scoring.GROUP
    num_leaves = last.shape[0] - 1
    leaf = block_leaf.long().clamp(max=num_leaves)
    pairs = (bounds[1:] - bounds[:-1]).long()[leaf]
    j = (torch.arange(block_leaf.shape[0])
         - (last.long()[leaf] - (pairs + group - 1) // group))
    count = (pairs - j * group).clamp(0, group)
    count = torch.where(block_leaf > num_leaves, 0, count)
    return torch.stack([leaf, bounds.long()[leaf] + j * group, count])


@pytest.mark.parametrize("kind", ["uniform", "skewed", "mixed"])
@pytest.mark.parametrize("q,p,num_leaves", [
    (7, 5, 4), (128, 40, 2000), (256, 128, 16), (333, 9, 5), (1, 1, 1),
])
def test_leaf_groups_cover_every_pair_once(kind, q, p, num_leaves):
    group = leaf_scoring.GROUP
    probes = _probes(kind, q, p, num_leaves, seed=q + p)
    order, bounds, last, block_leaf = leaf_scoring.leaf_groups(
        probes, num_leaves)
    for t in (order, bounds, last, block_leaf):
        assert t.dtype == torch.int32
    assert block_leaf.shape == (-(-q * p // group) + num_leaves,)
    leaf, start, count = group_table(bounds, last, block_leaf)
    flat = probes.reshape(-1)
    outside = (flat < 0) | (flat >= num_leaves)
    seen = torch.zeros(q * p, dtype=torch.long)
    for b in range(block_leaf.shape[0]):
        c = int(count[b])
        assert 0 <= c <= group
        if c == 0:
            continue
        pairs = order[start[b]:start[b] + c].long()
        seen[pairs] += 1
        if int(leaf[b]) == num_leaves:
            assert outside[pairs].all()
        else:
            assert (flat[pairs] == leaf[b]).all()
    assert (seen == 1).all()
    # Live rows come first; the rest hold no pairs.
    live = int((count > 0).sum())
    assert (count[:live] > 0).all() and (count[live:] == 0).all()


def test_leaf_groups_split_a_crowded_leaf():
    probes = torch.full((300, 2), 3)
    probes[:, 1] = torch.arange(300) % 5
    leaf, _, count = group_table(
        *leaf_scoring.leaf_groups(probes, 5)[1:])
    crowded = count[leaf == 3]
    # 300 + 60 pairs on leaf 3: five full groups and one of 40.
    assert crowded[crowded > 0].tolist() == [64] * 5 + [40]


@pytest.mark.parametrize("num_probes,splits", [
    (256, 1), (256, 2), (256, 7), (15, 7), (5, 5), (1, 1), (10, 3)])
def test_probe_splits_are_contiguous_and_cover(num_probes, splits):
    ranges = leaf_scoring.probe_splits(num_probes, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == num_probes
    for (_, end), (begin, _) in zip(ranges[:-1], ranges[1:]):
        assert end == begin
    assert all(end > begin for begin, end in ranges)


@pytest.mark.parametrize("tiles,tile,buckets,num_probes,sms,want", [
    (16, 64, 1280, 256, 132, 3),    # the main path: 320 blocks
    (4, 64, 1280, 256, 132, 10),    # int4_bucketed_reorder: 80 blocks
    (4, 64, 1280, 3, 132, 3),       # at most one split a probe
    (200, 64, 4096, 256, 132, 1),   # the grid already fills the card
    (200, 64, 4096, 1000, 132, 4),  # at most 256 probes a split
    (1, 8, 256, 0, 132, 1),         # no probes: one split
])
def test_bucketed_splits_fill_the_card(tiles, tile, buckets, num_probes, sms,
                                       want):
    splits = leaf_scoring.bucketed_splits(tiles, tile, buckets, num_probes,
                                          sms)
    assert splits == want
    blocks = -(-buckets // 64) * tiles * -(-tile // 64)
    assert splits == num_probes or splits == 1 or (
        blocks * splits >= 6 * sms) or -(-num_probes // splits) == 256


def _leaf_case(fmt, num_leaves, cap, d, rng):
    embs = rng.standard_normal((num_leaves, cap, d)).astype(np.float32)
    rows = rng.permutation(num_leaves * cap).reshape(num_leaves, cap)
    rows[:, -2:] = -1
    rows = torch.from_numpy(rows.astype(np.int32))
    if fmt in ("f32", "bf16"):
        t = torch.from_numpy(embs)
        return (t if fmt == "f32" else t.bfloat16()), None, False, rows
    bits = 4 if fmt == "int4" else 8
    top = 2 ** (bits - 1) - 1
    scales = np.abs(embs).max(-1) / top + 1e-6
    codes = np.clip(np.round(embs / scales[..., None]), -top - 1, top)
    codes = torch.from_numpy(codes.astype(np.int8))
    if bits == 4:
        from recommenders_tpu_torch.ops import quantization
        codes = quantization.pack_nibbles(codes)
    return codes, torch.from_numpy(scales.astype(np.float32)), bits == 4, rows


@pytest.mark.parametrize("fmt", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("tie", [False, True])
def test_ordered_merge_of_split_partials_is_the_unsplit_fold(fmt, splits,
                                                             tie):
    """Each split's partials are the twin over its probe range; merged in
    order with strict `>` they equal the twin over all probes, rows too.
    With `tie`, every leaf holds the same codes and an earlier probe's
    leaf holds higher rows, so only the order keeps the first maximum."""
    rng = np.random.default_rng(7 + splits)
    num_leaves, cap, d, buckets, tile, tiles, p = 9, 20, 16, 8, 3, 2, 7
    leaves, scales, packed4, rows = _leaf_case(fmt, num_leaves, cap, d, rng)
    probes = torch.from_numpy(rng.integers(0, num_leaves, (tiles, p)))
    probes[0, 2] = probes[0, 1]                    # a repeated probe
    if tie:
        leaves = leaves[:1].expand_as(leaves).contiguous()
        if scales is not None:
            scales = scales[:1].expand_as(scales).contiguous()
        rows = torch.stack([(num_leaves - leaf) * cap
                            + torch.arange(cap, dtype=torch.int32)
                            for leaf in range(num_leaves)])
        probes = torch.sort(probes, dim=1).values  # higher rows first
    queries = torch.from_numpy(
        rng.standard_normal((tiles * tile, d)).astype(np.float32))
    parts = [leaf_scoring.probed_bucketed_reference(
        queries, leaves, scales, rows, probes[:, a:b], buckets,
        query_tile=tile, packed4=packed4)
        for a, b in leaf_scoring.probe_splits(p, splits)]
    vals, got_rows = leaf_scoring.merge_probe_splits_reference(
        torch.stack([v for v, _ in parts]), torch.stack([r for _, r in parts]))
    want_v, want_r = leaf_scoring.probed_bucketed_reference(
        queries, leaves, scales, rows, probes, buckets, query_tile=tile,
        packed4=packed4)
    assert torch.equal(vals, want_v)
    assert torch.equal(got_rows, want_r)
    if tie:
        # The first probe's leaf holds every winner.
        first = rows[probes[:, 0].long()].repeat_interleave(tile, dim=0)
        assert bool((got_rows[:, None, :] == first[:, :, None]).any(1)
                    .all())
