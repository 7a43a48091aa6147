"""The numerics of K4's and K5's f32 bodies, on the CPU: their
split-precision model.

The CUDA bodies (`csrc/leaf_scoring.cu`) split each f32 query and leaf
value into three bf16 terms, x = h + m + l (`tc::split3`), and sum six of
the nine term products (hh, hm, mh, hl, lh, mm), each exact in f32, on the
tensor cores, as K3's f32 body does (tests/test_torch_split_precision.py,
whose adversarial kinds are taken here). `ops/scoring.py` models that
split (`split_scores`, `split_error_bound`). Against float64, at D = 128
and 512:

  - K4's probe-major scores, modelled query by query over the rows of its
    probed leaves, stay within `split_error_bound` of a float64 dot;
  - K5's fold of the modelled scores into buckets (probe-major, groups of
    B slots with a partial tail group, padding never winning, the first
    maximum kept) agrees with the f32 twin's fold as the card holds the
    kernel to it: values within D·2⁻²³·Σ|q||c| + 2ε|want| of the twin's
    winner, rows equal wherever the twin's winner beats the bucket's best
    other row by twice that;
  - the bound plus the twins' own f32 error fits that tolerance (plus
    1e-30, the GPU tests' absolute term).

The port's f32 twins are also held against the JAX package's kernels (its
Pallas kernels in interpret mode) on one such input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from recommenders_tpu.ops import leaf_scoring as jax_leaf
from recommenders_tpu_torch.ops import leaf_scoring
from recommenders_tpu_torch.ops import scoring
from test_torch_split_precision import ABS_TOL, KINDS, _problem
from torch_threads import torch_threads  # noqa: F401 (autouse)

F32_EPS = 2.0 ** -23
NUM_LEAVES, CAP, NUM_PROBES = 4, 48, 3
# K5: two tiles of 4 queries; 48 slots a leaf make groups of 20, 20 and a
# tail of 8.
TILE, BUCKETS = 4, 20


def _case(kind, d, seed=0, q=8, cap=CAP):
    """Queries, leaves `[L, cap, D]`, K4's probes `[Q, P]` (a repeated
    probe in row 0), K5's tile probes `[Q / TILE, P]` (sorted; the last
    tile probes one leaf P times) and the leaves' global rows (padding at
    every leaf's end; the last tile's leaf empty, so its buckets are)."""
    queries, corpus = _problem(kind, d, seed=seed, q=q, n=NUM_LEAVES * cap)
    leaves = corpus.view(NUM_LEAVES, cap, d)
    rng = np.random.default_rng(seed + 1)
    probes = rng.integers(0, NUM_LEAVES, (q, NUM_PROBES))
    probes[0, 1] = probes[0, 0]
    tile_probes = np.sort(probes[:q // TILE], axis=1)
    tile_probes[-1] = tile_probes[-1, 0]
    rows = rng.permutation(NUM_LEAVES * cap).reshape(NUM_LEAVES, cap)
    rows[:, -3:] = -1
    rows[tile_probes[-1, 0]] = -1
    return (queries, leaves, torch.from_numpy(probes).to(torch.int32),
            torch.from_numpy(tile_probes).to(torch.int32),
            torch.from_numpy(rows).to(torch.int32))


def _probed(fn, queries, leaves, probes):
    """`fn(queries [T, D], rows [P·cap, D])` for each row of `probes` (a
    query's or a tile's probed leaves), stacked: `[Q, P·cap]`."""
    d = queries.shape[1]
    per = queries.shape[0] // probes.shape[0]
    return torch.cat([
        fn(queries[i * per:(i + 1) * per],
           leaves[probes[i].long()].reshape(-1, d))
        for i in range(probes.shape[0])])


def _exact(q, c):
    return q.double() @ c.double().T


def _abs_dot(q, c):
    return q.double().abs() @ c.double().abs().T


def _tolerance(d, abs_dot, want):
    """The card's tolerance for K4 and K5 (`chip_smoke.check_k4` /
    `check_k5`), plus the GPU tests' absolute term."""
    return d * F32_EPS * abs_dot + 2 * F32_EPS * want.abs() + ABS_TOL


def _fold(scores, rows, probes, tile, buckets):
    """K5's fold of `[Q, P·cap]` scores of each tile's queries against its
    probes' slots, as the kernel folds: padding masked, slot s of each
    probed leaf into bucket s % B, probe-major then groups, the first
    maximum kept. Returns `([Q, B] values, [Q, B] rows)`; an empty
    bucket holds -inf / -1."""
    q = scores.shape[0]
    cap = rows.shape[1]
    slot_rows = rows[probes.long()].repeat_interleave(tile, dim=0)
    s = scores.view(q, -1, cap).masked_fill(slot_rows < 0, -np.inf)
    pad = (-cap) % buckets
    s = F.pad(s, (0, pad), value=-np.inf).reshape(q, -1, buckets)
    r = F.pad(slot_rows, (0, pad), value=-1).reshape(q, -1, buckets)
    vals, best = s.max(dim=1)          # the first maximum
    won = torch.gather(r, 1, best[:, None]).squeeze(1)
    return vals, torch.where(vals == -np.inf, -1, won)


def _assert_buckets_match(got_v, got_r, want_v, want_r, queries, leaves,
                          rows, probes, tile, buckets):
    """`got` against the f32 twin's fold `want`, as the card holds K5:
    empty buckets agree, values within the tolerance at the twin's
    winner, rows equal wherever that winner is separated from the bucket's
    best other row by twice it (at least 0.9 of the buckets)."""
    d = queries.shape[1]
    cand, cand_rows = leaf_scoring.probed_bucket_candidates(
        queries, leaves, None, rows, probes, buckets, tile)
    abs_cand, _ = leaf_scoring.probed_bucket_candidates(
        queries.abs(), leaves.abs(), None, rows, probes, buckets, tile)
    best = cand.argmax(dim=1, keepdim=True)
    abs_dot = torch.gather(abs_cand, 1, best).squeeze(1).double()
    tol = _tolerance(d, abs_dot, want_v.double())
    empty = want_v <= leaf_scoring.MIN_FLOAT
    assert bool(empty.any()) and bool((~empty).any())
    assert (got_r[empty] == -1).all() and (want_r[empty] == -1).all()
    err = (got_v.double() - want_v.double()).abs()
    assert (err[~empty] <= tol[~empty]).all()
    win_row = torch.gather(cand_rows, 1, best)
    runner_up = cand.masked_fill(cand_rows == win_row, leaf_scoring.MIN_FLOAT
                                 ).amax(dim=1).double()
    separated = (want_v.double() - runner_up > 2 * tol) & ~empty
    assert separated.sum() >= 0.9 * (~empty).sum()
    assert torch.equal(got_r[separated].long(), want_r[separated].long())


@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_k4_split_scores_within_their_bound_of_a_float64_dot(kind, d):
    queries, leaves, probes, _, _ = _case(kind, d)
    exact = _probed(_exact, queries, leaves, probes)
    got = _probed(scoring.split_scores, queries, leaves, probes)
    bound = _probed(scoring.split_error_bound, queries, leaves, probes)
    # float64's own rounding of both sums, far below the bound.
    slack = 2 * d * 2.0**-53 * _probed(_abs_dot, queries, leaves, probes)
    err = (got - exact).abs()
    assert got.shape == (8, NUM_PROBES * CAP)
    assert (err <= bound + slack).all()
    if kind == "residues":
        # One-signed dropped terms: the bound is reached within 4x.
        assert float((err / bound).max()) > 0.25


@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_k4_split_and_twin_errors_fit_the_cards_tolerance(kind, d):
    """The split's bound plus the f32 twin's own error (γ_D·Σ|q||c|) stay
    inside the tolerance K4 is held to, and so does the model against
    the twin, at every probed slot."""
    queries, leaves, probes, _, _ = _case(kind, d)
    exact = _probed(_exact, queries, leaves, probes)
    abs_dot = _probed(_abs_dot, queries, leaves, probes)
    twin = leaf_scoring.probed_scores_reference(queries, leaves, None,
                                                probes).double()
    assert bool(torch.isfinite(twin).all())
    twin_err = (twin - exact).abs()
    assert (twin_err <= d * 2.0**-24 * abs_dot + ABS_TOL).all()
    tol = _tolerance(d, abs_dot, twin)
    bound = _probed(scoring.split_error_bound, queries, leaves, probes)
    assert (bound + twin_err <= tol).all()
    split = _probed(scoring.split_scores, queries, leaves, probes)
    assert ((split - twin).abs() <= tol).all()


@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_k5_split_fold_matches_the_twins_fold(kind, d):
    """The fold of the split model against the f32 twin's fold
    (`probed_bucketed_reference`), and the split's bound plus the twin's
    error inside the tolerance at every live candidate of a tile."""
    queries, leaves, _, probes, rows = _case(kind, d)
    split = _probed(scoring.split_scores, queries, leaves, probes)
    got_v, got_r = _fold(split, rows, probes, TILE, BUCKETS)
    want_v, want_r = leaf_scoring.probed_bucketed_reference(
        queries, leaves, None, rows, probes, BUCKETS, query_tile=TILE)
    empty = want_v <= leaf_scoring.MIN_FLOAT
    assert (got_v[empty] == -np.inf).all()
    _assert_buckets_match(got_v, got_r, want_v, want_r, queries, leaves,
                          rows, probes, TILE, BUCKETS)

    exact = _probed(_exact, queries, leaves, probes)
    abs_dot = _probed(_abs_dot, queries, leaves, probes)
    each = probes.repeat_interleave(TILE, dim=0)   # a tile's probes a query
    twin = leaf_scoring.probed_scores_reference(queries, leaves, None,
                                                each).double()
    live = (rows[each.long()] >= 0).reshape(twin.shape)
    bound = _probed(scoring.split_error_bound, queries, leaves, probes)
    fits = bound + (twin - exact).abs() <= _tolerance(d, abs_dot, twin)
    assert fits[live].all()


def test_f32_twins_match_the_jax_kernels_on_adversarial_inputs():
    """The port's f32 twins (the wrappers on the CPU) against the JAX
    package's K4 and K5 (Pallas, interpret mode) on `residues` values,
    whose dropped split terms add up: K4 within the tolerance at every
    slot, K5's buckets as the card holds them."""
    d, cap, buckets, tile = 128, 256, 128, TILE
    queries, leaves, probes, tile_probes, rows = _case(
        "residues", d, seed=3, q=16, cap=cap)
    got = leaf_scoring.probed_leaf_scores(queries, leaves, None, probes)
    kernel = torch.from_numpy(np.array(jax_leaf.probed_leaf_scores(
        jnp.asarray(queries.numpy()), jnp.asarray(leaves.numpy()), None,
        jnp.asarray(probes.numpy()), interpret=True)))
    abs_dot = _probed(_abs_dot, queries, leaves, probes)
    tol = _tolerance(d, abs_dot, kernel.double())
    assert got.shape == kernel.shape == (16, NUM_PROBES * cap)
    assert ((got.double() - kernel.double()).abs() <= tol).all()

    got_v, got_r = leaf_scoring.probed_bucketed_scores(
        queries, leaves, None, rows, tile_probes, buckets, query_tile=tile)
    want_v, want_r = (torch.from_numpy(np.array(x)) for x in
                      jax_leaf.probed_bucketed_scores(
                          jnp.asarray(queries.numpy()),
                          jnp.asarray(leaves.numpy()), None,
                          jnp.asarray(rows.numpy()),
                          jnp.asarray(tile_probes.numpy()), buckets,
                          query_tile=tile, interpret=True))
    _assert_buckets_match(got_v, got_r, want_v, want_r, queries, leaves,
                          rows, tile_probes, tile, buckets)
