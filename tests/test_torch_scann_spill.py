"""The ScaNN build's spill regime at the smoke's proportions, both packages.

`chip_smoke.py` serves ScaNN over a clustered corpus of 1M rows from 1,024
centres with 1,024 leaves, so a leaf holds ~977 rows on average and
`_capacity` gives it 1,280 slots. Rows that find no room in their
`spill_rounds` nearest leaves go to the global pool of free slots, far
from their queries, and recall falls with their share. This checks that
the JAX package and the port land in the same regime: the recipe is cut
by `SCALE` in rows, centres and leaves alike (the same rows per centre
and per leaf, the same capacity, probe share and settings as the smoke's
main path, `int8_bucketed`), both packages build from the same NumPy
corpus and seed on the CPU, and their share of rows within their nearest
leaves and their recall@100 must agree.

Tolerances: near-leaf shares within 0.01 and recall@100 within 0.02.
Lloyd's sums in another order move near-ties between leaves, and each
such move shifts the packing of every later row of that leaf.

Run as a script for another cut, e.g. half of the smoke's corpus:

    JAX_PLATFORMS=cpu python tests/test_torch_scann_spill.py --scale 2
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from recommenders_tpu.layers import approximate as jax_approx  # noqa: E402
from recommenders_tpu_torch.layers import approximate  # noqa: E402

# 125,000 rows, 128 leaves: ~10 % of the rows spill (the smoke: ~18 %).
SCALE = 8
QUERIES = 256


def spill_regime(scale: int, queries: int, seed: int = 0) -> dict:
    """Builds the main path's index with both packages over the smoke's
    corpus cut by `scale`; returns each one's near-leaf share and
    recall@100 on `queries` queries, and their leaf agreement."""
    full = chip_smoke.ScannSize()
    size = dataclasses.replace(
        full, items=full.items // scale, centers=full.centers // scale,
        leaves=full.leaves // scale, batch=queries, requests=1)
    settings = chip_smoke.scann_configs(size)[chip_smoke.MAIN_INDEX][0]
    corpus, (q,) = chip_smoke.clustered_data(size, seed)
    exact = torch.from_numpy(
        np.argsort(-(q @ corpus.T), axis=1, kind="stable")[:, :chip_smoke.K])
    corpus_t = torch.from_numpy(corpus)

    jax_index = jax_approx.ScaNN(k=chip_smoke.K, seed=seed, **settings).index(
        jnp.asarray(corpus))
    port = approximate.ScaNN(k=chip_smoke.K, seed=seed, device="cpu",
                             **settings).index(corpus_t)
    jax_rows = torch.from_numpy(np.array(jax_index._leaf_rows))
    jax_centroids = torch.from_numpy(np.array(jax_index._centroids))
    rounds = port._spill_rounds
    n, cap = corpus.shape[0], jax_rows.shape[1]
    jax_leaf = chip_smoke.slot_of_rows(jax_rows, n) // cap
    port_leaf = chip_smoke.slot_of_rows(port._leaf_rows, n) // cap
    return {
        "items": n, "leaves": size.leaves, "cap": cap, "queries": queries,
        "spill_rounds": rounds,
        "jax_near": chip_smoke.near_share(jax_rows, jax_centroids, corpus_t,
                                          rounds),
        "port_near": chip_smoke.near_share(port._leaf_rows, port._centroids,
                                           corpus_t, rounds),
        "jax_recall": chip_smoke.recall(
            torch.from_numpy(np.array(jax_index(jnp.asarray(q))[1])),
            exact),
        "port_recall": chip_smoke.recall(port(torch.from_numpy(q))[1], exact),
        "same_leaf": float((jax_leaf == port_leaf).float().mean()),
    }


def test_port_build_lands_in_the_jax_spill_regime():
    got = spill_regime(SCALE, QUERIES)
    assert got["cap"] == 1280
    # The cut keeps the regime: rows do spill out of their nearest leaves.
    assert got["jax_near"] < 0.95, got
    assert abs(got["port_near"] - got["jax_near"]) <= 0.01, got
    assert abs(got["port_recall"] - got["jax_recall"]) <= 0.02, got


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scale", type=int, default=SCALE)
    parser.add_argument("--queries", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(spill_regime(args.scale, args.queries, args.seed)))
