"""`kernel_ab.py scale`'s readings beside its times, on the CPU: the digest
of K3's outputs that tells two checkouts' answers apart, and K3's int8
launches by query tile and fast-fold counts, read where the package has
them and skipped where an older checkout has not."""

import types

import torch

from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.tools import kernel_ab
from torch_threads import torch_threads  # noqa: F401 (autouse)


def test_digest_is_equal_for_equal_outputs_and_not_for_a_flipped_bit():
    vals = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    rows = torch.arange(32, dtype=torch.int32).view(4, 8)
    flipped = vals.clone()
    flipped.view(torch.int32)[2, 3] ^= 1
    moved = rows.clone()
    moved[0, 0] = 1
    a = kernel_ab._digest("K3", lambda: (vals, rows))
    assert a == kernel_ab._digest("K3", lambda: (vals.clone(), rows.clone()))
    assert a != kernel_ab._digest("K3", lambda: (flipped, rows))
    assert a != kernel_ab._digest("K3", lambda: (vals, moved))


def test_counts_are_read_where_the_package_keeps_them():
    cs = types.SimpleNamespace(scoring=scoring)
    tiles = kernel_ab._int8_tiles(cs)
    assert sorted(tiles) == sorted(str(t) for t in scoring._INT8_TILES)
    calls = []

    def k3_fold_counts(reset=False):
        calls.append(("read", reset))
        return {"checked": 40, "updated": 4}

    cs.cuda_build = types.SimpleNamespace(k3_fold_counts=k3_fold_counts)
    got = kernel_ab._fold_counts(cs, "K3", lambda: calls.append("call"))
    assert got == {"checked": 40, "updated": 4}
    # Cleared, the one call, then read and cleared.
    assert calls == [("read", True), "call", ("read", True)]


def test_counts_are_none_for_a_package_without_them():
    cs = types.SimpleNamespace(
        scoring=types.SimpleNamespace(bucketed_scores=lambda: None),
        cuda_build=types.SimpleNamespace())
    assert kernel_ab._int8_tiles(cs) is None
    assert kernel_ab._fold_counts(cs, "K3", lambda: None) is None
