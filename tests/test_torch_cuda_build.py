"""The port's kernel build digest and the launch plans of its tensor-core
kernels, on the CPU (no `nvcc` and no card needed: these are the parts of
the build and the launch decided in Python)."""

import shutil

import pytest
import torch

from recommenders_tpu_torch.ops import cuda_build
from recommenders_tpu_torch.ops import fused_retrieval
from recommenders_tpu_torch.ops import scoring
from torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    monkeypatch.setattr(cuda_build, "CSRC", copy)
    return copy


def test_every_source_exists_and_paths_differ():
    paths = {cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert len(paths) == len(cuda_build.SOURCES)
    for name in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cu").is_file()


@pytest.mark.parametrize("name", cuda_build.SOURCES)
def test_edited_header_changes_every_library_path(csrc_copy, name):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert headers, "the tensor-core kernels share a header"
    before = cuda_build.library_path(name)
    assert cuda_build.library_path(name) == before   # stable
    with open(headers[0], "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.library_path(name) != before


def test_edited_source_changes_only_its_own_path(csrc_copy):
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    with open(csrc_copy / "bucketed_scores.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    for name in cuda_build.SOURCES:
        assert (after[name] != before[name]) == (name == "bucketed_scores")


@pytest.mark.parametrize("own,loop,parts", [
    (4096, 4096, 5),     # bench.py's step: 64 row tiles, 320 blocks
    (100, 333, 6),       # 2 row tiles; the loop's 6 tiles cap the parts
    (64, 64, 1),         # one loop tile: no split
    (40000, 4096, 1),    # enough row tiles alone
])
def test_fused_retrieval_parts_fill_the_card(own, loop, parts):
    assert fused_retrieval._parts(own, loop, 132) == parts
    blocks = -(-own // 64)
    assert parts <= -(-loop // 64)
    assert blocks * parts >= 2 * 132 or parts == -(-loop // 64)


@pytest.mark.parametrize("own,loop,per_sm,parts", [
    (4096, 4096, 3, 6),  # the multitask step at D = 64: 384 blocks
    (129, 4099, 3, 65),  # 3 row tiles; the loop's 65 tiles cap the parts
    (4099, 129, 2, 3),   # dc of that shape: 65 row tiles, 3 loop tiles
    (4096, 4096, 1, 2),  # one block an SM (D = 256)
    (64, 64, 3, 1),      # one loop tile: no split
    (40000, 4096, 3, 1),  # more row tiles than one wave holds
])
def test_fused_retrieval_f32_parts_fill_one_wave(own, loop, per_sm, parts):
    """The f32 kernels' parts: as many as one wave of the blocks an SM
    holds, never more (a partial second wave costs a whole block)."""
    assert fused_retrieval._parts(own, loop, 132, per_sm) == parts
    blocks = -(-own // 64)
    assert blocks * parts <= per_sm * 132 or parts == 1
    assert (parts == -(-loop // 64)
            or blocks * (parts + 1) > per_sm * 132)


@pytest.mark.parametrize("qn,n,d,buckets,plan", [
    (1024, 1 << 20, 128, 4096, (128, 1)),    # bf16 / int8: 512 blocks
    (1024, 1 << 20, 128, 2048, (128, 2)),    # int4: 256 blocks, split in 2
    (1024, 65536, 128, 2048, (128, 2)),      # the GPU tests' split case
    (8, 1024, 128, 512, (128, 2)),           # 2 groups cap the split
    (64, 8192, 768, 256, (64, 32)),          # wide D: 64-query tiles
])
def test_bucketed_plan_fills_the_card(qn, n, d, buckets, plan):
    tq, splits = scoring._tc_plan(qn, n, d, buckets, 132)
    assert (tq, splits) == plan
    blocks = -(-buckets // 64) * -(-qn // tq)
    assert splits <= n // buckets
    assert blocks * splits >= 264 or splits == n // buckets


@pytest.mark.parametrize("qn,n,d,buckets,plan", [
    (1024, 1_001_472, 128, 2048, (128, 1)),  # the serving smoke: 256 blocks
    (40, 8192, 128, 256, (128, 32)),         # 4 blocks; 32 groups cap it
    (48, 4096, 384, 256, (64, 16)),          # 64-query tiles to D = 384
    (70, 4096, 640, 256, (32, 11)),          # 32-query tiles from D = 512
    (40, 2048, 768, 128, (32, 16)),          # the widest D
])
def test_f32_plan_fills_the_card_one_block_an_sm(qn, n, d, buckets, plan):
    tq, splits = scoring._tc_plan(qn, n, d, buckets, 132, f32=True)
    assert (tq, splits) == plan
    blocks = -(-buckets // 64) * -(-qn // tq)
    assert splits <= n // buckets
    assert blocks * splits >= 132 or splits == n // buckets


@pytest.mark.parametrize("d", [128, 256, 384, 512, 640, 768])
def test_f32_query_tile_is_the_largest_that_fits(d):
    """Three bf16 query planes [TQ][D + 8] and the two-slab f32 ring fit
    the 227 KB a block may take; twice the tile would not."""
    tq, _ = scoring._tc_plan(64, 4096, d, 256, 132, f32=True)
    smem = lambda t: 6 * t * (d + 8) + 2 * 64 * 136 * 4
    assert smem(tq) <= 232_448
    assert tq == 128 or smem(2 * tq) > 232_448
    assert tq == {128: 128, 256: 64, 384: 64}.get(d, 32)


def test_op_library_path_follows_its_source_and_the_kernels(csrc_copy):
    """The op library's digest covers `torch_ops.cpp` and the libraries
    it links: an edited kernel rebuilds it, an unrelated one does not."""
    before = cuda_build.torch_ops_path()
    assert cuda_build.torch_ops_path() == before
    with open(csrc_copy / "sparse_apply.cu", "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.torch_ops_path() == before
    with open(csrc_copy / "leaf_scoring.cu", "a") as f:
        f.write("\n// edited\n")
    after_kernel = cuda_build.torch_ops_path()
    assert after_kernel != before
    with open(csrc_copy / "torch_ops.cpp", "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.torch_ops_path() not in (before, after_kernel)


def test_the_pooled_op_library_follows_its_own_sources(csrc_copy):
    """The pooled lookup's op library is the serving ops' neighbour, not
    part of them: its digest covers `pooled_ops.cpp` and
    `pooled_lookup.cu`, and an edit to either leaves `torch_ops`
    alone (an index server loads nothing new)."""
    serving, pooled = cuda_build.torch_ops_path(), cuda_build.pooled_ops_path()
    assert pooled.name.startswith("libpooled_ops-") and pooled != serving
    with open(csrc_copy / "pooled_lookup.cu", "a") as f:
        f.write("\n// edited\n")
    after_kernel = cuda_build.pooled_ops_path()
    assert after_kernel != pooled
    with open(csrc_copy / "pooled_ops.cpp", "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.pooled_ops_path() not in (pooled, after_kernel)
    assert cuda_build.torch_ops_path() == serving


def test_fake_impls_give_the_ops_output_shapes():
    """What `torch.export` traces in place of a launch: the outputs'
    shapes and dtypes, on the inputs' device."""
    from recommenders_tpu_torch.ops import leaf_scoring

    meta = torch.device("meta")
    q = torch.empty((256, 128), device=meta)
    empty = torch.empty((0,), device=meta)
    vals, rows = scoring._bucketed_scores_fake(
        q.bfloat16(), torch.empty((4096, 128), dtype=torch.int8,
                                  device=meta),
        empty, 1, 512, 4000, 128, 2, scoring.MIN_FLOAT)
    assert vals.shape == rows.shape == (256, 512)
    assert (vals.dtype, rows.dtype) == (torch.float32, torch.int32)
    assert vals.device == meta
    out = leaf_scoring._leaf_fake(q, None, empty, None, None, None, None,
                                  2, 8, 1280, leaf_scoring.MIN_FLOAT)
    assert out.shape == (256, 8 * 1280) and out.dtype == torch.float32
    vals, rows = leaf_scoring._bucketed_fake(
        q, None, empty, None, torch.empty((4, 16), device=meta), 2, 64,
        1280, 1024, 3, leaf_scoring.MIN_FLOAT)
    assert vals.shape == rows.shape == (256, 1024)
    assert rows.dtype == torch.int32


def test_compiler_wrapper_drops_only_the_openmp_flags(tmp_path):
    """For a g++ installed without libgomp, AOTInductor builds through a
    wrapper that drops `-fopenmp` and `-lgomp` and passes every other
    argument through unchanged."""
    import subprocess

    from recommenders_tpu_torch.utils import native_serving

    wrapper = tmp_path / "g++"
    wrapper.write_text(native_serving._NO_OPENMP.format(gxx="/bin/echo"))
    wrapper.chmod(0o755)
    out = subprocess.run([str(wrapper), "-O3", "-fopenmp", "a b.cpp",
                          "-lgomp", "-ltorch"], capture_output=True,
                         text=True, check=True).stdout
    assert out.split() == ["-O3", "a", "b.cpp", "-ltorch"]
