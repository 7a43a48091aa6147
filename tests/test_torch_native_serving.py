"""`recommenders_tpu_torch.utils.native_serving` and the C++ serving host
(`csrc/serving_host.cpp`) on the CPU.

The tensor container is the JAX package's byte for byte (its
`write_tensors`, `recommenders_tpu/utils/native_serving.py:56-87`), for
all eight dtype codes. The host is built with g++ against the installed
(CPU) wheel's libtorch, three exports are compiled with AOTInductor (a
`BruteForce`, a `Bucketed` and a bucketed `ScaNN`, whose search never
reads `leaf_ids` or `leaf_valid`: `torch.export` keeps them, and the host
passes every argument in order), and the host's outputs are held bit for
bit to the same package loaded in Python. Against the index itself the
package's scores agree to 1e-5 and its ids wherever a score stands apart
from its row neighbours (Inductor may sum the plain path's products in
another order). A CPU package runs the plain path; the CUDA path, with
the op library of K3, K4 and K5, runs on the card in `chip_smoke.py`
phase 35. The host test skips only where g++ is missing.
"""

import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from recommenders_tpu.utils import native_serving as jax_ns
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.utils import export as export_lib
from recommenders_tpu_torch.utils import native_serving as ns
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _arrays():
    rng = np.random.RandomState(0)
    return [
        rng.normal(size=(3, 4)).astype(np.float32),
        rng.randint(-9, 9, size=(5,)).astype(np.int32),
        rng.randint(-9, 9, size=(2, 2, 2)).astype(np.int64),
        rng.normal(size=(4, 3)).astype(ml_dtypes.bfloat16),
        rng.normal(size=(6,)).astype(np.float16),
        rng.randint(0, 2**32 - 1, size=(3,), dtype=np.uint64).astype(
            np.uint32),
        rng.rand(7) > 0.5,
        rng.randint(-128, 127, size=(2, 5)).astype(np.int8),
        np.float32(2.5).reshape(()),   # rank 0
        np.zeros((0, 4), np.float32),  # empty
    ]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_container_is_the_jax_hosts_byte_for_byte(tmp_path):
    arrays = _arrays()
    jax_ns.write_tensors(str(tmp_path / "jax.bin"), arrays)
    ns.write_tensors(str(tmp_path / "port.bin"), [_torch(a) for a in arrays])
    assert ((tmp_path / "jax.bin").read_bytes()
            == (tmp_path / "port.bin").read_bytes())
    # NumPy arrays go in as they are (bf16 only as a tensor: NumPy has
    # none of its own).
    ns.write_tensors(str(tmp_path / "np.bin"), [
        a if a.dtype != ml_dtypes.bfloat16 else _torch(a) for a in arrays])
    assert ((tmp_path / "np.bin").read_bytes()
            == (tmp_path / "jax.bin").read_bytes())


def test_container_round_trips_all_eight_dtypes(tmp_path):
    tensors = [_torch(a) for a in _arrays()]
    path = str(tmp_path / "t.bin")
    ns.write_tensors(path, tensors)
    back = ns.read_tensors(path)
    assert [t.dtype for t in back] == [t.dtype for t in tensors]
    for got, want in zip(back, tensors):
        # A scalar travels as [1], as the JAX writer sends it.
        want = want.reshape(1) if want.dim() == 0 else want
        assert got.shape == want.shape
        assert torch.equal(got, want)
    # And what the JAX host's reader reads back.
    for got, want in zip(jax_ns.read_tensors(path), _arrays()):
        np.testing.assert_array_equal(
            got.view(np.uint16) if got.dtype == ml_dtypes.bfloat16 else got,
            want.view(np.uint16) if want.dtype == ml_dtypes.bfloat16
            else want)
    with pytest.raises(ValueError, match="not supported"):
        ns.write_tensors(path, [torch.zeros(2, dtype=torch.complex64)])


def test_host_runs_exported_packages_bit_equal_to_python(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the host builds with it")
    rng = np.random.RandomState(3)
    corpus = torch.from_numpy(rng.normal(size=(3000, 128)).astype(np.float32))
    queries = torch.from_numpy(rng.normal(size=(16, 128)).astype(np.float32))
    indexes = {
        "brute": factorized_top_k.BruteForce(k=10, device="cpu").index(
            corpus, torch.arange(3000) * 3),
        "bucketed": factorized_top_k.Bucketed(
            k=10, buckets=512, chunk=1024, quantize="int8",
            device="cpu").index(corpus),
        "scann": approximate.ScaNN(
            k=10, num_leaves=16, num_leaves_to_search=4, quantize="int8",
            scoring_buckets=256, probe_tile=8, device="cpu").index(corpus),
    }
    binary = ns.build_host(cuda=False)
    assert ns.host_available()   # the CPU wheel's host needs no op library
    info = ns.subprocess.run([str(binary), "info"], capture_output=True,
                             text=True, check=True).stdout
    assert f"torch: {torch.__version__.split('+')[0]}" in info
    for name, index in indexes.items():
        path = str(tmp_path / name)
        export_lib.export_index(path, index, queries, k=10)
        assert not export_lib.read_manifest(path)["ops"]
        result = ns.serve_exported_index(path, queries, repeat=3)
        package = ns.load_package(path)
        want = package(queries, *ns.host_arguments(path))
        assert len(result.outputs) == 2
        for got, ref in zip(result.outputs, want):
            assert got.dtype == ref.dtype and torch.equal(got, ref), name
        # Inductor may sum the plain path's products in another order:
        # scores within 1e-5, ids equal wherever the eager score is apart
        # from its neighbours in the row by more than that.
        scores, ids = index(queries)
        torch.testing.assert_close(result.outputs[0], scores, rtol=1e-5,
                                   atol=1e-5)
        gaps = scores[:, :-1] - scores[:, 1:]
        apart = torch.ones_like(scores, dtype=torch.bool)
        apart[:, :-1] &= gaps > 1e-4
        apart[:, 1:] &= gaps > 1e-4
        assert apart.float().mean() > 0.9
        assert torch.equal(result.outputs[1][apart], ids[apart]), name
        assert result.load_ms is not None and result.load_ms > 0
        assert result.repeat_stats["n"] == 3
        assert result.launches is None   # no op library on the CPU
    names = export_lib.read_manifest(str(tmp_path / "scann"))["arguments"]
    assert "leaf_ids" in names and "leaf_valid" in names
    # Rotating query variants: the last run's is the output.
    path = str(tmp_path / "bucketed")
    variants = torch.stack([queries, queries.flip(0)])
    result = ns.serve_exported_index(path, variants, repeat=2, pipeline=True)
    assert result.pipeline_stats["n"] == 2
    want = ns.load_package(path)(queries.flip(0), *ns.host_arguments(path))
    assert torch.equal(result.outputs[1], want[1])
