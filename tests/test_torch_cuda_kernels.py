"""The CUDA kernel against its plain twin, on the card.

Marked `cuda`; each test skips when `torch.cuda.is_available()` is
false (decided inside the test, never at import). This file imports
only torch and the port, so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Tolerance: the kernel and the twin take the same products in f32 in a
different order, so scores agree to |Δ| ≤ D·2⁻²³·Σ|q||c| of each winner
(the a-priori bound of an f32 sum), and ids are equal wherever the
twin's bucket winner beats its runner-up by more than twice that.
"""

import pytest
import torch

from recommenders_tpu_torch.ops import quantization
from recommenders_tpu_torch.ops import scoring

pytestmark = pytest.mark.cuda

FORMATS = ("f32", "bf16", "int8", "int4")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(fmt, q, n, d, device):
    g = torch.Generator(device=device).manual_seed(0)
    queries = torch.randn(q, d, device=device, generator=g)
    corpus = torch.randn(n, d, device=device, generator=g)
    if fmt == "f32":
        return queries, corpus, None, False, corpus
    if fmt == "bf16":
        return (queries.bfloat16(), corpus.bfloat16(), None, False,
                corpus.bfloat16().float())
    bits = 4 if fmt == "int4" else 8
    scales, codes = quantization.quantize_rows_device(corpus, 0.2, bits=bits)
    deq = codes.float() * scales[:, None]
    if bits == 4:
        codes = quantization.pack_nibbles(codes)
    return queries, codes, scales, bits == 4, deq


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("q,n,buckets,valid", [
    (40, 8192, 256, 8000), (64, 4096, 512, 4096), (8, 1024, 1024, 300),
])
def test_kernel_matches_twin(device, fmt, q, n, buckets, valid):
    queries, stored, scales, packed4, deq = _inputs(fmt, q, n, 128, device)
    chunk = buckets
    if packed4:  # int4 needs the buckets to divide chunk/2.
        buckets = min(buckets, n // 2)
        chunk = 2 * buckets
    before = scoring.bucketed_scores.launches
    vals, rows = scoring.bucketed_scores(
        queries, stored, scales, buckets=buckets, chunk=chunk,
        query_tile=q, valid_rows=valid, packed4=packed4,
    )
    torch.cuda.synchronize()
    assert scoring.bucketed_scores.launches == before + 1
    ref_v, ref_r = scoring.bucketed_scores_reference(
        queries, stored, scales, buckets=buckets, valid_rows=valid,
        packed4=packed4,
    )
    qf = queries.float()
    if scales is not None:
        qf = queries.bfloat16().float()
    abs_dot = (qf.abs()[:, None, :] * deq.abs()[ref_r.long()]).sum(-1)
    tol = 128 * 2.0**-23 * abs_dot + 1e-30
    assert ((vals - ref_v).abs() <= tol).all()
    scores = (qf @ deq.T).masked_fill(
        torch.arange(n, device=device) >= valid, scoring.MIN_FLOAT
    ).view(q, n // buckets, buckets)
    top2 = scores.topk(min(2, n // buckets), dim=1).values
    separated = (top2[:, 0] - top2[:, -1] > 2 * tol) | (n // buckets == 1)
    live = torch.arange(buckets, device=device) < valid
    separated &= live
    assert separated.sum() >= 0.9 * live.sum()
    assert (rows[separated] == ref_r[separated]).all()


def test_kernel_refuses_bad_inputs(device):
    queries, stored, _, _, _ = _inputs("f32", 8, 1024, 128, device)
    with pytest.raises(TypeError, match="share a dtype"):
        scoring.bucketed_scores(queries.bfloat16(), stored, buckets=256,
                                chunk=1024)
    with pytest.raises(ValueError, match="contiguous"):
        scoring.bucketed_scores(queries, stored.T.contiguous().T,
                                buckets=256, chunk=1024)
