"""The probe's copy step (`csrc/copy_chain.cu`) against its twin, on the
card.

Marked `cuda`; each test skips when `torch.cuda.is_available()` is false
(decided inside the test, never at import). Imports only torch and the
port:

    python -m pytest tests/test_torch_cuda_copy_chain.py -q --noconftest

Tolerance: none, the kernel must give the twin's bits.
"""

import pytest
import torch

from recommenders_tpu_torch.ops import copy_chain
from torch_threads import torch_threads  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _pair(rows, dim, dtype, device):
    g = torch.Generator(device=device).manual_seed(rows * 131 + dim)
    scale = 10.0 ** torch.randint(-9, 1, (2, rows, dim), device=device,
                                  generator=g)
    values = torch.randn(2, rows, dim, device=device, generator=g) * scale
    return values[0].to(dtype).contiguous(), values[1].contiguous()


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (3, 5), (64, 64),
                                   (1000, 33), (4097, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["in_place", "out_of_place", "unaligned"])
def test_copy_step_gives_the_twins_bits(device, shape, dtype, where):
    table, accum = _pair(*shape, dtype, device)
    want = copy_chain.copy_step_reference(
        table, accum, out=(torch.empty_like(table), torch.empty_like(accum)))
    src = (table.clone(), accum.clone())
    if where == "in_place":
        out = None
    elif where == "out_of_place":
        out = (torch.empty_like(table), torch.empty_like(accum))
    else:   # views that start one value past a 16-byte boundary
        out = tuple(torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
                    [1:].view(x.shape) for x in src)
    before = copy_chain.copy_step.launches
    got = copy_chain.copy_step(*src, out=out)
    torch.cuda.synchronize(device)
    assert copy_chain.copy_step.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if out is not None:
        assert torch.equal(src[0], table) and torch.equal(src[1], accum)


def test_copy_step_raises_on_mixed_devices_and_skips_empty(device):
    table = torch.zeros(4, 4, device=device)
    with pytest.raises(ValueError):
        copy_chain.copy_step(table, torch.zeros(4, 4))
    before = copy_chain.copy_step.launches
    empty = torch.zeros(0, 4, device=device)
    copy_chain.copy_step(empty, empty.clone())
    assert copy_chain.copy_step.launches == before
