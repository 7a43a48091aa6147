"""A streaming copy step over an embedding table and its accumulator.

Port of the one Pallas kernel outside the JAX package:
`benchmarks/_alias_probe.py`'s `copy_kernel` (`:111-113`) under
`copy_chain` (`:118-129`), the probe's block-streamed read-plus-write
floor. One step reads a table (f32 or bf16) and its f32 accumulator of
the same shape and writes `table + eps` and `accumulator + 1e-7`, where
eps is 1e-7 rounded to the table's type first, as the Pallas body takes
it (`jnp.asarray(1e-7, t_ref.dtype)`): a bf16 table gets
`bf16(f32(t) + f32(bf16(1e-7)))`, rounded to nearest even.

`copy_step` is the wrapper of the hand-written CUDA kernel
`csrc/copy_chain.cu`. It works in place when `out` is None (the probe's
`input_output_aliases={0: 0, 1: 1}`), else it writes into the given
pair. For tensors on the CPU it runs the plain PyTorch twin
`copy_step_reference`; for CUDA tensors it launches the kernel or
raises. Its `launches` attribute counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from recommenders_tpu_torch.ops import cuda_build

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]

EPS = 1e-7
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _check(table: Tensor, accum: Tensor, out: Optional[Pair]) -> None:
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"table dtype {table.dtype}: f32 or bf16 only")
    if accum.dtype != torch.float32:
        raise TypeError(f"accumulator dtype {accum.dtype}: f32 only")
    if accum.shape != table.shape:
        raise ValueError(f"accumulator {tuple(accum.shape)} and table "
                         f"{tuple(table.shape)} differ in shape")
    outs = (table, accum) if out is None else tuple(out)
    for got, want in zip(outs, (table, accum)):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise ValueError(
                f"output {got.dtype} {tuple(got.shape)} does not match its "
                f"input {want.dtype} {tuple(want.shape)}")
    for t in (accum, *outs):
        if t.device != table.device:
            raise ValueError(f"tensor on {t.device}, table on "
                             f"{table.device}")
    if not all(t.is_contiguous() for t in (table, accum, *outs)):
        raise ValueError("copy_step needs contiguous tensors")


def copy_step(table: Tensor, accum: Tensor,
              out: Optional[Pair] = None) -> Pair:
    """One copy step: `table + eps`, `accum + 1e-7`.

    Args:
      table: The table, any shape, f32 or bf16, contiguous.
      accum: Its f32 accumulator, the table's shape, contiguous.
      out: Where to write (a table and an accumulator of the inputs'
        dtypes and shape), or None to write in place.

    Returns:
      The written pair (`(table, accum)` in place, else `out`).
    """
    _check(table, accum, out)
    if table.device.type == "cpu":
        return copy_step_reference(table, accum, out)
    return _launch(table, accum, (table, accum) if out is None else out)


copy_step.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib = cuda_build.library("copy_chain")
    fn = lib.copy_chain_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.copy_chain_error_string.argtypes = [ctypes.c_int]
    lib.copy_chain_error_string.restype = ctypes.c_char_p
    return fn, lib.copy_chain_error_string


def _launch(table: Tensor, accum: Tensor, out: Pair) -> Pair:
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"tensors on {device}: the kernel needs CUDA")
    n = table.numel()
    if n == 0:                  # nothing to write: no launch
        return tuple(out)
    fn, error_string = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(int(table.dtype == torch.bfloat16), table.data_ptr(),
                 accum.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), n,
                 cuda_build.sm_count(device), stream)
    cuda_build.raise_on(err, "copy_chain", error_string)
    copy_step.launches += 1
    return tuple(out)


def copy_step_reference(table: Tensor, accum: Tensor,
                        out: Optional[Pair] = None) -> Pair:
    """Plain PyTorch twin of the kernel (any device).

    eps is a 0-dim tensor of the table's dtype, so a bf16 table adds
    bf16(1e-7), as the Pallas body does, and not the Python float.
    """
    new_table = table + torch.tensor(EPS, dtype=table.dtype)
    new_accum = accum + torch.tensor(EPS, dtype=torch.float32)
    to, ao = (table, accum) if out is None else out
    to.copy_(new_table)
    ao.copy_(new_accum)
    return to, ao
