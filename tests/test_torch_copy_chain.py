"""The probe's copy step (`ops/copy_chain.py`) against the JAX body.

`benchmarks/_alias_probe.py`'s `copy_kernel` (`:111-113`) is a closure
inside its `main()`, so the JAX side restates its two-line body, as jnp
expressions and as a `pl.pallas_call` in interpret mode with the probe's
specs (`:115-129`) and a small row block. Tolerance: none, the port's twin
must give the JAX body's bits for f32 and bf16 tables, in place and out
of place, at a ragged shape (V·D not a multiple of 8).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from recommenders_tpu_torch.ops import copy_chain
from recommenders_tpu_torch.tools import alias_probe
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
V, D, BR = 36, 63, 12                  # V·D = 2,268: not a multiple of 8
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(seed):
    """A table and accumulator with values at scales from 1e-9 to 1, of
    both signs and some zeros, so that adding 1e-7 moves their bits."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-9, 1, size=(2, V, D))
    values = (rng.normal(size=(2, V, D)) * scale).astype(np.float32)
    values[:, ::7, ::5] = 0.0
    values[0, 1, :8] = [-1e-7, 1e-7, -5e-8, 5e-8, 1.0, -1.0, 3e-8, -3e-8]
    return values[0], values[1]


def _copy_kernel(t_ref, a_ref, to_ref, ao_ref):
    # _alias_probe.py:111-113.
    to_ref[...] = t_ref[...] + jnp.asarray(1e-7, t_ref.dtype)
    ao_ref[...] = a_ref[...] + 1e-7


def _pallas_copy(table, accum, alias):
    """`copy_chain`'s call (`_alias_probe.py:115-129`), interpreted."""
    spec = pl.BlockSpec((BR, D), lambda i: (i, 0))
    call = pl.pallas_call(
        _copy_kernel, grid=(V // BR,), in_specs=[spec, spec],
        out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((V, D), table.dtype),
                   jax.ShapeDtypeStruct((V, D), jnp.float32)),
        input_output_aliases={0: 0, 1: 1} if alias else {},
        interpret=True)
    return call(table, accum)


def _bits(x):
    """Raw bits of a JAX or torch f32 / bf16 array, as NumPy integers."""
    if isinstance(x, torch.Tensor):
        wide = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        return x.view(wide).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("in_place", [True, False],
                         ids=["in_place", "out_of_place"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_copy_step_matches_the_jax_body_bit_for_bit(dtype, in_place):
    jdt, tdt = DTYPES[dtype]
    t_np, a_np = _pair(0)
    jt = jnp.asarray(t_np).astype(jdt)
    ja = jnp.asarray(a_np)
    want_t = jt + jnp.asarray(1e-7, jt.dtype)
    want_a = ja + 1e-7
    got_pallas = _pallas_copy(jt, ja, alias=in_place)
    for got, want in zip(got_pallas, (want_t, want_a)):
        np.testing.assert_array_equal(_bits(got), _bits(want))

    table = torch.from_numpy(t_np).to(tdt)
    accum = torch.from_numpy(a_np)
    before = [x.clone() for x in (table, accum)]
    out = None if in_place else (torch.empty_like(table),
                                 torch.empty_like(accum))
    launches = copy_chain.copy_step.launches
    got = copy_chain.copy_step(table, accum, out)
    assert copy_chain.copy_step.launches == launches    # the twin ran
    assert got[0] is (table if in_place else out[0])
    assert got[1] is (accum if in_place else out[1])
    for g, w in zip(got, (want_t, want_a)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if not in_place:
        for x, b in zip((table, accum), before):
            assert torch.equal(x, b)
    # eps moved bits: the test would pass a copy with no add otherwise.
    assert not torch.equal(got[1], before[1])
    if dtype == "bf16":
        # A Python-float eps (1e-7, not bf16(1e-7)) gives other bits.
        floats = (before[0].float() + 1e-7).to(torch.bfloat16)
        assert not torch.equal(floats, got[0])


@pytest.mark.parametrize("case", [
    "table_f16", "accum_bf16", "shapes", "out_dtype", "out_shape",
    "strided", "meta"])
def test_copy_step_rejects_what_the_kernel_does_not_take(case):
    table = torch.zeros(8, 4)
    accum = torch.zeros(8, 4)
    out = None
    error = ValueError
    if case == "table_f16":
        table, error = table.half(), TypeError
    elif case == "accum_bf16":
        accum, error = accum.bfloat16(), TypeError
    elif case == "shapes":
        accum = torch.zeros(4, 8)
    elif case == "out_dtype":
        out = (torch.zeros(8, 4, dtype=torch.bfloat16), torch.zeros(8, 4))
    elif case == "out_shape":
        out = (torch.zeros(8, 4), torch.zeros(8, 5))
    elif case == "strided":
        table = torch.zeros(4, 8).t()
    elif case == "meta":
        table = torch.zeros(8, 4, device="meta")
        accum = torch.zeros(8, 4, device="meta")
    with pytest.raises(error):
        copy_chain.copy_step(table, accum, out)


def test_alias_probe_measures_all_four_on_the_cpu_at_a_tiny_size():
    shape = alias_probe.Shape(rows=256, dim=8, ids=32, steps=2)
    for dtype in (torch.float32, torch.bfloat16):
        got = alias_probe.measurements(torch.device("cpu"), dtype, shape, 0)
        assert tuple(got) == alias_probe.MEASUREMENTS
        assert all(np.isfinite(v) and v > 0 for v in got.values())
    # _alias_probe.py's traffic, V·D·(table bytes + 4)·2, at 3.35 TB/s.
    assert alias_probe.traffic_bytes(131_072, 64, torch.bfloat16) == (
        100_663_296)
    assert alias_probe.traffic_bytes(131_072, 64, torch.float32) == (
        134_217_728)
    assert abs(alias_probe.floor_us(131_072, 64, torch.float32) - 40.06) < (
        0.01)


def test_alias_probe_wrapper_calls_are_what_its_chains_call(monkeypatch):
    """Phase 39 holds the card's launch counts to `wrapper_calls`: here the
    wrappers are counted as the chains call them, at a tiny size."""
    from recommenders_tpu_torch.ops import sparse_apply

    calls = {"copy": 0, "k1": 0}

    def counted(key, fn):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(copy_chain, "copy_step",
                        counted("copy", copy_chain.copy_step))
    monkeypatch.setattr(sparse_apply, "sorted_block_apply",
                        counted("k1", sparse_apply.sorted_block_apply))
    shape = alias_probe.Shape(rows=256, dim=8, ids=32, steps=3)
    alias_probe.measurements(torch.device("cpu"), torch.float32, shape, 0)
    assert (calls["copy"], calls["k1"]) == alias_probe.wrapper_calls(shape)
    assert alias_probe.wrapper_calls(alias_probe.Shape()) == (189, 126)


def test_alias_probe_exits_non_zero_without_cuda():
    proc = subprocess.run(
        [sys.executable, "-m", "recommenders_tpu_torch.tools.alias_probe"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA is not available" in proc.stderr
