"""K1's plain twin against the JAX package's, on the CPU.

`ops/sparse_apply.sorted_block_apply_reference` (the port's twin of the
CUDA kernel) must compute what the JAX twin computes: per touched row, the
f32 sum of its grads in sorted order, its count, one optimizer rule, and
bf16 write-back with stochastic rounding from the reference twin's hash.
The rules are the five kernel rules of each package's
`sparse_optimizer._kernel_rule`.

Tolerances, and why:
  - bit-equal where both sides take the same IEEE operations in the same
    order: the hash, stochastic rounding, the sorted f32 sums, sgd, and
    every accumulator `a + g²`;
  - bf16 states: within 1 bf16 ulp, at least 99 % of elements bit-equal;
  - f32 states: XLA's CPU `rsqrt` is an approximation (it agrees with
    PyTorch's IEEE `1/sqrt` on about 67 % of inputs, each within 1 ulp;
    XLA also rewrites `1/sqrt` into it), its `pow` and row `mean` round
    and sum in another order, and Adam's bias corrections `βᵗ` come from
    two `pow`s. So adam, adagrad and rowwise adagrad are held within
    2 ulp of the largest of the result, the value before the update and
    the update itself (an ulp of the update term shows at its scale),
    and ftrl's `z = linear + g − σ·w`, where `σ` subtracts two nearly
    equal square roots, within `|w| · 4 ulp(√n) / lr` more.
Against JAX's Pallas kernel in interpret mode, whose one-hot routing
splits each grad into bf16 hi + lo parts, values agree to that split's
~2⁻¹⁶ relative error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.embedding import config as jax_config
from recommenders_tpu.embedding import sparse_optimizer as jax_opt
from recommenders_tpu.ops import sparse_apply as jax_sa
from recommenders_tpu_torch.embedding import config as config
from recommenders_tpu_torch.embedding import sparse_optimizer as opt
from recommenders_tpu_torch.ops import sparse_apply
from torch_threads import torch_threads  # noqa: F401 (autouse)

KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam", "ftrl")
SPEC_ARGS = {
    "sgd": dict(kind="sgd", learning_rate=0.3),
    "adagrad": dict(kind="adagrad", learning_rate=0.2),
    "rowwise_adagrad": dict(kind="rowwise_adagrad", learning_rate=0.2),
    "adam": dict(kind="adam", learning_rate=0.05),
    "ftrl": dict(kind="ftrl", learning_rate=0.1,
                 l1_regularization_strength=0.01,
                 l2_regularization_strength=0.02),
}


def to_f32(x) -> np.ndarray:
    """float32 values of a JAX array, a NumPy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_ulp_close(got, want, *, bf16: bool, max_ulp: int,
                     min_equal: float = 0.0, before=None, extra=0.0):
    """Every element within `max_ulp` ulps (bf16 ulps when `bf16`) of the
    largest of the two values and, when `before` is given, the value
    before the update and the update itself, plus `extra`; at least
    `min_equal` of the elements bit-equal."""
    got, want = to_f32(got), to_f32(want)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(got), np.abs(want))
    if before is not None:
        before = to_f32(before)
        scale = np.maximum(scale, np.maximum(np.abs(before),
                                             np.abs(want - before)))
    ulp = np.spacing(scale).astype(np.float64)
    if bf16:
        ulp = ulp * 2.0**16
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = diff > max_ulp * ulp + extra
    assert not bad.any(), (
        f"{bad.sum()} elements off by more than {max_ulp} ulp: max diff "
        f"{diff[bad].max()}"
    )
    assert (got == want).mean() >= min_equal, (got == want).mean()


def _problem(seed, v, d, n, pad=8, state_dtype=np.float32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, v, size=n)
    ids[: n // 3] = ids[rng.randint(0, n, n // 3)]    # duplicates
    if pad:
        ids[-pad:] = v + rng.randint(0, 3, size=pad)  # padding, ≥ V
    ids = np.sort(ids).astype(np.int32)
    grads = rng.normal(size=(n, d)).astype(np.float32)
    return ids, grads


def _states(kind, v, d, seed, dtype):
    """Random table and slots for `kind`, as NumPy f32 (then cast)."""
    rng = np.random.RandomState(seed + 100)
    table = rng.normal(size=(v, d)).astype(np.float32)
    slot_shapes = {
        "sgd": [], "adagrad": [(v, d)], "rowwise_adagrad": [(v, 1)],
        "adam": [(v, d), (v, d)], "ftrl": [(v, d), (v, d)],
    }[kind]
    slots = [rng.uniform(0.05, 2.0, size=s).astype(np.float32)
             for s in slot_shapes]
    if kind == "ftrl":
        slots[1] = rng.normal(size=slot_shapes[1]).astype(np.float32)
    states = [table] + slots
    if dtype == "bf16":
        states = [np.asarray(jnp.asarray(s).astype(jnp.bfloat16)
                             .astype(jnp.float32)) for s in states]
    return states


def _run_both(kind, states, ids, grads, dtype, seed, step=3):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    _, jsc, jrule, _ = jax_opt._kernel_rule(
        jax_config.OptimizerSpec(**SPEC_ARGS[kind]), jnp.int32(step))
    _, tsc, trule, _ = opt._kernel_rule(
        config.OptimizerSpec(**SPEC_ARGS[kind]), step)
    want = jax_sa.sorted_block_apply_reference(
        tuple(jnp.asarray(s).astype(jdt) for s in states),
        jnp.asarray(ids), jnp.asarray(grads), jrule, scalars=jsc,
        stochastic_round_seed=None if seed is None else jnp.int32(seed),
    )
    tstates = tuple(torch.from_numpy(s.copy()).to(tdt) for s in states)
    got = sparse_apply.sorted_block_apply(
        tstates, torch.from_numpy(ids), torch.from_numpy(grads), trule,
        scalars=tsc, stochastic_round_seed=seed,
    )
    assert all(g is t for g, t in zip(got, tstates))   # in place
    return got, want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype,seed", [
    ("f32", None), ("bf16", None), ("bf16", 12345), ("bf16", -7),
])
@pytest.mark.parametrize("v,d,n", [(256, 8, 96), (4096, 64, 512)])
def test_twin_matches_jax_twin(kind, dtype, seed, v, d, n):
    ids, grads = _problem(v + d, v, d, n)
    states = _states(kind, v, d, 0, dtype)
    got, want = _run_both(kind, states, ids, grads, dtype, seed)
    for plane, (g, w, s) in enumerate(zip(got, want, states)):
        assert g.dtype == (torch.bfloat16 if dtype == "bf16"
                           else torch.float32)
        accumulator = plane == 1 and kind in ("adagrad", "ftrl")
        if kind == "sgd" or (accumulator and dtype == "f32"):
            np.testing.assert_array_equal(to_f32(g), to_f32(w))
        elif dtype == "bf16":
            assert_ulp_close(g, w, bf16=True, max_ulp=1, min_equal=0.99)
        else:
            extra = 0.0
            if kind == "ftrl" and plane != 1:
                lr = SPEC_ARGS["ftrl"]["learning_rate"]
                sqrt_n = np.sqrt(to_f32(want[1]).astype(np.float64))
                extra = (np.abs(states[0]) * 4
                         * np.spacing(sqrt_n.astype(np.float32)) / lr)
                if plane == 0:   # w = (sign(z)·l1 − z) / (√n / lr + 2·l2)
                    extra = extra * lr / sqrt_n
            assert_ulp_close(g, w, bf16=False, max_ulp=2, before=s,
                             extra=extra)


@pytest.mark.parametrize("kind", ["adagrad", "adam"])
def test_all_padding_leaves_every_state_untouched(kind):
    v, d, n = 64, 8, 16
    ids = np.full(n, v, np.int32)
    grads = np.random.RandomState(0).normal(size=(n, d)).astype(np.float32)
    states = _states(kind, v, d, 1, "f32")
    got, want = _run_both(kind, states, ids, grads, "f32", None)
    for g, w, s in zip(got, want, states):
        np.testing.assert_array_equal(to_f32(g), s)
        np.testing.assert_array_equal(to_f32(w), s)


def test_untouched_rows_bit_identical_and_duplicates_summed_in_order():
    v, d, n = 128, 16, 64
    ids, grads = _problem(3, v, d, n)
    states = _states("sgd", v, d, 3, "f32")
    got, _ = _run_both("sgd", states, ids, grads, "f32", None)
    touched = np.zeros(v, bool)
    touched[ids[ids < v]] = True
    table = to_f32(got[0])
    np.testing.assert_array_equal(table[~touched], states[0][~touched])
    # Row sums in sorted order, from zero, in f32.
    want = states[0].copy()
    for row in np.unique(ids[ids < v]):
        acc = np.zeros(d, np.float32)
        for gr in grads[ids == row]:
            acc = acc + gr
        want[row] = want[row] - np.float32(0.3) * acc
    np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("kind", KINDS)
def test_twin_close_to_jax_pallas_kernel_interpreted(kind):
    """Against the Pallas kernel itself (interpret mode, f32 states,
    exact hi + lo routing): the split's ~2⁻¹⁶ relative error."""
    v, d, n = 256, 16, 96
    ids, grads = _problem(5, v, d, n)
    states = _states(kind, v, d, 5, "f32")
    _, jsc, jrule, needs_count = jax_opt._kernel_rule(
        jax_config.OptimizerSpec(**SPEC_ARGS[kind]), jnp.int32(3))
    want = jax_sa.sorted_block_apply(
        tuple(jnp.asarray(s) for s in states), jnp.asarray(ids),
        jnp.asarray(grads), jrule, scalars=jsc, block_rows=64, chunk=32,
        need_count=needs_count, exact_routing=True, interpret=True,
    )
    got, _ = _run_both(kind, states, ids, grads, "f32", None)
    for g, w, s in zip(got, want, states):
        # ftrl's σ subtracts two nearly equal square roots, which scales
        # the split's error by |w| / lr: allow it at the plane's scale.
        atol = 2.0**-16 * (np.abs(s).max() if kind == "ftrl" else 1.0)
        np.testing.assert_allclose(to_f32(g), to_f32(w), rtol=2.0**-14,
                                   atol=atol)


@pytest.mark.parametrize("seed", [0, 77, 2**31 - 1, 2**31, 2**31 + 12345,
                                  2**32 - 1])
@pytest.mark.parametrize("stream", [0, 3])
def test_counter_random_u32_bit_equal(seed, stream):
    want = jax_sa.counter_random_u32(
        jnp.asarray(np.uint32(seed)), jnp.int32(stream), (33, 70))
    got = sparse_apply.counter_random_u32(seed, stream, (33, 70),
                                          device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_stochastic_round_bf16_bit_equal(seed):
    x = (np.random.RandomState(seed % 1000).normal(size=(40, 70)) * 37
         ).astype(np.float32)
    bits = sparse_apply.counter_random_u32(seed, 1, x.shape, device="cpu")
    want = jax_sa.stochastic_round_bf16(
        jnp.asarray(x), jnp.asarray(bits.numpy().astype(np.uint32)))
    got = sparse_apply.stochastic_round_bf16(torch.from_numpy(x), bits)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_f32(got), to_f32(want))


def test_random_bits_and_initializer_default_to_cuda():
    # Entry points run on the card unless the caller asks for the CPU.
    calls = (
        lambda: sparse_apply.counter_random_u32(5, 0, (2, 3)),
        lambda: config.default_initializer(4)(None, (2, 4)),
    )
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_rejects_unsupported_plane_shapes():
    table = torch.zeros(16, 8)
    _, sc, rule, _ = opt._kernel_rule(
        config.OptimizerSpec(kind="adagrad"), 0)
    with pytest.raises(ValueError, match="not supported"):
        sparse_apply.sorted_block_apply(
            (table, torch.zeros(16, 4)), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, 8), rule, scalars=sc)
