"""Port parity for `utils/activations.py` and `layers/blocks.MLP`.

Each activation is compared with its `jax.nn` namesake on the same inputs
to 1e-6 (elementwise f32 math in two libraries). The MLP gets the flax
MLP's weights (kernels transposed) and must agree to 1e-5 (f32 matmuls
in another sum order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import blocks as jax_blocks
from recommenders_tpu.utils import activations as jax_activations
from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.utils import activations


@pytest.mark.parametrize("name", sorted(jax_activations._ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.random.RandomState(0).normal(size=(4, 33)).astype(np.float32) * 3
    want = np.asarray(jax_activations.get(name)(jnp.asarray(x)))
    got = activations.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_activation_lookup():
    assert activations.get(None) is None
    assert activations.get(torch.tanh) is torch.tanh
    with pytest.raises(ValueError, match="Unknown activation"):
        activations.get("nope")


@pytest.mark.parametrize("final_activation", [None, "sigmoid"])
def test_mlp_matches_flax(final_activation):
    units = (64, 32, 8)
    x = np.random.RandomState(1).normal(size=(5, 16)).astype(np.float32)
    flax_mlp = jax_blocks.MLP(
        units=units, activation="gelu", final_activation=final_activation
    )
    params = flax_mlp.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    mlp = blocks.MLP(16, units, activation="gelu",
                     final_activation=final_activation, device="cpu")
    with torch.no_grad():
        for i, layer in enumerate(mlp.layers):
            dense = params[f"Dense_{i}"]
            layer.weight.copy_(torch.from_numpy(np.array(dense["kernel"]).T))
            layer.bias.copy_(torch.from_numpy(np.array(dense["bias"])))
        got = mlp(torch.from_numpy(x)).numpy()
    want = np.asarray(flax_mlp.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_initialisation_follows_flax_defaults():
    """Truncated-normal draws with the requested standard deviation, cut
    at two of them, as flax's initialisers give."""
    g = torch.Generator().manual_seed(0)
    w = torch.empty(200_000)
    blocks.truncated_normal_(w, 0.5, g)
    assert float(w.abs().max()) <= 2 * 0.5 / blocks._TRUNCATED_STD
    assert abs(float(w.std()) - 0.5) < 0.005
    mlp = blocks.MLP(400, (300,), device="cpu")
    mlp.reset_parameters(torch.Generator().manual_seed(1))
    weight = mlp.layers[0].weight.detach()
    assert abs(float(weight.std()) - 400 ** -0.5) < 0.001
    assert not mlp.layers[0].bias.any()
