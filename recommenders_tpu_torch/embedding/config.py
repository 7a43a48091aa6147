"""Declarative embedding configuration: TableConfig / FeatureConfig.

Port of `recommenders_tpu/embedding/config.py:26-165`. Tables declare
vocabulary, width, combiner, initializer and optimizer; features name a
table (several features may share one) and optionally keep a sequence
axis. Plain frozen dataclasses, hashable, with no global state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from recommenders_tpu_torch.utils import device as device_lib

# `init(generator, shape, dtype, device) -> tensor`.
Initializer = Callable[..., torch.Tensor]
# Float, or a schedule `step -> lr` (step is an int64 scalar tensor).
LearningRate = Union[float, Callable[[torch.Tensor], torch.Tensor]]

VALID_COMBINERS = ("sum", "mean", "sqrtn")

# Id value marking padding positions in fixed-length id matrices.
PAD_ID = -1


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Per-table sparse-optimizer spec (the JAX package's fields).

    `kind` is one of sgd | adagrad | rowwise_adagrad | adam | ftrl |
    clippy. `learning_rate` may be a float or a schedule `step -> lr`,
    evaluated on the engine's step counter.
    """

    kind: str = "adagrad"
    learning_rate: LearningRate = 0.01
    initial_accumulator_value: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-7
    # FTRL parameters.
    learning_rate_power: float = -0.5
    l1_regularization_strength: float = 0.0
    l2_regularization_strength: float = 0.0
    # Clippy parameters (kind="clippy").
    variable_relative_threshold: float = 0.1
    accumulator_relative_threshold: float = 0.0
    absolute_threshold: float = 1e-7
    clip_accumulator_update: bool = False
    use_standard_accumulator_update: bool = False

    def lr_at(self, step):
        """Resolves the learning rate at `step`."""
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return self.learning_rate


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Configuration for one embedding table.

    Attributes:
      vocabulary_size: Number of rows (ids in `[0, vocabulary_size)`).
      dim: Embedding width.
      name: Unique table name.
      combiner: "sum" | "mean" | "sqrtn" for multivalent features.
      initializer: `(generator, shape, dtype, device) -> tensor`;
        defaults to truncated normal with stddev `1/sqrt(dim)`.
      optimizer: Per-table sparse optimizer; None inherits the engine's.
      max_unique_ids: Optional bound on unique ids updated per step;
        steps with more unique ids drop the largest ids' updates.
    """

    vocabulary_size: int
    dim: int
    name: str
    combiner: str = "mean"
    initializer: Optional[Initializer] = None
    optimizer: Optional[OptimizerSpec] = None
    max_unique_ids: Optional[int] = None

    def __post_init__(self):
        if self.combiner not in VALID_COMBINERS:
            raise ValueError(
                f"combiner must be one of {VALID_COMBINERS}, got "
                f"{self.combiner!r}"
            )
        if self.vocabulary_size <= 0 or self.dim <= 0:
            raise ValueError(
                "vocabulary_size and dim must be positive, got "
                f"{self.vocabulary_size} and {self.dim}."
            )
        if self.max_unique_ids is not None and self.max_unique_ids <= 0:
            raise ValueError(
                f"max_unique_ids must be positive, got "
                f"{self.max_unique_ids}."
            )


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Configuration for one input feature.

    Attributes:
      table: The table this feature looks up (tables may be shared).
      name: Feature name (the key in the input features dict).
      max_sequence_length: If > 0, the lookup keeps the sequence axis
        (`[B, L, dim]`, padding rows zeroed) instead of combining.
      output_shape: Optional trailing batch shape override (config
        parity only).
    """

    table: TableConfig
    name: str
    max_sequence_length: int = 0
    output_shape: Optional[Tuple[int, ...]] = None


def default_initializer(dim: int) -> Initializer:
    """Truncated normal cut at ±2, divided by sqrt(dim).

    The draws come from a `torch.Generator`, so they never equal
    `jax.random`'s; carry state across with `utils.convert` to compare.
    """

    def init(generator: Optional[torch.Generator], shape,
             dtype=torch.float32, device: device_lib.DeviceLike = "cuda"):
        out = torch.empty(shape, dtype=torch.float32,
                          device=device_lib.resolve(device))
        torch.nn.init.trunc_normal_(out, std=1.0, a=-2.0, b=2.0,
                                    generator=generator)
        return (out / dim ** 0.5).to(dtype)

    return init
