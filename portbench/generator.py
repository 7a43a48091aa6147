"""The inputs of a run, made from `--seed` on the device.

A frozen copy of `chip_smoke.py`'s `scale_stream` (phase 38), itself
`benchmarks/ann.py`'s clustered catalog (`:46-76`): every row is one of
`centers` Gaussian centres plus `noise` × N(0, 1). Each batch of the
catalog, the centres and every request pool draw from a generator of
their own, seeded by (`--seed`, salt), so a pass over the catalog
regenerates the same rows and the requests share no draw with it.
"""

from __future__ import annotations

import hashlib

import torch

Tensor = torch.Tensor

# Salts: batch i of the catalog takes salt i; the others lie far above.
CENTER_SALT = 1 << 40
REQUEST_SALT = 1 << 41
WARMUP_SALT = 1 << 42
SAMPLE_SALT = 1 << 43


def generator(seed: int, salt: int, device: torch.device) -> torch.Generator:
    """A generator on `device` seeded by (seed, salt): 63 bits of their
    SHA-256, so any whole seed, however large, gives its own stream."""
    digest = hashlib.sha256(f"{int(seed)}:{int(salt)}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


class Catalog:
    """The clustered catalog of a configuration's `catalog` entry (`rows`,
    `dim`, `batch`, `centers`, `noise`), regenerated on every pass.

    Calling it returns a fresh iterator over its `[batch, dim]` f32
    blocks in row order: the zero-argument factory the port's streamed
    builds take."""

    def __init__(self, spec: dict, seed: int, device: torch.device):
        self.rows = int(spec["rows"])
        self.dim = int(spec["dim"])
        self.batch = int(spec["batch"])
        self.noise = float(spec["noise"])
        self.seed = seed
        self.device = device
        self.centers = torch.randn(
            (int(spec["centers"]), self.dim), device=device,
            generator=generator(seed, CENTER_SALT, device))

    def draw(self, n: int, salt: int) -> Tensor:
        """n rows: a centre each plus `noise` × N(0, 1), in two calls of
        one generator."""
        gen = generator(self.seed, salt, self.device)
        pick = torch.randint(0, self.centers.shape[0], (n,), generator=gen,
                             device=self.device)
        noise = torch.randn((n, self.dim), generator=gen, device=self.device)
        return self.centers[pick].add_(noise, alpha=self.noise)

    def __call__(self):
        for i, start in enumerate(range(0, self.rows, self.batch)):
            yield self.draw(min(self.batch, self.rows - start), i)

    def requests(self, count: int, size: int, salt: int) -> Tensor:
        """`[count, size, dim]` query embeddings from the catalog's own
        distribution, drawn in one call: `count` distinct requests."""
        return self.draw(count * size, salt).view(count, size, self.dim)
