"""Named random draws for the GAN step and the augment pipe.

The JAX package threads PRNG keys: each function splits its key into one
key a draw site. The port's functions take a draws object instead. A site
asks `child(name)` for the draws of a named sub-site, then calls
`uniform`, `normal` or `randint`, each of which makes one draw. The port's
own object, TorchDraws, makes every draw from one torch.Generator in call
order and ignores the names; a test can hand in an object that maps each
name to the JAX key the JAX function would have split there, and so feed
the port JAX's draws.
"""
from __future__ import annotations

from typing import Sequence

import torch


class TorchDraws:
    """Every draw from one torch.Generator (on its own device, then moved to
    `device`), in call order."""

    def __init__(self, generator: torch.Generator, device=None):
        self.generator = generator
        self.device = device if device is not None else generator.device

    def child(self, name: str) -> "TorchDraws":
        return self

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device).to(self.device)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device).to(self.device)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.generator.device).to(self.device)
