"""Named random draws for the GAN step, the augment pipe, the synthesis'
random noise and the inversion's steps.

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

    def normal(self, shape: Sequence[int], dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """f32 normal draws, then cast to dtype (the synthesis' noise takes
        its layer's)."""
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device).to(self.device, dtype)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.generator.device).to(self.device)


def draws_or_seeded(draws, key, device):
    """draws, or (None) a TorchDraws on a CPU generator seeded from the JAX
    key's low word (utils/jax_random.py), its numbers moved to device."""
    if draws is not None:
        return draws
    return TorchDraws(torch.Generator().manual_seed(int(key[1])), device)
