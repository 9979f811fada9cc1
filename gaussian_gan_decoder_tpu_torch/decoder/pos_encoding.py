"""NeRF-style positional encoding of the template position — port of
decoder/pos_encoding.py (the reference's main/decoder_utils/pos_encoding.py).

The reference's quirks are kept: the frequency bands are spaced LINEARLY
(not logarithmically) from 2^0 to 2^(num_freqs - 1), the input is included,
and each band gives [sin, cos]: out_dim = 3 + 2 * 10 * 3 = 63 for the
decoder's xyz embedding.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Embedder:
    include_input: bool = True
    input_dims: int = 3
    num_freqs: int = 10

    @property
    def freq_bands(self) -> np.ndarray:
        return np.linspace(2.0 ** 0.0, 2.0 ** (self.num_freqs - 1), self.num_freqs)

    @property
    def out_dim(self) -> int:
        d = self.input_dims if self.include_input else 0
        return d + 2 * self.num_freqs * self.input_dims

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., 3) -> (..., out_dim) in x's dtype. The bands are taken in
        float64 and rounded once: x * band reaches ~300 rad at the top band,
        where an f32 product would move sin by ~1e-5."""
        xd = x.double()
        parts = [x] if self.include_input else []
        for freq in self.freq_bands:
            parts.append(torch.sin(xd * float(freq)).to(x.dtype))
            parts.append(torch.cos(xd * float(freq)).to(x.dtype))
        return torch.cat(parts, dim=-1)
