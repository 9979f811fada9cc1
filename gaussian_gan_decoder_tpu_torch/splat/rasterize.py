"""Rasterizer configuration and the decoder-path renderer — port of
splat/rasterize.py::RasterizeConfig and of render_simple on its
'pallas_diff' and 'pallas' backends.

The port bins with one stable 64-bit key sort over exactly the pairs that
exist (splat/fast_raster.py), so the JAX config's pair budgets
(max_pairs, chunk, overflow_budget) have no counterpart: no pair is ever
dropped for want of room. Its payload options are the JAX ones, with the
JAX defaults (all off) and constraints:

  * bf16_colors: (r, g) and (b, opacity) as bf16 pairs (7 payload words);
  * packed_payloads: tile-local int16 pixel coordinates (1/32 px), f16
    conics, bf16 colours (5 words, 'packed_v2'); supersedes bf16_colors;
  * rgb10_payloads (with packed_payloads): cc|op as an f16 pair and rgb in
    one 10-bit fixed-point word (4 words, 'packed_v3');
  * fused_sort_key (with packed_payloads): the 32-bit key tile << 21 |
    depth-bits >> 11 (2^-12 relative depth); its frequent depth ties keep
    the JAX sort's order, copy class (a pair's rank in its Gaussian's tile
    rect, capped at static_copies) first, then the Gaussian;
  * blend_mxu_power (with packed_payloads): the blend's falloff as the
    quadratic polynomial of the pixel's tile-local coordinates.

static_copies (the JAX structural copies) is read only as that tie-order
class cap. The training blend (rasterize_fast(differentiable=True), K4 /
K5) reads f32 payloads whatever the config, as the JAX one does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 16
    tile_capacity: int = 1024   # per-tile depth-ordered blend budget (max_k)
    static_copies: int = 4      # the fused key's tie-order class cap
    bf16_colors: bool = False
    packed_payloads: bool = False
    fused_sort_key: bool = False
    blend_mxu_power: bool = False
    rgb10_payloads: bool = False

    @property
    def payload_format(self) -> str:
        """The blend's payload format, as the JAX _blend_and_assemble picks
        it: 'packed_v3', 'packed_v2', 'bf16_colors' or 'f32'."""
        if self.packed_payloads:
            return "packed_v3" if self.rgb10_payloads else "packed_v2"
        return "bf16_colors" if self.bf16_colors else "f32"

    @property
    def fused_key(self) -> bool:
        """Whether binning sorts by the fused 32-bit key (packed formats only)."""
        return self.fused_sort_key and self.packed_payloads

    @property
    def mxu_power(self) -> bool:
        """Whether the blend takes the quadratic-basis falloff (packed only)."""
        return self.blend_mxu_power and self.packed_payloads


BACKENDS = ("pallas_diff", "pallas", "xla")


def render_simple(cam, decoded: Dict[str, torch.Tensor], bg: torch.Tensor,
                  config: Optional[RasterizeConfig] = None,
                  backend: str = "pallas_diff") -> Dict[str, torch.Tensor]:
    """Decoder-path renderer (ref gaussian_renderer/__init__.py:105-186):
    decoded carries the RAW decoder outputs {xyz, scale, rotation, opacity,
    color}; scales exp, opacity sigmoid, colour the degree-0 SH feature,
    rotation normalised in the projection. backend 'pallas_diff' blends
    with the training kernels (K4 / K5, differentiable), 'pallas' with the
    frame blend (K3, forward only: the JAX rasterize_fast(differentiable=
    False)); 'xla', the f32 oracle rasterizer, is not ported."""
    from .fast_raster import rasterize_fast

    if backend not in BACKENDS:
        raise ValueError(f"render_simple backend {backend!r}: one of {BACKENDS}")
    if backend == "xla":
        raise NotImplementedError("render_simple backend 'xla' (the f32 oracle rasterize) is "
                                  "not ported yet (ROADMAP.md queue A item A3)")
    return rasterize_fast(cam, decoded["xyz"], torch.exp(decoded["scale"]), decoded["rotation"],
                          torch.sigmoid(decoded["opacity"]), decoded["color"][:, None, :],
                          bg, config or RasterizeConfig(),
                          differentiable=backend == "pallas_diff")
