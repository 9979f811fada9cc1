"""Rasterizer configuration and the decoder-path renderer — port of the
fields of splat/rasterize.py::RasterizeConfig that the port reads, and of
render_simple (its 'pallas_diff' backend).

The TPU sort-bandwidth trades of the JAX config (static_copies,
overflow_budget, bf16_colors, packed_payloads, rgb10_payloads,
fused_sort_key, blend_mxu_power) are not ported: the port bins with one
64-bit (tile, depth) key sort over exactly the pairs that exist, carries
the f32 payload, and never drops a pair (n_dropped is always 0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 16
    tile_capacity: int = 1024   # per-tile depth-ordered blend budget (max_k)


def render_simple(cam, decoded: Dict[str, torch.Tensor], bg: torch.Tensor,
                  config: Optional[RasterizeConfig] = None) -> Dict[str, torch.Tensor]:
    """Decoder-path renderer (ref gaussian_renderer/__init__.py:105-186):
    decoded carries the RAW decoder outputs {xyz, scale, rotation, opacity,
    color}; scales exp, opacity sigmoid, colour the degree-0 SH feature,
    rotation normalised in the projection. Differentiable (kernels K4 /
    K5)."""
    from .fast_raster import rasterize_fast

    return rasterize_fast(cam, decoded["xyz"], torch.exp(decoded["scale"]), decoded["rotation"],
                          torch.sigmoid(decoded["opacity"]), decoded["color"][:, None, :],
                          bg, config or RasterizeConfig())
