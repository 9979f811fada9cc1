"""Rasterizer configuration and the decoder-path renderer — port of the
fields of splat/rasterize.py::RasterizeConfig that the port reads, and of
render_simple on its 'pallas_diff' and 'pallas' backends.

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
