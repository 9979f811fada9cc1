"""Spherical harmonics colour, degree 0 — port of gaussians/sh.py
(sh_to_color at the active degree the decoder path renders with)."""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814


def sh_to_color(deg: int, sh: torch.Tensor) -> torch.Tensor:
    """sh (N, 3, k) coefficients -> rgb (N, 3): C0 * sh[..., 0] + 0.5,
    clamped at 0 (the CUDA rasterizer's computeColorFromSH at degree 0)."""
    if deg != 0:
        raise NotImplementedError("the port renders SH degree 0 only; higher degrees come "
                                  "with classic 3DGS (ROADMAP.md queue A item A6)")
    return torch.clamp(SH_C0 * sh[..., 0] + 0.5, min=0.0)
