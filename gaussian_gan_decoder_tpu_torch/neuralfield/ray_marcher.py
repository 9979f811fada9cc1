"""Midpoint alpha-compositing ray marcher (MipRayMarcher2) — port of
neuralfield/ray_marcher.py."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mip_ray_march(colors, densities, depths, rgb_to_minus1_1: bool = False):
    """colors (N, R, S, C), densities / depths (N, R, S, 1) -> (rgb (N, R, C),
    depth (N, R, 1), weights (N, R, S-1, 1)); softplus density clamp."""
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    densities_mid = (densities[:, :, :-1] + densities[:, :, 1:]) / 2
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2
    densities_mid = F.softplus(densities_mid - 1)
    alpha = 1 - torch.exp(-densities_mid * deltas)
    alpha_shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1 - alpha + 1e-10], dim=-2)
    weights = alpha * torch.cumprod(alpha_shifted, dim=-2)[:, :, :-1]
    composite_rgb = torch.sum(weights * colors_mid, dim=-2)
    weight_total = weights.sum(2)
    composite_depth = torch.sum(weights * depths_mid, dim=-2) / weight_total
    composite_depth = torch.nan_to_num(composite_depth, nan=float("inf"))
    composite_depth = torch.clamp(composite_depth, depths.min(), depths.max())
    if rgb_to_minus1_1:
        composite_rgb = composite_rgb * 2 - 1
    return composite_rgb, composite_depth, weights
