"""Bilinear / trilinear grid sampling — port of ops/grid_sample.py.

The JAX package's semantics, which are torch `grid_sample`'s with
align_corners=False and padding_mode='zeros': grid -1..1 maps to the
outer edges of the corner texels (texel centres at (g + 1) / 2 * size -
0.5), and a tap outside the input reads 0. Written, as there, as an
explicit channels-last gather and lerp in the same order of products, so
the values and both gradients (input and grid) are the JAX package's.
"""
from __future__ import annotations

import torch


def _unnormalize(g, size):
    # align_corners=False: x = ((g + 1) * size - 1) / 2
    return ((g + 1.0) * size - 1.0) * 0.5


def _gather(table, idx, valid):
    """table (N, P, C) channels-last, idx / valid (N, ...) -> (N, ..., C),
    zero where not valid."""
    N, _, C = table.shape
    out = torch.gather(table, 1, idx.reshape(N, -1, 1).expand(-1, -1, C))
    out = out.reshape(*idx.shape, C)
    return out * valid[..., None].to(out.dtype)


def grid_sample_2d(input: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """input (N, C, H, W), grid (N, Ho, Wo, 2) with (x, y) in [-1, 1] ->
    (N, C, Ho, Wo)."""
    N, C, H, W = input.shape
    img = input.permute(0, 2, 3, 1).reshape(N, H * W, C)
    gx = _unnormalize(grid[..., 0], W)
    gy = _unnormalize(grid[..., 1], H)
    x0f, y0f = torch.floor(gx), torch.floor(gy)
    x0, y0 = x0f.long(), y0f.long()

    def val(iy, ix):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        return _gather(img, iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1), valid)

    v00, v01 = val(y0, x0), val(y0, x0 + 1)
    v10, v11 = val(y0 + 1, x0), val(y0 + 1, x0 + 1)
    wx = (gx - x0f)[..., None].to(v00.dtype)
    wy = (gy - y0f)[..., None].to(v00.dtype)
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    return out.permute(0, 3, 1, 2)


def grid_sample_3d(input: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """input (N, C, D, H, W), grid (N, Do, Ho, Wo, 3) with (x, y, z) in
    [-1, 1] (x indexes W, y H, z D) -> (N, C, Do, Ho, Wo)."""
    N, C, D, H, W = input.shape
    vol = input.permute(0, 2, 3, 4, 1).reshape(N, D * H * W, C)
    gx = _unnormalize(grid[..., 0], W)
    gy = _unnormalize(grid[..., 1], H)
    gz = _unnormalize(grid[..., 2], D)
    x0f, y0f, z0f = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    wx = (gx - x0f)[..., None]
    wy = (gy - y0f)[..., None]
    wz = (gz - z0f)[..., None]

    def val(iz, iy, ix):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0) & (iz < D)
        idx = (iz.clamp(0, D - 1) * (H * W) + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
        return _gather(vol, idx, valid)

    c00 = val(z0, y0, x0) * (1 - wx) + val(z0, y0, x0 + 1) * wx
    c01 = val(z0, y0 + 1, x0) * (1 - wx) + val(z0, y0 + 1, x0 + 1) * wx
    c10 = val(z0 + 1, y0, x0) * (1 - wx) + val(z0 + 1, y0, x0 + 1) * wx
    c11 = val(z0 + 1, y0 + 1, x0) * (1 - wx) + val(z0 + 1, y0 + 1, x0 + 1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    out = c0 * (1 - wz) + c1 * wz
    return out.permute(0, 4, 1, 2, 3)
