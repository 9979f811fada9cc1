"""Real spherical harmonics, degrees 0-3 — port of gaussians/sh.py.

The constants and polynomials of the reference's sh_utils.py and of the
CUDA rasterizer's computeColorFromSH, with its forward's `+ 0.5` offset and
its clamp at 0.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def rgb_to_sh(rgb):
    """(ref sh_utils.py:114) RGB2SH = (rgb - 0.5) / C0."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh):
    return sh * SH_C0 + 0.5


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH at unit directions (ref sh_utils.py:29-112): deg 0..3 (the active
    degree), sh (..., C, (deg_max + 1)^2) of which the first (deg + 1)^2
    are read, dirs (..., 3) -> (..., C)."""
    result = SH_C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        result = result - SH_C1 * y * sh[..., 1] + SH_C1 * z * sh[..., 2] - SH_C1 * x * sh[..., 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * sh[..., 4]
                      + SH_C2[1] * yz * sh[..., 5]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + SH_C2[3] * xz * sh[..., 7]
                      + SH_C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result
                          + SH_C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + SH_C3[1] * xy * z * sh[..., 10]
                          + SH_C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                          + SH_C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + SH_C3[5] * z * (xx - yy) * sh[..., 14]
                          + SH_C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    return result


def sh_to_color(deg: int, sh: torch.Tensor, means: torch.Tensor,
                campos: torch.Tensor) -> torch.Tensor:
    """CUDA computeColorFromSH: eval_sh + 0.5, clamped at 0. sh (N, C, K)
    coefficients, means (N, 3), campos (3,) -> (N, C). Degree 0 reads no
    view direction."""
    if deg == 0:
        return torch.clamp(SH_C0 * sh[..., 0] + 0.5, min=0.0)
    dirs = means - campos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    return torch.clamp(eval_sh(deg, sh, dirs[:, None, :]) + 0.5, min=0.0)
