"""Pixel-centre rays from cam2world + normalised intrinsics — port of
neuralfield/ray_sampler.py."""
from __future__ import annotations

import torch

from .math_utils import normalize_vecs


def sample_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor, resolution: int):
    """cam2world (N, 4, 4), intrinsics (N, 3, 3) -> (ray_origins (N, M, 3),
    ray_dirs (N, M, 3)), M = resolution^2 in row-major pixel order."""
    N = cam2world.shape[0]
    cam_pos = cam2world[:, :3, 3]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    coords = (torch.arange(resolution, dtype=cam2world.dtype, device=cam2world.device)
              + 0.5) / resolution
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    x_cam = xx.reshape(-1)[None, :]
    y_cam = yy.reshape(-1)[None, :]
    z_cam = torch.ones_like(x_cam)
    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    M = x_cam.shape[1]
    cam_rel = torch.stack([x_lift.expand(N, M), y_lift.expand(N, M), z_cam.expand(N, M),
                           torch.ones((N, M), dtype=cam2world.dtype, device=cam2world.device)],
                          dim=-1)
    world = torch.einsum("nij,nmj->nmi", cam2world, cam_rel)[:, :, :3]
    ray_dirs = normalize_vecs(world - cam_pos[:, None, :])
    return cam_pos[:, None, :].expand_as(ray_dirs), ray_dirs
