"""Camera pose / intrinsics sampling (y-up origin orbit) — port of
decoder/camera_sampling.py.

The draws are arguments: standard normals (normal sampling) or uniforms in
[0, 1) (uniform sampling) for the horizontal and vertical angle, so that a
caller reproduces any source of randomness.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def normalize_vecs(v, eps=0.0):
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def create_cam2world_matrix(forward_vector: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """y-up, no roll -> (N, 4, 4)."""
    forward = normalize_vecs(forward_vector)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=forward.dtype,
                      device=forward.device).expand_as(forward)
    right = -normalize_vecs(torch.cross(up, forward, dim=-1))
    up2 = normalize_vecs(torch.cross(forward, right, dim=-1))
    n = forward.shape[0]
    rot = torch.eye(4, dtype=forward.dtype, device=forward.device).repeat(n, 1, 1)
    rot[:, :3, :3] = torch.stack([right, up2, forward], dim=-1)
    tr = torch.eye(4, dtype=forward.dtype, device=forward.device).repeat(n, 1, 1)
    tr[:, :3, 3] = origin
    return tr @ rot


def _origin_from_hv(h, v, radius):
    v = torch.clamp(v, 1e-5, math.pi - 1e-5)
    phi = torch.arccos(1 - 2 * (v / math.pi))
    x = radius * torch.sin(phi) * torch.cos(math.pi - h)
    z = radius * torch.sin(phi) * torch.sin(math.pi - h)
    y = radius * torch.cos(phi)
    return torch.cat([x, y, z], dim=-1)


def pose_from_hv(h, v, radius, lookat=None):
    """Angles (N, 1) -> cam2world (N, 4, 4) looking at lookat ((N, 3) or
    (3,); the origin when None)."""
    origin = _origin_from_hv(h, v, radius)
    target = torch.zeros_like(origin) if lookat is None else lookat
    return create_cam2world_matrix(normalize_vecs(target - origin), origin)


def fov_to_intrinsics(fov_degrees, imsize: float = 1.0):
    """Normalised intrinsics (keeps the reference's 3.14159 for parity)."""
    fov_rad = fov_degrees * 2 * 3.14159 / 360
    focal = imsize / (2 * torch.tan(fov_rad / 2))
    z, o = torch.zeros_like(focal), torch.ones_like(focal)
    return torch.stack([torch.stack([focal, z, 0.5 * o], -1),
                        torch.stack([z, focal, 0.5 * o], -1),
                        torch.stack([z, z, o], -1)], -2)


def sample_camera_params(h_draw: torch.Tensor, v_draw: torch.Tensor, fov_deg: torch.Tensor,
                         camera_sampling: str = "normal", horizontal_stddev: float = 1.0,
                         vertical_stddev: float = 0.3, radius: float = 2.7
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (camera_params (1, 25), cam2world (1, 4, 4), h, v). h_draw and
    v_draw (1, 1): standard normals for 'normal', uniforms in [0, 1) for
    'uniform'; stddevs in units of pi, like the reference CLI flags."""
    hs, vs = math.pi * horizontal_stddev, math.pi * vertical_stddev
    if camera_sampling == "normal":
        h = h_draw * hs + math.pi / 2
        v = v_draw * vs + math.pi / 2
    elif camera_sampling == "uniform":
        h = (h_draw * 2 - 1) * hs + math.pi / 2
        v = (v_draw * 2 - 1) * vs + math.pi / 2
    else:
        raise ValueError(f"camera_sampling {camera_sampling!r}")
    pose = pose_from_hv(h, v, radius)
    intr = fov_to_intrinsics(fov_deg.float())
    cp = torch.cat([pose.reshape(1, 16), intr.reshape(1, 9).to(pose.dtype)], dim=1)
    return cp, pose, h, v
