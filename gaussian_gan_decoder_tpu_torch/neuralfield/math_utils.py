"""Ray/box math — port of neuralfield/math_utils.py."""
from __future__ import annotations

import torch


def normalize_vecs(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def get_ray_limits_box(rays_o: torch.Tensor, rays_d: torch.Tensor, box_side_length: float):
    """Entry/exit distances of rays vs the centred cube -> (tmin, tmax), each
    with a trailing dim of 1; rays that miss get (-1, -2)."""
    half = box_side_length / 2
    invdir = 1.0 / rays_d
    t0 = (-half - rays_o) * invdir
    t1 = (half - rays_o) * invdir
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    ok = tmin <= tmax
    tmin = torch.where(ok, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(ok, tmax, torch.full_like(tmax, -2.0))
    return tmin[..., None], tmax[..., None]


def linspace_batch(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """(num, *start.shape) evenly spaced start..stop inclusive."""
    steps = torch.arange(num, dtype=start.dtype, device=start.device) / (num - 1)
    steps = steps.reshape((num,) + (1,) * start.ndim)
    return start[None] + steps * (stop - start)[None]
