"""Explicit 3DGS scene — port of the part of gaussians/model.py the decoder
path needs: inverse_sigmoid, GaussianScene and gaussian_scene_from_decoded.
The classic 3DGS model (densify, optimizer surgery) is ROADMAP queue A6.

Raw storage conventions (the reference GaussianModel's): xyz (N, 3),
features_dc (N, 1, 3), features_rest (N, K-1, 3), scaling (N, 3) log-scale,
rotation (N, 4) unnormalised quaternion, opacity (N, 1) logit; activations
exp / normalise / sigmoid.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


class GaussianScene(NamedTuple):
    xyz: torch.Tensor            # (N, 3)
    features_dc: torch.Tensor    # (N, 1, 3)
    features_rest: torch.Tensor  # (N, K-1, 3)
    scaling: torch.Tensor        # (N, 3) log
    rotation: torch.Tensor       # (N, 4)
    opacity: torch.Tensor        # (N, 1) logit
    valid: torch.Tensor          # (N,) bool: capacity mask
    max_sh_degree: int = 0
    active_sh_degree: int = 0

    @property
    def get_scaling(self):
        return torch.exp(self.scaling)

    @property
    def get_rotation(self):
        return self.rotation / (torch.linalg.norm(self.rotation, dim=-1, keepdim=True) + 1e-12)

    @property
    def get_xyz(self):
        return self.xyz

    @property
    def get_features(self):
        if self.active_sh_degree == 0:
            return self.features_dc
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def get_opacity(self):
        # invalid slots render as fully transparent
        o = torch.sigmoid(self.opacity)
        return o * self.valid[:, None].to(o.dtype)

    @property
    def num_points(self):
        return self.xyz.shape[0]


def gaussian_scene_from_decoded(decoded: Dict[str, torch.Tensor],
                                sh_degree: int = 0) -> GaussianScene:
    """A scene from the raw decoder outputs, as the reference training loop
    fills one (main/train_pano2gaussian_decoder.py:222-227)."""
    xyz = decoded["xyz"]
    n = xyz.shape[0]
    k = (sh_degree + 1) ** 2
    color = decoded["color"]
    return GaussianScene(
        xyz=xyz, features_dc=color[:, None, :],
        features_rest=torch.zeros((n, k - 1, 3), dtype=color.dtype, device=color.device),
        scaling=decoded["scale"], rotation=decoded["rotation"], opacity=decoded["opacity"],
        valid=torch.ones((n,), dtype=torch.bool, device=xyz.device),
        max_sh_degree=sh_degree, active_sh_degree=0)
