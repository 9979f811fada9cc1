"""Explicit 3DGS scene — port of gaussians/model.py: inverse_sigmoid,
GaussianScene, gaussian_scene_from_decoded, create_from_points and
build_covariance. Adaptive density control at fixed capacity is
gaussians/densify.py.

Raw storage conventions (the reference GaussianModel's): xyz (N, 3),
features_dc (N, 1, 3), features_rest (N, K-1, 3), scaling (N, 3) log-scale,
rotation (N, 4) unnormalised quaternion, opacity (N, 1) logit; activations
exp / normalise / sigmoid.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..ops.knn import mean_sq_dist_to_knn
from .sh import rgb_to_sh


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


def create_from_points(points: torch.Tensor, colors: Optional[torch.Tensor] = None,
                       sh_degree: int = 0, opacity_init: float = 0.1) -> GaussianScene:
    """Point-cloud initialisation (ref create_from_pcd, gaussian_model.py:
    130-152): log-scale from the mean 3-NN squared distance, identity
    rotations, inverse-sigmoid(opacity_init) opacity."""
    n, dev, dt = points.shape[0], points.device, points.dtype
    k = (sh_degree + 1) ** 2
    if colors is None:
        colors = torch.full((n, 3), 0.5, dtype=dt, device=dev)
    fused_color = rgb_to_sh(torch.clamp(colors, 0, 1))
    dist2 = torch.clamp(mean_sq_dist_to_knn(points, k=3), min=1e-7)
    rots = torch.zeros((n, 4), dtype=dt, device=dev)
    rots[:, 0] = 1.0
    return GaussianScene(
        xyz=points, features_dc=fused_color[:, None, :],
        features_rest=torch.zeros((n, k - 1, 3), dtype=dt, device=dev),
        scaling=torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3), rotation=rots,
        opacity=inverse_sigmoid(torch.full((n, 1), opacity_init, dtype=dt, device=dev)),
        valid=torch.ones((n,), dtype=torch.bool, device=dev),
        max_sh_degree=sh_degree, active_sh_degree=0)


def build_covariance(scene: GaussianScene, scaling_modifier: float = 1.0) -> torch.Tensor:
    """Upper-triangle (N, 6) covariance (ref get_covariance, :28-33, 126)."""
    from ..splat.projection import build_cov3d

    cov = build_cov3d(scene.get_scaling, scene.rotation, scaling_modifier)
    return torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                        cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], dim=1)
