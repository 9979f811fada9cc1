"""3DGS EWA projection on channel vectors — port of
splat/projection.py (build_rotation, build_cov3d, project_channels,
project_gaussians).

Plain PyTorch; the slab decode kernel (csrc/slab_decode.cu) inlines the same
math per point. Everything is elementwise over (N,) vectors:

  view = p @ W, clip = p @ P_full, pix = ((ndc + 1) * size - 1) / 2
  Sigma2D = J V Sigma V^T J^T + 0.3 I, conic = inv(Sigma2D),
  radius = ceil(3 sqrt(max eigenvalue))
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..gaussians.cameras import Camera


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), normalised here -> rotation matrix (..., 3, 3)
    (ref general_utils.py:78-98)."""
    q = q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)) + 1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def build_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """(N, 3) activated scales and (N, 4) quaternions -> (N, 3, 3)
    covariance R S S^T R^T (ref gaussian_model.py:28-33)."""
    RS = build_rotation(rotations) * (scales * scale_modifier)[..., None, :]
    return RS @ RS.transpose(-1, -2)


def project_channels(cam: Camera, mx, my, mz, q, s, scale_modifier: float = 1.0,
                     cov3d6=None):
    """-> dict of (N,) tensors: px, py, depth, conic_a/b/c, radius_f, visible.
    cov3d6, the six upper-triangle entries (00, 01, 02, 11, 12, 22) of a
    precomputed 3D covariance, takes the place of q and s."""
    W = cam.world_view_transform
    P = cam.full_proj_transform

    def xform(Mt):
        return tuple(mx * Mt[0, j] + my * Mt[1, j] + mz * Mt[2, j] + Mt[3, j]
                     for j in range(4))

    view_x, view_y, view_z, _ = xform(W)
    clip_x, clip_y, _, clip_w = xform(P)
    p_w = 1.0 / (clip_w + 1e-7)
    in_front = view_z > 0.2

    px = ((clip_x * p_w + 1) * cam.image_width - 1) * 0.5
    py = ((clip_y * p_w + 1) * cam.image_height - 1) * 0.5

    focal_x = cam.image_width / (2.0 * cam.tanfovx)
    focal_y = cam.image_height / (2.0 * cam.tanfovy)
    tz = view_z
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    tx = torch.clamp(view_x / tz_safe, -limx, limx) * tz_safe
    ty = torch.clamp(view_y / tz_safe, -limy, limy) * tz_safe

    V = W[:3, :3].t()
    inv_z = 1.0 / tz_safe
    j00 = focal_x * inv_z
    j02 = -(focal_x * tx) * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -(focal_y * ty) * inv_z * inv_z
    u0 = j00 * V[0, 0] + j02 * V[2, 0]
    u1 = j00 * V[0, 1] + j02 * V[2, 1]
    u2 = j00 * V[0, 2] + j02 * V[2, 2]
    v0 = j11 * V[1, 0] + j12 * V[2, 0]
    v1 = j11 * V[1, 1] + j12 * V[2, 1]
    v2 = j11 * V[1, 2] + j12 * V[2, 2]

    if cov3d6 is None:
        r, x, y, z = q
        norm = torch.sqrt(r * r + x * x + y * y + z * z) + 1e-12
        r, x, y, z = r / norm, x / norm, y / norm, z / norm
        r00 = 1 - 2 * (y * y + z * z)
        r01 = 2 * (x * y - r * z)
        r02 = 2 * (x * z + r * y)
        r10 = 2 * (x * y + r * z)
        r11 = 1 - 2 * (x * x + z * z)
        r12 = 2 * (y * z - r * x)
        r20 = 2 * (x * z - r * y)
        r21 = 2 * (y * z + r * x)
        r22 = 1 - 2 * (x * x + y * y)
        s0, s1, s2 = (si * scale_modifier for si in s)
        m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
        m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
        m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
        s_00 = m00 * m00 + m01 * m01 + m02 * m02
        s_01 = m00 * m10 + m01 * m11 + m02 * m12
        s_02 = m00 * m20 + m01 * m21 + m02 * m22
        s_11 = m10 * m10 + m11 * m11 + m12 * m12
        s_12 = m10 * m20 + m11 * m21 + m12 * m22
        s_22 = m20 * m20 + m21 * m21 + m22 * m22
    else:
        s_00, s_01, s_02, s_11, s_12, s_22 = cov3d6

    su0 = s_00 * u0 + s_01 * u1 + s_02 * u2
    su1 = s_01 * u0 + s_11 * u1 + s_12 * u2
    su2 = s_02 * u0 + s_12 * u1 + s_22 * u2
    sv0 = s_00 * v0 + s_01 * v1 + s_02 * v2
    sv1 = s_01 * v0 + s_11 * v1 + s_12 * v2
    sv2 = s_02 * v0 + s_12 * v1 + s_22 * v2
    cov_a = u0 * su0 + u1 * su1 + u2 * su2 + 0.3
    cov_b = v0 * su0 + v1 * su1 + v2 * su2
    cov_c = v0 * sv0 + v1 * sv1 + v2 * sv2 + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det > 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    mid = 0.5 * (cov_a + cov_c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))
    visible = in_front & det_ok
    radius_f = torch.where(visible, radius_f, torch.zeros_like(radius_f))
    return dict(
        px=px, py=py, depth=view_z,
        conic_a=cov_c * det_inv, conic_b=-cov_b * det_inv, conic_c=cov_a * det_inv,
        radius_f=radius_f, visible=visible & (radius_f > 0),
    )


class ProjectedGaussians(NamedTuple):
    pix_xy: torch.Tensor    # (N, 2) pixel-space means
    depth: torch.Tensor     # (N,) view-space z
    conic: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor    # (N,) int32 screen radius, 0 when culled
    visible: torch.Tensor   # (N,) bool


def project_gaussians(cam: Camera, means3d: torch.Tensor, scales: torch.Tensor,
                      rotations: torch.Tensor, scale_modifier: float = 1.0,
                      cov3d_precomp: Optional[torch.Tensor] = None) -> ProjectedGaussians:
    """Row-major API over project_channels (the JAX package's
    project_gaussians): means3d (N, 3), scales (N, 3) activated, rotations
    (N, 4), cov3d_precomp (N, 3, 3) in place of scales and rotations."""
    cov6 = None
    if cov3d_precomp is not None:
        cov6 = tuple(cov3d_precomp[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1),
                                                          (1, 2), (2, 2)))
    ch = project_channels(cam, means3d[:, 0], means3d[:, 1], means3d[:, 2],
                          tuple(rotations[:, k] for k in range(4)),
                          tuple(scales[:, k] for k in range(3)), scale_modifier, cov3d6=cov6)
    return ProjectedGaussians(
        pix_xy=torch.stack([ch["px"], ch["py"]], dim=1), depth=ch["depth"],
        conic=torch.stack([ch["conic_a"], ch["conic_b"], ch["conic_c"]], dim=1),
        radius=ch["radius_f"].to(torch.int32), visible=ch["visible"])
