"""Plane axes, tri-grid feature sampling, the two-pass importance renderer
and the per-frame int8 slab volume — port of neuralfield/renderer.py.

All plain PyTorch (the JAX functions are XLA-level too). build_slab_volume
matches the JAX function bit for bit on equal f32 planes. sample_from_planes
is the float brick path (build_plane_table + the trilinear table sample):
the JAX package pre-expands each 2x2x2 corner neighbourhood into one table
row because a TPU gathers rows at a fixed cost; here each point gathers its
8 corners from the zero-padded channels-last volume, with the same corner
weights, validity masks and summation order (dz, dy, dx), so the result is
the same and autograd's scatter carries the gradient back to the planes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .math_utils import get_ray_limits_box, linspace_batch
from .ray_marcher import mip_ray_march

Y_ALIGN = 8   # slab volume row padding (YP)
X_ALIGN = 4   # slab volume column padding (XP)


def generate_planes(variant: str = "panohead") -> np.ndarray:
    """Plane axis triples (3, 3, 3). variant in {'panohead', 'eg3d'}."""
    if variant == "panohead":
        return np.array(
            [
                [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
                [[0, 1, 0], [0, 0, 1], [1, 0, 0]],
            ],
            dtype=np.float32,
        )
    return np.array(
        [
            [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
            [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
            [[0, 0, 1], [1, 0, 0], [0, 1, 0]],
        ],
        dtype=np.float32,
    )


def build_slab_volume(
    plane_features: torch.Tensor,   # (1, n_planes, C*D, H, W)
    triplane_depth: int,
):
    """Channels-last int8 volume for the slab decode -> (vol (P, DZ, YP,
    XP*C) int8, scales (P, C) f32), DZ = D+2, YP = roundup(H+2, Y_ALIGN),
    XP = roundup(W+2, X_ALIGN). One zero voxel of leading pad per axis (the
    padded-index contract of the corner weights), trailing pad up to the
    alignment. Symmetric absmax scales per (plane, channel), the JAX
    function's clip_quantile=0 path (percentile scales are not ported)."""
    N, n_planes, CD, H, W = plane_features.shape
    assert N == 1, "slab volume is a per-frame (batch-1) structure"
    D = triplane_depth
    if D < 2:
        raise NotImplementedError("the bilinear (depth-1, EG3D) slab variant is not ported")
    C = CD // D
    feats = plane_features.float().reshape(n_planes, C, D, H, W)
    absmax = feats.abs().amax(dim=(2, 3, 4))
    scales = torch.clamp(absmax / 127.0, min=1e-12)                 # (P, C)
    q = feats * (1.0 / scales)[:, :, None, None, None]
    q8 = torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    YP = -(-(H + 2) // Y_ALIGN) * Y_ALIGN
    XP = -(-(W + 2) // X_ALIGN) * X_ALIGN
    vol = torch.zeros((n_planes, D + 2, YP, XP, C), dtype=torch.int8,
                      device=plane_features.device)
    vol[:, 1:D + 1, 1:H + 1, 1:W + 1] = q8.permute(0, 2, 3, 4, 1)
    return vol.reshape(n_planes, D + 2, YP, XP * C), scales


def project_onto_planes(plane_axes: np.ndarray, coordinates: torch.Tensor) -> torch.Tensor:
    """(N, M, 3) coords -> (N, n_planes, M, 3) plane-local coords."""
    inv = torch.tensor(np.linalg.inv(plane_axes), dtype=coordinates.dtype,
                       device=coordinates.device)
    return torch.einsum("nmc,pcd->npmd", coordinates, inv)


def _corner_weights_1d(g, size):
    """align_corners=False: padded index clip(x0 + 1, 0, size), weight of
    the upper corner, validity of the two corners."""
    x = ((g + 1.0) * size - 1.0) * 0.5
    x0 = torch.floor(x)
    w1 = x - x0
    x0 = x0.long()
    v0 = (x0 >= 0) & (x0 < size)
    v1 = (x0 + 1 >= 0) & (x0 + 1 < size)
    return torch.clamp(x0 + 1, 0, size), w1, v0, v1


def sample_from_planes(plane_axes: np.ndarray, plane_features: torch.Tensor,
                       coordinates: torch.Tensor, box_warp: float,
                       triplane_depth: int) -> torch.Tensor:
    """Trilinear probe of the tri-grid at world coords (torch grid_sample
    semantics, align_corners=False, zeros padding): plane_features (N, 3,
    C*D, H, W), coordinates (N, M, 3) -> (N, n_planes, M, C)."""
    N, n_planes, CD, H, W = plane_features.shape
    M = coordinates.shape[1]
    D = triplane_depth
    if D < 2:
        raise NotImplementedError("the bilinear (depth-1, EG3D) tri-plane sample is not ported")
    C = CD // D
    proj = project_onto_planes(plane_axes, (2.0 / box_warp) * coordinates)
    proj = proj.reshape(N * n_planes, M, 3)
    fcl = plane_features.reshape(N * n_planes, C, D, H, W).permute(0, 2, 3, 4, 1)
    fcl = F.pad(fcl, (0, 0, 1, 1, 1, 1, 1, 1)).reshape(N * n_planes, -1, C)
    ix, wx, vx0, vx1 = _corner_weights_1d(proj[..., 0], W)
    iy, wy, vy0, vy1 = _corner_weights_1d(proj[..., 1], H)
    iz, wz, vz0, vz1 = _corner_weights_1d(proj[..., 2], D)
    wdt = plane_features.dtype
    wzs = ((1 - wz)[..., None], wz[..., None])
    wys = ((1 - wy)[..., None], wy[..., None])
    wxs = ((1 - wx)[..., None], wx[..., None])
    vz, vy, vx = (vz0, vz1), (vy0, vy1), (vx0, vx1)
    b = torch.arange(N * n_planes, device=coordinates.device)[:, None]
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx = ((iz + dz) * (H + 2) + iy + dy) * (W + 2) + ix + dx
                rows = fcl[b, idx]                                  # (B, M, C)
                m = (vz[dz] & vy[dy] & vx[dx])[..., None].to(wdt)
                out = out + rows * m * wzs[dz] * wys[dy] * wxs[dx]
    return out.reshape(N, n_planes, M, C)


def triplane_crop_mask(xyz: torch.Tensor, thresh: float, boxwarp: float,
                       allow_bottom: bool = True) -> torch.Tensor:
    """True where the density is masked: outside the cropped box."""
    flip = torch.tensor([-1.0, 1.0, -1.0], dtype=xyz.dtype, device=xyz.device)
    p = xyz * flip
    lim = boxwarp / 2 - thresh
    inside_xz = (p[..., [0, 2]].abs() <= lim).all(dim=-1, keepdim=True)
    ans = inside_xz
    if allow_bottom:
        ans = ans | ((p[..., 1:2] <= -lim) & inside_xz)
    return ~ans


def unify_samples(d1, c1, s1, x1, d2, c2, s2, x2):
    """Merge coarse and fine samples and sort them by depth (stable)."""
    d = torch.cat([d1, d2], dim=-2)
    c = torch.cat([c1, c2], dim=-2)
    x = torch.cat([x1, x2], dim=-2)
    s = torch.cat([s1, s2], dim=-2)
    idx = torch.argsort(d, dim=-2, stable=True)

    def gather(a):
        return torch.gather(a, -2, idx.expand(*a.shape[:-1], a.shape[-1]))

    return gather(d), gather(c), gather(s), gather(x)


def sample_pdf(u: torch.Tensor, bins: torch.Tensor, weights: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF sampling: u (B, n) uniform draws, bins (B, S+1) mid-bin
    positions, weights (B, S) -> (B, n) samples."""
    B, S = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=S)
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_b, bins_a = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


@dataclass(frozen=True)
class RenderDraws:
    """The renderer's random draws as named tensors (the JAX package takes
    them from the stratified and importance keys)."""
    stratified: torch.Tensor    # (N, R, S, 1) uniform [0, 1): coarse jitter
    importance: torch.Tensor    # (N * R, S_importance) uniform [0, 1): pdf draws

    @staticmethod
    def make(generator: torch.Generator, N: int, R: int, S: int, S_imp: int, device):
        return RenderDraws(
            torch.rand((N, R, S, 1), generator=generator, device=device),
            torch.rand((N * R, S_imp), generator=generator, device=device))


@dataclass(frozen=True)
class ImportanceRenderer:
    """Two-pass (coarse + importance) volume renderer of the PanoHead tri-grid
    (xyz composited beside rgb, triplane crop at 0.1)."""

    plane_variant: str = "panohead"

    @property
    def plane_axes(self) -> np.ndarray:
        return generate_planes(self.plane_variant)

    def run_model(self, planes, decoder_fn: Callable, coords, opts: Dict) -> Dict:
        feats = sample_from_planes(self.plane_axes, planes, coords, opts["box_warp"],
                                   opts["triplane_depth"])
        out = decoder_fn(feats)
        out["xyz"] = coords
        return out

    def __call__(self, draws: RenderDraws, planes, decoder_fn: Callable, ray_origins,
                 ray_directions, opts: Dict, triplane_crop: Optional[float] = 0.1):
        """-> (rgb (N, R, C), depth (N, R, 1), weight sum (N, R, 1))."""
        if self.plane_variant != "panohead" or not (opts["ray_start"] == opts["ray_end"]
                                                    == "auto"):
            raise NotImplementedError("the port renders the PanoHead tri-grid with auto "
                                      "ray limits only")
        ray_start, ray_end = get_ray_limits_box(ray_origins, ray_directions,
                                                box_side_length=opts["box_warp"])
        ok = ray_end > ray_start
        if bool(ok.any()):
            inf = torch.full_like(ray_start, float("inf"))
            rs_min = torch.where(ok, ray_start, inf).min()
            rs_max = torch.where(ok, ray_start, -inf).max()
            ray_start = torch.where(ok, ray_start, rs_min)
            ray_end = torch.where(ok, ray_end, rs_max)
        S = opts["depth_resolution"]
        d = linspace_batch(ray_start, ray_end, S).permute(1, 2, 0, 3)   # (N, R, S, 1)
        delta = (ray_end - ray_start) / (S - 1)
        depths_coarse = d + draws.stratified * delta[..., None]
        N, R = depths_coarse.shape[:2]

        def probe(depths, n):
            coords = (ray_origins[:, :, None, :] + depths * ray_directions[:, :, None, :]
                      ).reshape(N, -1, 3)
            out = self.run_model(planes, decoder_fn, coords, opts)
            dens = out["sigma"]
            if triplane_crop:
                mask = triplane_crop_mask(out["xyz"], triplane_crop, opts["box_warp"])
                dens = torch.where(mask, torch.full_like(dens, -1e3), dens)
            return (out["rgb"].reshape(N, R, n, -1), dens.reshape(N, R, n, 1),
                    out["xyz"].reshape(N, R, n, 3))

        colors_c, dens_c, xyz_c = probe(depths_coarse, S)
        n_imp = opts["depth_resolution_importance"]
        _, _, weights = mip_ray_march(colors_c, dens_c, depths_coarse)
        depths_fine = self.sample_importance(draws.importance, depths_coarse, weights, n_imp)
        colors_f, dens_f, xyz_f = probe(depths_fine, n_imp)
        all_d, all_c, all_s, all_x = unify_samples(depths_coarse, colors_c, dens_c, xyz_c,
                                                   depths_fine, colors_f, dens_f, xyz_f)
        rgb, depth, w = mip_ray_march(torch.cat([all_c, all_x], dim=-1), all_s, all_d)
        return rgb[..., :-3], depth, w.sum(2)

    @staticmethod
    def sample_importance(u, z_vals, weights, n_importance):
        """PDF importance resampling of the coarse depths (no gradient)."""
        N, R, S, _ = z_vals.shape
        z = z_vals.reshape(N * R, S)
        w = weights.reshape(N * R, -1)
        ninf = torch.full_like(w[:, :1], float("-inf"))
        w_pad = torch.cat([ninf, w, ninf], dim=1)
        w_max = torch.maximum(w_pad[:, :-1], w_pad[:, 1:])
        w_smooth = (w_max[:, :-1] + w_max[:, 1:]) / 2 + 0.01
        z_mid = (z[:, :-1] + z[:, 1:]) / 2
        samples = sample_pdf(u[:, :n_importance], z_mid, w_smooth[:, 1:-1])
        return samples.detach().reshape(N, R, n_importance, 1)
