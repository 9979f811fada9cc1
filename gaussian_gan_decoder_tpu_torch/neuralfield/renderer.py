"""Plane axes, tri-grid and tri-plane feature sampling, the two-pass
importance renderer and the per-frame int8 slab volume — port of
neuralfield/renderer.py.

Plain PyTorch (the JAX functions are XLA-level too), except the tri-grid
brick-table build (neuralfield/pallas_expand.py, kernel K10).
build_slab_volume matches the JAX function bit for bit on equal f32 planes.

Two plane kinds: the PanoHead tri-grid (depth D > 1, trilinear taps over
the depth-stacked sub-volumes) and the EG3D tri-plane (depth 1, 2-D
bilinear taps, torch grid_sample semantics).

sample_from_planes has two routes. Without a table (the train step's and
the volume renderer's float route) each point gathers its 8 corners (4 on
a tri-plane) from the zero-padded channels-last volume, with the JAX
brick path's corner weights, validity masks and summation order, so the
result is the same and autograd's scatter carries the gradient back to the
planes. With table= (the inference brick route) it is the JAX brick path
itself: build_plane_table pre-expands each 2x2x2 (2x2) neighbourhood into
one table row (tri-grid: int8 with per-(plane, channel) absmax scales, or
the float dtype; tri-plane: the float dtype, bf16 on the decode route), and
_trilinear_sample_table / _bilinear_sample_table gather one row per point
and plane and combine the corners. sample_fused_inputs prepares the same
gathers for the gather-fused decode kernel K9.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .math_utils import get_ray_limits_box, linspace_batch
from .pallas_expand import build_brick_table
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
    XP*C) int8, scales (P, C) f32), DZ = D+2 (1 for depth-1 tri-planes,
    which have no z padding: the bilinear pack's z index is 0), YP =
    roundup(H+2, Y_ALIGN), XP = roundup(W+2, X_ALIGN). One zero voxel of
    leading pad per axis (the padded-index contract of the corner weights),
    trailing pad up to the alignment. Symmetric absmax scales per (plane,
    channel), the JAX function's clip_quantile=0 path (percentile scales
    are not ported)."""
    N, n_planes, CD, H, W = plane_features.shape
    assert N == 1, "slab volume is a per-frame (batch-1) structure"
    D = triplane_depth
    C = CD // D
    q8, scales = _quantize_int8(plane_features.float().reshape(n_planes, C, D, H, W))
    YP = -(-(H + 2) // Y_ALIGN) * Y_ALIGN
    XP = -(-(W + 2) // X_ALIGN) * X_ALIGN
    zp = 0 if D == 1 else 1
    DZ = D + 2 * zp
    vol = torch.zeros((n_planes, DZ, YP, XP, C), dtype=torch.int8,
                      device=plane_features.device)
    vol[:, zp:zp + D, 1:H + 1, 1:W + 1] = q8.permute(0, 2, 3, 4, 1)
    return vol.reshape(n_planes, DZ, YP, XP * C), scales


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


def _quantize_int8(feats: torch.Tensor):
    """Symmetric absmax int8 per (volume, channel): feats (B, C, ...) f32 ->
    (q8 int8, scales (B, C) f32), the JAX package's quantisation. The
    divisor is a tensor: PyTorch divides a CUDA tensor by a Python scalar
    as the product with its reciprocal, which can leave a scale one f32
    spacing off the quotient that the CPU and JAX take."""
    dims = tuple(range(2, feats.dim()))
    absmax = feats.abs().amax(dim=dims)
    scales = torch.clamp(absmax / absmax.new_full((), 127.0), min=1e-12)
    inv = (1.0 / scales).reshape(scales.shape + (1,) * len(dims))
    q8 = torch.clamp(torch.round(feats * inv), -127, 127).to(torch.int8)
    return q8, scales


def decode_brick_dtype(triplane_depth: int) -> torch.dtype:
    """The brick table's dtype on the decode's brick routes (the JAX
    decoder's _brick_dtype with int8_sampling): int8 on a tri-grid; bf16 on
    a depth-1 tri-plane, which has no int8 table."""
    return torch.int8 if triplane_depth > 1 else torch.bfloat16


PALLAS_BUILDS = (False, True, "select")


def build_plane_table(plane_features: torch.Tensor, triplane_depth: int, brick_dtype=None,
                      pallas_build=False):
    """The corner-brick table of the planes (N, 3, C*D, H, W), built once
    per frame. Tri-grid: brick_dtype torch.int8 quantises the raw volume
    with symmetric absmax scales per (plane, channel) and expands the int8
    volume -> (e, NY, scales (N*3, C) f32); a float brick_dtype (or None:
    the planes' dtype) -> (e, NY). The expansion is pallas_expand.
    build_brick_table (K10 on the card; on the CPU its plain version, the
    JAX package's XLA 8-slice concat with NY padded as K10 pads it):
    pallas_build False or True (the JAX XLA and Pallas builds of the same
    table) take K10's rotate form, "select" its select form (JAX
    _trilinear_table's pallas_build). Tri-plane (depth 1): a float table
    only, as in the JAX package -> (e,), e (N*3, (H+1)*(W+1), 4*C), built
    in plain PyTorch (_bilinear_table); pallas_build does not apply."""
    if pallas_build not in PALLAS_BUILDS:
        raise ValueError(f"pallas_build {pallas_build!r}: one of {PALLAS_BUILDS}")
    select = pallas_build == "select"
    N, n_planes, CD, H, W = plane_features.shape
    C, D = CD // triplane_depth, triplane_depth
    if D == 1:
        if brick_dtype == torch.int8:
            raise ValueError("int8 bricks exist for the tri-grid only; a depth-1 tri-plane "
                             "takes a float table (the decode route's bf16)")
        if brick_dtype is not None:
            plane_features = plane_features.to(brick_dtype)
        return _bilinear_table(plane_features.reshape(N * n_planes, C, H, W))
    if brick_dtype == torch.int8:
        q8, scales = _quantize_int8(plane_features.float().reshape(N * n_planes, C, D, H, W))
        e, NY = build_brick_table(q8, select=select)
        return e, NY, scales
    if brick_dtype is not None:
        plane_features = plane_features.to(brick_dtype)
    return build_brick_table(plane_features.reshape(N * n_planes, C, D, H, W), select=select)


def _bilinear_table(feats: torch.Tensor):
    """feats (B, C, H, W) -> (e,), e (B, (H+1)*(W+1), 4*C): each row the
    zero-padded 2x2 neighbourhood [f(y, x), f(y, x+1), f(y+1, x),
    f(y+1, x+1)] (the JAX package's _bilinear_table)."""
    B, C, H, W = feats.shape
    fcl = F.pad(feats, (1, 1, 1, 1)).permute(0, 2, 3, 1)        # (B, H+2, W+2, C)
    e = torch.cat([fcl[:, :-1, :-1], fcl[:, :-1, 1:], fcl[:, 1:, :-1], fcl[:, 1:, 1:]],
                  dim=-1)
    return (e.reshape(B, (H + 1) * (W + 1), 4 * C).contiguous(),)


def _bilinear_combine(corners, wx, wy, vx0, vx1, vy0, vy1):
    """The 4-corner combine of the JAX package's _bilinear_sample_table:
    corners [c00, c01, c10, c11] (M, C) -> sum_k c_k * mask_k (in the
    corners' dtype) * x weight * y weight, in that order."""
    m = lambda v: v[:, None].to(corners[0].dtype)  # noqa: E731
    wx, wy = wx[:, None], wy[:, None]
    c00, c01, c10, c11 = corners
    return (c00 * m(vy0 & vx0) * (1 - wx) * (1 - wy)
            + c01 * m(vy0 & vx1) * wx * (1 - wy)
            + c10 * m(vy1 & vx0) * (1 - wx) * wy
            + c11 * m(vy1 & vx1) * wx * wy)


def _bilinear_sample_table(table, C: int, H: int, W: int, grid: torch.Tensor):
    """table (e,) from _bilinear_table; grid (B, M, 2) in [-1, 1] -> (B, M,
    C): one row gather per point and plane, then _bilinear_combine (a bf16
    table's corners times their mask in bf16, then times the f32 weights,
    as JAX promotes them)."""
    (e,) = table
    ix, wx, vx0, vx1 = _corner_weights_1d(grid[..., 0], W)
    iy, wy, vy0, vy1 = _corner_weights_1d(grid[..., 1], H)
    idx = iy * (W + 1) + ix
    outs = []
    for b in range(e.shape[0]):
        rows = e[b][idx[b]]                                          # (M, 4C)
        outs.append(_bilinear_combine([rows[:, k * C:(k + 1) * C] for k in range(4)],
                                      wx[b], wy[b], vx0[b], vx1[b], vy0[b], vy1[b]))
    return torch.stack(outs)


def _trilinear_sample_table(table, C: int, D: int, H: int, W: int, grid: torch.Tensor):
    """table from build_plane_table ((e, NY) float or (e, NY, scales) int8);
    grid (B, M, 3) in [-1, 1] -> (B, M, C): per-plane row gathers, the
    8-corner combine in (dz, dy, dx) order (int8 corners cast to f32, float
    corners times their mask in the table's dtype, then times the grid's
    weights, as JAX promotes them), then the int8 dequant."""
    e, NY = table[0], table[1]
    scales = table[2] if len(table) > 2 else None
    ix, wx, vx0, vx1 = _corner_weights_1d(grid[..., 0], W)
    iy, wy, vy0, vy1 = _corner_weights_1d(grid[..., 1], H)
    iz, wz, vz0, vz1 = _corner_weights_1d(grid[..., 2], D)
    idx = (iz * NY + iy) * (W + 1) + ix
    wdt = torch.float32 if scales is not None else e.dtype
    wzs = ((1 - wz)[..., None], wz[..., None])
    wys = ((1 - wy)[..., None], wy[..., None])
    wxs = ((1 - wx)[..., None], wx[..., None])
    vz, vy, vx = (vz0, vz1), (vy0, vy1), (vx0, vx1)
    outs = []
    for b in range(e.shape[0]):
        rows = e[b][idx[b]]                                          # (M, 8C)
        out = 0.0
        k = 0
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    m = (vz[dz][b] & vy[dy][b] & vx[dx][b])[:, None].to(wdt)
                    out = out + (rows[:, k * C:(k + 1) * C].to(wdt) * m
                                 * wzs[dz][b] * wys[dy][b] * wxs[dx][b])
                    k += 1
        if scales is not None:
            out = out * scales[b][None, :]
        outs.append(out)
    return torch.stack(outs)


def sample_from_planes(plane_axes: np.ndarray, plane_features: torch.Tensor,
                       coordinates: torch.Tensor, box_warp: float,
                       triplane_depth: int, table=None, pallas_build=False) -> torch.Tensor:
    """Probe of the planes at world coords (torch grid_sample semantics,
    align_corners=False, zeros padding): trilinear on a tri-grid (D > 1),
    bilinear on a tri-plane (D == 1, the plane-local z ignored);
    plane_features (N, 3, C*D, H, W), coordinates (N, M, 3) -> (N,
    n_planes, M, C).

    With table (build_plane_table's output, reused across calls) it samples
    the brick table: f32 out for int8 bricks, the planes' dtype otherwise.
    Without it it gathers the corners directly, in the planes' dtype,
    differentiably, unless pallas_build (True or "select") asks for a
    tri-grid table: then it builds the planes' float table as
    build_plane_table does (K10's rotate or select form) and samples it, as
    the JAX function does (no gradient through the kernel)."""
    N, n_planes, CD, H, W = plane_features.shape
    M = coordinates.shape[1]
    D = triplane_depth
    C = CD // D
    proj = project_onto_planes(plane_axes, (2.0 / box_warp) * coordinates)
    proj = proj.reshape(N * n_planes, M, 3)
    if table is None and pallas_build and D > 1:
        table = build_plane_table(plane_features, D, pallas_build=pallas_build)
    if D == 1:
        return _sample_tri_plane(plane_features, proj, table).reshape(
            N, n_planes, M, C).to(plane_features.dtype)
    if table is not None:
        out = _trilinear_sample_table(table, C, D, H, W, proj)
        out_dtype = torch.float32 if len(table) > 2 else plane_features.dtype
        return out.reshape(N, n_planes, M, C).to(out_dtype)
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


def _sample_tri_plane(plane_features, proj, table=None):
    """Bilinear probe of depth-1 planes (N, 3, C, H, W) at plane-local
    coords proj (N*3, M, 3) -> (N*3, M, C): through the table when given,
    else the 4 corners gathered from the zero-padded channels-last planes
    (the same values and combine as the table: differentiable)."""
    N, n_planes, C, H, W = plane_features.shape
    B = N * n_planes
    if table is not None:
        return _bilinear_sample_table(table, C, H, W, proj[..., :2])
    fcl = F.pad(plane_features.reshape(B, C, H, W), (1, 1, 1, 1)).permute(0, 2, 3, 1)
    fcl = fcl.reshape(B, (H + 2) * (W + 2), C)
    ix, wx, vx0, vx1 = _corner_weights_1d(proj[..., 0], W)
    iy, wy, vy0, vy1 = _corner_weights_1d(proj[..., 1], H)
    outs = []
    for b in range(B):
        corners = [fcl[b, (iy[b] + dy) * (W + 2) + ix[b] + dx]
                   for dy in (0, 1) for dx in (0, 1)]
        outs.append(_bilinear_combine(corners, wx[b], wy[b], vx0[b], vx1[b], vy0[b], vy1[b]))
    return torch.stack(outs)


def sample_fused_inputs(plane_axes: np.ndarray, plane_features: torch.Tensor,
                        coordinates: torch.Tensor, box_warp: float, triplane_depth: int,
                        pad_to: int, table=None, pallas_build=False):
    """Inputs of the gather-fused decode (decoder/pallas_heads.py::
    decode_project_fused, kernel K9) for one scene, from the plane table
    (built here when table is None, with pallas_build as build_plane_table
    takes it: int8 on a tri-grid, bf16 on a depth-1 tri-plane, the JAX
    decoder's brick dtypes): plane_features (1, 3, C*D,
    H, W), coordinates (1, M, 3) -> (rows, wts, scale_rows), with K = 8
    corners per tap on a tri-grid and 4 on a tri-plane:

      rows       - n_planes brick-row gathers (Mpad, K*C), int8 (tri-grid)
                   or bf16 (tri-plane), the index padded with row 0 up to
                   Mpad = pad_to;
      wts        - (WR, Mpad) f32 channel-major corner weights, row p*K + c
                   the mask-folded weight of corner c of plane p (the
                   products the table samplers use), WR =
                   roundup(n_planes*K, 8), pad columns zero;
      scale_rows - (n_planes, C) f32: the int8 dequant scales with the
                   1/n_planes plane mean folded in, or the plane mean alone
                   for a float table (what the JAX kernel's 'bcast' lerp
                   recovers from its segment matrices). The 'dots' lerp
                   rounds it to bf16 where it applies it (K9 and its plain
                   version), as the JAX kernel rounds its segment matrices
                   (smats) before its segment-sum product."""
    N, n_planes, CD, H, W = plane_features.shape
    if N != 1:
        raise ValueError("fused sampling is single-scene (the decode hot path)")
    M = coordinates.shape[1]
    C, D = CD // triplane_depth, triplane_depth
    Mpad = pad_to
    if Mpad < M:
        raise ValueError(f"pad_to {Mpad} < {M} points")
    proj = project_onto_planes(plane_axes, (2.0 / box_warp) * coordinates).reshape(
        n_planes, M, 3)
    if table is None:
        table = build_plane_table(plane_features, triplane_depth,
                                  brick_dtype=decode_brick_dtype(D), pallas_build=pallas_build)
    e = table[0]
    K = 8 if D > 1 else 4

    def w01(w, v0, v1):
        zero = torch.zeros_like(w)
        return torch.where(v0, 1.0 - w, zero), torch.where(v1, w, zero)

    rows, wcols = [], []
    for b in range(n_planes):
        g = proj[b]
        ix, wx, vx0, vx1 = _corner_weights_1d(g[:, 0], W)
        iy, wy, vy0, vy1 = _corner_weights_1d(g[:, 1], H)
        ax, ay = w01(wx, vx0, vx1), w01(wy, vy0, vy1)
        if K == 8:
            iz, wz, vz0, vz1 = _corner_weights_1d(g[:, 2], D)
            az = w01(wz, vz0, vz1)
            wcols += [az[dz] * ay[dy] * ax[dx] for dz in (0, 1) for dy in (0, 1)
                      for dx in (0, 1)]
            idx = (iz * table[1] + iy) * (W + 1) + ix
        else:
            wcols += [ay[dy] * ax[dx] for dy in (0, 1) for dx in (0, 1)]
            idx = iy * (W + 1) + ix
        rows.append(e[b][F.pad(idx, (0, Mpad - M))])
    WR = -(-(n_planes * K) // 8) * 8
    wts = F.pad(torch.stack([w.float() for w in wcols]), (0, Mpad - M, 0, WR - n_planes * K))
    if K == 8:
        scale_rows = table[2] / n_planes
    else:
        scale_rows = torch.full((n_planes, C), 1.0 / n_planes, device=e.device)
    return rows, wts.contiguous(), scale_rows.contiguous()


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
    """Two-pass (coarse + importance) volume renderer. 'panohead': the
    tri-grid, rays limited by the box ('auto'), xyz composited beside rgb,
    triplane crop at 0.1. 'eg3d': the tri-plane, no xyz tracking or crop,
    the composited rgb mapped to (-1, 1) (the EG3D marcher); both take
    explicit ray limits (EG3D's 2.25 / 3.3) as well as 'auto'."""

    plane_variant: str = "panohead"

    @property
    def plane_axes(self) -> np.ndarray:
        return generate_planes(self.plane_variant)

    def run_model(self, planes, decoder_fn: Callable, coords, opts: Dict) -> Dict:
        """Probe the planes (through opts['plane_table'], build_plane_table's
        output, when there is one) and decode."""
        feats = sample_from_planes(self.plane_axes, planes, coords, opts["box_warp"],
                                   opts["triplane_depth"], table=opts.get("plane_table"))
        out = decoder_fn(feats)
        out["xyz"] = coords
        return out

    def __call__(self, draws: RenderDraws, planes, decoder_fn: Callable, ray_origins,
                 ray_directions, opts: Dict, triplane_crop: Optional[float] = 0.1):
        """-> (rgb (N, R, C), depth (N, R, 1), weight sum (N, R, 1)). The
        coarse and the importance passes probe one table, opts['plane_table']
        (build_plane_table's output), when the caller hands one; without it
        they sample the planes directly."""
        if self.plane_variant not in ("panohead", "eg3d"):
            raise ValueError(f"unknown plane variant {self.plane_variant!r}")
        track_xyz = self.plane_variant == "panohead"
        S = opts["depth_resolution"]
        if opts["ray_start"] == opts["ray_end"] == "auto":
            ray_start, ray_end = get_ray_limits_box(ray_origins, ray_directions,
                                                    box_side_length=opts["box_warp"])
            ok = ray_end > ray_start
            if bool(ok.any()):
                inf = torch.full_like(ray_start, float("inf"))
                rs_min = torch.where(ok, ray_start, inf).min()
                rs_max = torch.where(ok, ray_start, -inf).max()
                ray_start = torch.where(ok, ray_start, rs_min)
                ray_end = torch.where(ok, ray_end, rs_max)
            d = linspace_batch(ray_start, ray_end, S).permute(1, 2, 0, 3)   # (N, R, S, 1)
            delta = (ray_end - ray_start) / (S - 1)
            depths_coarse = d + draws.stratified * delta[..., None]
        else:
            # one depth range for every ray (the JAX package's scalar limits)
            rs, re = float(opts["ray_start"]), float(opts["ray_end"])
            base = torch.linspace(rs, re, S, dtype=ray_origins.dtype, device=ray_origins.device)
            depths_coarse = base.reshape(1, 1, S, 1) + draws.stratified * ((re - rs) / (S - 1))
        N, R = depths_coarse.shape[:2]

        def probe(depths, n):
            coords = (ray_origins[:, :, None, :] + depths * ray_directions[:, :, None, :]
                      ).reshape(N, -1, 3)
            out = self.run_model(planes, decoder_fn, coords, opts)
            dens = out["sigma"]
            if track_xyz and triplane_crop:
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
        if not track_xyz:
            rgb, depth, w = mip_ray_march(all_c, all_s, all_d, rgb_to_minus1_1=True)
            return rgb, depth, w.sum(2)
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
