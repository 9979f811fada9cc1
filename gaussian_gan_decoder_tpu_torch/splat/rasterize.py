"""Rasterizer configuration, the differentiable f32 tile rasterizer and its
all-pairs oracle, and the decoder-path renderer — port of
splat/rasterize.py (RasterizeConfig, rasterize, reference_rasterize,
render_simple on every backend).

rasterize is the JAX package's 'xla' backend in plain PyTorch,
differentiated by autograd: project, one depth sort, duplication into
(tile, Gaussian) pairs under the max_pairs budget (the pairs past it, the
farthest Gaussians', are dropped and counted in n_dropped), one stable
sort by tile, a (tiles, tile_capacity) index matrix, then the front-to-back
blend over the capacity axis in chunks of `chunk`, each chunk recomputed
in the backward (torch.utils.checkpoint, as the JAX scan rematerialises).
It is XLA-level code in JAX, not a Pallas kernel, so it has no CUDA
kernel. reference_rasterize blends every Gaussian at every pixel (test
use).

The fast path (splat/fast_raster.py) bins with one stable 64-bit key sort
over exactly the pairs that exist, so max_pairs and chunk are read by
rasterize alone and the JAX overflow_budget has no counterpart: the fast
path never drops a pair for want of room. Its payload options are the JAX
ones, with the JAX defaults (all off) and constraints:
  * bf16_colors: (r, g) and (b, opacity) as bf16 pairs (7 payload words);
  * packed_payloads: tile-local int16 pixel coordinates (1/32 px), f16
    conics, bf16 colours (5 words, 'packed_v2'); supersedes bf16_colors;
  * rgb10_payloads (with packed_payloads): cc|op as an f16 pair and rgb in
    one 10-bit fixed-point word (4 words, 'packed_v3');
  * fused_sort_key (with packed_payloads): the 32-bit key tile << 21 |
    depth-bits >> 11 (2^-12 relative depth); its frequent depth ties keep
    the JAX sort's order, copy class (a pair's rank in its Gaussian's tile
    rect, capped at static_copies) first, then the Gaussian;
  * blend_mxu_power (with packed_payloads): the blend's falloff as the
    quadratic polynomial of the pixel's tile-local coordinates.

static_copies (the JAX structural copies) is read only as that tie-order
class cap. The training blend (rasterize_fast(differentiable=True), K4 /
K5) reads f32 payloads whatever the config, as the JAX one does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..gaussians.sh import sh_to_color
from .projection import project_gaussians


@dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 16
    tile_capacity: int = 1024   # per-tile depth-ordered blend budget (max_k)
    static_copies: int = 4      # the fused key's tie-order class cap
    bf16_colors: bool = False
    packed_payloads: bool = False
    fused_sort_key: bool = False
    blend_mxu_power: bool = False
    rgb10_payloads: bool = False
    max_pairs: int = 2 ** 21    # rasterize: the (tile, Gaussian) pair budget
    chunk: int = 64             # rasterize: the blend's capacity-axis chunk

    @property
    def payload_format(self) -> str:
        """The blend's payload format, as the JAX _blend_and_assemble picks
        it: 'packed_v3', 'packed_v2', 'bf16_colors' or 'f32'."""
        if self.packed_payloads:
            return "packed_v3" if self.rgb10_payloads else "packed_v2"
        return "bf16_colors" if self.bf16_colors else "f32"

    @property
    def fused_key(self) -> bool:
        """Whether binning sorts by the fused 32-bit key (packed formats only)."""
        return self.fused_sort_key and self.packed_payloads

    @property
    def mxu_power(self) -> bool:
        """Whether the blend takes the quadratic-basis falloff (packed only)."""
        return self.blend_mxu_power and self.packed_payloads


def _tile_rects(pix_xy, radius, grid_x: int, grid_y: int, tile_size: int):
    """CUDA getRect: inclusive-exclusive tile spans, clamped to the grid ->
    (x0, y0, width, height) int32."""
    def span(v, lo):
        return torch.clamp((v / tile_size).to(torch.int32), 0, lo)
    x0 = span(pix_xy[:, 0] - radius, grid_x)
    y0 = span(pix_xy[:, 1] - radius, grid_y)
    x1 = span(pix_xy[:, 0] + radius + tile_size - 1, grid_x)
    y1 = span(pix_xy[:, 1] + radius + tile_size - 1, grid_y)
    return x0, y0, torch.clamp(x1 - x0, min=0), torch.clamp(y1 - y0, min=0)


def _blend_chunk(accum, trans, ids, pixx, pixy, feat):
    """One capacity chunk of the blend: ids (T, chunk) Gaussian ids, -1 pad;
    feat (N, 9) the sorted Gaussians' (x, y, conic a, b, c, opacity, rgb);
    accum (T, P, 3), trans (T, P) -> the updated (accum, trans). One
    index_select gathers the chunk's rows: its backward adds into the rows
    (index_add_), so the pads, all clamped to row 0, do not serialise the
    backward as advanced indexing's sort-based accumulation would."""
    T, n = ids.shape
    f = feat.index_select(0, torch.clamp(ids, min=0).reshape(-1)).reshape(T, n, -1)
    dx = f[:, :, 0:1] - pixx[:, None, :]                       # (T, chunk, P)
    dy = f[:, :, 1:2] - pixy[:, None, :]
    power = (-0.5 * (f[:, :, 2:3] * dx * dx + f[:, :, 4:5] * dy * dy)
             - f[:, :, 3:4] * dx * dy)
    alpha = torch.clamp(f[:, :, 5:6] * torch.exp(power), max=0.99)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(power > 0.0, zero, alpha)              # CUDA skip
    alpha = torch.where(alpha < 1.0 / 255.0, zero, alpha)      # CUDA skip
    alpha = torch.where((ids >= 0)[:, :, None], alpha, zero)
    cp = torch.cumprod(1.0 - alpha, dim=1)
    t_within = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
    w = alpha * t_within * trans[:, None, :]
    return accum + torch.einsum("tkp,tkc->tpc", w, f[:, :, 6:9]), trans * cp[:, -1]


def _blend_tiles(idx_mat, pix_xy, conic, colors, opacities, grid_x: int, tile_size: int,
                 chunk: int):
    """Front-to-back alpha blend of the (T, K) depth-ordered index matrix,
    over the capacity axis in chunks; each chunk is recomputed in the
    backward -> (accum (T, P, 3), trans (T, P))."""
    T, K = idx_mat.shape
    if K % chunk:
        raise ValueError(f"tile_capacity {K} must be a multiple of chunk {chunk}")
    dev, dt = pix_xy.device, pix_xy.dtype
    tiles = torch.arange(T, device=dev)
    ox = torch.arange(tile_size, device=dev, dtype=dt)
    py_in, px_in = torch.meshgrid(ox, ox, indexing="ij")
    pixx = (tiles % grid_x).to(dt)[:, None] * tile_size + px_in.reshape(1, -1)   # (T, P)
    pixy = (tiles // grid_x).to(dt)[:, None] * tile_size + py_in.reshape(1, -1)
    accum = torch.zeros((T, tile_size * tile_size, 3), device=dev, dtype=dt)
    trans = torch.ones((T, tile_size * tile_size), device=dev, dtype=dt)
    feat = torch.cat([pix_xy, conic, opacities[:, None], colors], dim=1)
    grad = torch.is_grad_enabled() and feat.requires_grad
    for c in range(0, K, chunk):
        args = (accum, trans, idx_mat[:, c:c + chunk], pixx, pixy, feat)
        accum, trans = (checkpoint(_blend_chunk, *args, use_reentrant=False) if grad
                        else _blend_chunk(*args))
    return accum, trans


def rasterize(cam, means3d: torch.Tensor, scales: torch.Tensor, rotations: torch.Tensor,
              opacities: torch.Tensor, colors_precomp: Optional[torch.Tensor] = None,
              shs: Optional[torch.Tensor] = None, sh_degree: int = 0,
              bg: Optional[torch.Tensor] = None, scale_modifier: float = 1.0,
              cov3d_precomp: Optional[torch.Tensor] = None,
              config: RasterizeConfig = RasterizeConfig(),
              means2d_offset: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The differentiable f32 tile rasterizer (the JAX package's 'xla'
    backend) -> {render (3, H, W), alpha (1, H, W), radii (N,) int32,
    visibility_filter (N,), n_dropped (pairs past max_pairs, an int),
    n_pairs (pairs blended: within max_pairs and each tile's first
    tile_capacity)}. shs (N, K_sh, 3) at sh_degree 0..3 when colors_precomp
    is not given, viewed along means3d - cam.camera_center; means2d_offset (N, 2) is added to the pixel means (its
    gradient is the screen-space mean gradient)."""
    N = means3d.shape[0]
    H, W = cam.image_height, cam.image_width
    ts = config.tile_size
    if H % ts or W % ts:
        raise ValueError(f"image {H}x{W} is not a whole number of {ts}-pixel tiles")
    grid_x, grid_y = W // ts, H // ts
    T, K = grid_x * grid_y, config.tile_capacity
    dev = means3d.device
    if opacities.ndim == 2:
        opacities = opacities[:, 0]
    if bg is None:
        bg = torch.zeros(3, device=dev)
    proj = project_gaussians(cam, means3d, scales, rotations, scale_modifier, cov3d_precomp)
    pix_xy = proj.pix_xy if means2d_offset is None else proj.pix_xy + means2d_offset
    colors = (sh_to_color(sh_degree, shs.transpose(1, 2), means3d, cam.camera_center)
              if colors_precomp is None else colors_precomp)

    # -- the global depth sort (invisible Gaussians last) --------------------
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.visible, proj.depth, inf).detach(), stable=True)
    pix_s, conic_s = pix_xy[order], proj.conic[order]
    col_s, op_s = colors[order], opacities[order]
    radius_s, vis_s = proj.radius[order], proj.visible[order]

    # -- duplication into (tile, Gaussian) pairs, the first max_pairs --------
    x0, y0, rw, rh = _tile_rects(pix_s.detach(), radius_s.float(), grid_x, grid_y, ts)
    counts = torch.where(vis_s, rw * rh, torch.zeros_like(rw)).long()
    offsets = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    n_kept = min(total, config.max_pairs)
    # each Gaussian's count cut to what is left of the budget at its offset:
    # the first n_kept pairs of the full expansion, and no more, are built
    kept = torch.clamp(torch.minimum(counts, config.max_pairs - offsets), min=0)
    pair_g = torch.repeat_interleave(torch.arange(N, device=dev), kept, output_size=n_kept)
    local = torch.arange(n_kept, device=dev) - offsets[pair_g]
    rw_g = torch.clamp(rw[pair_g], min=1).long()
    tile_id = (y0[pair_g] + local // rw_g) * grid_x + x0[pair_g] + local % rw_g

    # -- per-tile segments (the stable sort keeps the depth order) -----------
    sorted_tile, pair_order = torch.sort(tile_id, stable=True)
    sorted_g = pair_g[pair_order]
    tile_start = torch.searchsorted(sorted_tile, torch.arange(T, device=dev))
    rank = torch.arange(n_kept, device=dev) - tile_start[sorted_tile]
    keep = rank < K
    idx_flat = torch.full((T * K,), -1, dtype=torch.long, device=dev)
    idx_flat[(sorted_tile * K + rank)[keep]] = sorted_g[keep]

    accum, trans = _blend_tiles(idx_flat.reshape(T, K), pix_s, conic_s, col_s, op_s, grid_x,
                                ts, config.chunk)
    img = accum + trans[:, :, None] * bg[None, None, :]
    img = img.reshape(grid_y, grid_x, ts, ts, 3).permute(0, 2, 1, 3, 4).reshape(H, W, 3)
    alpha = (1.0 - trans).reshape(grid_y, grid_x, ts, ts).permute(0, 2, 1, 3).reshape(H, W)
    return {
        "render": img.permute(2, 0, 1),
        "alpha": alpha[None],
        "radii": proj.radius,
        "visibility_filter": proj.radius > 0,
        "n_dropped": max(0, total - config.max_pairs),
        "n_pairs": int(keep.sum()),
    }


def reference_rasterize(cam, means3d, scales, rotations, opacities, colors, bg=None,
                        scale_modifier: float = 1.0) -> torch.Tensor:
    """Exact all-pairs oracle (no tiles, no capacity) for small scenes ->
    (3, H, W): the full depth sort, then a front-to-back blend of every
    Gaussian at every pixel of its 16-pixel-tile footprint, as the CUDA
    per-pixel loop does. O(N H W) — test use only."""
    H, W = cam.image_height, cam.image_width
    dev = means3d.device
    if opacities.ndim == 2:
        opacities = opacities[:, 0]
    if bg is None:
        bg = torch.zeros(3, device=dev)
    proj = project_gaussians(cam, means3d, scales, rotations, scale_modifier)
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.visible, proj.depth, inf).detach(), stable=True)
    pix, con, vis = proj.pix_xy[order], proj.conic[order], proj.visible[order]
    col, op, rad = colors[order], opacities[order], proj.radius[order].float()
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    dx = pix[:, 0, None, None] - xs[None]
    dy = pix[:, 1, None, None] - ys[None]
    power = (-0.5 * (con[:, 0, None, None] * dx * dx + con[:, 2, None, None] * dy * dy)
             - con[:, 1, None, None] * dx * dy)
    alpha = torch.clamp(op[:, None, None] * torch.exp(power), max=0.99)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(power > 0.0, zero, alpha)
    alpha = torch.where(alpha < 1.0 / 255.0, zero, alpha)
    ts = 16.0
    tpx, tpy = torch.floor(xs / ts)[None], torch.floor(ys / ts)[None]
    gx0 = torch.floor((pix[:, 0] - rad) / ts)[:, None, None]
    gx1 = torch.floor((pix[:, 0] + rad + ts - 1) / ts)[:, None, None]
    gy0 = torch.floor((pix[:, 1] - rad) / ts)[:, None, None]
    gy1 = torch.floor((pix[:, 1] + rad + ts - 1) / ts)[:, None, None]
    inside = (tpx >= gx0) & (tpx < gx1) & (tpy >= gy0) & (tpy < gy1)
    alpha = torch.where(vis[:, None, None] & inside, alpha, zero)
    one_minus = 1.0 - alpha
    t_excl = torch.cat([torch.ones_like(one_minus[:1]), torch.cumprod(one_minus, 0)[:-1]])
    img = torch.einsum("nhw,nc->chw", alpha * t_excl, col)
    return img + torch.prod(one_minus, 0)[None] * bg[:, None, None]


BACKENDS = ("pallas_diff", "pallas", "xla")


def render_simple(cam, decoded: Dict[str, torch.Tensor], bg: torch.Tensor,
                  config: Optional[RasterizeConfig] = None,
                  backend: str = "pallas_diff") -> Dict[str, torch.Tensor]:
    """Decoder-path renderer (ref gaussian_renderer/__init__.py:105-186):
    decoded carries the RAW decoder outputs {xyz, scale, rotation, opacity,
    color}; scales exp, opacity sigmoid, colour the degree-0 SH feature,
    rotation normalised in the projection. backend 'pallas_diff' (the
    port's default: the training path the kernels serve) blends with the
    training kernels (K4 / K5, differentiable), 'pallas' with the frame
    blend (K3, forward only: the JAX rasterize_fast(differentiable=
    False)), 'xla' (the JAX function's default) with rasterize, the
    differentiable f32 tile rasterizer in plain PyTorch."""
    from .fast_raster import rasterize_fast

    if backend not in BACKENDS:
        raise ValueError(f"render_simple backend {backend!r}: one of {BACKENDS}")
    args = (cam, decoded["xyz"], torch.exp(decoded["scale"]), decoded["rotation"],
            torch.sigmoid(decoded["opacity"]))
    shs = decoded["color"][:, None, :]
    if backend == "xla":
        return rasterize(*args, shs=shs, sh_degree=0, bg=bg, config=config or RasterizeConfig())
    return rasterize_fast(*args, shs, bg, config or RasterizeConfig(),
                          differentiable=backend == "pallas_diff")
