"""Fast frame rasterization: GPU binning + the tile-blend kernel — port of
splat/fast_raster.py::render_rows.

The JAX package bins with static copies, an overflow lane and a
lexicographic lax.sort, all shaped by the TPU (1-D channel layouts, sorts
that stream payloads, slow gathers). The port bins the way the reference
CUDA rasterizer does, in plain PyTorch:

  1. per-Gaussian tile rect (`_tile_rects_ch`, the CUDA getRect);
  2. keep visible Gaussians whose rect has area > 0;
  3. per-Gaussian pair counts -> exclusive scan;
  4. duplicate into (tile, Gaussian) pairs, tile = y * grid_x + x;
  5. one 64-bit key tile << 32 | bits(max(depth, 1e-6)) — positive f32
     depths order like their int32 bit patterns, all 32 bits kept;
  6. one stable sort of the keys;
  7. gather the 9 f32 payload fields field-major (blend ROWS order);
  8. tile_starts = searchsorted of the sorted tiles.

Every pair that exists is kept, so n_dropped is always 0. The blend
(splat/pallas_blend.py::blend_tiles) then truncates each tile to
tile_capacity pairs, like the JAX kernel.

rasterize_fast is the decoder-path rasterizer; differentiable: projection
by autograd, binning as above on detached values, the payload gathered from
the per-Gaussian fields by the sorted pair index (autograd of that gather
routes each pair's gradient back to its Gaussian: the inverse permutation
of the JAX package's _sort_pairs), and the training blend
(pallas_blend.blend_tiles_diff: kernels K4 / K5); not differentiable, the
frame blend (K3).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..decoder.pallas_heads import PROJ_ROWS
from ..gaussians.cameras import Camera
from ..gaussians.sh import sh_to_color
from .pallas_blend import blend_tiles, blend_tiles_diff
from .projection import project_channels
from .rasterize import RasterizeConfig

_BLEND_FIELDS = ("px", "py", "conic_a", "conic_b", "conic_c", "opac",
                 "col_r", "col_g", "col_b")


def _to_i32(v):
    # f32 -> i32 truncation toward zero, saturating like XLA's convert
    v = torch.nan_to_num(v, nan=0.0).clamp(-2.0 ** 30, 2.0 ** 30)
    return v.to(torch.int32)


def _tile_rects_ch(px, py, radius_f, grid_x, grid_y, tile_size):
    """CUDA getRect on channel vectors: clamped tile spans."""
    x0 = torch.clamp(_to_i32((px - radius_f) / tile_size), 0, grid_x)
    y0 = torch.clamp(_to_i32((py - radius_f) / tile_size), 0, grid_y)
    x1 = torch.clamp(_to_i32((px + radius_f + tile_size - 1) / tile_size), 0, grid_x)
    y1 = torch.clamp(_to_i32((py + radius_f + tile_size - 1) / tile_size), 0, grid_y)
    return x0, y0, torch.clamp(x1 - x0, min=0), torch.clamp(y1 - y0, min=0)


@torch.no_grad()
def bin_indices(px, py, radius_f, depth, visible, grid_x: int, grid_y: int,
                tile_size: int, max_k: Optional[int] = None):
    """Per-Gaussian channel vectors -> (tile_starts (T+1,) int32, pair_index
    (Ptot,) int64): the Gaussian of every (tile, Gaussian) pair, in (tile,
    depth) order. With max_k, only each tile's first max_k pairs, the ones
    a blend with that budget reads."""
    T = grid_x * grid_y
    x0, y0, rw, rh = _tile_rects_ch(px, py, radius_f, grid_x, grid_y, tile_size)
    area = rw * rh
    gid = torch.nonzero(visible & (area > 0)).squeeze(1)
    counts = area[gid].long()
    offs = torch.cumsum(counts, 0) - counts
    total = int(counts.sum()) if counts.numel() else 0
    pair_g = torch.repeat_interleave(gid, counts, output_size=total)
    k = torch.arange(total, device=px.device) - torch.repeat_interleave(
        offs, counts, output_size=total)
    rw_p = rw[pair_g].long()
    tile = (y0[pair_g].long() + k // rw_p) * grid_x + x0[pair_g].long() + k % rw_p
    qdepth = torch.clamp(depth, min=1e-6).contiguous().view(torch.int32)
    key = (tile << 32) | qdepth[pair_g].long()
    key_sorted, order = torch.sort(key, stable=True)
    tile_sorted = (key_sorted >> 32).contiguous()
    tile_starts = torch.searchsorted(tile_sorted, torch.arange(T + 1, device=px.device))
    pair = pair_g[order]
    if max_k is not None:
        keep = torch.arange(total, device=px.device) - tile_starts[tile_sorted] < max_k
        counts = torch.clamp(tile_starts[1:] - tile_starts[:-1], max=max_k)
        tile_starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        pair = pair[keep]
    return tile_starts.to(torch.int32), pair


def bin_pairs(rows: torch.Tensor, grid_x: int, grid_y: int, tile_size: int):
    """decode rows (NROWS, Mpad) -> (tile_starts (T+1,) int32, attrs
    (9, Ptot) f32 field-major in (tile, depth) order)."""
    r = {k: rows[v] for k, v in PROJ_ROWS.items()}
    tile_starts, pair = bin_indices(r["px"], r["py"], r["radius_f"], r["depth"],
                                    r["visible"] > 0.5, grid_x, grid_y, tile_size)
    attrs = torch.stack([r[f] for f in _BLEND_FIELDS])[:, pair].contiguous()
    return tile_starts, attrs


def _blend_and_assemble(tile_starts, attrs, grid_x, grid_y, ts, bg, config,
                        differentiable=False):
    blend = blend_tiles_diff if differentiable else blend_tiles
    accum, trans = blend(tile_starts, attrs, grid_x, grid_y, ts, max_k=config.tile_capacity)
    H, W = grid_y * ts, grid_x * ts
    img = accum + trans[:, :, None] * bg[None, None, :]
    img = img.reshape(grid_y, grid_x, ts, ts, 3).permute(0, 2, 1, 3, 4).reshape(H, W, 3)
    alpha = (1.0 - trans).reshape(grid_y, grid_x, ts, ts).permute(0, 2, 1, 3).reshape(H, W)
    return img, alpha


def render_rows(cam: Camera, rows: torch.Tensor, bg: torch.Tensor,
                config: RasterizeConfig = RasterizeConfig(),
                stage_timer=None) -> Dict[str, torch.Tensor]:
    """Fused decode rows -> frame: binning + blend. stage_timer, when given,
    is called with 'binning' and 'blend' as each stage is issued. Per-slot
    outputs (radii, visibility) are the caller's: it knows the slot order."""
    ts = config.tile_size
    grid_x, grid_y = cam.image_width // ts, cam.image_height // ts
    tile_starts, attrs = bin_pairs(rows, grid_x, grid_y, ts)
    if stage_timer is not None:
        stage_timer("binning")
    img, alpha = _blend_and_assemble(tile_starts, attrs, grid_x, grid_y, ts, bg, config)
    if stage_timer is not None:
        stage_timer("blend")
    return {
        "render": img.permute(2, 0, 1),
        "alpha": alpha[None],
        "n_dropped": 0,
        "n_pairs": attrs.shape[1],
    }


def rasterize_fast(cam: Camera, means3d: torch.Tensor, scales: torch.Tensor,
                   rotations: torch.Tensor, opacities: torch.Tensor, shs: torch.Tensor,
                   bg: torch.Tensor, config: RasterizeConfig = RasterizeConfig(),
                   differentiable: bool = True) -> Dict[str, torch.Tensor]:
    """Tiled rasterizer of (N, ...) Gaussians with degree-0 SH colours (shs
    (N, 1, 3)) -> {render (3, H, W), alpha (1, H, W), radii,
    visibility_filter, n_dropped, n_pairs (those blended: each tile's first
    tile_capacity)}: the JAX package's
    rasterize_fast. differentiable blends with the training kernels (K4 /
    K5); otherwise with the frame blend (K3, 16x16 tiles only), forward
    only. The frame path is render_rows."""
    ts = config.tile_size
    grid_x, grid_y = cam.image_width // ts, cam.image_height // ts
    if opacities.ndim == 2:
        opacities = opacities[:, 0]
    ch = project_channels(
        cam, means3d[:, 0], means3d[:, 1], means3d[:, 2],
        tuple(rotations[:, k] for k in range(4)),
        tuple(scales[:, k] for k in range(3)))
    colors = sh_to_color(0, shs.transpose(1, 2))
    # each tile's pairs past tile_capacity are never blended: dropping them
    # here bounds the payload and K4's entries by the budget
    tile_starts, pair = bin_indices(ch["px"], ch["py"], ch["radius_f"], ch["depth"],
                                    ch["visible"], grid_x, grid_y, ts, config.tile_capacity)
    fields = torch.stack([ch["px"], ch["py"], ch["conic_a"], ch["conic_b"], ch["conic_c"],
                          opacities, colors[:, 0], colors[:, 1], colors[:, 2]])
    attrs = fields[:, pair]
    img, alpha = _blend_and_assemble(tile_starts, attrs, grid_x, grid_y, ts, bg, config,
                                     differentiable=differentiable)
    return {
        "render": img.permute(2, 0, 1),
        "alpha": alpha[None],
        "radii": ch["radius_f"].detach().to(torch.int32),
        "visibility_filter": ch["visible"],
        "n_dropped": 0,
        "n_pairs": attrs.shape[1],
    }
