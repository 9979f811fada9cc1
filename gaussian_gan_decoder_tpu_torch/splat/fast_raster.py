"""Fast frame rasterization: GPU binning + the tile-blend kernel — port of
splat/fast_raster.py::render_rows.

The JAX package bins with static copies, an overflow lane and a
lexicographic lax.sort, all shaped by the TPU (1-D channel layouts, sorts
that stream payloads, slow gathers). The port bins the way the reference
CUDA rasterizer does, in plain PyTorch:

  1. per-Gaussian tile rect (`_tile_rects_ch`, the CUDA getRect);
  2. keep visible Gaussians whose rect has area > 0;
  3. per-Gaussian pair counts -> exclusive scan;
  4. duplicate into (tile, Gaussian) pairs, tile = y * grid_x + x, k the
     pair's rank in its Gaussian's rect (the JAX copy / overflow cell);
  5. one 64-bit key: tile << 32 | bits(max(depth, 1e-6)) — positive f32
     depths order like their int32 bit patterns, all 32 bits kept — or,
     with the fused sort key, the JAX 32-bit key tile << 21 | bits >> 11,
     either above the copy class min(k, copies) (static_copies with the
     fused key or not, the JAX default 4), so that depth ties keep the JAX
     stable sort's order (copy class, then Gaussian); the fused key's
     2^-12 relative depth makes them frequent;
  6. one stable sort of the keys;
  7. gather the payload words field-major (blend ROWS order) in the
     config's format (the per-Gaussian words packed once, before the
     gather; the packed formats' tile-local pixel word after the sort,
     from each pair's tile);
  8. tile_starts = searchsorted of the sorted tiles.

render_rows keeps every pair that exists (n_dropped is always 0); the
blend (splat/pallas_blend.py::blend_tiles) then reads each tile's first
tile_capacity pairs, like the JAX kernel. rasterize_fast keeps only those
pairs in binning (each tile's first tile_capacity), which bounds its
payload and K4's entries by the budget; its n_pairs counts them.

Payload formats (RasterizeConfig.payload_format; the JAX word layouts of
build_pairs_packed and bin_pairs_lexsort_ch, f32-bitcast words):

  f32          9: px, py, ca, cb, cc, op, r, g, b
  bf16_colors  7: px, py, ca, cb, cc, r|g, b|op       (bf16 pairs)
  packed_v2    5: pxl|pyl, ca|cb, cc, r|g, b|op       (int16 1/32 px, f16 conic * 4096)
  packed_v3    4: pxl|pyl, ca|cb, cc|op, rgb10        (rgb 10 bits each, step 1/256)

rasterize_fast is the decoder-path rasterizer; differentiable: projection
by autograd, binning as above on detached values, the f32 payload gathered
from the per-Gaussian fields by the sorted pair index (autograd of that
gather routes each pair's gradient back to its Gaussian: the inverse
permutation of the JAX package's _sort_pairs), and the training blend
(pallas_blend.blend_tiles_diff: kernels K4 / K5); not differentiable, the
frame blend (K3) in the config's payload format.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..decoder.pallas_heads import PROJ_ROWS
from ..gaussians.cameras import Camera
from ..gaussians.sh import sh_to_color
from .pallas_blend import PAYLOAD_ROWS, blend_tiles, blend_tiles_diff
from .projection import project_channels
from .rasterize import RasterizeConfig

_BLEND_FIELDS = ("px", "py", "conic_a", "conic_b", "conic_c", "opac",
                 "col_r", "col_g", "col_b")

# fixed-point step of the packed tile-local pixel coordinates: 1/32 px over
# +-1024 px (i16_pack_pair)
PXY_SCALE = 32.0
# the f16 conic pre-scale: shifts f16's normal range to [1.5e-8, 16], so
# that flat giant Gaussians (conic ~1e-6) stay normal (f16_pack_pair)
CONIC_SCALE = 4096.0
RGB10_SCALE = 256.0   # packed_v3 colour step, 1/256 over [0, 1023/256]
# the fused key: the tile in its top 11 bits, above the top 21 bits of the
# depth's f32 pattern; the copy class below it in the sort key
FUSED_TILE_BITS = 11
FUSED_DEPTH_SHIFT = 11
CLASS_BITS = 8


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.float().contiguous().view(torch.int32)


def _as_word(i: torch.Tensor) -> torch.Tensor:
    return i.to(torch.int32).contiguous().view(torch.float32)


def bf16_pack_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 vectors -> one f32-bitcast word bf16(a) << 16 | bf16(b),
    each rounded half up (+0x8000 on its bit pattern): JAX _bf16_pack_pair."""
    hi = (_bits(a) + 0x8000) & -65536
    lo = ((_bits(b) + 0x8000) >> 16) & 0xFFFF
    return _as_word(hi | lo)


def i16_pack_pair(a: torch.Tensor, b: torch.Tensor, scale: float = PXY_SCALE) -> torch.Tensor:
    """Two f32 vectors -> one word of two int16 fixed-point values (a high,
    b low), round(x * scale) clamped to +-32767: JAX _i16_pack_pair."""
    ai = torch.clamp(torch.round(a * scale), -32767, 32767).to(torch.int32)
    bi = torch.clamp(torch.round(b * scale), -32767, 32767).to(torch.int32)
    return _as_word((ai << 16) | (bi & 0xFFFF))


def _half_bits(x: torch.Tensor, scale: float) -> torch.Tensor:
    y = torch.clamp(x * scale, -65504.0, 65504.0)
    b = _bits(y)
    s = (b >> 16) & 0x8000
    babs = (b & 0x7FFFFFFF) + 0x1000          # round half up at bit 13
    e = (babs >> 23) - 112                    # the f16 exponent
    m = (babs >> 13) & 0x3FF
    bits = torch.where(e <= 0, torch.zeros_like(e), (e << 10) | m)   # subnormals -> 0
    bits = torch.where(e >= 31, torch.full_like(e, 0x7BFF), bits)    # max finite
    return s | bits


def f16_pack_pair(a: torch.Tensor, b: torch.Tensor, scale: float = CONIC_SCALE) -> torch.Tensor:
    """Two f32 vectors -> one word of two IEEE-half patterns of x * scale
    (a high, b low), subnormals flushed to zero, clamped to 0x7BFF: JAX
    _f16_pack_pair."""
    return _as_word((_half_bits(a, scale) << 16) | _half_bits(b, scale))


def rgb10_pack(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Three colour channels -> one word of 10-bit fixed point each (r high,
    b low), round(v * 256) clamped to [0, 1023]: JAX _rgb10_pack."""
    def q(v):
        return torch.clamp(torch.round(v * RGB10_SCALE), 0, 1023).to(torch.int32)
    return _as_word((q(r) << 20) | (q(g) << 10) | q(b))


def gaussian_words(fields: Sequence[torch.Tensor], fmt: str) -> torch.Tensor:
    """The 9 per-Gaussian blend fields (px, py, ca, cb, cc, op, r, g, b) ->
    the words of the payload that do not depend on the pair's tile, (n, N)
    f32-bitcast: all of them but the packed formats' pixel word."""
    if fmt == "f32":
        return torch.stack(list(fields))
    # the packed words carry no gradient (the training blend reads f32)
    px, py, ca, cb, cc, op, r, g, b = (f.detach() for f in fields)
    if fmt == "bf16_colors":
        return torch.stack([px, py, ca, cb, cc, bf16_pack_pair(r, g), bf16_pack_pair(b, op)])
    if fmt == "packed_v2":
        return torch.stack([f16_pack_pair(ca, cb), cc, bf16_pack_pair(r, g),
                            bf16_pack_pair(b, op)])
    if fmt == "packed_v3":
        return torch.stack([f16_pack_pair(ca, cb), f16_pack_pair(cc, op), rgb10_pack(r, g, b)])
    raise ValueError(f"payload format {fmt!r}: one of {sorted(PAYLOAD_ROWS)}")


def pair_payload(fields: Sequence[torch.Tensor], pair: torch.Tensor, tile: torch.Tensor,
                 grid_x: int, tile_size: int, fmt: str) -> torch.Tensor:
    """The sorted pairs' payload, (PAYLOAD_ROWS[fmt], P) field-major: the
    per-Gaussian words gathered by pair; for the packed formats, first the
    tile-local pixel word i16_pack_pair(px - tile_x * ts, py - tile_y * ts)
    of each pair's tile."""
    words = gaussian_words(fields, fmt)[:, pair]
    if fmt not in ("packed_v2", "packed_v3"):
        return words
    tx = ((tile % grid_x) * tile_size).float()
    ty = ((tile // grid_x) * tile_size).float()
    pxy = i16_pack_pair(fields[0].detach()[pair].float() - tx,
                        fields[1].detach()[pair].float() - ty)
    return torch.cat([pxy[None], words])


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
                tile_size: int, max_k: Optional[int] = None, fused_key: bool = False,
                copies: int = RasterizeConfig.static_copies):
    """Per-Gaussian channel vectors -> (tile_starts (T+1,) int32, pair_index
    (Ptot,) int64, tile (Ptot,) int64): the Gaussian and the tile of every
    (tile, Gaussian) pair, in (tile, depth) order. With max_k, only each
    tile's first max_k pairs, the ones a blend with that budget reads.
    fused_key sorts by the JAX fused 32-bit key, else by the full key;
    copies (the JAX static_copies) caps the tie-order class (module
    docstring)."""
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
    qdepth = torch.clamp(depth, min=1e-6).contiguous().view(torch.int32)[pair_g].long()
    if not fused_key:
        if T >= 2 ** (31 - CLASS_BITS):
            raise ValueError(f"{T} tiles: the sort key holds the tile in {31 - CLASS_BITS} bits")
        primary, tile_shift = (tile << 32) | qdepth, 32 + CLASS_BITS
    else:
        if T >= 2 ** FUSED_TILE_BITS:
            raise ValueError(f"{T} tiles: the fused sort key holds the tile in "
                             f"{FUSED_TILE_BITS} bits")
        primary = (tile << (32 - FUSED_TILE_BITS)) | (qdepth >> FUSED_DEPTH_SHIFT)
        tile_shift = 32 - FUSED_TILE_BITS + CLASS_BITS
    if not 0 <= copies < 2 ** CLASS_BITS:
        raise ValueError(f"static_copies {copies}: 0 .. {2 ** CLASS_BITS - 1}")
    # ties of the primary key: copy class first, then (the stable sort's
    # pre-sort order) the Gaussian, as the JAX stable sort of its copies
    key = (primary << CLASS_BITS) | torch.clamp(k, max=copies)
    key_sorted, order = torch.sort(key, stable=True)
    tile_sorted = (key_sorted >> tile_shift).contiguous()
    tile_starts = torch.searchsorted(tile_sorted, torch.arange(T + 1, device=px.device))
    pair = pair_g[order]
    if max_k is not None:
        keep = torch.arange(total, device=px.device) - tile_starts[tile_sorted] < max_k
        counts = torch.clamp(tile_starts[1:] - tile_starts[:-1], max=max_k)
        tile_starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        pair, tile_sorted = pair[keep], tile_sorted[keep]
    return tile_starts.to(torch.int32), pair, tile_sorted


def bin_pairs(rows: torch.Tensor, grid_x: int, grid_y: int, tile_size: int,
              config: Optional[RasterizeConfig] = None):
    """decode rows (NROWS, Mpad) -> (tile_starts (T+1,) int32, attrs
    (PAYLOAD_ROWS[fmt], Ptot) f32-bitcast words field-major in (tile, depth)
    order), in config's payload format and sort key (f32 and the 64-bit
    key without a config)."""
    config = config or RasterizeConfig(tile_size=tile_size)
    r = {k: rows[v] for k, v in PROJ_ROWS.items()}
    tile_starts, pair, tile = bin_indices(r["px"], r["py"], r["radius_f"], r["depth"],
                                          r["visible"] > 0.5, grid_x, grid_y, tile_size,
                                          fused_key=config.fused_key,
                                          copies=config.static_copies)
    attrs = pair_payload([r[f] for f in _BLEND_FIELDS], pair, tile, grid_x, tile_size,
                         config.payload_format)
    return tile_starts, attrs.contiguous()


def _blend_and_assemble(tile_starts, attrs, grid_x, grid_y, ts, bg, config,
                        differentiable=False):
    if differentiable:
        accum, trans = blend_tiles_diff(tile_starts, attrs, grid_x, grid_y, ts,
                                        max_k=config.tile_capacity)
    else:
        accum, trans = blend_tiles(tile_starts, attrs, grid_x, grid_y, ts,
                                   max_k=config.tile_capacity,
                                   payload_format=config.payload_format,
                                   mxu_power=config.mxu_power)
    H, W = grid_y * ts, grid_x * ts
    img = accum + trans[:, :, None] * bg[None, None, :]
    img = img.reshape(grid_y, grid_x, ts, ts, 3).permute(0, 2, 1, 3, 4).reshape(H, W, 3)
    alpha = (1.0 - trans).reshape(grid_y, grid_x, ts, ts).permute(0, 2, 1, 3).reshape(H, W)
    return img, alpha


def render_rows(cam: Camera, rows: torch.Tensor, bg: torch.Tensor,
                config: RasterizeConfig = RasterizeConfig(),
                stage_timer=None) -> Dict[str, torch.Tensor]:
    """Fused decode rows -> frame: binning + blend, in config's payload
    format and sort key. stage_timer, when given, is called with 'binning'
    and 'blend' as each stage is issued. Per-slot outputs (radii,
    visibility) are the caller's: it knows the slot order."""
    ts = config.tile_size
    grid_x, grid_y = cam.image_width // ts, cam.image_height // ts
    tile_starts, attrs = bin_pairs(rows, grid_x, grid_y, ts, config)
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
    tile_capacity)}: the JAX package's rasterize_fast. differentiable blends
    with the training kernels (K4 / K5) on f32 payloads, as the JAX one
    does; otherwise with the frame blend (K3, 16x16 tiles only) in config's
    payload format and sort key, forward only. The frame path is
    render_rows."""
    ts = config.tile_size
    grid_x, grid_y = cam.image_width // ts, cam.image_height // ts
    if opacities.ndim == 2:
        opacities = opacities[:, 0]
    if differentiable:
        config = dataclasses.replace(config, bf16_colors=False, packed_payloads=False)
    ch = project_channels(
        cam, means3d[:, 0], means3d[:, 1], means3d[:, 2],
        tuple(rotations[:, k] for k in range(4)),
        tuple(scales[:, k] for k in range(3)))
    colors = sh_to_color(0, shs.transpose(1, 2), means3d, cam.camera_center)
    # each tile's pairs past tile_capacity are never blended: dropping them
    # here bounds the payload and K4's entries by the budget
    tile_starts, pair, tile = bin_indices(ch["px"], ch["py"], ch["radius_f"], ch["depth"],
                                          ch["visible"], grid_x, grid_y, ts,
                                          config.tile_capacity, config.fused_key,
                                          config.static_copies)
    fields = [ch["px"], ch["py"], ch["conic_a"], ch["conic_b"], ch["conic_c"],
              opacities, colors[:, 0], colors[:, 1], colors[:, 2]]
    attrs = pair_payload(fields, pair, tile, grid_x, ts, config.payload_format)
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
