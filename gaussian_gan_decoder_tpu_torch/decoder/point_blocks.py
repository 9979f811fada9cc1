"""Static point-block packing for the slab-gather decode path — numpy copy
of gaussian_gan_decoder_tpu/decoder/point_blocks.py (host code, run once
per template; copied, not imported, so the port never loads jax).

The port keeps the packing (slot order, validity, compact indices) and
drops build_slab_weights: its slab decode kernel reads the 8 corners (4 on
a depth-1 tri-plane) of each plane straight from the int8 channels-last
volume at the compact padded indices, with the corner weights recomputed
in f32 from the slot position (decoder/pallas_heads.py).

The flagship frame decodes a FIXED template of points every frame (only
the latent changes), so the tri-grid access pattern is static: the
template is Morton-sorted once and consecutive points are packed into
blocks whose per-plane tri-grid footprint fits a slab window (DZW
z-slices x EY rows x EX cells). The port keeps this packing bit for bit
(its slot order, padding and validity define the decode rows the JAX
package is compared against); the Morton order also keeps one kernel
block's volume reads local. Point order is irrelevant downstream
(Gaussians are depth-sorted by the rasterizer).

Index semantics mirror the JAX renderer's _corner_weights_1d
(grid_sample align_corners=False + zeros padding): padded-axis index
clip(floor(x) + 1, 0, size) plus per-corner validity bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

C = 32           # feature channels per plane
DZW = 4          # slab z window (DZW * EY must be 128: one MXU K-tile)
EY = 32          # slab y rows
EX = 20          # slab x cells (EX*C = 640 lanes; Morton cubes of 1024
#                  flagship points span ~16 cells/axis — ex=16 usable
#                  width is 12 after alignment and fragments 5x)
Y_ALIGN = 8      # y origin alignment (int8 DMA sublane granule)
X_ALIGN = 4      # x origin alignment (4 cells * 32 ch = 128 lanes)


def _corner_1d(g: np.ndarray, size: int):
    """Mirror renderer._corner_weights_1d: padded-axis index + the two
    validity-folded corner weights."""
    x = ((g + 1.0) * size - 1.0) * 0.5
    x0 = np.floor(x).astype(np.int64)
    w1 = (x - x0).astype(np.float32)
    v0 = (x0 >= 0) & (x0 < size)
    v1 = (x0 + 1 >= 0) & (x0 + 1 < size)
    idxp = np.clip(x0 + 1, 0, size)
    return idxp, ((1.0 - w1) * v0).astype(np.float32), (w1 * v1).astype(np.float32)


def _morton3(ix, iy, iz, bits=9):
    code = np.zeros(ix.shape, np.int64)
    for b in range(bits):
        code |= ((ix >> b) & 1).astype(np.int64) << (3 * b)
        code |= ((iy >> b) & 1).astype(np.int64) << (3 * b + 1)
        code |= ((iz >> b) & 1).astype(np.int64) << (3 * b + 2)
    return code


class _RangeMinMax:
    """O(1) min/max over index ranges (sparse table) for the greedy
    block search."""

    def __init__(self, v: np.ndarray):
        n = len(v)
        k = max(1, int(np.floor(np.log2(max(n, 1)))) + 1)
        self.mins = [v]
        self.maxs = [v]
        for j in range(1, k):
            half = 1 << (j - 1)
            prev_min, prev_max = self.mins[-1], self.maxs[-1]
            if len(prev_min) <= half:
                break
            self.mins.append(np.minimum(prev_min[:-half], prev_min[half:]))
            self.maxs.append(np.maximum(prev_max[:-half], prev_max[half:]))

    def query(self, lo: int, hi: int):  # [lo, hi)
        j = max(0, (hi - lo).bit_length() - 1)
        j = min(j, len(self.mins) - 1)
        half = 1 << j
        a, b = lo, hi - half
        return (min(self.mins[j][a], self.mins[j][b]),
                max(self.maxs[j][a], self.maxs[j][b]))


@dataclass(frozen=True)
class PointBlocks:
    """Static packing of a point template for the slab decode kernel."""
    perm: np.ndarray        # (M,) Morton sort order: perm[k] = original
    #                         index of the k-th packed REAL point (slots
    #                         include padding, so this is not per-slot)
    positions: np.ndarray   # (Mpad, 3) f32 permuted + zero-padded template
    origins: np.ndarray     # (n_blocks, 12) i32 (zt, yt, xt) per plane
    idxw: np.ndarray        # (32, Mpad) f32 per-point idx/weight rows
    #                         (None when reconstructed from a compact
    #                         cache — the device build then needs idx16)
    valid: np.ndarray       # (Mpad,) f32 1.0 real / 0.0 pad
    n_points: int           # real point count M
    block: int

    @property
    def n_blocks(self) -> int:
        return self.origins.shape[0]

    @property
    def m_padded(self) -> int:
        return self.positions.shape[0]


def compact_indices(pb: PointBlocks, plane_axes, box_warp, sizes,
                    bilinear: bool = False) -> np.ndarray:
    """(Mpad, 12) int16 compact host payload: per plane (ix, iy, iz)
    padded-axis indices + one int16 of the 6 host validity bits
    (vx0 vx1 vy0 vy1 vz0 vz1). bilinear (depth-1 planes): no z validity
    from the position; the single z corner's bit (1 << 4) is always set.

    Validity must be the HOST's, recomputed from the TRUE (unclipped)
    floor with the same math as the packer: where _corner_weights_1d's
    clip binds (point far outside the grid) idxp - 1 is NOT the true
    floor, so a device-side in-range check on it would wrongly validate
    a garbage corner — the host bits zero those corners exactly.

    This is the only host product the device weight build needs beyond
    (origins, positions); it is what the slab-context disk cache stores
    instead of the 32-row idxw block."""
    D, H, W = sizes
    inv = np.linalg.inv(plane_axes).astype(np.float32)
    g_h = (2.0 / box_warp) * pb.positions
    idx16 = np.zeros((pb.m_padded, 12), np.int16)
    for p in range(3):
        c0 = p * 9
        idx16[:, 4 * p + 0] = pb.idxw[c0 + 0].astype(np.int16)
        idx16[:, 4 * p + 1] = pb.idxw[c0 + 3].astype(np.int16)
        idx16[:, 4 * p + 2] = pb.idxw[c0 + 6].astype(np.int16)
        proj_h = g_h @ inv[p]
        bits = np.zeros(pb.m_padded, np.int16)
        axes = ((0, W), (1, H)) if bilinear else ((0, W), (1, H), (2, D))
        for ax, size in axes:
            x0t = np.floor(((proj_h[:, ax] + 1.0) * size - 1.0) * 0.5
                           ).astype(np.int64)
            v0 = (x0t >= 0) & (x0t < size)
            v1 = (x0t + 1 >= 0) & (x0t + 1 < size)
            bits = bits | (v0.astype(np.int16) << (2 * ax))
            bits = bits | (v1.astype(np.int16) << (2 * ax + 1))
        if bilinear:
            bits = bits | (1 << 4)   # the single z corner, always valid
        idx16[:, 4 * p + 3] = bits
    return idx16


def build_point_blocks(
    init_position: np.ndarray,    # (M, 3) world coords
    plane_axes: np.ndarray,       # (3, 3, 3) generate_planes() output
    box_warp: float,
    sizes: tuple,                 # (D, H, W) tri-grid dims
    block: int = 1024,
    ey: int = EY,
    bilinear: bool = False,
) -> PointBlocks:
    """Morton-sort + greedy-pack the template into slab-fitting blocks.

    Per plane p the padded-axis indices (ix, iy, iz) of every point must
    fit a window: z in [zt, zt+DZW-1] (zt <= DZ-DZW), y in
    [8*yt, 8*yt+ey-1], x in [4*xt, 4*xt+EX-1], with room for the +1
    corner. The greedy walk binary-searches the longest sorted run that
    fits (O(1) range-min/max), so worst case it splits at Morton
    boundary crossings; pads each block to `block` slots.

    bilinear=True packs a depth-1 (EG3D) tri-plane: 2-D (y, x) windows
    only, no z fit, the z index 0 and its corner weights (1, 0); the JAX
    package pairs it with ey=128 (its kernel's matrix-unit depth). The
    port's kernel needs no window; the pack is kept bit for bit because
    it sets the slot order, the padding and Mpad."""
    D, H, W = sizes
    M = init_position.shape[0]
    pos = np.asarray(init_position, np.float32)
    inv = np.linalg.inv(plane_axes).astype(np.float32)  # (3, 3, 3)
    g = (2.0 / box_warp) * pos                          # (M, 3) in [-1, 1]

    ix = np.zeros((3, M), np.int64)
    iy = np.zeros((3, M), np.int64)
    iz = np.zeros((3, M), np.int64)
    wts = np.zeros((3, 6, M), np.float32)  # (wxa wxb wya wyb wza wzb)
    for p in range(3):
        proj = g @ inv[p]                               # (M, 3)
        ix[p], wts[p, 0], wts[p, 1] = _corner_1d(proj[:, 0], W)
        iy[p], wts[p, 2], wts[p, 3] = _corner_1d(proj[:, 1], H)
        if bilinear:
            wts[p, 4] = 1.0   # the single z corner at window row 0
        else:
            iz[p], wts[p, 4], wts[p, 5] = _corner_1d(proj[:, 2], D)

    # Morton order on the clamped world grid (the SAME clamped indices
    # that drive the windows, so clustering bounds the windows). Shift
    # each axis so the OCCUPIED region starts at a Morton-aligned corner:
    # greedy blocks then split at Morton-cube boundaries instead of
    # mid-cube (unshifted, the walk fragmented 5x on the flagship
    # template — 449% padding).
    gq = np.clip(((g + 1.0) * 0.5 * (W - 1)).astype(np.int64), 0, W - 1)
    gq = gq - gq.min(axis=0)
    order = np.argsort(_morton3(gq[:, 0], gq[:, 1], gq[:, 2]),
                       kind="stable")

    ixs, iys, izs = ix[:, order], iy[:, order], iz[:, order]
    rmm = [[_RangeMinMax(a[p]) for a in (ixs, iys, izs)] for p in range(3)]

    DZ = D + 2
    YP = _round_up(H + 2, Y_ALIGN)
    XP = _round_up(W + 2, X_ALIGN)

    def fits(lo: int, hi: int) -> bool:
        for p in range(3):
            xmin, xmax = rmm[p][0].query(lo, hi)
            x0 = min((xmin // X_ALIGN) * X_ALIGN, XP - EX)
            if xmax + 1 > x0 + EX - 1:
                return False
            ymin, ymax = rmm[p][1].query(lo, hi)
            y0 = min((ymin // Y_ALIGN) * Y_ALIGN, YP - ey)
            if ymax + 1 > y0 + ey - 1:
                return False
            if not bilinear:
                zmin, zmax = rmm[p][2].query(lo, hi)
                zt = min(zmin, DZ - DZW)
                if zmax + 1 > zt + DZW - 1:
                    return False
        return True

    starts = []
    ends = []
    lo = 0
    while lo < M:
        # largest hi in (lo, lo+block] with fits(lo, hi)
        hi_max = min(lo + block, M)
        if fits(lo, hi_max):
            hi = hi_max
        else:
            a, b = lo + 1, hi_max       # fits(lo, a) trivially true
            while a < b - 1:
                mid = (a + b) // 2
                if fits(lo, mid):
                    a = mid
                else:
                    b = mid
            hi = a
        starts.append(lo)
        ends.append(hi)
        lo = hi

    nb = len(starts)
    Mpad = nb * block
    perm = order
    positions = np.zeros((Mpad, 3), np.float32)
    idxw = np.zeros((32, Mpad), np.float32)
    valid = np.zeros((Mpad,), np.float32)
    origins = np.zeros((nb, 12), np.int32)
    for b, (s, e) in enumerate(zip(starts, ends)):
        sl = slice(b * block, b * block + (e - s))
        positions[sl] = pos[order[s:e]]
        valid[sl] = 1.0
        for p in range(3):
            xmin = ixs[p, s:e].min()
            ymin = iys[p, s:e].min()
            x0 = min((xmin // X_ALIGN) * X_ALIGN, XP - EX)
            y0 = min((ymin // Y_ALIGN) * Y_ALIGN, YP - ey)
            zt = 0 if bilinear else min(izs[p, s:e].min(), DZ - DZW)
            origins[b, 3 * p:3 * p + 3] = (zt, y0 // Y_ALIGN, x0 // X_ALIGN)
            c0 = p * 9
            idxw[c0 + 0, sl] = ixs[p, s:e]
            idxw[c0 + 1, sl] = wts[p, 0, order[s:e]]
            idxw[c0 + 2, sl] = wts[p, 1, order[s:e]]
            idxw[c0 + 3, sl] = iys[p, s:e]
            idxw[c0 + 4, sl] = wts[p, 2, order[s:e]]
            idxw[c0 + 5, sl] = wts[p, 3, order[s:e]]
            idxw[c0 + 6, sl] = izs[p, s:e]
            idxw[c0 + 7, sl] = wts[p, 4, order[s:e]]
            idxw[c0 + 8, sl] = wts[p, 5, order[s:e]]

    return PointBlocks(
        perm=perm, positions=positions, origins=origins, idxw=idxw,
        valid=valid, n_points=M, block=block)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m
