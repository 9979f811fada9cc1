"""Iso-surface point sampling from a density grid — port of
decoder/surface.py: the sampling lattice (create_samples), the separable
and the gather sigma grids, marching tetrahedra (the two-stage and the
single-stage compaction) and barycentric surface sampling.

Faces come out in the JAX package's order. Two-stage: crossed cubes by
ascending cube id (the first CUBE_CAPACITY of them), then faces by
(tet*2 + tri) slot major and cube slot minor, the first face_capacity of
them — the order of its sort keys tt * CC + slot, which a row-major nonzero
over the (12, CC) validity mask reproduces. Single-stage: every cube, faces
by (tet*2 + tri) major and cube id minor (its keys tt * C + cube), the
first face_capacity; it drops no cube.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

CUBE_CAPACITY = 2 ** 18
SIGMA_CHUNK = 2 ** 18    # OSG-decoder probes per step of the sigma grid

# Kuhn 6-tet decomposition; corner id = 4i + 2j + k
_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                  [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], dtype=np.int64)
_CORNER_OFFS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                        dtype=np.float32)


def _tet_case_tables():
    """16-case tables: triangles as local-vertex edge pairs."""
    tri_a = np.zeros((16, 2, 3), np.int64)
    tri_b = np.zeros((16, 2, 3), np.int64)
    for case in range(16):
        ins = [i for i in range(4) if case & (1 << i)]
        outs = [i for i in range(4) if not case & (1 << i)]
        tris = []
        if len(ins) == 1:
            tris = [[(ins[0], outs[0]), (ins[0], outs[1]), (ins[0], outs[2])]]
        elif len(ins) == 3:
            tris = [[(outs[0], ins[0]), (outs[0], ins[1]), (outs[0], ins[2])]]
        elif len(ins) == 2:
            a0, a1 = ins
            b0, b1 = outs
            tris = [[(a0, b0), (a0, b1), (a1, b1)], [(a0, b0), (a1, b1), (a1, b0)]]
        for t, tri in enumerate(tris):
            for v, (ea, eb) in enumerate(tri):
                tri_a[case, t, v] = ea
                tri_b[case, t, v] = eb
    return tri_a, tri_b


def _combo_table():
    """(192, 24) per-(tet, tri, case) rows: for each of the 3 vertices the
    two edge-end corner offsets (6) and corner ids (2)."""
    tri_a, tri_b = _tet_case_tables()
    tab = np.zeros((6 * 2 * 16, 24), np.float32)
    for tet in range(6):
        for tri in range(2):
            for case in range(16):
                row = tab[(tet * 2 + tri) * 16 + case]
                for vv in range(3):
                    ca = _TETS[tet, tri_a[case, tri, vv]]
                    cb = _TETS[tet, tri_b[case, tri, vv]]
                    row[vv * 8:vv * 8 + 3] = _CORNER_OFFS[ca]
                    row[vv * 8 + 3:vv * 8 + 6] = _CORNER_OFFS[cb]
                    row[vv * 8 + 6] = ca
                    row[vv * 8 + 7] = cb
    return tab


_COMBO_TAB = _combo_table()


def _corner_values(sigmas):
    """(8, C) corner sigmas of the (R-1)^3 cubes, corner id 4i + 2j + k."""
    R = sigmas.shape[0]
    return torch.stack([sigmas[i:i + R - 1, j:j + R - 1, k:k + R - 1].reshape(-1)
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)])


def create_samples(samples_per_axis: int = 256, cube_length: float = 1.0,
                   device=None) -> torch.Tensor:
    """(1, R^3, 3) world-coordinate lattice, index order i (x) slowest, k
    (z) fastest (ref marching_cube/sample.py:5-26, voxel origin 0), built
    on the device."""
    r = samples_per_axis
    idx = (torch.arange(r, dtype=torch.float32, device=device) * (cube_length / (r - 1))
           - cube_length / 2)
    return torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1).reshape(1, r ** 3, 3)


def _tet_faces(ins):
    """ins (8, n) int64 corner inside-flags -> (case (6, n), valid (12, n)):
    each tet's 16-way case and, per (tet*2 + tri) slot, whether it has that
    triangle."""
    b = ins[torch.tensor(_TETS, device=ins.device)]             # (6, 4, n)
    case = b[:, 0] + (b[:, 1] << 1) + (b[:, 2] << 2) + (b[:, 3] << 3)
    n_in = b.sum(1)
    valid = torch.stack([(n_in > 0) & (n_in < 4), n_in == 2], dim=1).reshape(12, -1)
    return case, valid


def marching_tetrahedra_faces(sigmas: torch.Tensor, level: float, face_capacity: int,
                              cube_capacity: int = CUBE_CAPACITY, two_stage: bool = True):
    """Marching tetrahedra -> (packed (F, 9) vertex coordinates in INDEX
    space, n_faces, n_dropped_cubes); F = max(1, min(n_faces,
    face_capacity)). two_stage compacts the crossed cubes first (the first
    cube_capacity of them; the rest are counted in n_dropped_cubes and
    give no face); single-stage enumerates the faces of every cube and
    drops none (its only loss is the face_capacity clamp). With no face,
    one capacity-fill row as in the JAX package: cube 0 and combo 0
    (two-stage) or combo cases[0, 0] (single-stage)."""
    R = sigmas.shape[0]
    C = (R - 1) ** 3
    dev = sigmas.device
    v = _corner_values(sigmas)                                   # (8, C)
    if two_stage:
        CC = min(cube_capacity, C)
        n_in8 = (v > level).sum(0)
        crossed = (n_in8 > 0) & (n_in8 < 8)
        cube_ids = torch.nonzero(crossed).squeeze(1)
        n_dropped = max(int(cube_ids.numel()) - CC, 0)
        cube_ids = cube_ids[:CC]
        case, valid = _tet_faces((v[:, cube_ids] > level).long())   # valid (tt, slot)
    else:
        n_dropped = 0
        case, valid = _tet_faces((v > level).long())                # valid (tt, cube)
    n_faces = int(valid.sum())
    tt, slot = torch.nonzero(valid, as_tuple=True)
    tt, slot = tt[:face_capacity], slot[:face_capacity]
    if tt.numel() == 0:
        cube = torch.zeros(1, dtype=torch.long, device=dev)
        combo = cube if two_stage else case[0, :1]
    else:
        cube = cube_ids[slot] if two_stage else slot
        combo = tt * 16 + case[tt // 2, slot]
    crow = torch.tensor(_COMBO_TAB, device=dev)[combo]           # (F, 24)
    vrow = v[:, cube].t()                                        # (F, 8)
    r1 = R - 1
    base = ((cube // (r1 * r1)).to(sigmas.dtype), ((cube // r1) % r1).to(sigmas.dtype),
            (cube % r1).to(sigmas.dtype))
    cols = []
    for vv in range(3):
        sa = vrow.gather(1, crow[:, vv * 8 + 6].long()[:, None])[:, 0]
        sb = vrow.gather(1, crow[:, vv * 8 + 7].long()[:, None])[:, 0]
        denom = sb - sa
        denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
        t = torch.clamp((level - sa) / denom, 0.0, 1.0)
        for k in range(3):
            pa = base[k] + crow[:, vv * 8 + k]
            pb = base[k] + crow[:, vv * 8 + 3 + k]
            cols.append(pa + t * (pb - pa))
    return torch.stack(cols, dim=1), n_faces, n_dropped


def marching_tetrahedra_sample(sigmas: torch.Tensor, face_u: torch.Tensor,
                               weight_u: torch.Tensor, thickness_n: torch.Tensor,
                               level: float = 10.0, surface_thickness: float = 0.1,
                               face_capacity: int = 2 ** 20,
                               two_stage: bool = True) -> torch.Tensor:
    """Surface point cloud (P, 3) as the reference's marching-cubes +
    barycentric + thickness pipeline. Draws: face_u (P,) uniform (face
    choice), weight_u (P, 3) uniform (barycentric weights, sum-normalised),
    thickness_n (P,) standard normal (shrink jitter)."""
    packed, n_faces, _ = marching_tetrahedra_faces(sigmas, level, face_capacity,
                                                   two_stage=two_stage)
    R = sigmas.shape[0]
    n_eff = max(min(n_faces, face_capacity), 1)
    fidx = torch.clamp(torch.floor(face_u * float(n_eff)).long(), max=n_eff - 1)
    rows = packed[fidx]
    w = weight_u / weight_u.sum(1, keepdim=True)
    scale = torch.clamp(thickness_n * surface_thickness + 1.0, 0.0, 1.0)
    pts = [((rows[:, k] * w[:, 0] + rows[:, 3 + k] * w[:, 1] + rows[:, 6 + k] * w[:, 2])
            / R - 0.5) * scale for k in range(3)]
    return torch.stack(pts, dim=1)


def _interp_matrix(R: int, size: int, device) -> torch.Tensor:
    """(R, size) align_corners=False lerp weights of linspace(-1, 1, R),
    zero where a corner falls outside."""
    vals = torch.linspace(-1.0, 1.0, R, device=device)
    x = ((vals + 1.0) * size - 1.0) * 0.5
    x0 = torch.floor(x)
    w1 = x - x0
    x0 = x0.long()
    cols = torch.arange(size, device=device)[None, :]
    v0 = ((x0 >= 0) & (x0 < size))[:, None]
    v1 = ((x0 + 1 >= 0) & (x0 + 1 < size))[:, None]
    a = torch.where((cols == torch.clamp(x0, 0, size - 1)[:, None]) & v0,
                    (1.0 - w1)[:, None], 0.0)
    b = torch.where((cols == torch.clamp(x0 + 1, 0, size - 1)[:, None]) & v1,
                    w1[:, None], 0.0)
    return a + b


def sigma_grid_separable(generator, planes: torch.Tensor, shape_res: int = 128,
                         chunk: int = SIGMA_CHUNK) -> torch.Tensor:
    """(R, R, R) density of the OSG decoder over the sampling cube, by
    separable lattice resampling of the tri-grid (three small interpolation
    products per plane instead of R^3 trilinear gathers); the decoder runs
    over chunks of `chunk` probes."""
    D = generator.triplane_depth
    R = shape_res
    N, n_planes, CD, H, W = planes.shape
    assert N == 1
    C = CD // D
    dev = planes.device
    A_W, A_H = _interp_matrix(R, W, dev), _interp_matrix(R, H, dev)
    A_D = torch.ones((R, 1), device=dev) if D == 1 else _interp_matrix(R, D, dev)
    vol = planes.float().reshape(n_planes, C, D, H, W)
    inv = np.linalg.inv(generator.plane_axes)
    acc = torch.zeros((C, R, R, R), dtype=torch.float32, device=dev)
    src_pos = {0: 3, 1: 2, 2: 1}
    for p in range(n_planes):
        t1 = torch.einsum("cdhw,aw->cdha", vol[p], A_W)
        t2 = torch.einsum("cdha,bh->cdba", t1, A_H)
        t3 = torch.einsum("cdba,ed->ceba", t2, A_D)
        col_of_world = [int(np.argmax(inv[p][m])) for m in range(3)]
        acc += t3.permute([0] + [src_pos[col_of_world[m]] for m in range(3)])
    feats = (acc.reshape(C, R ** 3) / n_planes).t()
    sig = torch.cat([generator.decoder(feats[None, None, i:i + chunk])["sigma"][0, :, 0]
                     for i in range(0, R ** 3, chunk)])
    return sig.reshape(R, R, R)


def sigma_grid(generator, planes: torch.Tensor, shape_res: int = 128, chunk: int = SIGMA_CHUNK,
               table=None, separable: bool = True) -> torch.Tensor:
    """(R, R, R) density of the OSG decoder over the sampling cube. separable
    (the port's default; the JAX function's is the gather): the separable
    lattice resampling of the raw planes, which takes no table — handing it
    one is an error, since the table's bf16 / int8 quantisation would be
    ignored. Otherwise the gather grid: create_samples' R^3 points probed
    through `table` (build_sampling_table's output; the planes' float
    table when None, built once) in chunks of `chunk` points."""
    if separable:
        assert table is None, (
            "sigma_grid(separable=True) samples the raw planes directly; a probe table (and "
            "any bf16 / int8 quantisation in it) would be ignored: build none on this path")
        return sigma_grid_separable(generator, planes, shape_res=shape_res, chunk=chunk)
    samples = create_samples(shape_res, generator.rk["box_warp"], device=planes.device)[0]
    n = samples.shape[0]
    assert n % chunk == 0, (n, chunk)
    if table is None:
        table = generator.build_sampling_table(planes)
    sig = [generator.sample_mixed_from_planes(planes, samples[None, i:i + chunk],
                                              table=table)["sigma"][0, :, 0]
           for i in range(0, n, chunk)]
    return torch.cat(sig).reshape(shape_res, shape_res, shape_res)
