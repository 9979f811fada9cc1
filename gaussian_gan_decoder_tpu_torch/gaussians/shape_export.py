"""Shape export: density grids -> volume .mrc / mesh .ply — port of
gaussians/shape_export.py (the reference's PanoHead/shape_utils.py:40-123,
convert_sdf_samples_to_ply and convert_mrc, without skimage, plyfile or
mrcfile: both formats are written directly). Given the same arrays, the
files are byte for byte the JAX package's. numpy only: callers hand in
host arrays (`tensor.cpu().numpy()`).
"""
from __future__ import annotations

import os
import struct

import numpy as np


def save_mrc(path: str, volume: np.ndarray, voxel_size: float = 1.0) -> None:
    """Minimal MRC2014 writer (mode 2 = float32), readable by mrcfile and
    ChimeraX."""
    vol = np.ascontiguousarray(np.asarray(volume, np.float32))
    nz, ny, nx = vol.shape
    header = bytearray(1024)
    struct.pack_into("<3i", header, 0, nx, ny, nz)          # NX NY NZ
    struct.pack_into("<i", header, 12, 2)                   # MODE 2 float32
    struct.pack_into("<3i", header, 28, nx, ny, nz)         # MX MY MZ
    struct.pack_into("<3f", header, 40, nx * voxel_size, ny * voxel_size,
                     nz * voxel_size)                       # CELLA
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0)   # CELLB
    struct.pack_into("<3i", header, 64, 1, 2, 3)            # MAPC/R/S
    struct.pack_into("<3f", header, 76, float(vol.min()), float(vol.max()),
                     float(vol.mean()))                     # DMIN DMAX DMEAN
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"                   # little-endian stamp
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(vol.tobytes())


def save_mesh_ply(path: str, verts: np.ndarray, n_faces: int,
                  voxel_origin=(0.0, 0.0, 0.0), scale: float = 1.0) -> None:
    """Triangle soup (F, 3, 3) — marching tetrahedra's output, the first
    n_faces rows valid — -> binary PLY mesh, identical corner positions
    (rounded to 6 decimals) welded into shared vertices."""
    f = int(n_faces)
    tri = np.asarray(verts[:f], np.float32) * scale + np.asarray(voxel_origin, np.float32)
    flat = tri.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(6), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(uniq)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header", "",
    ]).encode("ascii")
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(uniq.astype("<f4").tobytes())
        face_rec = np.zeros((len(faces),), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        face_rec["n"] = 3
        face_rec["idx"] = faces
        fh.write(face_rec.tobytes())
