"""3DGS .ply import/export — port of gaussians/ply.py, byte for byte the
JAX writer's file (the reference layout: binary_little_endian 1.0, one
'vertex' element of f4 properties x y z nx ny nz f_dc_* [f_rest_*] opacity
scale_* rot_*, RAW pre-activation values), written with numpy. Exported
files load in splatviz / SIBR viewers like the reference's exports.

As in the JAX package, f_rest_* is written only for active_sh_degree > 0
(the reference gates the names on the active degree and the data on the
maximum, and raises for a save before its first SH ramp step); load_ply
zero-fills missing rest coefficients.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from .model import GaussianScene


def _np(x, dtype=np.float32):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _header(names: List[str], count: int) -> bytes:
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {count}"]
    lines += [f"property float {n}" for n in names]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def _attribute_names(scene: GaussianScene) -> List[str]:
    """(ref construct_list_of_attributes, gaussian_model.py:266-279)"""
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(scene.features_dc.shape[1] * 3)]
    if scene.active_sh_degree > 0:
        names += [f"f_rest_{i}" for i in range(scene.features_rest.shape[1] * 3)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(scene.scaling.shape[1])]
    names += [f"rot_{i}" for i in range(scene.rotation.shape[1])]
    return names


def save_ply(scene: GaussianScene, path: str, only_valid: bool = True) -> None:
    xyz = _np(scene.xyz)
    valid = _np(scene.valid, bool)
    n = len(xyz)
    # f_dc / f_rest channel-major, as torch's features.transpose(1, 2).flatten(1)
    f_dc = _np(scene.features_dc).transpose(0, 2, 1).reshape(n, -1)
    cols = [xyz, np.zeros_like(xyz), f_dc]
    if scene.active_sh_degree > 0:
        cols.append(_np(scene.features_rest).transpose(0, 2, 1).reshape(n, -1))
    cols += [_np(scene.opacity), _np(scene.scaling), _np(scene.rotation)]
    attributes = np.concatenate(cols, axis=1).astype("<f4")
    if only_valid:
        attributes = attributes[valid]
    names = _attribute_names(scene)
    assert attributes.shape[1] == len(names), (attributes.shape, len(names))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_header(names, attributes.shape[0]))
        f.write(np.ascontiguousarray(attributes).tobytes())


def _parse_header(blob: bytes) -> Tuple[int, List[str], int]:
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:end].decode("ascii")
    if "binary_little_endian" not in header:
        raise ValueError("only binary_little_endian .ply files are read")
    count = int(re.search(r"element vertex (\d+)", header).group(1))
    names = re.findall(r"property float (\S+)", header)
    return count, names, end


def load_ply_arrays(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        blob = f.read()
    count, names, offset = _parse_header(blob)
    data = np.frombuffer(blob, dtype="<f4", count=count * len(names), offset=offset)
    data = data.reshape(count, len(names))
    return {n: data[:, i].copy() for i, n in enumerate(names)}


def _numbered(cols, prefix):
    return sorted((k for k in cols if k.startswith(prefix)), key=lambda s: int(s.split("_")[-1]))


def load_ply(path: str, max_sh_degree: int = 0, device=None) -> GaussianScene:
    """(ref load_ply, gaussian_model.py:310-351)"""
    cols = load_ply_arrays(path)
    n = len(cols["x"])
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    f_dc = np.stack([cols["f_dc_0"], cols["f_dc_1"], cols["f_dc_2"]], axis=1)
    rest_names = _numbered(cols, "f_rest_")
    k_rest = (max_sh_degree + 1) ** 2 - 1
    if rest_names:
        if len(rest_names) != 3 * k_rest:
            raise ValueError(f"{len(rest_names)} f_rest properties for SH degree {max_sh_degree}")
        rest = np.stack([cols[k] for k in rest_names], axis=1).reshape(n, 3, k_rest)
        rest = rest.transpose(0, 2, 1)
    else:
        rest = np.zeros((n, k_rest, 3), np.float32)
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return GaussianScene(
        xyz=t(xyz), features_dc=t(f_dc)[:, None, :], features_rest=t(rest),
        scaling=t(np.stack([cols[k] for k in _numbered(cols, "scale_")], axis=1)),
        rotation=t(np.stack([cols[k] for k in _numbered(cols, "rot_")], axis=1)),
        opacity=t(cols["opacity"])[:, None],
        valid=torch.ones((n,), dtype=torch.bool, device=device),
        max_sh_degree=max_sh_degree, active_sh_degree=max_sh_degree)
