"""Photogrammetric scene IO: COLMAP binary + Blender synthetic — a copy of
the JAX package's data/scene_io.py (numpy only), so that the port imports
nothing of that package.

Re-design of the reference's gaussian_splatting/scene/
{colmap_loader.py (binary parsers), dataset_readers.py:132 readColmapSceneInfo,
:221 readNerfSyntheticInfo, __init__.py:32-103 Scene}. Produces camera
lists (R, T, fovx, fovy, image path) + an initial point cloud, consumable
by the classic 3DGS trainer (train/gaussian_splatting.py).

The COLMAP binary formats are public fixed layouts (camera_id/model/params,
image quaternions, 3D points with tracks) parsed with struct — no pycolmap.
"""
from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# COLMAP camera models: id -> (name, num_params)
_CAM_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_cameras_binary(path: str) -> Dict[int, dict]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = _CAM_MODELS[model]
            params = struct.unpack("<" + "d" * np_, f.read(8 * np_))
            out[cam_id] = dict(model=name, width=w, height=h, params=np.array(params))
    return out


def read_images_binary(path: str) -> Dict[int, dict]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            img_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            (cam_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.read(24 * n2d)  # skip 2D points (x, y, point3D_id)
            out[img_id] = dict(qvec=qvec, tvec=tvec, camera_id=cam_id,
                               name=name.decode())
    return out


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            f.read(8)  # point id
            xyz = struct.unpack("<3d", f.read(24))
            rgb = struct.unpack("<3B", f.read(3))
            f.read(8)  # error
            (tl,) = struct.unpack("<Q", f.read(8))
            f.read(8 * tl)
            xyzs.append(xyz)
            rgbs.append(rgb)
    return np.asarray(xyzs, np.float32), np.asarray(rgbs, np.float32) / 255.0


@dataclass
class SceneCamera:
    R: np.ndarray            # world->cam rotation (3,3)
    T: np.ndarray            # world->cam translation (3,)
    fovx: float
    fovy: float
    image_path: str
    width: int
    height: int


@dataclass
class SceneInfo:
    cameras: List[SceneCamera]
    points: np.ndarray
    colors: np.ndarray
    nerf_normalization_radius: float = 1.0

    @property
    def extent(self) -> float:
        return self.nerf_normalization_radius


def _focal2fov(focal, pixels):
    import math

    return 2 * math.atan(pixels / (2 * focal))


def read_colmap_scene(path: str, images_dir: str = "images") -> SceneInfo:
    """(ref dataset_readers.py:132-219)"""
    sparse = os.path.join(path, "sparse", "0")
    cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb = read_points3d_binary(os.path.join(sparse, "points3D.bin"))

    out = []
    centers = []
    for img in sorted(images.values(), key=lambda d: d["name"]):
        cam = cams[img["camera_id"]]
        R = qvec2rotmat(img["qvec"])
        T = img["tvec"]
        if cam["model"] == "SIMPLE_PINHOLE":
            fx = fy = cam["params"][0]
        else:
            fx, fy = cam["params"][0], cam["params"][1]
        out.append(SceneCamera(
            R=R.astype(np.float32), T=T.astype(np.float32),
            fovx=_focal2fov(fx, cam["width"]), fovy=_focal2fov(fy, cam["height"]),
            image_path=os.path.join(path, images_dir, img["name"]),
            width=int(cam["width"]), height=int(cam["height"]),
        ))
        centers.append(-R.T @ T)
    centers = np.asarray(centers)
    radius = float(np.max(np.linalg.norm(centers - centers.mean(0), axis=1)) * 1.1) or 1.0
    return SceneInfo(out, xyz, rgb, radius)


def read_blender_scene(path: str, white_background: bool = False,
                       split: str = "train", n_random_points: Optional[int] = None,
                       seed: int = 0) -> SceneInfo:
    """(ref dataset_readers.py:221-255): transforms_{split}.json cameras +
    a random init cloud in the synthetic-NeRF bounds."""
    with open(os.path.join(path, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    out = []
    centers = []
    for frame in meta["frames"]:
        c2w = np.asarray(frame["transform_matrix"], np.float32)
        c2w[:3, 1:3] *= -1  # blender -> COLMAP camera convention
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3]
        T = w2c[:3, 3]
        img_path = os.path.join(path, frame["file_path"] + ".png")
        out.append(SceneCamera(
            R=R, T=T, fovx=fovx, fovy=fovx, image_path=img_path,
            width=800, height=800,
        ))
        centers.append(c2w[:3, 3])
    rng = np.random.RandomState(seed)
    n_pts = n_random_points if n_random_points is not None else 100_000
    pts = (rng.rand(n_pts, 3).astype(np.float32) * 2.6 - 1.3)
    rgb = rng.rand(n_pts, 3).astype(np.float32)
    centers = np.asarray(centers)
    radius = float(np.max(np.linalg.norm(centers - centers.mean(0), axis=1)) * 1.1) or 1.0
    return SceneInfo(out, pts, rgb, radius)


def camera_to_render_inputs(cam: SceneCamera):
    """SceneCamera -> (world_view^T-style cam2world, fov) for make_camera.

    The classic pipeline's Camera (ref scene/cameras.py:18-60) builds
    world_view = [R|T]^T; our make_camera consumes EG3D-style cam2world =
    inv([R|T]) — convert here."""
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = cam.R
    w2c[:3, 3] = cam.T
    return np.linalg.inv(w2c), cam.fovx
