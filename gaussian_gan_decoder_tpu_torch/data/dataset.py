"""Image datasets for GAN training — a copy of the JAX package's
data/dataset.py (numpy and PIL, no framework code).

Re-design of the reference's training/dataset.py: ImageFolderDataset (a
zip or directory of images with camera labels from dataset.json, CHW
uint8, optional xflip doubling with the yaw-flipped label),
MaskLabeledDataset (paired image and segmentation archives, pose filter and
back-view oversampling), InfiniteSampler (the reference's sharded infinite
shuffled index stream, torch_utils/misc.py:113-136) and batch_iterator
(numpy batches in [-1, 1]). The GAN trainer moves its batches to the card.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _flip_yaw_label(c: np.ndarray) -> np.ndarray:
    """Mirror a 25-dim EG3D camera label for xflip augmentation (flip the
    cam2world pose around the yz-plane — same transform the reference
    datasets apply for mirrored images)."""
    c = c.copy()
    pose = c[:16].reshape(4, 4)
    flip = np.diag([-1.0, 1.0, 1.0, 1.0]).astype(pose.dtype)
    pose = flip @ pose @ flip
    c[:16] = pose.reshape(-1)
    return c


class ImageFolderDataset:
    """zip or directory of images + dataset.json labels (ref dataset.py:161-244)."""

    def __init__(
        self,
        path: str,
        resolution: Optional[int] = None,
        use_labels: bool = True,
        xflip: bool = False,
        max_size: Optional[int] = None,
    ):
        self.path = path
        self._zip = None
        if path.endswith(".zip"):
            self._zip = zipfile.ZipFile(path)
            names = self._zip.namelist()
        else:
            names = [
                os.path.relpath(os.path.join(r, f), path).replace("\\", "/")
                for r, _, fs in os.walk(path) for f in fs
            ]
        exts = (".png", ".jpg", ".jpeg")
        self._image_names = sorted(n for n in names if n.lower().endswith(exts))
        if max_size is not None:
            self._image_names = self._image_names[:max_size]
        self.resolution = resolution
        self.xflip = xflip

        self._labels = None
        if use_labels:
            raw = self._read("dataset.json")
            if raw is not None:
                table = {
                    fname.replace("\\", "/"): np.asarray(lab, np.float32)
                    for fname, lab in json.loads(raw)["labels"]
                }
                self._labels = [table[n] for n in self._image_names]

    # -- raw IO ----------------------------------------------------------------

    def _read(self, name: str) -> Optional[bytes]:
        if self._zip is not None:
            try:
                return self._zip.read(name)
            except KeyError:
                return None
        p = os.path.join(self.path, name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return f.read()
        return None

    def _load_image(self, name: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(io.BytesIO(self._read(name))).convert("RGB")
        if self.resolution is not None and img.size != (self.resolution, self.resolution):
            img = img.resize((self.resolution, self.resolution), Image.LANCZOS)
        return np.asarray(img, np.uint8).transpose(2, 0, 1)  # CHW

    # -- dataset protocol --------------------------------------------------------

    def __len__(self):
        return len(self._image_names) * (2 if self.xflip else 1)

    @property
    def label_dim(self):
        return len(self._labels[0]) if self._labels else 0

    def get_label(self, idx: int) -> np.ndarray:
        base, flip = divmod(idx, 1) if not self.xflip else (idx // 2, idx % 2)
        if self._labels is None:
            return np.zeros((0,), np.float32)
        lab = self._labels[base]
        return _flip_yaw_label(lab) if flip else lab

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        base, flip = (idx, 0) if not self.xflip else (idx // 2, idx % 2)
        img = self._load_image(self._image_names[base])
        if flip:
            img = img[:, :, ::-1].copy()
        return img, self.get_label(idx)


def _matrix2angle(R: np.ndarray):
    """Rotation matrix -> (yaw, pitch, roll) in radians — the reference's
    Euler decomposition verbatim in math (PanoHead/training/utils.py:24-55,
    matrix2angle; 'x' there is the yaw the pose filter keys on)."""
    from math import asin, atan2, cos, pi

    if R[2, 0] > 0.998:
        z = 0.0
        x = pi / 2
        y = z + atan2(-R[0, 1], -R[0, 2])
    elif R[2, 0] < -0.998:
        z = 0.0
        x = -pi / 2
        y = -z + atan2(R[0, 1], R[0, 2])
    else:
        x = asin(R[2, 0])
        y = atan2(R[2, 1] / cos(x), R[2, 2] / cos(x))
        z = atan2(R[1, 0] / cos(x), R[0, 0] / cos(x))
    if abs(y) > pi / 2:
        x = (pi - x) if x > 0 else (-pi - x)
    y = atan2(R[2, 1] / cos(x), R[2, 2] / cos(x))
    z = atan2(R[1, 0] / cos(x), R[0, 0] / cos(x))
    return x, y, z


def get_poseangle(label: np.ndarray):
    """25-dim camera label -> (yaw, pitch, roll) in DEGREES
    (ref PanoHead/training/utils.py:66-80 get_poseangle)."""
    convert = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float64)
    cam2world = np.asarray(label[:16], np.float64).reshape(4, 4)
    world2cam = np.linalg.inv(cam2world @ convert)
    return tuple(a * 180.0 / np.pi for a in _matrix2angle(world2cam[:3, :3]))


class MaskLabeledDataset:
    """Paired image+segmentation zips with pose filtering + back-view
    oversampling (ref dataset.py:301-352)."""

    def __init__(self, img_path: str, seg_path: str, resolution=None,
                 xflip: bool = False, back_repeat: int = 1,
                 min_yaw: float = 0.0, max_yaw: float = 180.0,
                 max_pitch: float = 90.0):
        self.images = ImageFolderDataset(img_path, resolution, True, xflip)
        self.segs = ImageFolderDataset(seg_path, resolution, False, xflip)
        self.back_repeat = back_repeat
        # reference _filter_samples (dataset.py:329-352): keep
        # min_yaw <= |yaw| <= max_yaw and |pitch| <= max_pitch; repeat
        # |yaw| >= max(90, min_yaw) views back_repeat times
        idx = np.arange(len(self.images))
        weights = []
        back_cut = max(90.0, min_yaw)
        for i in idx:
            yaw, pitch, _ = get_poseangle(self.images.get_label(int(i)))
            valid = (min_yaw <= abs(yaw) <= max_yaw) and abs(pitch) <= max_pitch
            backfacing = valid and abs(yaw) >= back_cut
            weights.append(back_repeat if backfacing else (1 if valid else 0))
        self._index = np.repeat(idx, weights)

    def __len__(self):
        return len(self._index)

    @property
    def label_dim(self):
        return self.images.label_dim

    def __getitem__(self, idx: int):
        i = int(self._index[idx])
        img, lab = self.images[i]
        seg, _ = self.segs[i]
        return img, seg[:1], lab


class InfiniteSampler:
    """Sharded infinite shuffled index stream with the reference's
    sliding-window re-shuffle (ref misc.py:113-136): after each step, the
    current position is swapped with a random earlier position inside a
    window of window_size * dataset_size — index-exact vs the reference
    sampler (golden test imports the actual torch_utils.misc copy)."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 seed: int = 0, shuffle: bool = True, window_size: float = 0.5):
        assert dataset_size > 0 and num_replicas > 0
        assert 0 <= rank < num_replicas
        assert 0 <= window_size <= 1
        self.size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.seed = seed
        self.shuffle = shuffle
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))

        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


def batch_iterator(dataset, batch_size: int, sampler: InfiniteSampler):
    """-> iterator of numpy batches (images [-1,1] f32, labels)."""
    it = iter(sampler)
    while True:
        imgs, labs, segs = [], [], []
        for _ in range(batch_size):
            item = dataset[next(it)]
            if len(item) == 3:
                img, seg, lab = item
                segs.append(seg)
            else:
                img, lab = item
            imgs.append(img)
            labs.append(lab)
        images = np.stack(imgs).astype(np.float32) / 127.5 - 1.0
        labels = np.stack(labs)
        if segs:
            seg = np.stack(segs).astype(np.float32) / 255.0
            yield images, seg, labels
        else:
            yield images, labels
