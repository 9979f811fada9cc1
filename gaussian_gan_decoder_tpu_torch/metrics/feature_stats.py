"""Feature statistics for the GAN metrics — a copy of the JAX package's
metrics/feature_stats.py (numpy; the reference's metrics/metric_utils.py
FeatureStats and its feature loops, eg3d's decoder path
eg3d/metrics/metric_utils.py:286-322).

Batches stream through one feature function (any `features(images [0, 255]
NCHW) -> (N, D)` callable: the port's InceptionV3.features, or
VGG16LPIPS.pooled_features without Inception weights) and the statistics
accumulate in float64 on the host.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Callable, Optional

import numpy as np


class FeatureStats:
    """(num, mean, cov) accumulation + optional raw capture (ref
    metric_utils.py FeatureStats)."""

    def __init__(self, capture_all: bool = False, capture_mean_cov: bool = True,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        if self.max_items is not None:
            take = min(x.shape[0], self.max_items - self.num_items)
            if take <= 0:
                return
            x = x[:take]
        if self.num_features is None:
            self.num_features = x.shape[1]
            self.raw_mean = np.zeros(self.num_features)
            self.raw_cov = np.zeros((self.num_features, self.num_features))
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x.astype(np.float32))
        if self.capture_mean_cov:
            self.raw_mean += x.sum(axis=0)
            self.raw_cov += x.T @ x

    def get_all(self) -> np.ndarray:
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.__dict__, f)

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        with open(path, "rb") as f:
            state = pickle.load(f)
        obj = cls()
        obj.__dict__.update(state)
        return obj


def cache_path(cache_dir: str, tag: str, **kwargs) -> str:
    """Deterministic stat-cache file (ref metric_utils.py feature caching)."""
    key = repr(sorted(kwargs.items()))
    h = hashlib.md5((tag + key).encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"{tag}-{h}.pkl")


def to_host(x) -> np.ndarray:
    """A feature batch (numpy, or a torch tensor on any device) on the host."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def stats_for_iterator(
    batches,                       # yields uint8/f32 images (N, C, H, W) in [0, 255]
    feature_fn: Callable,
    max_items: int,
    capture_all: bool = False,
    capture_mean_cov: bool = True,
) -> FeatureStats:
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov,
                         max_items=max_items)
    for imgs in batches:
        stats.append(to_host(feature_fn(imgs)))
        if stats.is_full():
            break
    return stats
