"""Improved precision / recall (ref PanoHead/metrics/precision_recall.py):
manifold membership by k-NN radii — the JAX package's
metrics/precision_recall.py, its distances taken in float64 on `device`
(the card unless the caller names the CPU), a batch of probes at a time."""
from __future__ import annotations

import numpy as np
import torch


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances (len(a), len(b)) from the differences, as
    np.linalg.norm of the broadcast difference (no Gram-matrix shortcut)."""
    return torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist")


def _knn_radii(feats: torch.Tensor, k: int, batch: int = 1024) -> torch.Tensor:
    return torch.cat([torch.sort(_dist(feats[i:i + batch], feats), dim=1).values[:, k]
                      for i in range(0, feats.shape[0], batch)])   # k-th NN (0 is self)


def _fraction_in_manifold(probes, manifold, radii, batch: int = 1024) -> float:
    hits = sum(int((_dist(probes[i:i + batch], manifold) <= radii[None, :]).any(dim=1).sum())
               for i in range(0, probes.shape[0], batch))
    return hits / probes.shape[0]


def precision_recall(real: np.ndarray, gen: np.ndarray, nhood_size: int = 3, device="cuda"):
    """-> (precision, recall)."""
    from ..flagship import resolve_device
    dev = resolve_device(device)
    r = torch.as_tensor(np.asarray(real), dtype=torch.float64).to(dev)
    g = torch.as_tensor(np.asarray(gen), dtype=torch.float64).to(dev)
    r_radii, g_radii = _knn_radii(r, nhood_size), _knn_radii(g, nhood_size)
    return float(_fraction_in_manifold(g, r, r_radii)), float(_fraction_in_manifold(r, g, g_radii))
