"""Kernel Inception Distance (ref PanoHead/metrics/kernel_inception_distance.py):
polynomial-kernel MMD^2 over feature subsets — the JAX package's
metrics/kernel.py, its subsets drawn by the same numpy RandomState, its
kernel sums taken in the features' dtype (as numpy takes them there) on
`device` (the card unless the caller names the CPU)."""
from __future__ import annotations

import numpy as np
import torch


def kid_from_features(real: np.ndarray, gen: np.ndarray, num_subsets: int = 100,
                      max_subset_size: int = 1000, seed: int = 0, device="cuda") -> float:
    from ..flagship import resolve_device
    dev = resolve_device(device)
    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    rng = np.random.RandomState(seed)
    r, g = torch.as_tensor(np.asarray(real)).to(dev), torch.as_tensor(np.asarray(gen)).to(dev)
    t = 0.0
    for _ in range(num_subsets):
        x = g[torch.from_numpy(rng.choice(gen.shape[0], m, replace=False)).to(dev)]
        y = r[torch.from_numpy(rng.choice(real.shape[0], m, replace=False)).to(dev)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += float((a.sum() - torch.trace(a)) / (m - 1) - b.sum() * 2 / m)
    return float(t / num_subsets / m)
