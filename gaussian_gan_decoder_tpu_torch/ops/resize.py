"""Bilinear image resize with torch F.interpolate conventions — port of
ops/resize.py.

align_corners=False half-pixel mapping; antialias=True applies the tent
filter widened by the downsampling factor, dropping out-of-bounds taps and
renormalising (torch's antialias path). Computed, as in the JAX package, as
two small dense resize-matrix products (H, then W), so the result and its
gradient are the JAX package's.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear resize matrix."""
    scale = in_size / out_size
    support = max(scale, 1.0) if antialias else 1.0
    out_coord = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(out_coord - support).astype(int)
    hi = np.ceil(out_coord + support).astype(int)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        idx = np.arange(lo[i], hi[i] + 1)
        w = np.clip(1.0 - np.abs(idx - out_coord[i]) / support, 0.0, None)
        if antialias:
            keep = (idx >= 0) & (idx < in_size)
            idx, w = idx[keep], w[keep]
        else:
            idx = np.clip(idx, 0, in_size - 1)
        for j, ww in zip(idx, w):
            m[i, j] += ww
    m /= m.sum(axis=1, keepdims=True)
    return m.astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    antialias: bool = False) -> torch.Tensor:
    """Resize (..., H, W) to (..., out_h, out_w)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    mh = torch.tensor(_resize_matrix(in_h, out_h, antialias), dtype=x.dtype, device=x.device)
    mw = torch.tensor(_resize_matrix(in_w, out_w, antialias), dtype=x.dtype, device=x.device)
    x = torch.einsum("oh,...hw->...ow", mh, x)
    return torch.einsum("pw,...hw->...hp", mw, x)
