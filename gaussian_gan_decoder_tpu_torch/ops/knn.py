"""Mean squared distance to the k nearest neighbours — port of ops/knn.py.

The seed of a point cloud's initial log-scales (the reference's simple-knn
distCUDA2, itself approximate). As in the JAX package: three Morton orders
(permuted axis interleavings), a banded search of +-window sorted
neighbours in each, and the merged candidates' k smallest after the
duplicates across orders are removed. Plain PyTorch, stable sorts where
JAX sorts stably.
"""
from __future__ import annotations

import torch


def _morton_key(pts: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Interleave `bits` bits per axis of the normalised points -> (N,)
    int64 key (JAX's uint32 key, whose 30 bits fit)."""
    lo = pts.amin(dim=0, keepdim=True)
    hi = pts.amax(dim=0, keepdim=True)
    q = (pts - lo) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((q * ((1 << bits) - 1)).to(torch.int64), 0, (1 << bits) - 1)

    def spread(v):
        # 10 bits to every 3rd position
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _band_knn_d2(points: torch.Tensor, key: torch.Tensor, k: int, window: int) -> torch.Tensor:
    """The k smallest squared distances within +-window of each point in the
    key-sorted order -> (N, k), in the points' order."""
    n = points.shape[0]
    dev = points.device
    order = torch.argsort(key, stable=True)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, device=dev)
    sp = points[order]
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])
    idx = torch.arange(n, device=dev)[:, None] + offsets[None, :]          # (N, 2W)
    valid = (idx >= 0) & (idx < n)
    nbrs = sp[torch.clamp(idx, 0, n - 1)]
    d2 = torch.sum(torch.square(nbrs - sp[:, None, :]), dim=-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    neg_top, _ = torch.topk(-d2, k, dim=-1)
    return (-neg_top)[inv_order]


def mean_sq_dist_to_knn(points: torch.Tensor, k: int = 3, window: int = 16) -> torch.Tensor:
    """(N, 3) points -> (N,) mean squared distance to the k approximately
    nearest neighbours (exact where each point's neighbours lie within
    `window` of it along one of the three curve orders)."""
    cands = [_band_knn_d2(points, _morton_key(points[:, list(p)]), k, window)
             for p in ((0, 1, 2), (1, 2, 0), (2, 0, 1))]
    d2, _ = torch.sort(torch.cat(cands, dim=-1), dim=-1)               # (N, 3k)
    # a neighbour found by several orders counts once
    dup = torch.cat([torch.zeros_like(d2[:, :1], dtype=torch.bool), d2[:, 1:] == d2[:, :-1]],
                    dim=-1)
    d2 = torch.where(dup, torch.full_like(d2, float("inf")), d2)
    neg_top, _ = torch.topk(-d2, k, dim=-1)
    return torch.mean(-neg_top, dim=-1)
