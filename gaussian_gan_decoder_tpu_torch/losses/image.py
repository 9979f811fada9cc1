"""Image-space losses: L1, L2, windowed SSIM, Sobel — port of
losses/image.py (11x11 Gaussian window sigma 1.5, zero-padded depthwise
convolutions; Sobel kernels summed over the RGB channels)."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a, b):
    return (a - b).abs().mean()


def l2_loss(a, b):
    return (a - b).square().mean()


@lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise(x, k):
    c = x.shape[1]
    w = torch.tensor(k, dtype=x.dtype, device=x.device)[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, w, padding=(k.shape[0] // 2, k.shape[1] // 2), groups=c)


def ssim(img1, img2, window_size: int = 11):
    """-> (mean ssim, ssim map); inputs (C, H, W) or (N, C, H, W)."""
    squeeze = img1.ndim == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    w = _gaussian_window(window_size, 1.5)
    mu1, mu2 = _depthwise(img1, w), _depthwise(img2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise(img1 * img1, w) - mu1_sq
    sigma2_sq = _depthwise(img2 * img2, w) - mu2_sq
    sigma12 = _depthwise(img1 * img2, w) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if squeeze:
        ssim_map = ssim_map[0]
    return ssim_map.mean(), ssim_map


_SOBEL_X = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
_SOBEL_Y = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32)


def _sobel(x, k):
    w = torch.tensor(k, dtype=x.dtype, device=x.device)[None, None].expand(1, x.shape[1], 3, 3)
    return F.conv2d(x, w, padding=1)


def sobel_loss(render, target):
    """-> (mean squared gradient difference, map); (C, H, W) or (N, C, H, W)."""
    if render.ndim == 3:
        render, target = render[None], target[None]
    dx = _sobel(render, _SOBEL_X) - _sobel(target, _SOBEL_X)
    dy = _sobel(render, _SOBEL_Y) - _sobel(target, _SOBEL_Y)
    diff = dx.square() + dy.square()
    return diff.mean(), diff


def area_downsample(x, out: int):
    """F.interpolate(mode='area') for integer factors: average pooling."""
    n, c, h, w = x.shape
    f = h // out
    assert f * out == h and w // out * out == w, (h, w, out)
    return x.reshape(n, c, out, f, out, f).mean(dim=(3, 5))
