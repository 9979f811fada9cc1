"""Pad -> upsample -> FIR filter -> downsample — port of ops/upfirdn2d.py.

Plain PyTorch in the shape of the reference's `impl='ref'` path: zero
insertion, pad/crop, a depthwise conv with the (flipped) filter, then
decimation. torch convs are cross-correlations, so the filter is flipped
unless flip_filter=True, exactly like the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def _get_filter_size(f: Optional[torch.Tensor]):
    if f is None:
        return 1, 1
    assert f.ndim in (1, 2)
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(
    f: Union[None, int, float, Sequence],
    normalize: bool = True,
    flip_filter: bool = False,
    gain: float = 1.0,
    separable: Optional[bool] = None,
    device=None,
) -> torch.Tensor:
    """FIR filter constant (f32): normalize to unit sum, optional flip, fold
    gain ** (ndim/2), promote 1-D taps to an outer product unless separable."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f, axis=tuple(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return torch.tensor(np.ascontiguousarray(f, dtype=np.float32), device=device)


def upfirdn2d(
    x: torch.Tensor,
    f: Optional[torch.Tensor],
    up: Union[int, Sequence[int]] = 1,
    down: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int]] = 0,
    flip_filter: bool = False,
    gain: float = 1.0,
) -> torch.Tensor:
    """NCHW upfirdn2d; padding is w.r.t. the upsampled image, negative crops."""
    assert x.ndim == 4, "expected NCHW"
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    B, C, H, W = x.shape

    # zero insertion (up-1 zeros after every pixel, the last one included)
    x = x.reshape(B, C, H, 1, W, 1)
    x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
    x = x.reshape(B, C, H * upy, W * upx)
    # pad, then crop the negative sides
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0): x.shape[2] - max(-pady1, 0),
          max(-padx0, 0): x.shape[3] - max(-padx1, 0)]

    f = f * (float(gain) ** (f.ndim / 2))
    f = f.to(x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    # one filter for every channel: the channels go into the batch and the
    # conv has one input channel. This is the depthwise conv's result bit
    # for bit, and its double backward (R1 through the discriminator) stays
    # one conv, where a grouped conv's runs one conv a group.
    Hp, Wp = x.shape[2], x.shape[3]
    x = x.reshape(B * C, 1, Hp, Wp)
    if f.ndim == 2:
        x = F.conv2d(x, f[None, None])
    else:
        x = F.conv2d(x, f[None, None, :, None])   # vertical taps
        x = F.conv2d(x, f[None, None, None, :])   # horizontal taps
    x = x.reshape(B, C, x.shape[2], x.shape[3])
    return x[:, :, ::downy, ::downx]


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """FIR upsample by `up` (reference upsample2d padding rule)."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        padx0 + (fw + upx - 1) // 2,
        padx1 + (fw - upx) // 2,
        pady0 + (fh + upy - 1) // 2,
        pady1 + (fh - upy) // 2,
    ]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    """Shape-preserving FIR filter (reference filter2d padding rule)."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        padx0 + fw // 2,
        padx1 + (fw - 1) // 2,
        pady0 + fh // 2,
        pady1 + (fh - 1) // 2,
    ]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """FIR downsample by `down` (reference downsample2d padding rule)."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        padx0 + (fw - downx + 1) // 2,
        padx1 + (fw - downx) // 2,
        pady0 + (fh - downy + 1) // 2,
        pady1 + (fh - downy) // 2,
    ]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
