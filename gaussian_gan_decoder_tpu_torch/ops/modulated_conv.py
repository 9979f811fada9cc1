"""Conv2d with FIR upsampling + StyleGAN2 modulated conv — port of
ops/modulated_conv.py.

Plain PyTorch, same execution strategy as the JAX package: modulation
scales the activations (conv(x * s, W) * d == conv(x, W * s) * d), so one
batched conv serves any batch size; the up=2 path is zero insertion + FIR
(upfirdn2d) followed by the weight conv.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .upfirdn2d import _get_filter_size, _parse_padding, upfirdn2d


def _conv2d(x, w, padding=(0, 0, 0, 0), flip_weight=True, stride=1):
    """NCHW conv; padding (py0, py1, px0, px1). flip_weight=True is a plain
    correlation (torch conv2d)."""
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    py0, py1, px0, px1 = padding
    if py0 != py1 or px0 != px1:
        x = F.pad(x, [px0, px1, py0, py1])
        py0 = px0 = 0
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(py0, px0))


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[torch.Tensor] = None,
    up: int = 1,
    padding=0,
    flip_weight: bool = True,
    down: int = 1,
) -> torch.Tensor:
    """2D conv with optional FIR upsampling or downsampling; padding is
    w.r.t. the upsampled image and applied once up front. down > 1 (the
    discriminator's) filters and pads, then runs a strided weight conv."""
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    if down > 1:
        assert up == 1, "the port resamples one way a conv"
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1])
        return _conv2d(x, w, flip_weight=flip_weight, stride=down)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2)
        return _conv2d(x, w, flip_weight=flip_weight)
    return _conv2d(x, w, padding=(py0, py1, px0, px1), flip_weight=flip_weight)


def modulated_conv2d(
    x: torch.Tensor,                 # (N, C_in, H, W)
    weight: torch.Tensor,            # (C_out, C_in, kh, kw)
    styles: torch.Tensor,            # (N, C_in)
    noise: Optional[torch.Tensor] = None,
    up: int = 1,
    padding: int = 0,
    resample_filter: Optional[torch.Tensor] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
) -> torch.Tensor:
    """StyleGAN2 modulated conv via activation scaling. Demodulation
    statistics are taken in f32 whatever x's dtype."""
    dcoefs = None
    if demodulate:
        wf = weight[None].float() * styles.float()[:, None, :, None, None]
        dcoefs = torch.rsqrt(wf.square().sum(dim=(2, 3, 4)) + 1e-8)  # (N, O)

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
