"""StyleGAN3's filtered leaky ReLU — port of ops/filtered_lrelu.py (the
reference's torch_utils/ops/filtered_lrelu.py composition path, :123-156):
bias, FIR upsample, leaky ReLU with gain and clamp, FIR downsample, each
an op of this package (ops/bias_act.py, ops/upfirdn2d.py) in plain
PyTorch; autograd gives the backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .bias_act import bias_act
from .upfirdn2d import upfirdn2d


def filtered_lrelu(x: torch.Tensor, fu: Optional[torch.Tensor] = None,
                   fd: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
                   up: int = 1, down: int = 1, padding=0, gain: float = math.sqrt(2),
                   slope: float = 0.2, clamp: Optional[float] = None,
                   flip_filter: bool = False) -> torch.Tensor:
    """bias -> FIR upsample (fu, gain up^2) -> lrelu (* gain, clamp) -> FIR
    downsample (fd). padding is upfirdn2d's, of the upsampling pass."""
    if b is not None:
        x = bias_act(x, b, dim=1)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2, flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
