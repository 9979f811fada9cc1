"""InceptionV3 feature extractor for FID / KID / PR / IS — port of
metrics/inception.py.

The pytorch-fid `fid_inception_v3` network (torchvision's InceptionV3 with
pytorch-fid's pooling: FIDInceptionA / C / E_1 average-pool with
count_include_pad=False, E_2 max-pools 3x3 stride 1), the architecture of
the converted TF weights `pt_inception-2015-12-05-6726825d.pth`. Module
and parameter names are pytorch-fid's (`Conv2d_1a_3x3.conv.weight`,
`Mixed_5b.branch1x1.bn.running_var`, `fc.weight`, ...), so load_inception
loads that file with strict=True. Each BasicConv2d is a bias-free conv,
BatchNorm (eps 1e-3) folded to a scale and shift in f32, and ReLU.

Input (N, 3, H, W) in [0, 255]; `features` resizes to 299^2 (bilinear,
align_corners=False, no antialias: pytorch-fid's) and maps to [-1, 1] ->
(N, 2048) pool3 features; `logits` adds the 2048 -> 1008 TF-class fc for
is50k. Without weights the network is seeded random (normal / sqrt(fan_in)
convs, identity BatchNorm), as the JAX package's init.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resize_bilinear

# name, cin, cout, kh, kw, stride, pad
_STEM = [
    ("Conv2d_1a_3x3", 3, 32, 3, 3, 2, 0),
    ("Conv2d_2a_3x3", 32, 32, 3, 3, 1, 0),
    ("Conv2d_2b_3x3", 32, 64, 3, 3, 1, 1),
    ("Conv2d_3b_1x1", 64, 80, 1, 1, 1, 0),
    ("Conv2d_4a_3x3", 80, 192, 3, 3, 1, 0),
]

# (name, kind, cin, kwargs)
_MIXED = [
    ("Mixed_5b", "a", 192, dict(pool_features=32)),
    ("Mixed_5c", "a", 256, dict(pool_features=64)),
    ("Mixed_5d", "a", 288, dict(pool_features=64)),
    ("Mixed_6a", "b", 288, {}),
    ("Mixed_6b", "c", 768, dict(c7=128)),
    ("Mixed_6c", "c", 768, dict(c7=160)),
    ("Mixed_6d", "c", 768, dict(c7=160)),
    ("Mixed_6e", "c", 768, dict(c7=192)),
    ("Mixed_7a", "d", 768, {}),
    ("Mixed_7b", "e1", 1280, {}),
    ("Mixed_7c", "e2", 2048, {}),
]

# branch -> (cin or None for the block's, cout or a key, kh, kw, padding (h, w), stride)
_BRANCHES = {
    "a": {"branch1x1": (None, 64, 1, 1, (0, 0), 1),
          "branch5x5_1": (None, 48, 1, 1, (0, 0), 1), "branch5x5_2": (48, 64, 5, 5, (2, 2), 1),
          "branch3x3dbl_1": (None, 64, 1, 1, (0, 0), 1),
          "branch3x3dbl_2": (64, 96, 3, 3, (1, 1), 1),
          "branch3x3dbl_3": (96, 96, 3, 3, (1, 1), 1),
          "branch_pool": (None, "pool_features", 1, 1, (0, 0), 1)},
    "b": {"branch3x3": (None, 384, 3, 3, (0, 0), 2),
          "branch3x3dbl_1": (None, 64, 1, 1, (0, 0), 1),
          "branch3x3dbl_2": (64, 96, 3, 3, (1, 1), 1),
          "branch3x3dbl_3": (96, 96, 3, 3, (0, 0), 2)},
    "c": {"branch1x1": (None, 192, 1, 1, (0, 0), 1),
          "branch7x7_1": (None, "c7", 1, 1, (0, 0), 1),
          "branch7x7_2": ("c7", "c7", 1, 7, (0, 3), 1),
          "branch7x7_3": ("c7", 192, 7, 1, (3, 0), 1),
          "branch7x7dbl_1": (None, "c7", 1, 1, (0, 0), 1),
          "branch7x7dbl_2": ("c7", "c7", 7, 1, (3, 0), 1),
          "branch7x7dbl_3": ("c7", "c7", 1, 7, (0, 3), 1),
          "branch7x7dbl_4": ("c7", "c7", 7, 1, (3, 0), 1),
          "branch7x7dbl_5": ("c7", 192, 1, 7, (0, 3), 1),
          "branch_pool": (None, 192, 1, 1, (0, 0), 1)},
    "d": {"branch3x3_1": (None, 192, 1, 1, (0, 0), 1),
          "branch3x3_2": (192, 320, 3, 3, (0, 0), 2),
          "branch7x7x3_1": (None, 192, 1, 1, (0, 0), 1),
          "branch7x7x3_2": (192, 192, 1, 7, (0, 3), 1),
          "branch7x7x3_3": (192, 192, 7, 1, (3, 0), 1),
          "branch7x7x3_4": (192, 192, 3, 3, (0, 0), 2)},
    "e": {"branch1x1": (None, 320, 1, 1, (0, 0), 1),
          "branch3x3_1": (None, 384, 1, 1, (0, 0), 1),
          "branch3x3_2a": (384, 384, 1, 3, (0, 1), 1),
          "branch3x3_2b": (384, 384, 3, 1, (1, 0), 1),
          "branch3x3dbl_1": (None, 448, 1, 1, (0, 0), 1),
          "branch3x3dbl_2": (448, 384, 3, 3, (1, 1), 1),
          "branch3x3dbl_3a": (384, 384, 1, 3, (0, 1), 1),
          "branch3x3dbl_3b": (384, 384, 3, 1, (1, 0), 1),
          "branch_pool": (None, 192, 1, 1, (0, 0), 1)},
}


class _BatchNorm(nn.Module):
    """Inference BatchNorm (eps 1e-3) without num_batches_tracked."""

    def __init__(self, c, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, kh, kw, stride=1, padding=(0, 0), generator=None,
                 device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride, padding, bias=False, device=device)
        gdev = generator.device if generator is not None else device
        with torch.no_grad():
            self.conv.weight.copy_(torch.randn(self.conv.weight.shape, generator=generator,
                                               device=gdev) / np.sqrt(cin * kh * kw))
        self.bn = _BatchNorm(cout, device)

    def forward(self, x):
        y = F.conv2d(x, self.conv.weight.to(x.dtype), stride=self.stride,
                     padding=self.padding).float()
        bn = self.bn
        scale = bn.weight * torch.rsqrt(bn.running_var + 1e-3)
        shift = bn.bias - bn.running_mean * scale
        return torch.relu(y * scale[None, :, None, None] + shift[None, :, None, None]).to(x.dtype)


def _avg_pool_nip(x):
    """avg_pool2d(3, 1, 1) with count_include_pad=False (pytorch-fid A/C/E_1)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class _Mixed(nn.Module):
    def __init__(self, kind, cin, generator=None, device=None, **kw):
        super().__init__()
        self.kind = kind
        for name, (ci, co, kh, kwid, pad, stride) in _BRANCHES[kind[0]].items():
            ci = cin if ci is None else kw[ci] if isinstance(ci, str) else ci
            co = kw[co] if isinstance(co, str) else co
            setattr(self, name, BasicConv2d(ci, co, kh, kwid, stride, pad, generator, device))

    def forward(self, x):
        k = self.kind
        if k == "a":
            b5 = self.branch5x5_2(self.branch5x5_1(x))
            b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
            return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_nip(x))], 1)
        if k == "b":
            bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
            return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)
        if k == "c":
            b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
            bd = self.branch7x7dbl_1(x)
            for i in range(2, 6):
                bd = getattr(self, f"branch7x7dbl_{i}")(bd)
            return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_nip(x))], 1)
        if k == "d":
            b3 = self.branch3x3_2(self.branch3x3_1(x))
            b7 = x
            for i in range(1, 5):
                b7 = getattr(self, f"branch7x7x3_{i}")(b7)
            return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        px = _avg_pool_nip(x) if k == "e1" else F.max_pool2d(x, 3, 1, 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(px)], 1)


class InceptionV3(nn.Module):
    """pytorch-fid-compatible InceptionV3 (pool3 features and TF logits)."""

    def __init__(self, num_classes: int = 1008, compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        for name, cin, cout, kh, kw, stride, pad in _STEM:
            setattr(self, name, BasicConv2d(cin, cout, kh, kw, stride, (pad, pad), generator,
                                            device))
        for name, kind, cin, kw in _MIXED:
            setattr(self, name, _Mixed(kind, cin, generator, device, **kw))
        self.fc = nn.Linear(2048, num_classes, device=device)
        gdev = generator.device if generator is not None else device
        with torch.no_grad():
            self.fc.weight.copy_(torch.randn(self.fc.weight.shape, generator=generator,
                                             device=gdev) / np.sqrt(2048))
            self.fc.bias.zero_()

    def features(self, img255: torch.Tensor, resize_input: bool = True) -> torch.Tensor:
        """(N, 3, H, W) in [0, 255] -> (N, 2048) pool3 features, f32."""
        x = img255.to(self.compute_dtype)
        if resize_input and tuple(x.shape[-2:]) != (299, 299):
            x = resize_bilinear(x, 299, 299, antialias=False)
        x = x / 127.5 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name, *_ in _MIXED:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()

    def logits(self, img255: torch.Tensor) -> torch.Tensor:
        """(N, 1008) TF-class logits (inception_score's classifier)."""
        return self.features(img255) @ self.fc.weight.T + self.fc.bias


def load_inception(path: str, compute_dtype: torch.dtype = torch.float32, device="cuda"
                   ) -> InceptionV3:
    """`pt_inception-2015-12-05-6726825d.pth` (or any state dict with
    pytorch-fid names) -> the InceptionV3 on `device`, loaded strictly
    (BatchNorm's num_batches_tracked, which the network does not keep,
    dropped)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    state: Dict[str, torch.Tensor] = {k: torch.as_tensor(v) for k, v in obj.items()
                                      if not k.endswith("num_batches_tracked")}
    net = InceptionV3(compute_dtype=compute_dtype, device=device)
    net.load_state_dict(state, strict=True)
    return net.eval().requires_grad_(False)

