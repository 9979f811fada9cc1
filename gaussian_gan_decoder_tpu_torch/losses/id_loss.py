"""Face-identity loss through an IR-SE-50 ArcFace backbone — port of
losses/id_loss.py.

IRSE50 is an nn.Module whose parameter and buffer names are those of the
reference's `model_ir_se50.pth` (main/models/encoders/model_irse.py:9-84,
helpers.py): input_layer.{0 conv, 1 BatchNorm, 2 PReLU},
body.{i}.res_layer.{0 BatchNorm, 1 conv, 2 PReLU, 3 conv, 4 BatchNorm,
5 SE (fc1, fc2)}, body.{i}.shortcut_layer.{0 conv, 1 BatchNorm} where a
unit changes width, output_layer.{0 BatchNorm2d, 3 Linear, 4 BatchNorm1d}.
So the names the JAX package's IRSE50.load_torch_state_dict reads load
with strict=True (load_irse50_state; `num_batches_tracked` entries of a
real checkpoint are dropped). Inference only: BatchNorm with its running
statistics (the reference calls .eval()), dropout the identity.

The ArcFace weights are not in the repository: without them the network is
seeded random (`IRSE50(generator=...)`, He-normal convs and identity
BatchNorm, as the JAX init; `random_irse50` also draws the BatchNorm
statistics, for runs that must not embed a black crop to 0/0).

Pipeline (ref main/loss_utils/id_loss.py:16-28): area-downsample to 256^2,
crop rows 35:223 and cols 32:220, adaptive average pool to 112^2, embed,
1 - <x, y> with the target's embedding detached.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .image import area_downsample


def _blocks_50() -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) of the 24 units (ref helpers.py:25-36)."""
    out = []
    for cin, depth, units in [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)]:
        out.append((cin, depth, 2))
        out += [(depth, depth, 1)] * (units - 1)
    return out


def _conv_weight(cout, cin, ks, generator, device):
    gdev = generator.device if generator is not None else device
    w = torch.randn((cout, cin, ks, ks), generator=generator, device=gdev)
    return nn.Parameter((w * np.sqrt(2.0 / (cin * ks * ks))).to(device))


class _Conv(nn.Module):
    """Bias-free convolution (its weight under `weight`)."""

    def __init__(self, cin, cout, ks, stride=1, padding=0, generator=None, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = _conv_weight(cout, cin, ks, generator, device)

    def forward(self, x):
        return F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class _BatchNorm(nn.Module):
    """Eval-mode BatchNorm (1-D or 2-D input), as the JAX package folds it:
    x * w / sqrt(var + 1e-5) + (b - mean * w / sqrt(var + 1e-5))."""

    def __init__(self, c, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + 1e-5)
        scale = self.weight * inv
        shift = self.bias - self.running_mean * self.weight * inv
        if x.ndim == 4:
            return x * scale[None, :, None, None] + shift[None, :, None, None]
        return x * scale + shift


class _PReLU(nn.Module):
    def __init__(self, c, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((c,), 0.25, device=device))

    def forward(self, x):
        a = self.weight[None, :, None, None] if x.ndim == 4 else self.weight
        return torch.where(x >= 0, x, a * x)


class _SE(nn.Module):
    def __init__(self, c, generator=None, device=None):
        super().__init__()
        self.fc1 = _Conv(c, c // 16, 1, generator=generator, device=device)
        self.fc2 = _Conv(c // 16, c, 1, generator=generator, device=device)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class _Unit(nn.Module):
    """bottleneck_IR_SE (ref model_irse.py / helpers.py)."""

    def __init__(self, cin, depth, stride, generator=None, device=None):
        super().__init__()
        self.stride = stride
        kw = dict(generator=generator, device=device)
        self.shortcut_layer = None if cin == depth else nn.Sequential(
            _Conv(cin, depth, 1, stride, **kw), _BatchNorm(depth, device))
        self.res_layer = nn.Sequential(
            _BatchNorm(cin, device), _Conv(cin, depth, 3, 1, 1, **kw), _PReLU(depth, device),
            _Conv(depth, depth, 3, stride, 1, **kw), _BatchNorm(depth, device), _SE(depth, **kw))

    def forward(self, x):
        if self.shortcut_layer is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]   # MaxPool2d(1, stride)
        else:
            shortcut = self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


class IRSE50(nn.Module):
    def __init__(self, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.input_layer = nn.Sequential(_Conv(3, 64, 3, 1, 1, **kw), _BatchNorm(64, device),
                                         _PReLU(64, device))
        self.body = nn.Sequential(*[_Unit(cin, depth, stride, **kw)
                                    for cin, depth, stride in _blocks_50()])
        gdev = generator.device if generator is not None else device
        linear = nn.Linear(512 * 7 * 7, 512, device=device)
        with torch.no_grad():
            linear.weight.copy_(torch.randn(linear.weight.shape, generator=generator,
                                            device=gdev) * 0.01)
            linear.bias.zero_()
        # indices 1 (Dropout) and 2 (Flatten) hold no weights
        self.output_layer = nn.Sequential(_BatchNorm(512, device), nn.Identity(), nn.Flatten(),
                                          linear, _BatchNorm(512, device))
        self.requires_grad_(False)   # a frozen loss network

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3, 112, 112) -> l2-normalised (N, 512)."""
        x = self.output_layer(self.body(self.input_layer(x)))
        return x / torch.linalg.norm(x, dim=1, keepdim=True)

    def extract_feats(self, img: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) -> embeddings: area pool to 256^2 above that size,
        crop rows 35:223 and cols 32:220, adaptive average pool to 112^2
        (ref id_loss.py:16-22)."""
        if img.shape[2] > 256:
            img = area_downsample(img, 256)
        img = img[:, :, 35:223, 32:220]
        return self.embed(F.adaptive_avg_pool2d(img, 112))


def random_irse50(generator: torch.Generator, device=None) -> IRSE50:
    """A seeded random IR-SE50 for runs without the ArcFace weights: the
    plain init, then random BatchNorm scales (1 + 0.1 n), shifts and
    running means (0.1 n) and variances (U[0.5, 1.5)), and each unit's
    second convolution scaled by 0.3. With the plain init's identity
    BatchNorm every layer is bias-free, so an all-black crop (a target whose
    head misses the crop) embeds to the zero vector and its normalisation
    is 0/0, as it would be in the JAX package; trained weights have
    non-zero shifts, and so has this network. The scaled residual branches
    keep the random network's f32 rounding small (with them at 1.0, f32
    moves a unit embedding by ~4e-2, at 0.3 by ~2e-7)."""
    model = IRSE50(generator=generator, device=device)
    gdev = generator.device

    def draw(shape, kind):
        if kind == "uniform":
            return torch.rand(shape, generator=generator, device=gdev).to(device) + 0.5
        return torch.randn(shape, generator=generator, device=gdev).to(device)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _BatchNorm):
                c = m.weight.shape
                m.weight.copy_(1.0 + 0.1 * draw(c, "normal"))
                m.bias.copy_(0.1 * draw(c, "normal"))
                m.running_mean.copy_(0.1 * draw(c, "normal"))
                m.running_var.copy_(draw(c, "uniform"))
            elif isinstance(m, _Unit):
                m.res_layer[3].weight.mul_(0.3)
    return model


def load_irse50_state(model: IRSE50, state: Union[str, Mapping]) -> None:
    """Load `model_ir_se50.pth`-named weights (a path of a torch file, or a
    mapping of tensors or arrays) strictly; `num_batches_tracked` entries
    are dropped."""
    if isinstance(state, str):
        state = torch.load(state, map_location="cpu", weights_only=True)
    sd = {k: torch.as_tensor(np.asarray(v, np.float32) if not torch.is_tensor(v) else v)
          for k, v in state.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=True)


def id_loss(model: IRSE50, synth_image, target_image):
    """1 - <emb(synth), emb(target)> averaged over the batch, the target's
    embedding detached (ref id_loss.py:24-28)."""
    x = model.extract_feats(synth_image)
    with torch.no_grad():
        y = model.extract_feats(target_image)
    return 1.0 - (x * y).sum(1).mean()


def id_similarity(model: IRSE50, synth_image, target_image):
    return (model.extract_feats(synth_image) * model.extract_feats(target_image)).sum(1)
