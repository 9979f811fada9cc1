"""VGG16-LPIPS perceptual loss — port of losses/lpips.py.

The VGG16 feature extractor (convs through conv5_3) under torchvision's
names (`features.{idx}.weight/bias`, so a torchvision-style state dict
loads with strict=True), unit-normalised taps at relu1_2, relu2_2,
relu3_3, relu4_3 and relu5_3, and the reference loss's area-downsample to
256^2 with its (img + 1) / 2 * 255 input mapping. Without pretrained weights
the network is seeded random (He-normal convs, zero biases), as in the JAX
package.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .image import area_downsample

# (out_channels, max-pool before)
_VGG16_PLAN = [(64, False), (64, False), (128, True), (128, False), (256, True),
               (256, False), (256, False), (512, True), (512, False), (512, False),
               (512, True), (512, False), (512, False)]
_LPIPS_TAPS = (1, 3, 6, 9, 12)
_IMAGENET_MEAN = (123.68, 116.779, 103.939)


class VGG16LPIPS(nn.Module):
    def __init__(self, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        layers, cin = [], 3
        for cout, pool in _VGG16_PLAN:
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            conv = nn.Conv2d(cin, cout, 3, padding=1, device=device)
            gdev = generator.device if generator is not None else device
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator,
                                              device=gdev) * np.sqrt(2.0 / (cin * 9)))
                conv.bias.zero_()
            layers += [conv, nn.ReLU()]
            cin = cout
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN, device=device).reshape(
            1, 3, 1, 1), persistent=False)

    def tap_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (N, 3, H, W) in [0, 255] -> unit-normalised tap features, in x's
        dtype end to end (a bf16 input convolves with bf16 weights and adds a
        bf16 bias, as the JAX features do)."""
        x = x - self.mean.to(x.dtype)
        feats, conv_i = [], 0
        for layer in self.features:
            if isinstance(layer, nn.Conv2d) and x.dtype != layer.weight.dtype:
                x = (F.conv2d(x, layer.weight.to(x.dtype), padding=1)
                     + layer.bias.to(x.dtype).reshape(1, -1, 1, 1))
            else:
                x = layer(x)
            if isinstance(layer, nn.ReLU):
                if conv_i in _LPIPS_TAPS:
                    feats.append(x * torch.rsqrt(x.square().sum(1, keepdim=True) + 1e-10))
                conv_i += 1
        return feats

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """Flat LPIPS embedding: the squared-difference sum of two embeddings
        is the LPIPS distance (features scaled by 1/sqrt(H W): the spatial
        mean)."""
        return torch.cat([(f / np.sqrt(f.shape[2] * f.shape[3])).reshape(f.shape[0], -1)
                          for f in self.tap_features(img)], dim=1)


    def pooled_features(self, img: torch.Tensor) -> torch.Tensor:
        """Resolution-independent (N, 1472) embedding: the global-average-
        pooled unit-normalised taps, the fixed-width feature the GAN metrics
        take without Inception weights (metrics/feature_stats.py)."""
        return torch.cat([f.mean(dim=(2, 3)) for f in self.tap_features(img)], dim=1)


def lpips_loss(vgg: VGG16LPIPS, target, image, downsampling: bool = True,
               dtype: Optional[torch.dtype] = None):
    """Area-pool to 256^2, map (img + 1) / 2 * 255 (the reference training
    loop feeds [0, 1] images to a wrapper expecting [-1, 1]; replicated),
    then the LPIPS distance, f32. dtype (e.g. torch.bfloat16): the pooled
    images and every feature in that dtype; the distance stays f32."""
    if downsampling and image.shape[2] > 256:
        image = area_downsample(image, 256)
    if downsampling and target.shape[2] > 256:
        target = area_downsample(target, 256)
    if dtype is not None:
        image, target = image.to(dtype), target.to(dtype)
    fi = vgg.embed((image + 1.0) / 2.0 * 255.0)
    ft = vgg.embed((target + 1.0) / 2.0 * 255.0)
    return (fi.float() - ft.float()).square().sum(1).mean()
