"""StyleGAN2 / EG3D / PanoHead discriminators — port of
models/discriminator.py.

DiscriminatorBlock, minibatch_std, DiscriminatorEpilogue, filtered_resizing
and Discriminator in the modes 'single' / 'plain' (one image), 'dual' (EG3D:
the image beside its raw render resized to the image's size) and
'mask_dual' (PanoHead: 'dual' plus a segmentation branch of its own blocks
`sb{res}`, summed into the trunk before the epilogue). Module and parameter
names follow the reference module tree (b{res}.{fromrgb,conv0,conv1,skip},
sb{res}.*, mapping.{embed,fc0..fc7}, b4.{conv,fc,out}), so the flat state
dict of the JAX package's param tree loads with strict=True
(port/from_jax.load_discriminator_state). Blocks at the top num_fp16_res
resolutions run in bf16, as the JAX package runs the reference's fp16
blocks; the epilogue runs in f32.

The conditioning noise of disc_c_noise > 0 is an explicit draw: forward
takes `noise`, a standard normal tensor of c's shape, where the JAX package
takes a key.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Optional

import torch
from torch import nn

from ..ops import downsample2d, resize_bilinear, setup_filter, upsample2d
from .stylegan2 import Conv2dLayer, FullyConnectedLayer, MappingNetwork


class DiscriminatorBlock(nn.Module):
    def __init__(self, in_channels, tmp_channels, out_channels, resolution, img_channels,
                 architecture="resnet", activation="lrelu", resample_filter=(1, 3, 3, 1),
                 conv_clamp=None, use_fp16=False, generator=None, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.resolution = resolution
        self.architecture = architecture
        self.use_fp16 = use_fp16
        kw = dict(generator=generator, device=device)
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter), device=device),
                             persistent=False)
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, activation=activation,
                                       conv_clamp=conv_clamp, **kw)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3, activation=activation,
                                 conv_clamp=conv_clamp, **kw)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, activation=activation, down=2,
                                 resample_filter=resample_filter, conv_clamp=conv_clamp, **kw)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, 1, bias=False, down=2,
                                    resample_filter=resample_filter, **kw)

    def forward(self, x, img, force_fp32=False):
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else torch.float32
        if x is not None:
            x = x.to(dtype)
        if self.in_channels == 0 or self.architecture == "skip":
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter)
                   if self.architecture == "skip" else None)
        if self.architecture == "resnet":
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=math.sqrt(0.5))
            x = y + x
        else:
            x = self.conv1(self.conv0(x))
        return x, img


def minibatch_std(x, group_size: Optional[int] = 4, num_channels: int = 1):
    """Append the per-group feature standard deviation as channels (ref
    networks_stylegan2.py:651-676); N must divide by the group."""
    N, C, H, W = x.shape
    g = min(group_size, N) if group_size is not None else N
    f = num_channels
    y = x.reshape(g, -1, f, C // f, H, W)
    y = y - y.mean(dim=0)
    y = y.square().mean(dim=0)
    y = torch.sqrt(y + 1e-8)
    y = y.mean(dim=(2, 3, 4))
    y = y.reshape(-1, f, 1, 1).repeat(g, 1, H, W)
    return torch.cat([x, y.to(x.dtype)], dim=1)


class DiscriminatorEpilogue(nn.Module):
    def __init__(self, in_channels, cmap_dim, resolution=4, img_channels=3,
                 architecture="resnet", mbstd_group_size=4, mbstd_num_channels=1,
                 activation="lrelu", conv_clamp=None, generator=None, device=None):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.architecture = architecture
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        kw = dict(generator=generator, device=device)
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, 1, activation=activation, **kw)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, 3,
                                activation=activation, conv_clamp=conv_clamp, **kw)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation, **kw)
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim, **kw)

    def forward(self, x, img, cmap):
        x = x.float()
        if self.architecture == "skip":
            x = x + self.fromrgb(img.float())
        if self.mbstd_num_channels > 0:
            x = minibatch_std(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x)
        x = self.fc(x.reshape(x.shape[0], -1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return x


def filtered_resizing(image, size: int, filter_mode="antialiased", f=None):
    """Resize to size² (ref dual_discriminator.py:79-97): 'antialiased'
    (bilinear with torch's antialias), 'classic' (2x FIR upsample, bilinear
    to 2·size + 2, flipped-filter downsample cropping 1), 'none' (plain
    bilinear), or a float: that blend of antialiased over plain."""
    if filter_mode == "antialiased":
        return resize_bilinear(image, size, size, antialias=True)
    if filter_mode == "classic":
        x = upsample2d(image, f, up=2)
        x = resize_bilinear(x, size * 2 + 2, size * 2 + 2)
        return downsample2d(x, f, down=2, flip_filter=True, padding=-1)
    if filter_mode == "none":
        return resize_bilinear(image, size, size, antialias=False)
    if isinstance(filter_mode, float):
        a = resize_bilinear(image, size, size, antialias=True)
        b = resize_bilinear(image, size, size, antialias=False)
        return (1 - filter_mode) * b + filter_mode * a
    raise ValueError(filter_mode)


@dataclass(frozen=True)
class DiscriminatorConfig:
    """The constructor arguments of a Discriminator (the JAX package's
    Discriminator dataclass fields)."""
    c_dim: int
    img_resolution: int
    img_channels: int
    mode: str = "single"            # 'single' | 'plain' | 'dual' | 'mask_dual'
    architecture: str = "resnet"
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 4
    conv_clamp: Optional[float] = 256.0
    cmap_dim: Optional[int] = None
    disc_c_noise: float = 0.0
    seg_resolution: int = 64
    seg_channels: int = 1
    mbstd_group_size: Optional[int] = 4


def _block_resolutions(res: int):
    return [2 ** i for i in range(int(math.log2(res)), 2, -1)]


class Discriminator(nn.Module):
    """The SG2 discriminator, and the trunk of the dual / mask-dual ones."""

    def __init__(self, c_dim, img_resolution, img_channels, mode="single",
                 architecture="resnet", channel_base=32768, channel_max=512, num_fp16_res=4,
                 conv_clamp=256.0, cmap_dim=None, disc_c_noise=0.0, seg_resolution=64,
                 seg_channels=1, mbstd_group_size=4, generator=None, device=None):
        super().__init__()
        self.config = DiscriminatorConfig(
            c_dim, img_resolution, img_channels, mode, architecture, channel_base, channel_max,
            num_fp16_res, conv_clamp, cmap_dim, disc_c_noise, seg_resolution, seg_channels,
            mbstd_group_size)
        self.c_dim, self.img_resolution, self.mode = c_dim, img_resolution, mode
        self.disc_c_noise, self.seg_resolution = disc_c_noise, seg_resolution
        self.block_resolutions = _block_resolutions(img_resolution)
        self.seg_block_resolutions = _block_resolutions(seg_resolution)
        eff_channels = img_channels * 2 if mode in ("dual", "mask_dual") else img_channels
        ch = {r: min(channel_base // r, channel_max) for r in self.block_resolutions + [4]}
        cmap = 0 if c_dim == 0 else (cmap_dim if cmap_dim is not None else ch[4])
        fp16_res = max(2 ** (int(math.log2(img_resolution)) + 1 - num_fp16_res), 8)
        kw = dict(generator=generator, device=device)

        def blocks(prefix, resolutions, channels, top):
            for res in resolutions:
                # the seg branch takes the trunk's widths at its resolutions
                setattr(self, f"{prefix}b{res}", DiscriminatorBlock(
                    ch[res] if res < top else 0, ch[res], ch[res // 2], res, channels,
                    architecture=architecture, conv_clamp=conv_clamp,
                    use_fp16=(res >= fp16_res), **kw))

        blocks("", self.block_resolutions, eff_channels, img_resolution)
        if mode == "mask_dual":
            blocks("s", self.seg_block_resolutions, seg_channels, seg_resolution)
        if c_dim > 0:
            self.mapping = MappingNetwork(0, c_dim, cmap, num_ws=None, w_avg_beta=None, **kw)
        self.b4 = DiscriminatorEpilogue(ch[4], cmap, resolution=4, img_channels=eff_channels,
                                        architecture=architecture, conv_clamp=conv_clamp,
                                        mbstd_group_size=mbstd_group_size, **kw)
        self.register_buffer("resample_filter", setup_filter([1, 3, 3, 1], device=device),
                             persistent=False)

    @classmethod
    def from_config(cls, config: DiscriminatorConfig, generator=None, device=None):
        kw = {f.name: getattr(config, f.name) for f in fields(config)}
        return cls(**kw, generator=generator, device=device)

    def forward(self, img, c, noise: Optional[torch.Tensor] = None, force_fp32=False):
        """img: a tensor ('single' / 'plain') or a dict with image and
        image_raw (+ image_mask for 'mask_dual'); noise: the conditioning
        noise draw (c's shape), read when disc_c_noise > 0 -> logits (N, 1)."""
        f = self.resample_filter
        seg = None
        if self.mode in ("dual", "mask_dual"):
            raw = filtered_resizing(img["image_raw"], img["image"].shape[-1], "antialiased", f)
            if self.mode == "mask_dual":
                seg = 2 * filtered_resizing(img["image_mask"], self.seg_resolution,
                                            "antialiased", f) - 1
            img = torch.cat([img["image"], raw], dim=1)
        elif isinstance(img, dict):
            img = img["image"]

        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, force_fp32)
        if seg is not None:
            xs = None
            for res in self.seg_block_resolutions:
                xs, seg = getattr(self, f"sb{res}")(xs, seg, force_fp32)
            x = x + xs

        cmap = None
        if self.c_dim > 0:
            if self.disc_c_noise > 0:
                if noise is None:
                    raise ValueError("disc_c_noise > 0 needs the noise draw")
                c = c + noise * c.std(dim=0, correction=0) * self.disc_c_noise
            cmap = self.mapping(None, c)
        return self.b4(x, img, cmap)

