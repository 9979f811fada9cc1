"""StyleGAN2 backbone as nn.Modules — port of models/stylegan2.py.

Module and parameter names follow the reference module tree, so the flat
state dict the JAX package exports (port/torch_export.py) loads with
strict=True: mapping.{embed,fc0..fc7}.{weight,bias} + mapping.w_avg,
synthesis.b{res}.{const,conv0,conv1,torgb}.{affine.*,weight,bias,
noise_const,noise_strength}. Static resample filters are non-persistent
buffers.

Compute policy is the JAX package's: blocks at resolution >= fp16_res run
in bf16 (the reference's fp16 blocks), demodulation statistics and the
ToRGB skip image stay f32. Initialisation draws from an explicit
torch.Generator. noise_mode is 'const', 'none' or 'random'; 'random' takes
a draws object (utils/draws.py): the network asks `child("b{res}")` for
each block in resolution order, a block `child("conv0")` / `child("conv1")`
for each conv layer, and a layer draws its (N, 1, res, res) noise with one
`normal` call in its dtype, scaled by noise_strength — the sites at which
the JAX package splits its noise key.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import (activation_funcs, bias_act, conv2d_resample, modulated_conv2d, setup_filter,
                   upsample2d)


def normalize_2nd_moment(x, dim=-1, eps=1e-8):
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def _randn(shape, generator, device):
    """Normal draws from the generator on its own device, then moved: a
    seeded CPU generator gives the same weights on any device."""
    gdev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gdev,
                       dtype=torch.float32).to(device)


class FullyConnectedLayer(nn.Module):
    def __init__(self, in_features, out_features, bias=True, activation="linear",
                 lr_multiplier=1.0, bias_init=0.0, generator=None, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(
            _randn((out_features, in_features), generator, device) / lr_multiplier)
        self.bias = (nn.Parameter(torch.full((out_features,), float(bias_init),
                                             device=device) / lr_multiplier)
                     if bias else None)

    def forward(self, x):
        w = self.weight.to(x.dtype) * (self.lr_multiplier / math.sqrt(self.in_features))
        b = self.bias
        if b is not None and self.lr_multiplier != 1.0:
            b = b * self.lr_multiplier
        x = x @ w.t()
        return bias_act(x, b, dim=x.ndim - 1, act=self.activation)


class Conv2dLayer(nn.Module):
    """Plain (unmodulated) conv with optional FIR up/downsampling, the
    discriminator's layer (ref networks_stylegan2.py Conv2dLayer): weight
    gain 1/sqrt(fan_in), the weight cast to x's dtype (bf16 blocks), bias,
    activation, and a clamp scaled by the gain."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True, activation="linear",
                 up=1, down=1, resample_filter=(1, 3, 3, 1), conv_clamp=None, generator=None,
                 device=None):
        super().__init__()
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter), device=device),
                             persistent=False)
        self.weight = nn.Parameter(_randn(
            (out_channels, in_channels, kernel_size, kernel_size), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if bias else None

    def forward(self, x, gain=1.0):
        w = self.weight * self.weight_gain
        x = conv2d_resample(x, w.to(x.dtype), f=self.resample_filter, up=self.up,
                            down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1))
        act_gain = None if gain == 1.0 else activation_funcs[self.activation][2] * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class MappingNetwork(nn.Module):
    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=8, embed_features=None,
                 layer_features=None, activation="lrelu", last_activation=None,
                 lr_multiplier=0.01, w_avg_beta=0.998, generator=None, device=None):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim, self.num_ws = z_dim, c_dim, w_dim, num_ws
        self.num_layers = num_layers
        self.activation = activation
        self.last_activation = last_activation
        self.lr_multiplier = lr_multiplier
        self.w_avg_beta = w_avg_beta
        embed = w_dim if embed_features is None else embed_features
        if c_dim == 0:
            embed = 0
        layer = layer_features or w_dim
        self.features = [z_dim + embed] + [layer] * (num_layers - 1) + [w_dim]
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed, generator=generator, device=device)
        for idx in range(num_layers):
            act = activation
            if idx == num_layers - 1 and last_activation:
                act = last_activation
            setattr(self, f"fc{idx}", FullyConnectedLayer(
                self.features[idx], self.features[idx + 1], activation=act,
                lr_multiplier=lr_multiplier, generator=generator, device=device))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim, device=device))

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        """-> ws (N, num_ws, w_dim), pulled toward w_avg by truncation_psi;
        with truncation_cutoff, only ws[:, :truncation_cutoff]."""
        x = normalize_2nd_moment(z.float()) if self.z_dim > 0 else None
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=-1) if x is not None else y
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)
        if hasattr(self, "w_avg"):
            if self.num_ws is None or truncation_cutoff is None:
                x = self.w_avg + (x - self.w_avg) * truncation_psi
            else:
                head = self.w_avg + (x[:, :truncation_cutoff] - self.w_avg) * truncation_psi
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


class SynthesisLayer(nn.Module):
    def __init__(self, in_channels, out_channels, w_dim, resolution, kernel_size=3,
                 up=1, use_noise=True, activation="lrelu", resample_filter=(1, 3, 3, 1),
                 conv_clamp=None, generator=None, device=None):
        super().__init__()
        self.resolution = resolution
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter), device=device),
                             persistent=False)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0,
                                          generator=generator, device=device)
        self.weight = nn.Parameter(_randn(
            (out_channels, in_channels, kernel_size, kernel_size), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        if use_noise:
            self.register_buffer("noise_const",
                                 _randn((resolution, resolution), generator, device))
            self.noise_strength = nn.Parameter(torch.zeros((), device=device))

    def forward(self, x, w, noise_mode="const", gain=1.0, draws=None):
        if noise_mode not in ("const", "none", "random"):
            raise ValueError(f"noise_mode {noise_mode!r}: 'const', 'none' or 'random'")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            if draws is None:
                raise ValueError("noise_mode='random' needs draws")
            shape = (x.shape[0], 1, self.resolution, self.resolution)
            noise = draws.normal(shape, x.dtype).to(x.device) * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = self.noise_const.to(x.dtype) * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation][2] * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayer(nn.Module):
    def __init__(self, in_channels, out_channels, w_dim, kernel_size=1, conv_clamp=None,
                 generator=None, device=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0,
                                          generator=generator, device=device)
        self.weight = nn.Parameter(_randn(
            (out_channels, in_channels, kernel_size, kernel_size), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """'skip' architecture block (the reference generator's default); up=1
    is the super-resolution stack's SynthesisBlockNoUp."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels,
                 is_last, resample_filter=(1, 3, 3, 1), conv_clamp=None,
                 use_fp16=False, up=2, generator=None, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.resolution = resolution
        self.up = up
        self.use_fp16 = use_fp16
        self.num_conv = (1 if in_channels != 0 else 0) + 1
        self.num_torgb = 1
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter), device=device),
                             persistent=False)
        if in_channels == 0:
            self.const = nn.Parameter(_randn((out_channels, resolution, resolution),
                                             generator, device))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution,
                                        up=up, resample_filter=resample_filter,
                                        conv_clamp=conv_clamp, generator=generator,
                                        device=device)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                                    conv_clamp=conv_clamp, generator=generator,
                                    device=device)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp=conv_clamp,
                                generator=generator, device=device)

    def forward(self, x, img, ws, noise_mode="const", force_fp32=False, draws=None):
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else torch.float32

        def site(name):
            return None if draws is None else draws.child(name)

        if self.in_channels == 0:
            x = self.const.to(dtype)[None].expand(ws.shape[0], -1, -1, -1)
            x = self.conv1(x, ws[:, 0], noise_mode=noise_mode, draws=site("conv1"))
            w_rgb = ws[:, 1]
        else:
            x = self.conv0(x.to(dtype), ws[:, 0], noise_mode=noise_mode, draws=site("conv0"))
            x = self.conv1(x, ws[:, 1], noise_mode=noise_mode, draws=site("conv1"))
            w_rgb = ws[:, 2]
        if img is not None and self.up == 2:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, w_rgb).float()
        img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, num_fp16_res=4, conv_clamp=None, generator=None,
                 device=None):
        super().__init__()
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        log2 = int(math.log2(img_resolution))
        self.block_resolutions: Sequence[int] = [2 ** i for i in range(2, log2 + 1)]
        fp16_res = max(2 ** (log2 + 1 - num_fp16_res), 8)

        def channels(res):
            return min(channel_base // res, channel_max)

        self.num_ws = 0
        for res in self.block_resolutions:
            block = SynthesisBlock(
                channels(res // 2) if res > 4 else 0, channels(res), w_dim, res,
                img_channels, is_last=(res == img_resolution),
                use_fp16=(res >= fp16_res), conv_clamp=conv_clamp,
                generator=generator, device=device)
            self.num_ws += block.num_conv
            setattr(self, f"b{res}", block)
        self.num_ws += 1   # the last block's ToRGB

    def forward(self, ws, noise_mode="const", force_fp32=False, draws=None):
        ws = ws.float()
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            cur = ws[:, w_idx:w_idx + block.num_conv + block.num_torgb]
            x, img = block(x, img, cur, noise_mode=noise_mode, force_fp32=force_fp32,
                           draws=None if draws is None else draws.child(f"b{res}"))
            w_idx += block.num_conv
        return img


class Generator(nn.Module):
    """StyleGAN2 generator (mapping + synthesis), 'skip' architecture."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 channel_base=32768, channel_max=512, num_fp16_res=4, conv_clamp=None,
                 mapping_kwargs: Optional[dict] = None, generator=None, device=None):
        super().__init__()
        self.synthesis = SynthesisNetwork(
            w_dim, img_resolution, img_channels, channel_base=channel_base,
            channel_max=channel_max, num_fp16_res=num_fp16_res, conv_clamp=conv_clamp,
            generator=generator, device=device)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, self.num_ws,
                                      generator=generator, device=device,
                                      **(mapping_kwargs or {}))
