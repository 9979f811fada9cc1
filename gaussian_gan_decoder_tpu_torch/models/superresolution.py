"""EG3D / PanoHead super-resolution stacks — port of
models/superresolution.py.

Each stack is two StyleGAN2 SynthesisBlocks conditioned on the last w
repeated 3x, after a bilinear (optionally antialiased) resize of the raw
and feature images to the stack's input resolution. Parameter names follow
the reference (block0.*, block1.*), so the JAX export loads strictly.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import resize_bilinear
from .stylegan2 import SynthesisBlock

# name -> (input_res, b0_out, b1_out, b0_res, b1_res, b0_up, returns_feats)
_VARIANTS = {
    "SuperresolutionHybrid8X": (128, 128, 64, 256, 512, True, False),
    "SuperresolutionHybrid8XDC": (128, 256, 128, 256, 512, True, False),
    "SuperresolutionHybrid4X": (128, 128, 64, 128, 256, False, False),
    "SuperresolutionHybrid4XCustom": (256, 128, 96, 512, 1024, True, True),
    "SuperresolutionHybrid2X": (64, 128, 64, 64, 128, False, False),
    "SuperresolutionHybrid2XCustom": (64, 128, 96, 256, 512, False, False),
    "SuperresolutionHybridDeepfp32": (128, 128, 64, 128, 256, False, False),
}


class Superresolution(nn.Module):
    def __init__(self, channels: int, input_resolution: int, block0_out: int,
                 block1_out: int, block0_res: int, block1_res: int, block0_up: bool,
                 sr_antialias: bool = True, use_fp16: bool = False,
                 returns_features: bool = False, generator=None, device=None):
        super().__init__()
        self.input_resolution = input_resolution
        self.block0_up = block0_up
        self.sr_antialias = sr_antialias
        self.returns_features = returns_features
        clamp = 256.0 if use_fp16 else None
        self.block0 = SynthesisBlock(channels, block0_out, 512, block0_res, 3, is_last=False,
                                     conv_clamp=clamp, use_fp16=use_fp16,
                                     up=2 if block0_up else 1, generator=generator,
                                     device=device)
        self.block1 = SynthesisBlock(block0_out, block1_out, 512, block1_res, 3, is_last=True,
                                     conv_clamp=clamp, use_fp16=use_fp16,
                                     generator=generator, device=device)

    def forward(self, rgb, x, ws, noise_mode="const", draws=None):
        """rgb (N, 3, h, w), x (N, C, h, w), ws (N, num_ws, 512) -> (image,
        raw_alias): raw_alias is block0's image when block0 neither resizes
        nor upsamples the raw image — the reference adds block0's ToRGB skip
        into the caller's image_raw in place (networks_stylegan2.py:461,
        triplane.py:392-399) — else None. draws: noise_mode 'random''s
        draws, at the sites `block0` and `block1` (the JAX package splits
        its noise key in two)."""
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        aliases = not self.block0_up and x.shape[-1] == self.input_resolution
        if x.shape[-1] != self.input_resolution:
            r = self.input_resolution
            x = resize_bilinear(x, r, r, antialias=self.sr_antialias)
            rgb = resize_bilinear(rgb, r, r, antialias=self.sr_antialias)
        def site(name):
            return None if draws is None else draws.child(name)

        x, rgb = self.block0(x, rgb, ws, noise_mode=noise_mode, draws=site("block0"))
        raw_alias = rgb if aliases else None
        x, rgb = self.block1(x, rgb, ws, noise_mode=noise_mode, draws=site("block1"))
        return (x if self.returns_features else rgb), raw_alias


def _variant(class_name: str):
    short = class_name.rsplit(".", 1)[-1]
    if short not in _VARIANTS:
        raise ValueError(f"unknown superresolution module: {class_name}")
    return _VARIANTS[short]


def sr_input_resolution(class_name: str) -> int:
    """The input resolution of the SR stack named class_name (the
    background synthesis' output resolution, models/triplane.py)."""
    return _variant(class_name)[0]


def make_superresolution(class_name: str, channels: int, sr_num_fp16_res: int = 0,
                         sr_antialias: bool = True, generator: Optional[torch.Generator] = None,
                         device=None) -> Superresolution:
    """Build an SR stack from the reference's dotted class name."""
    in_res, b0o, b1o, b0r, b1r, b0up, rfeat = _variant(class_name)
    return Superresolution(channels, in_res, b0o, b1o, b0r, b1r, b0up, sr_antialias,
                           use_fp16=sr_num_fp16_res > 0, returns_features=rfeat,
                           generator=generator, device=device)
