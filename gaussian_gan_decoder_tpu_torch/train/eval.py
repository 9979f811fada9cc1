"""Decoder evaluation — port of train/eval.py (`run_eval`).

Two no-grad loops of the reference (main/eval.py:13-106) folded into one,
as in the JAX package: each of `eval_steps` steps scores a random-camera
sample (L1, L2, LPIPS, DSSIM = 1 - ssim, Sobel) and, when an IR-SE50 is
given, a near-frontal fov-10 sample (horizontal / vertical stddev 0.15 /
0.1 pi) by ID similarity; the means come back as `Metrics10k/*`. The
reference logs raw ssim under the name DSSIM (eval.py:50); here, as in
the JAX package and in training, DSSIM is 1 - ssim.

The JAX package renders through its 'xla' oracle; the port renders through
the frame blend K3 (render_simple backend 'pallas'), the same function.
Its kernels are K6 (the head chain of decoder.apply) and K3. Draws come
from a torch.Generator the caller seeds.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, Optional

import torch

from ..decoder.heads import GaussianDecoder
from ..decoder.target_pipeline import TargetDraws, TargetSamplerConfig, sample_target
from ..gaussians.cameras import make_camera
from ..losses import (IRSE50, VGG16LPIPS, id_similarity, l1_loss, l2_loss, lpips_loss,
                      sobel_loss, ssim)
from ..splat.rasterize import RasterizeConfig, render_simple
from .distill import DistillConfig


def eval_metrics(image: torch.Tensor, target: torch.Tensor, vgg: VGG16LPIPS
                 ) -> Dict[str, torch.Tensor]:
    """One random-camera sample's scores: (3, H, W) render and target."""
    return {"L1": l1_loss(image, target), "L2": l2_loss(image, target),
            "LPIPS": lpips_loss(vgg, target[None], image[None]),
            "DSSIM": 1.0 - ssim(image, target)[0], "Sobel": sobel_loss(image, target)[0]}


def frontal_config(target_cfg: TargetSamplerConfig) -> TargetSamplerConfig:
    """The ID loop's near-frontal sampler (ref eval.py:64-76)."""
    return replace(target_cfg, fov_offset=10.0, fov_offset_scale=0.0, horizontal_stddev=0.15,
                   vertical_stddev=0.1, camera_sampling="normal")


def _render_one(rng, decoder, frozen_generator, tcfg, cfg, raster_cfg, dev):
    gen = frozen_generator
    z = torch.randn((1, gen.z_dim), generator=rng).to(dev)
    t = sample_target(TargetDraws.make(rng, gen, tcfg, dev), gen, z, cfg=tcfg)
    decoded = decoder.apply(t.z, t.gan_camera_params, t.vertices, t.truncation)
    fov = float(t.fov_deg) / 360.0 * 2 * math.pi
    cam = make_camera(cfg.image_size, fov, t.cam2world_pose[0], device=dev)
    bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev)
    image = render_simple(cam, decoded, bg, raster_cfg, backend="pallas")["render"][:3]
    return image, t.img[0]


@torch.no_grad()
def run_eval(rng: torch.Generator, decoder: GaussianDecoder, frozen_generator,
             vgg: VGG16LPIPS, irse: Optional[IRSE50] = None, eval_steps: int = 100,
             cfg: DistillConfig = DistillConfig(),
             target_cfg: TargetSamplerConfig = TargetSamplerConfig(),
             raster_cfg: RasterizeConfig = RasterizeConfig()) -> Dict[str, float]:
    """-> {Metrics10k/{L1, L2, LPIPS, DSSIM, Sobel[, id]}: mean over
    eval_steps}; {} for eval_steps <= 0. rng: a CPU torch.Generator."""
    if eval_steps <= 0:
        return {}
    dev = next(decoder.parameters()).device
    fcfg = frontal_config(target_cfg)
    sums: Dict[str, torch.Tensor] = {}
    for _ in range(eval_steps):
        image, target = _render_one(rng, decoder, frozen_generator, target_cfg, cfg,
                                    raster_cfg, dev)
        metrics = eval_metrics(image, target, vgg)
        if irse is not None:
            fimg, ftgt = _render_one(rng, decoder, frozen_generator, fcfg, cfg, raster_cfg, dev)
            metrics["id"] = id_similarity(irse, fimg[None], ftgt[None]).mean()
        for name, v in metrics.items():
            sums[name] = sums.get(name, 0.0) + v.double()
    return {f"Metrics10k/{k}": float(v) / eval_steps for k, v in sums.items()}
