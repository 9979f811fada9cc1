"""GAN inversion (PTI): W-space projection, then generator fine-tuning —
port of train/inversion.py (the reference's projector_withseg.py:47-260).

`project` optimises w from w_avg with LPIPS (VGG16) + MSE under the
cosine learning-rate ramp, with decaying w-space exploration noise, the
self-adaptive camera offset (t_mapping) folded into c once up front;
`project_pti` freezes that pivot and runs Adam over every tensor of the
generator's state dict (the JAX package's param tree: buffers such as
noise_const included). Each of the JAX package's scanned loops is a plain
step loop with torch.optim.Adam; the schedules are closed-form in the step
index, as there.

Randomness: compute_w_stats draws JAX's z for a key through the port's
numpy threefry (utils/jax_random.py), so a seed gives the JAX package's
w_avg. A step's draws come from a draws object (utils/draws.py), at the
site `step{i}`: its `w` child draws the w noise, its `render` child the
renderer's stratified and importance draws, in that order — the JAX step
folds the step into its key and draws both from that one key.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..decoder.camera_sampling import pose_from_hv
from ..losses.image import area_downsample
from ..losses.lpips import VGG16LPIPS
from ..models.triplane import TriPlaneGenerator
from ..neuralfield.renderer import RenderDraws
from ..ops import resize_bilinear
from ..utils import jax_random
from ..utils.draws import draws_or_seeded
from .gan import trained_tensors

FRONTAL_INTRINSICS = ((4.2647, 0.0, 0.5), (0.0, 4.2647, 0.5), (0.0, 0.0, 1.0))


@dataclass(frozen=True)
class ProjectConfig:
    num_steps: int = 1000
    w_avg_samples: int = 10_000
    initial_learning_rate: float = 0.1
    initial_noise_factor: float = 0.05
    lr_rampdown_length: float = 0.25
    lr_rampup_length: float = 0.05
    noise_ramp_length: float = 0.75
    mse_weight: float = 0.1
    pti_learning_rate: float = 3e-4
    pti_steps: int = 1000
    neural_rendering_resolution: int = 64


def _lr_schedule(step: int, cfg: ProjectConfig) -> float:
    """(ref projector_withseg.py:122-129), in float32 as the JAX package."""
    f32 = np.float32
    t = f32(step) / f32(cfg.num_steps)
    ramp = np.minimum(f32(1.0), (f32(1.0) - t) / f32(cfg.lr_rampdown_length))
    ramp = f32(0.5) - f32(0.5) * np.cos(ramp * f32(np.pi))
    ramp = ramp * np.minimum(f32(1.0), t / f32(cfg.lr_rampup_length))
    return float(f32(cfg.initial_learning_rate) * ramp)


def frontal_camera(device=None) -> torch.Tensor:
    """(1, 25): the frontal pose at radius 2.7 and the reference's
    normalised intrinsics (focal 4.2647)."""
    h = torch.full((1, 1), math.pi / 2)
    pose = pose_from_hv(h, h.clone(), 2.7)
    intr = torch.tensor(FRONTAL_INTRINSICS, dtype=torch.float32)
    return torch.cat([pose.reshape(1, 16), intr.reshape(1, 9)], dim=1).to(device)


@torch.no_grad()
def compute_w_stats(gen: TriPlaneGenerator, key: np.ndarray, n_samples: int = 10_000,
                    chunk: int = 500) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_avg (1, 1, w_dim) and w_std over n_samples frontal-camera mappings
    (ref :73-82) of JAX's z for key (jax_random.normal), mapped on the
    generator's device in chunks of 500 as the JAX package maps them."""
    dev = next(gen.parameters()).device
    z = torch.from_numpy(jax_random.normal(key, (n_samples, gen.z_dim))).to(dev)
    c = frontal_camera(dev)
    ws = torch.cat([gen.mapping(zc, c.expand(zc.shape[0], 25))[:, :1]
                    for zc in z.split(chunk)], dim=0)
    w_avg = ws.mean(dim=0, keepdim=True)
    w_std = torch.sqrt((ws - w_avg).square().sum() / n_samples)
    return w_avg, w_std


def _render(gen: TriPlaneGenerator, ws, c, draws, nrr: int) -> torch.Tensor:
    """The image (the SR output, else the raw render) with const noise and
    the renderer's draws from the draws object's two uniform calls."""
    rk, n = gen.rk, c.shape[0]
    render = RenderDraws(
        draws.uniform((n, nrr * nrr, rk["depth_resolution"], 1)).to(c.device),
        draws.uniform((n * nrr * nrr, rk["depth_resolution_importance"])).to(c.device))
    out = gen.synthesis(ws, c, render, nrr, noise_mode="const")
    return out["image"] if "image" in out else out["image_raw"]


def _perc_features(vgg: VGG16LPIPS, img_minus1_1: torch.Tensor) -> torch.Tensor:
    """LPIPS embedding of [-1, 1] images at <= 256^2 (ref :101-105)."""
    x = (img_minus1_1 + 1) * (255.0 / 2)
    if x.shape[-1] > 256:
        x = area_downsample(x, 256)
    return vgg.embed(x)


def _loss(vgg, img, target, target_feat, cfg: ProjectConfig) -> torch.Tensor:
    perc = (_perc_features(vgg, img) - target_feat).square().sum()
    tgt = target if img.shape == target.shape else resize_bilinear(
        target, img.shape[-2], img.shape[-1], antialias=True)
    return perc + cfg.mse_weight * (img - tgt).square().mean()


def _target(target_image: torch.Tensor, dev):
    return target_image[None].to(dev, torch.float32) / 255.0 * 2 - 1


def project(gen: TriPlaneGenerator, target_image: torch.Tensor, c: torch.Tensor,
            vgg: VGG16LPIPS, key: np.ndarray, cfg: ProjectConfig = ProjectConfig(),
            draws=None, on_step=None) -> Tuple[torch.Tensor, torch.Tensor, List[float]]:
    """Stage 1 of PTI -> (w_pivot (1, num_ws, w_dim), the camera with the
    t_mapping offset folded in, the step losses). target_image (C, H, W) in
    [0, 255]; c (1, 25); key a JAX key (jax_random.PRNGKey): its first half
    draws the w statistics; draws: the steps' draws (None: a TorchDraws);
    on_step(step): called after each step (a timer's mark)."""
    dev = next(gen.parameters()).device
    k_stats, _ = jax_random.split(key)
    w_avg, w_std = compute_w_stats(gen, k_stats, cfg.w_avg_samples)
    c = c.to(dev)
    if gen.variant == "panohead":
        with torch.no_grad():
            c, _ = gen.apply_delta_c(torch.zeros((1, gen.z_dim), device=dev), c)
    target = _target(target_image, dev)
    with torch.no_grad():
        target_feat = _perc_features(vgg, target)
    w = w_avg.expand(1, gen.num_ws, w_avg.shape[-1]).clone().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    draws = draws_or_seeded(draws, key, dev)
    losses = []
    for step in range(cfg.num_steps):
        d = draws.child(f"step{step}")
        t = np.float32(step) / np.float32(cfg.num_steps)
        ramp = max(np.float32(0.0), np.float32(1.0) - t / np.float32(cfg.noise_ramp_length))
        noise_scale = w_std * np.float32(cfg.initial_noise_factor) * np.float32(ramp) ** 2
        ws = w + d.child("w").normal(tuple(w.shape)).to(dev) * noise_scale
        img = _render(gen, ws, c, d.child("render"), cfg.neural_rendering_resolution)
        loss = _loss(vgg, img, target, target_feat, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        # optax.adam(1.0) on the gradient scaled by the schedule's rate
        w.grad.mul_(_lr_schedule(step, cfg))
        opt.step()
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(step)
    return w.detach(), c.detach(), losses


def project_pti(gen: TriPlaneGenerator, w_pivot: torch.Tensor, target_image: torch.Tensor,
                c: torch.Tensor, vgg: VGG16LPIPS, key: np.ndarray,
                cfg: ProjectConfig = ProjectConfig(), draws=None, on_step=None) -> List[float]:
    """Stage 2: fine-tune every tensor of the generator's state dict at the
    frozen pivot (ref :186-260), in place -> the step losses. draws: the
    steps' renderer draws, at `step{i}` -> `render` (None: a TorchDraws
    seeded from the key); on_step(step) as project's."""
    dev = next(gen.parameters()).device
    target = _target(target_image, dev)
    with torch.no_grad():
        target_feat = _perc_features(vgg, target)
    tensors = trained_tensors(gen)
    was = [t.requires_grad for t in tensors]
    for t in tensors:
        t.requires_grad_(True)
    opt = torch.optim.Adam(tensors, lr=cfg.pti_learning_rate, betas=(0.9, 0.999), eps=1e-8)
    draws = draws_or_seeded(draws, key, dev)
    w_pivot, c = w_pivot.to(dev).detach(), c.to(dev)
    losses = []
    for step in range(cfg.pti_steps):
        d = draws.child(f"step{step}")
        img = _render(gen, w_pivot, c, d.child("render"), cfg.neural_rendering_resolution)
        loss = _loss(vgg, img, target, target_feat, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(step)
    for t, r in zip(tensors, was):
        t.requires_grad_(r)
    return losses
