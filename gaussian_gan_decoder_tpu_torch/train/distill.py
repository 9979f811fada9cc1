"""Distillation training step — port of train/distill.py.

Per step: sample_target on the FROZEN generator (camera, truncation, the
512^2 target image, the surface point cloud) without gradient; decode the
surface points with the trainable G copy and the heads; render them with
the differentiable rasterizer; loss = 0.2 L1 + 0.1 L2 + 1.0 LPIPS +
0.5 DSSIM + 0.2 Sobel (+ 1.0 ID on a frontal view with fov > 8 degrees,
when an IR-SE50 is given); backward; one Adam step over the heads and the
G copy. The frontal gate (ref :243-251) is decided on the host from the
step's camera draws, so the IR-SE50 runs only on frontal views and the
step reads nothing back from the card for it.

The step runs eagerly; its kernels are K6 / K7 (head chain), K4 / K5
(training blend, raster_backend 'pallas_diff'; 'xla' renders with the f32
tile rasterizer in plain PyTorch) and, with a probe option in the target
config, K10 (the frozen target's probe table). A stage_timer, when given, is called with each stage's
name as the stage is issued: target, decode, render, losses, backward,
optimizer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..decoder.heads import GaussianDecoder
from ..decoder.target_pipeline import TargetDraws, TargetSamplerConfig, sample_target
from ..gaussians.cameras import make_camera
from ..losses import IRSE50, VGG16LPIPS, id_loss, l1_loss, l2_loss, lpips_loss, sobel_loss, ssim
from ..ops import resize_bilinear
from ..splat.rasterize import RasterizeConfig, render_simple


@dataclass(frozen=True)
class DistillConfig:
    """The JAX package's DistillConfig. raster_backend defaults to
    'pallas_diff' here, the JAX trainer's default and the path the kernels
    serve (the JAX dataclass's default is 'xla')."""
    lr: float = 9e-5
    l1_weight: float = 0.2
    l2_weight: float = 0.1
    lpips_weight: float = 1.0
    ssim_weight: float = 0.5
    sobel_weight: float = 0.2
    id_loss_weight: float = 1.0
    image_size: int = 512
    apply_mask_to_rendering: bool = False
    bg_color: Tuple[float, float, float] = (0.55717, 0.52256, 0.51045)
    id_cam_threshold: float = math.pi * 0.2
    id_min_fov: float = 8.0
    use_gen_finetune: bool = True
    # use_gen_finetune=False only: decode from the frozen target's planes
    # instead of re-synthesising on the (identical, frozen) copy; False if
    # the copy may have diverged from the frozen generator. Never for the
    # 'sequential' decoder, whose mapping sees the real camera
    reuse_frozen_planes: bool = True
    raster_backend: str = "pallas_diff"   # 'pallas_diff' (K4 / K5) | 'xla'
    lpips_bf16: bool = False   # VGG16 features in bf16; the distance stays f32


@dataclass
class TrainState:
    decoder: GaussianDecoder          # heads + the trainable G copy
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(decoder: GaussianDecoder, cfg: DistillConfig) -> torch.optim.Optimizer:
    """Adam over the heads and, with use_gen_finetune, the G copy (which is
    frozen otherwise)."""
    params = [p for h in decoder.heads().values() for p in h.parameters()]
    decoder.G.requires_grad_(cfg.use_gen_finetune)
    if cfg.use_gen_finetune:
        params += list(decoder.G.parameters())
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(decoder: GaussianDecoder, frozen_generator,
                     cfg: DistillConfig = DistillConfig()) -> TrainState:
    """The decoder's G becomes a copy of the frozen generator's weights; the
    frozen generator gets no gradient."""
    decoder.G.load_state_dict(frozen_generator.state_dict(), strict=True)
    frozen_generator.requires_grad_(False)
    return TrainState(decoder, make_optimizer(decoder, cfg), 0)


def frontal_view(draws: TargetDraws, cfg: DistillConfig,
                 target_cfg: TargetSamplerConfig) -> bool:
    """The ID term's gate (ref :243-251): the drawn camera's angles within
    id_cam_threshold of frontal and its fov above id_min_fov, computed on
    the host from the draws in float32, as sample_camera_params computes
    them on the device."""
    fov_u, h_draw, v_draw = (torch.tensor(x, dtype=torch.float32)
                             for x in draws.camera_draws())
    hs = math.pi * target_cfg.horizontal_stddev
    vs = math.pi * target_cfg.vertical_stddev
    if target_cfg.camera_sampling == "normal":
        h, v = h_draw * hs + math.pi / 2, v_draw * vs + math.pi / 2
    else:
        h = (h_draw * 2 - 1) * hs + math.pi / 2
        v = (v_draw * 2 - 1) * vs + math.pi / 2
    fov_deg = fov_u * target_cfg.fov_offset_scale + target_cfg.fov_offset
    return bool((torch.abs(h - math.pi / 2) < cfg.id_cam_threshold)
                & (torch.abs(v - math.pi / 2) < cfg.id_cam_threshold)
                & (fov_deg > cfg.id_min_fov))


def make_loss_fn(decoder: GaussianDecoder, frozen_generator, vgg: VGG16LPIPS,
                 cfg: DistillConfig = DistillConfig(),
                 target_cfg: TargetSamplerConfig = TargetSamplerConfig(),
                 raster_cfg: RasterizeConfig = RasterizeConfig(),
                 irse: Optional[IRSE50] = None):
    """-> losses_and_metrics(draws, z, iteration, stage_timer=None) ->
    (loss, metrics, aux); metrics are detached 0-d tensors. irse, when
    given, adds the ID term on frontal views."""
    def losses_and_metrics(draws: TargetDraws, z: torch.Tensor, iteration,
                           stage_timer: Optional[Callable[[str], None]] = None):
        mark = stage_timer or (lambda name: None)
        target = sample_target(draws, frozen_generator, z, iteration=iteration, cfg=target_cfg)
        mark("target")
        if (cfg.reuse_frozen_planes and not cfg.use_gen_finetune
                and decoder.decoder_type != "sequential"):
            # the frozen copy equals the frozen generator and maps the zeroed
            # camera, as the target pipeline does: reuse its planes. The
            # 'sequential' decoder maps the real camera, so its planes differ
            decoded = decoder.decode_from_planes(target.feature_planes, target.vertices)
        else:
            decoded = decoder.apply(target.z, target.gan_camera_params, target.vertices,
                                    truncation_psi=target.truncation)
        mark("decode")
        dev = target.img.device
        fov = float(target.fov_deg) / 360.0 * 2 * math.pi
        cam = make_camera(cfg.image_size, fov, target.cam2world_pose[0], device=dev)
        bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev)
        render_out = render_simple(cam, decoded, bg, raster_cfg, backend=cfg.raster_backend)
        image = render_out["render"][:3]
        target_img = target.img[0]
        if cfg.apply_mask_to_rendering and target.img_mask is not None:
            mask = resize_bilinear(target.img_mask, cfg.image_size, cfg.image_size)[0]
            image = image * mask + 1 - mask
            target_img = target_img * mask + 1 - mask
        mark("render")
        ll1 = l1_loss(image, target_img)
        ll2 = l2_loss(image, target_img)
        lssim = 1.0 - ssim(image, target_img)[0]
        lsobel = sobel_loss(image, target_img)[0]
        llpips = lpips_loss(vgg, target_img[None], image[None],
                            dtype=torch.bfloat16 if cfg.lpips_bf16 else None)
        loss = (ll1 * cfg.l1_weight + ll2 * cfg.l2_weight + llpips * cfg.lpips_weight
                + lssim * cfg.ssim_weight + lsobel * cfg.sobel_weight)
        lid = torch.zeros((), device=dev)
        if (irse is not None and cfg.id_loss_weight > 0
                and frontal_view(draws, cfg, target_cfg)):
            lid = id_loss(irse, image[None], target_img[None])
            loss = loss + lid * cfg.id_loss_weight
        mark("losses")
        metrics = {"Loss/L1": ll1, "Loss/L2": ll2, "Loss/LPIPS": llpips, "Loss/DSSIM": lssim,
                   "Loss/Sobel": lsobel, "Loss/id": lid, "Loss/total": loss,
                   "General/truncation": torch.tensor(float(target.truncation)),
                   "General/n_dropped": torch.tensor(render_out["n_dropped"]),
                   "General/n_pairs": torch.tensor(render_out["n_pairs"])}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss, metrics, {"image": image.detach(), "target": target_img}

    return losses_and_metrics


def make_batched_train_step(decoder: GaussianDecoder, frozen_generator, vgg: VGG16LPIPS,
                            cfg: DistillConfig = DistillConfig(),
                            target_cfg: TargetSamplerConfig = TargetSamplerConfig(),
                            raster_cfg: RasterizeConfig = RasterizeConfig(),
                            irse: Optional[IRSE50] = None):
    """-> step(state, draws (B TargetDraws), zs (B, 1, z_dim), iteration,
    stage_timer=None) -> (state, metrics, aux): the mean loss's gradient
    over the B views, one Adam update in place on the state's decoder and
    optimizer, the per-view metrics' means and the last view's aux. The
    views run one after another and each view's backward of loss / B
    accumulates into the gradients, so B views never hold B sets of
    activations at once."""
    losses_and_metrics = make_loss_fn(decoder, frozen_generator, vgg, cfg, target_cfg,
                                      raster_cfg, irse)

    def step(state: TrainState, draws: Sequence[TargetDraws], zs: torch.Tensor, iteration,
             stage_timer: Optional[Callable[[str], None]] = None):
        mark = stage_timer or (lambda name: None)
        B = len(draws)
        if zs.shape[0] != B:
            raise ValueError(f"{zs.shape[0]} latents for {B} views")
        state.optimizer.zero_grad(set_to_none=True)
        sums = {}
        for b in range(B):
            loss, metrics, aux = losses_and_metrics(draws[b], zs[b], iteration, stage_timer)
            (loss / B).backward()
            mark("backward")
            sums = {k: v + sums[k] if sums else v for k, v in metrics.items()}
        state.optimizer.step()
        mark("optimizer")
        state.step += 1
        return state, ({k: v / B for k, v in sums.items()} if B > 1 else sums), aux

    return step


def make_train_step(decoder: GaussianDecoder, frozen_generator, vgg: VGG16LPIPS,
                    cfg: DistillConfig = DistillConfig(),
                    target_cfg: TargetSamplerConfig = TargetSamplerConfig(),
                    raster_cfg: RasterizeConfig = RasterizeConfig(),
                    irse: Optional[IRSE50] = None):
    """-> step(state, draws, z, iteration, stage_timer=None) -> (state,
    metrics, aux): make_batched_train_step's step on one view."""
    views_step = make_batched_train_step(decoder, frozen_generator, vgg, cfg, target_cfg,
                                         raster_cfg, irse)

    def step(state: TrainState, draws: TargetDraws, z: torch.Tensor, iteration,
             stage_timer: Optional[Callable[[str], None]] = None):
        return views_step(state, [draws], z[None], iteration, stage_timer)

    return step
