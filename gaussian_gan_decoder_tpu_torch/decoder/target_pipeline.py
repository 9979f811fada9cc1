"""Per-iteration distillation target sampler — port of
decoder/target_pipeline.py.

One call produces what the training step needs from the FROZEN generator,
without gradient: a camera, the truncation, the target image (volume render
+ raw ToRGB + SR at 512^2), the separable sigma grid and the surface point
cloud from marching tetrahedra. Every random draw is a named tensor in
TargetDraws, made from an explicit torch.Generator or handed in.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from ..neuralfield.renderer import RenderDraws
from .camera_sampling import sample_camera_params
from .surface import marching_tetrahedra_sample, sigma_grid_separable


@dataclass(frozen=True)
class TargetSamplerConfig:
    """The JAX package's TargetSamplerConfig fields this slice runs; its
    probe options (bf16/int8/Pallas brick tables, the gather sigma grid,
    single-stage marching tetrahedra) are not ported."""
    cam_radius: float = 2.7
    truncation: float = 1.0
    truncation_ramp: int = 10_000
    init_truncation: float = 0.5
    camera_sampling: str = "uniform"      # 'uniform' | 'normal'
    vertical_stddev: float = 0.3          # units of pi
    horizontal_stddev: float = 1.0
    fov_offset: float = 5.0
    fov_offset_scale: float = 12.0
    surface_thickness: float = 0.1
    shape_res: int = 128
    num_points: int = 500_000
    mc_level: float = 10.0
    face_capacity: int = 2 ** 20
    neural_rendering_resolution: int = 64


@dataclass(frozen=True)
class TargetDraws:
    """The random draws of one target sample."""
    fov_u: torch.Tensor        # () uniform: fov = u * fov_offset_scale + fov_offset
    cam_h: torch.Tensor        # (1, 1) camera draw, horizontal angle
    cam_v: torch.Tensor        # (1, 1) camera draw, vertical angle
    render: RenderDraws        # stratified and importance draws of the target render
    face_u: torch.Tensor       # (P,) uniform: face choice
    weight_u: torch.Tensor     # (P, 3) uniform: barycentric weights
    thickness_n: torch.Tensor  # (P,) normal: thickness jitter
    # (fov_u, cam_h, cam_v) as host floats when drawn on the CPU: the step
    # decides on them (the ID term's frontal gate) without reading the card
    host_camera: Optional[Tuple[float, float, float]] = None

    def camera_draws(self) -> Tuple[float, float, float]:
        """(fov_u, cam_h, cam_v) on the host."""
        if self.host_camera is not None:
            return self.host_camera
        return (float(self.fov_u), float(self.cam_h.reshape(())), float(self.cam_v.reshape(())))

    @staticmethod
    def make(generator: torch.Generator, gen, cfg: TargetSamplerConfig, device
             ) -> "TargetDraws":
        """Draws from a torch.Generator on `device` (the CPU generator's
        numbers are moved)."""
        gdev = generator.device
        rk = gen.rk
        res = cfg.neural_rendering_resolution
        cam = torch.randn if cfg.camera_sampling == "normal" else torch.rand

        def mv(t):
            return t.to(device)

        P = cfg.num_points
        fov_u = torch.rand((), generator=generator, device=gdev)
        cam_h = cam((1, 1), generator=generator, device=gdev)
        cam_v = cam((1, 1), generator=generator, device=gdev)
        host = ((float(fov_u), float(cam_h[0, 0]), float(cam_v[0, 0]))
                if gdev.type == "cpu" else None)
        return TargetDraws(
            fov_u=mv(fov_u), cam_h=mv(cam_h), cam_v=mv(cam_v),
            render=RenderDraws(
                mv(torch.rand((1, res * res, rk["depth_resolution"], 1), generator=generator,
                              device=gdev)),
                mv(torch.rand((res * res, rk["depth_resolution_importance"]),
                              generator=generator, device=gdev))),
            face_u=mv(torch.rand((P,), generator=generator, device=gdev)),
            weight_u=mv(torch.rand((P, 3), generator=generator, device=gdev)),
            thickness_n=mv(torch.randn((P,), generator=generator, device=gdev)),
            host_camera=host)


def truncation_at(cfg: TargetSamplerConfig, iteration) -> float:
    """Linear truncation ramp (ref target_dataloader.py:82-86)."""
    mag = 1.0 if cfg.truncation_ramp == 0 else min(max(
        float(iteration) / cfg.truncation_ramp, 0.0), 1.0)
    return cfg.init_truncation * (1 - mag) + cfg.truncation * mag


@torch.no_grad()
def sample_target(draws: TargetDraws, generator, z: torch.Tensor, iteration=None,
                  cfg: TargetSamplerConfig = TargetSamplerConfig(),
                  camera_params: Optional[torch.Tensor] = None) -> SimpleNamespace:
    """One target sample from the frozen generator -> namespace of img (1, 3,
    512, 512) in [0, 1], img_mask, vertices (P, 3), gan_camera_params (1, 25),
    cam2world_pose (1, 4, 4), fov_deg, cam_h, cam_v, truncation,
    feature_planes, ws, z. A fixed camera_params (1, 25) takes the place of
    the drawn camera (whose draws are then unused); cam2world_pose comes
    from it, and fov_deg, cam_h and cam_v are None (the caller's)."""
    if camera_params is None:
        fov_deg = draws.fov_u * cfg.fov_offset_scale + cfg.fov_offset
        cp, cam2world, h, v = sample_camera_params(
            draws.cam_h, draws.cam_v, fov_deg, camera_sampling=cfg.camera_sampling,
            horizontal_stddev=cfg.horizontal_stddev, vertical_stddev=cfg.vertical_stddev,
            radius=cfg.cam_radius)
    else:
        cp, fov_deg, h, v = camera_params, None, None, None
        cam2world = cp[:, :16].reshape(-1, 4, 4)
    truncation = (truncation_at(cfg, iteration) if iteration is not None
                  else float(cfg.truncation))
    # frozen generator: ws with ZEROED camera conditioning (ref :90)
    ws = generator.mapping(z, torch.zeros_like(cp), truncation_psi=truncation)
    planes = generator.synthesis_planes(ws, noise_mode="const")
    synth = generator.render_planes(planes, ws, cp, draws.render,
                                    neural_rendering_resolution=cfg.neural_rendering_resolution)
    image = synth["image"] if "image" in synth else synth["image_raw"]
    sigmas = sigma_grid_separable(generator, planes, shape_res=cfg.shape_res)
    vertices = marching_tetrahedra_sample(
        sigmas, draws.face_u, draws.weight_u, draws.thickness_n, level=cfg.mc_level,
        surface_thickness=cfg.surface_thickness, face_capacity=cfg.face_capacity)
    return SimpleNamespace(
        img=torch.clamp((image + 1) / 2, 0, 1), img_mask=synth.get("image_mask"),
        vertices=vertices, gan_camera_params=cp, cam2world_pose=cam2world, fov_deg=fov_deg,
        cam_h=h, cam_v=v, truncation=truncation, feature_planes=planes, ws=ws, z=z)
