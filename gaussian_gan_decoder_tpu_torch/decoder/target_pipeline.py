"""Per-iteration distillation target sampler — port of
decoder/target_pipeline.py.

One call produces what the training step needs from the FROZEN generator,
without gradient: a camera, the truncation, the target image (volume render
+ raw ToRGB + SR at 512^2), the sigma grid and the surface point cloud
(marching tetrahedra, or the sigma > 10 voxel filter). Every random draw is
a named tensor in TargetDraws, made from an explicit torch.Generator or
handed in.

The probe options build one table of the frozen planes a target
(generator.build_sampling_table: K10 on a tri-grid, on the card), which
the render's coarse and importance passes and the gather sigma grid share:
bf16_probe and int8_probe set its element type (int8_probe wins),
pallas_probe_build its build (False and True K10's rotate form, "select"
its select form), and sigma_separable=False takes the gather grid through
it. With none of them the render samples the planes directly and the
separable grid samples the raw planes: no table is built.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple, Union

import torch

from ..neuralfield.renderer import RenderDraws
from .camera_sampling import sample_camera_params
from .surface import create_samples, marching_tetrahedra_sample, sigma_grid


# the voxel filter's density threshold: a constant, not mc_level (ref
# target_dataloader.py:120)
VOXEL_SIGMA = 10.0


@dataclass(frozen=True)
class TargetSamplerConfig:
    """The JAX package's TargetSamplerConfig. sigma_separable defaults to
    True here, as the JAX CLI sets it (the JAX dataclass's default is the
    gather grid, False)."""
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
    use_marching_cubes: bool = True   # False: the sigma > 10 voxel filter
    bf16_probe: bool = False          # bf16 probe table (~2^-8 feature error)
    int8_probe: bool = False          # int8 probe table (tri-grid; overrides bf16_probe)
    pallas_probe_build: Union[bool, str] = False   # False | True | "select"
    mt_two_stage: bool = True         # two-stage crossed-cube compaction
    sigma_separable: bool = True      # separable sigma grid (False: the gather grid)
    sigma_chunk: int = 2 ** 18        # probes a chunk of the sigma grid

    @property
    def probe_dtype(self) -> Optional[torch.dtype]:
        """The probe table's element type (None: the planes' f32)."""
        return torch.int8 if self.int8_probe else torch.bfloat16 if self.bf16_probe else None

    @property
    def probe_table(self) -> bool:
        """Whether a target builds the probe table."""
        return (self.probe_dtype is not None or bool(self.pallas_probe_build)
                or not self.sigma_separable)


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


    @staticmethod
    def fixed_camera(draws, gen, cfg: TargetSamplerConfig, device) -> "TargetDraws":
        """The draws of a target at a caller's camera (sample_target's
        camera_params; the camera draws are zeros, unread) from a draws
        object (utils/draws.py), at the JAX package's sites: `render`
        (stratified, then importance) and `surface` (face choice,
        barycentric weights, thickness jitter)."""
        rk, res, P = gen.rk, cfg.neural_rendering_resolution, cfg.num_points
        rd, sd = draws.child("render"), draws.child("surface")

        def mv(t):
            return t.to(device)
        return TargetDraws(
            fov_u=torch.zeros((), device=device), cam_h=torch.zeros((1, 1), device=device),
            cam_v=torch.zeros((1, 1), device=device),
            render=RenderDraws(mv(rd.uniform((1, res * res, rk["depth_resolution"], 1))),
                               mv(rd.uniform((res * res, rk["depth_resolution_importance"])))),
            face_u=mv(sd.uniform((P,))), weight_u=mv(sd.uniform((P, 3))),
            thickness_n=mv(sd.normal((P,))))


def truncation_at(cfg: TargetSamplerConfig, iteration) -> float:
    """Linear truncation ramp (ref target_dataloader.py:82-86)."""
    mag = 1.0 if cfg.truncation_ramp == 0 else min(max(
        float(iteration) / cfg.truncation_ramp, 0.0), 1.0)
    return cfg.init_truncation * (1 - mag) + cfg.truncation * mag


def voxel_filter(sigmas: torch.Tensor, box_warp: float, num_points: int,
                 threshold: float = VOXEL_SIGMA) -> torch.Tensor:
    """The sigma > threshold voxel filter (ref target_dataloader.py:120-122)
    -> (num_points, 3): the lattice points (create_samples) of the first
    num_points voxels over the threshold, in index order, the rest filled
    with voxel 0 — the JAX package's fixed-size nonzero (its comment says
    uniform resampling; its code does this)."""
    R = sigmas.shape[0]
    samples = create_samples(R, box_warp, device=sigmas.device)[0]
    idx = torch.nonzero(sigmas.reshape(-1) > threshold).squeeze(1)[:num_points]
    idx = torch.cat([idx, idx.new_zeros(num_points - idx.numel())])
    return samples[idx]


@torch.no_grad()
def sample_target(draws: TargetDraws, generator, z: torch.Tensor, iteration=None,
                  cfg: TargetSamplerConfig = TargetSamplerConfig(),
                  camera_params: Optional[torch.Tensor] = None) -> SimpleNamespace:
    """One target sample from the frozen generator -> namespace of img (1, 3,
    512, 512) in [0, 1], img_mask, vertices (P, 3), sigmas (R, R, R), gan_camera_params (1, 25),
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
    # ONE table for the render's passes and the gather sigma grid; the
    # separable grid samples the raw planes and is never handed one
    table = (generator.build_sampling_table(planes, brick_dtype=cfg.probe_dtype,
                                            pallas_build=cfg.pallas_probe_build)
             if cfg.probe_table else None)
    synth = generator.render_planes(planes, ws, cp, draws.render,
                                    neural_rendering_resolution=cfg.neural_rendering_resolution,
                                    plane_table=table)
    image = synth["image"] if "image" in synth else synth["image_raw"]
    sigmas = sigma_grid(generator, planes, shape_res=cfg.shape_res, chunk=cfg.sigma_chunk,
                        table=None if cfg.sigma_separable else table,
                        separable=cfg.sigma_separable)
    if cfg.use_marching_cubes:
        vertices = marching_tetrahedra_sample(
            sigmas, draws.face_u, draws.weight_u, draws.thickness_n, level=cfg.mc_level,
            surface_thickness=cfg.surface_thickness, face_capacity=cfg.face_capacity,
            two_stage=cfg.mt_two_stage)
    else:
        vertices = voxel_filter(sigmas, generator.rk["box_warp"], cfg.num_points)
    return SimpleNamespace(
        img=torch.clamp((image + 1) / 2, 0, 1), img_mask=synth.get("image_mask"),
        vertices=vertices, sigmas=sigmas, gan_camera_params=cp, cam2world_pose=cam2world, fov_deg=fov_deg,
        cam_h=h, cam_v=v, truncation=truncation, feature_planes=planes, ws=ws, z=z)
