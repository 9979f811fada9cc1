"""Classic photogrammetric 3DGS training (the INRIA pipeline) — port of
train/gaussian_splatting.py.

A random camera a step, the render through the differentiable tile
rasterizer (splat/rasterize.py::rasterize), loss (1 - lambda) L1 +
lambda (1 - SSIM), torch.optim.Adam with one parameter group per
attribute (the xyz group's learning rate set before each step from the
log-lerp schedule), and adaptive densify / clone / split / prune on the
screen-space mean gradients with periodic opacity resets, all at a fixed
capacity (gaussians/densify.py).

The scene's six per-point attributes are the optimizer's parameters: the
step and the densification write into them in place, so a GSTrainState's
scene and its optimizer always hold the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..gaussians.densify import densify_and_prune, get_expon_lr_func, reset_adam_state
from ..gaussians.model import GaussianScene, create_from_points
from ..losses.image import l1_loss, ssim
from ..splat.rasterize import RasterizeConfig, rasterize

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


@dataclass(frozen=True)
class GSOptimizationConfig:
    """(ref arguments/__init__.py:71-120 defaults)"""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    capacity: int = 2 ** 20
    sh_degree: int = 3


class GSTrainState(NamedTuple):
    scene: GaussianScene
    optimizer: torch.optim.Adam
    grad_accum: torch.Tensor
    denom: torch.Tensor
    max_radii2d: torch.Tensor
    step: int


def init_scene_at_capacity(points, colors, cfg: GSOptimizationConfig,
                           device=None) -> GaussianScene:
    """create_from_points, padded to cfg.capacity with invalid slots at the
    origin (log-scale 0, identity rotation, opacity logit 0), as in JAX.
    points / colors: (n, 3) arrays or tensors; colors may be None."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    scene = create_from_points(t(points), None if colors is None else t(colors),
                               sh_degree=cfg.sh_degree)
    n, cap = scene.num_points, cfg.capacity
    if cap < n:
        raise ValueError(f"capacity {cap} below the {n} initial points")

    def pad(x):
        return torch.cat([x, x.new_zeros((cap - n,) + x.shape[1:])], dim=0)

    rotation = pad(scene.rotation)
    rotation[n:, 0] = 1.0
    return GaussianScene(
        xyz=pad(scene.xyz), features_dc=pad(scene.features_dc),
        features_rest=pad(scene.features_rest), scaling=pad(scene.scaling),
        rotation=rotation, opacity=pad(scene.opacity), valid=pad(scene.valid),
        max_sh_degree=cfg.sh_degree, active_sh_degree=0)


def xyz_schedule(cfg: GSOptimizationConfig, spatial_lr_scale: float):
    """The xyz learning rate at an update count (ref gaussian_model.py:217-238:
    the log-lerp schedule scaled by the scene's extent)."""
    return get_expon_lr_func(cfg.position_lr_init * spatial_lr_scale,
                             cfg.position_lr_final * spatial_lr_scale,
                             lr_delay_mult=cfg.position_lr_delay_mult,
                             max_steps=cfg.position_lr_max_steps)


def make_optimizer(scene: GaussianScene, cfg: GSOptimizationConfig,
                   spatial_lr_scale: float) -> torch.optim.Adam:
    """Adam with eps 1e-15 and one group per attribute, in PARAMS order, at
    JAX's learning rates (f_rest at feature_lr / 20); the xyz group's rate
    is the schedule's at update 0 until the step sets it."""
    lrs = dict(xyz=xyz_schedule(cfg, spatial_lr_scale)(0), features_dc=cfg.feature_lr,
               features_rest=cfg.feature_lr / 20.0, scaling=cfg.scaling_lr,
               rotation=cfg.rotation_lr, opacity=cfg.opacity_lr)
    return torch.optim.Adam([{"params": [getattr(scene, k)], "lr": lrs[k], "name": k}
                             for k in PARAMS], eps=1e-15)


def init_gs_state(points, colors, cfg: GSOptimizationConfig, spatial_lr_scale: float,
                  device=None) -> GSTrainState:
    scene = init_scene_at_capacity(points, colors, cfg, device)
    scene = scene._replace(**{k: getattr(scene, k).requires_grad_(True) for k in PARAMS})
    n = scene.num_points
    z = lambda: torch.zeros(n, device=scene.xyz.device)  # noqa: E731
    return GSTrainState(scene, make_optimizer(scene, cfg, spatial_lr_scale), z(), z(), z(), 0)


def make_train_step(cfg: GSOptimizationConfig, raster_cfg: RasterizeConfig,
                    image_size: int, spatial_lr_scale: float):
    """-> step(state, cam, gt, bg, sh_degree) -> (state, metrics): one Adam
    update of the scene (in place) and the densification statistics
    (grad_accum, denom, max_radii2d) updated as JAX does; metrics loss,
    l1, n_valid (0-d tensors, not synchronised). Every attribute takes an
    update every step, a zero gradient where it is unused (f_rest at
    degree 0), as optax updates every leaf."""
    sched = xyz_schedule(cfg, spatial_lr_scale)

    def step(state: GSTrainState, cam, gt, bg, sh_degree: int):
        scene, opt = state.scene, state.optimizer
        for group in opt.param_groups:
            if group["name"] == "xyz":
                group["lr"] = sched(state.step)
        off = torch.zeros((scene.num_points, 2), device=scene.xyz.device, requires_grad=True)
        shs = (scene.features_dc if sh_degree == 0
               else torch.cat([scene.features_dc, scene.features_rest], dim=1))
        out = rasterize(cam, scene.get_xyz, scene.get_scaling, scene.get_rotation,
                        scene.get_opacity, shs=shs, sh_degree=sh_degree, bg=bg,
                        config=raster_cfg, means2d_offset=off)
        img = out["render"]
        ll1 = l1_loss(img, gt)
        loss = (1.0 - cfg.lambda_dssim) * ll1 + cfg.lambda_dssim * (1.0 - ssim(img, gt)[0])
        opt.zero_grad(set_to_none=False)
        loss.backward()
        for k in PARAMS:
            p = getattr(scene, k)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        with torch.no_grad():
            vis = out["visibility_filter"]
            zero = torch.zeros_like(state.grad_accum)
            ga = state.grad_accum + torch.where(vis, off.grad.norm(dim=-1), zero)
            dn = state.denom + vis.float()
            mr = torch.maximum(state.max_radii2d, torch.where(vis, out["radii"].float(), zero))
        metrics = {"loss": loss.detach(), "l1": ll1.detach(),
                   "n_valid": scene.valid.sum(), "n_pairs": out["n_pairs"],
                   "n_dropped": out["n_dropped"]}
        return GSTrainState(scene, opt, ga, dn, mr, state.step + 1), metrics

    return step


def assign_scene(state: GSTrainState, scene: GaussianScene) -> GSTrainState:
    """Write scene's attribute values into the state's parameters in place
    (the optimizer holds those tensors) -> the state with scene's valid
    mask and degrees."""
    with torch.no_grad():
        for k in PARAMS:
            getattr(state.scene, k).copy_(getattr(scene, k))
    params = {k: getattr(state.scene, k) for k in PARAMS}
    return state._replace(scene=scene._replace(**params))


def densify_step(state: GSTrainState, key: torch.Generator, cfg: GSOptimizationConfig,
                 extent: float, max_screen_size: Optional[float]):
    """densify_and_prune on the state's statistics, the rewritten slots'
    Adam moments zeroed, the statistics reset -> (state, stats)."""
    with torch.no_grad():
        scene, stats = densify_and_prune(
            state.scene, state.grad_accum, state.denom, state.max_radii2d, key,
            max_grad=cfg.densify_grad_threshold, extent=extent,
            max_screen_size=max_screen_size, percent_dense=cfg.percent_dense)
        reset_adam_state(state.optimizer, scene.valid != state.scene.valid)
    state = assign_scene(state, scene)
    z = torch.zeros_like(state.grad_accum)
    return state._replace(grad_accum=z, denom=z.clone(), max_radii2d=z.clone()), stats
