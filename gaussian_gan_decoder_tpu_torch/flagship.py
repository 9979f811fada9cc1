"""Flagship builders and the decode-and-render frame — port of flagship.py:
the frame on the slab and brick routes, and the frame stream.

The flagship is the PanoHead easy-khair deployment: tri-grid of depth 3 at
256^2, 500k template Gaussians, a 512^2 frame. flagship_generator("eg3d")
is the EG3D tri-plane generator at the same widths (256^2 planes of depth
1, the SR stack to 512^2); its frames run on the same three routes, with
the depth-1 forms of the decode (its presets' background is black).
Weights are seeded random unless a JAX export is loaded (port/from_jax.py)
or a reference pickle (port/torch_pickle.py). The builders here, like
every entry point of the port, build on the card unless the caller asks
for the CPU (device="cpu"); without a card they raise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .decoder.heads import GaussianDecoder, InferenceWeights, SlabContext
from .decoder.pallas_heads import PROJ_ROWS
from .gaussians.cameras import make_camera
from .models.triplane import TriPlaneGenerator
from .splat.fast_raster import render_rows
from .splat.rasterize import RasterizeConfig

DEFAULT_BG = (0.55717, 0.52256, 0.51045)


def resolve_device(device="cuda") -> torch.device:
    """The device of an entry point: the card unless the caller names the
    CPU. Raises, rather than falling back, when a CUDA device is asked for
    and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: gaussian_gan_decoder_tpu_torch runs on an NVIDIA "
                           "GPU; pass device='cpu' to run the plain versions on the CPU")
    return dev


def flagship_generator(variant: str = "panohead", img_resolution: int = 512,
                       rng: Optional[torch.Generator] = None,
                       device="cuda") -> TriPlaneGenerator:
    # bf16 blocks at the top 4 resolutions and in the SR stack, as the
    # reference deployment
    return TriPlaneGenerator(z_dim=512, c_dim=25, w_dim=512, img_resolution=img_resolution,
                             img_channels=3, variant=variant, num_fp16_res=4,
                             sr_num_fp16_res=4, generator=rng, device=resolve_device(device))


def flagship_decoder(gen: Optional[TriPlaneGenerator] = None,
                     rng: Optional[torch.Generator] = None, device="cuda",
                     fused_sampling: bool = False) -> GaussianDecoder:
    """The JAX package's flagship decoder: sequential_reversed heads (hidden
    128), the fused mapping, polynomial GELU ("poly"), bf16 chain, int8
    bricks; fused_sampling takes the gather-fused decode (K9) on the brick
    route. The slab route runs the coarser "poly6" GELU, as the JAX
    benchmark sets it: GaussianDecoder(gen, gelu="poly6")."""
    dev = resolve_device(device)
    return GaussianDecoder(gen or flagship_generator(rng=rng, device=dev),
                           gelu="poly", rng=rng, device=dev,
                           fused_sampling=fused_sampling)


def flagship_raster_config() -> RasterizeConfig:
    return RasterizeConfig(tile_size=16, tile_capacity=640)


def default_camera_params(fov_deg: float = 13.0, device="cuda"):
    """Frontal orbit camera -> (camera_params (1, 25) f32, cam2world (4, 4) f32)."""
    cam2world = np.eye(4, dtype=np.float32)
    cam2world[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    cam2world[2, 3] = 2.7
    focal = 1.0 / (2.0 * np.tan(np.deg2rad(fov_deg) / 2))
    intr = np.array([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1]], np.float32)
    cp = np.concatenate([cam2world.reshape(-1), intr.reshape(-1)])[None]
    device = resolve_device(device)
    return (torch.tensor(cp, dtype=torch.float32, device=device),
            torch.tensor(cam2world, device=device))


def _frame_tail(decoder: GaussianDecoder, weights: InferenceWeights, planes, cam, cfg, bgv,
                slab_ctx: Optional[SlabContext], init_position, return_aux: bool,
                stage_timer=None):
    """One frame's planes -> (image, decoded[, aux]): decode + binning +
    blend, outputs in template order."""
    rows, layout = decoder.decode_project(weights, planes, cam, slab_ctx=slab_ctx,
                                          init_position=init_position, stage_timer=stage_timer)
    out = render_rows(cam, rows, bgv, cfg, stage_timer=stage_timer)
    if slab_ctx is not None:
        # slab rows are in packed slot order: map back to template order
        order = slab_ctx.inv_slot
    else:
        # brick rows are in template order, pad columns past M
        order = slice(0, init_position.shape[0])
    r16 = rows[:16][:, order]
    decoded = {name: r16[c:c + d].t() for name, (c, d) in layout.items()}
    if not return_aux:
        return out["render"], decoded
    out["radii"] = rows[PROJ_ROWS["radius_f"]][order].to(torch.int32)
    out["visibility_filter"] = (rows[PROJ_ROWS["visible"]] > 0.5)[order]
    return out["render"], decoded, out


def _route_device(slab_ctx, init_position):
    if slab_ctx is not None:
        return slab_ctx.positions.device
    if init_position is None:
        raise ValueError("a frame needs a slab context or the init_position template")
    return init_position.device


@torch.inference_mode()
def decode_and_render(
    decoder: GaussianDecoder,
    weights: InferenceWeights,
    z: torch.Tensor,
    camera_params: torch.Tensor,
    cam2world,
    slab_ctx: Optional[SlabContext],
    fov: float,
    image_size: int = 512,
    bg=DEFAULT_BG,
    raster_cfg: Optional[RasterizeConfig] = None,
    truncation_psi: float = 1.0,
    return_aux: bool = False,
    stage_timer=None,
    init_position: Optional[torch.Tensor] = None,
):
    """The real-time editing frame: latent -> Gaussians -> (3, H, W) image.
    weights from decoder.fold(). slab_ctx from decoder.make_slab_context
    (template) takes the slab route; slab_ctx=None with init_position, the
    (M, 3) template tensor, takes the brick route (decoder.fused_sampling
    picks K9 over the table sample + K8). -> (image, decoded[, aux]);
    decoded holds the raw head outputs per attribute in template order
    (scale activated, xyz offset applied), aux the rasterizer output with
    radii and visibility in template order. stage_timer, when given, is
    called with each stage's name as the stage is issued (mapping,
    synthesis, then volume, decode on the slab route or table, sample,
    decode on the brick route, then binning, blend)."""
    dev = _route_device(slab_ctx, init_position)
    cam = make_camera(image_size, float(fov), cam2world, device=dev)
    cfg = raster_cfg or flagship_raster_config()
    planes, _ = decoder.synthesize_planes(weights, z, camera_params, truncation_psi,
                                          stage_timer=stage_timer)
    bgv = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    return _frame_tail(decoder, weights, planes, cam, cfg, bgv, slab_ctx, init_position,
                       return_aux, stage_timer)


@torch.inference_mode()
def decode_and_render_stream(
    decoder: GaussianDecoder,
    weights: InferenceWeights,
    zs: torch.Tensor,
    camera_params: torch.Tensor,
    cam2world,
    fov: float,
    slab_ctx: Optional[SlabContext] = None,
    init_position: Optional[torch.Tensor] = None,
    image_size: int = 512,
    bg=DEFAULT_BG,
    raster_cfg: Optional[RasterizeConfig] = None,
    truncation_psi: float = 1.0,
    frame_batch: int = 4,
):
    """F frames from a latent stream zs (F, 1, z_dim) -> (F, 3, H, W): the
    mapping (K1) and the synthesis run batched, frame_batch latents at a time
    (the backbone at batch 1 leaves the card mostly idle), the per-frame tail
    (decode + binning + blend) one frame at a time, so peak memory stays at
    one frame's tail. Either route: slab_ctx, or init_position (brick)."""
    F_, _, z_dim = zs.shape
    if F_ % frame_batch:
        raise ValueError(f"{F_} frames are not a multiple of frame_batch {frame_batch}")
    dev = _route_device(slab_ctx, init_position)
    cam = make_camera(image_size, float(fov), cam2world, device=dev)
    cfg = raster_cfg or flagship_raster_config()
    bgv = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    cp_b = camera_params.expand(frame_batch, camera_params.shape[-1])
    frames = torch.empty((F_, 3, image_size, image_size), dtype=torch.float32, device=dev)
    for f0 in range(0, F_, frame_batch):
        planes, _ = decoder.synthesize_planes(weights, zs[f0:f0 + frame_batch, 0], cp_b,
                                              truncation_psi)
        for i in range(frame_batch):
            frames[f0 + i] = _frame_tail(decoder, weights, planes[i:i + 1], cam, cfg, bgv,
                                         slab_ctx, init_position, False)[0]
    return frames
