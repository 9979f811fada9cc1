"""Flagship builders and the decode-and-render frame — port of flagship.py
(slab route).

The flagship is the PanoHead easy-khair deployment: tri-grid of depth 3 at
256^2, 500k template Gaussians, a 512^2 frame. Weights are seeded random
unless a JAX export is loaded (port/from_jax.py). The builders here, like
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
                     rng: Optional[torch.Generator] = None, device="cuda") -> GaussianDecoder:
    """The slab route's decoder: sequential_reversed heads (hidden 128), the
    fused mapping, poly6 GELU, bf16 chain, absmax int8 volume."""
    dev = resolve_device(device)
    return GaussianDecoder(gen or flagship_generator(rng=rng, device=dev),
                           gelu="poly6", rng=rng, device=dev)


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


@torch.inference_mode()
def decode_and_render(
    decoder: GaussianDecoder,
    weights: InferenceWeights,
    z: torch.Tensor,
    camera_params: torch.Tensor,
    cam2world,
    slab_ctx: SlabContext,
    fov: float,
    image_size: int = 512,
    bg=DEFAULT_BG,
    raster_cfg: Optional[RasterizeConfig] = None,
    truncation_psi: float = 1.0,
    return_aux: bool = False,
    stage_timer=None,
):
    """The real-time editing frame: latent -> Gaussians -> (3, H, W) image,
    on the slab route. weights from decoder.fold(), slab_ctx from
    decoder.make_slab_context(template). -> (image, decoded[, aux]); decoded
    holds the raw head outputs per attribute in template order (scale
    activated, xyz offset applied), aux the rasterizer output with radii and
    visibility in template order. stage_timer, when given, is called with
    each stage's name as the stage is issued (mapping, synthesis, volume,
    decode, binning, blend)."""
    dev = slab_ctx.positions.device
    cam = make_camera(image_size, float(fov), cam2world, device=dev)
    cfg = raster_cfg or flagship_raster_config()
    planes, _ = decoder.synthesize_planes(weights, z, camera_params, truncation_psi,
                                          stage_timer=stage_timer)
    rows, layout = decoder.decode_project(weights, planes, cam, slab_ctx,
                                          stage_timer=stage_timer)
    bgv = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    out = render_rows(cam, rows, bgv, cfg, stage_timer=stage_timer)
    # rows are in packed slot order: map back to template order
    r16 = rows[:16][:, slab_ctx.inv_slot]
    decoded = {name: r16[c:c + d].t() for name, (c, d) in layout.items()}
    if not return_aux:
        return out["render"], decoded
    out["radii"] = rows[PROJ_ROWS["radius_f"]][slab_ctx.inv_slot].to(torch.int32)
    out["visibility_filter"] = (rows[PROJ_ROWS["visible"]] > 0.5)[slab_ctx.inv_slot]
    return out["render"], decoded, out
