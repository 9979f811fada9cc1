"""Tri-grid (PanoHead) and tri-plane (EG3D) generator — port of
models/triplane.py.

The config (`rk`, `triplane_depth`: 1 for 'eg3d'), the StyleGAN2
`backbone`, the OSG decoder (`decoder.net.{0,2}`; always sigmoid on
'eg3d'), the raw ToRGB (`torgb`, PanoHead only), the super-resolution
stack (`superresolution`, unless without_sr), PanoHead's self-adaptive
camera mapping (`t_mapping`: w_dim 3, one w) and its background synthesis
network (`bcg_synthesis`, with use_background: built and loaded, never
evaluated — the reference forces the background to -1, triplane.py:183-191,
as the JAX package does). The GAN-side API: `mapping` (with
truncation_cutoff), `apply_delta_c`, `synthesis_planes`, `render_planes`
(volume render + raw ToRGB + SR from precomputed planes, optionally through
a probe table, with per-call rk_overrides), `synthesis`, `sample_mixed`,
`sample`, `apply` and the probe-table APIs
(`build_sampling_table`, `sample_mixed_from_planes`).

Where the JAX package takes a PRNG key for the renderer's stratified and
importance draws, the port takes them as a RenderDraws, or a
torch.Generator that makes them (None: a generator seeded 0, as JAX's
key=None is PRNGKey(0)). noise_mode is 'const', 'none' or 'random'; the
per-pixel noise of 'random' (and of superresolution_noise_mode 'random')
comes from `noise_draws`, a draws object (utils/draws.py) that the
backbone asks at `b{res}` and the SR stack at `block0` / `block1`, where
the JAX package hands both the same noise key.

Every constructor argument but the weights' seed and device is recorded in
`config`, a TriPlaneGeneratorConfig, from which from_config rebuilds the
same network (decoder snapshots store it as JSON, train/checkpoint.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..neuralfield.ray_sampler import sample_rays
from ..neuralfield.renderer import (ImportanceRenderer, RenderDraws, build_plane_table,
                                   generate_planes)
from .stylegan2 import (FullyConnectedLayer, Generator as StyleGAN2Backbone, MappingNetwork,
                        SynthesisNetwork, ToRGBLayer)
from .superresolution import make_superresolution, sr_input_resolution


def default_rendering_kwargs(variant: str = "panohead") -> Dict[str, Any]:
    """Presets matching the reference launchers (PanoHead/train.py:302-340,
    eg3d/train.py:285-310, ffhq cfg), key for key the JAX package's."""
    base = dict(
        image_resolution=512,
        disparity_space_sampling=False,
        clamp_mode="softplus",
        c_gen_conditioning_zero=False,
        c_scale=1.0,
        superresolution_noise_mode="none",
        density_reg=0.25,
        density_reg_p_dist=0.004,
        decoder_lr_mul=1.0,
        sr_antialias=True,
        depth_resolution=48,
        depth_resolution_importance=48,
        ray_start=2.25,
        ray_end=3.3,
        box_warp=1.0,
        avg_camera_radius=2.7,
        avg_camera_pivot=(0, 0, 0.2),
    )
    if variant == "panohead":
        base.update(
            superresolution_module="training.superresolution.SuperresolutionHybrid8XDC",
            decoder_activation="lrelu",
            use_torgb_raw=True,
            use_background=True,
            triplane_size=256,
            triplane_depth=3,
            ray_start="auto",
            ray_end="auto",
        )
    else:
        base.update(
            superresolution_module="training.superresolution.SuperresolutionHybrid8XDC",
            decoder_activation="sigmoid",
            use_torgb_raw=False,
            use_background=False,
            triplane_size=256,
            triplane_depth=1,
        )
    return base


class OSGDecoder(nn.Module):
    """Plane-mean feature -> {rgb (N, M, 32), sigma (N, M, 1)}: FC 32->64,
    softplus, FC 64->33 (`net.0`, `net.2`, the reference's Sequential)."""

    def __init__(self, n_features=32, hidden_dim=64, output_dim=32, lr_multiplier=1.0,
                 activation="lrelu", generator=None, device=None):
        super().__init__()
        self.activation = activation
        self.net = nn.Sequential(
            FullyConnectedLayer(n_features, hidden_dim, lr_multiplier=lr_multiplier,
                                generator=generator, device=device),
            nn.Softplus(),
            FullyConnectedLayer(hidden_dim, 1 + output_dim, lr_multiplier=lr_multiplier,
                                generator=generator, device=device))

    def forward(self, sampled_features):
        x = self.net(sampled_features.mean(dim=1))
        rgb, sigma = x[..., 1:], x[..., 0:1]
        if self.activation == "sigmoid":
            rgb = torch.sigmoid(rgb) * (1 + 2 * 0.001) - 0.001
        else:
            rgb = F.leaky_relu(rgb, 0.2) * math.sqrt(2.0)
        return {"rgb": rgb, "sigma": sigma}


# mixed into the seed of the GAN-side networks' own stream
_SIDE_STREAM = 0x5DEECE66D


def _side_stream(generator: torch.Generator) -> torch.Generator:
    """A new generator seeded from a hash of `generator`'s state, which it
    leaves as it was: two generators in different states give different
    streams, and one in the same state the same stream."""
    digest = hashlib.blake2b(generator.get_state().cpu().numpy().tobytes(), digest_size=8).digest()
    seed = (int.from_bytes(digest, "little") ^ _SIDE_STREAM) & ((1 << 63) - 1)
    return torch.Generator(generator.device).manual_seed(seed)


def _frozen_items(kwargs) -> Tuple:
    """A kwargs dict (or its items) -> a tuple of (key, value) pairs with
    every list a tuple, at every depth (hashable, JSON round-trips)."""
    def deep(v):
        return tuple(deep(x) for x in v) if isinstance(v, (list, tuple)) else v
    return tuple((k, deep(v)) for k, v in dict(kwargs or {}).items())


@dataclass(frozen=True)
class TriPlaneGeneratorConfig:
    """The constructor arguments of a TriPlaneGenerator; the kwargs dicts
    as tuples of (key, value) pairs."""
    z_dim: int = 512
    c_dim: int = 25
    w_dim: int = 512
    img_resolution: int = 512
    img_channels: int = 3
    variant: str = "panohead"
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 0
    sr_num_fp16_res: int = 0
    without_sr: bool = False
    conv_clamp: Optional[float] = None
    mapping_kwargs: Tuple = ()
    rendering_kwargs: Tuple = ()


class TriPlaneGenerator(nn.Module):
    def __init__(self, z_dim=512, c_dim=25, w_dim=512, img_resolution=512,
                 img_channels=3, variant="panohead", channel_base=32768,
                 channel_max=512, num_fp16_res=0, sr_num_fp16_res=0, without_sr=False,
                 conv_clamp=None, mapping_kwargs: Optional[dict] = None,
                 rendering_kwargs: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        mapping_kwargs, rendering_kwargs = dict(mapping_kwargs or {}), dict(rendering_kwargs or {})
        self.config = TriPlaneGeneratorConfig(
            z_dim, c_dim, w_dim, img_resolution, img_channels, variant, channel_base,
            channel_max, num_fp16_res, sr_num_fp16_res, without_sr, conv_clamp,
            _frozen_items(mapping_kwargs), _frozen_items(rendering_kwargs))
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.variant = variant
        self.rk = default_rendering_kwargs(variant)
        self.rk.update(rendering_kwargs)
        rk = self.rk
        self.triplane_depth = int(rk["triplane_depth"]) if variant == "panohead" else 1
        self.backbone = StyleGAN2Backbone(
            z_dim, c_dim, w_dim, img_resolution=int(rk["triplane_size"]),
            img_channels=32 * 3 * self.triplane_depth, channel_base=channel_base,
            channel_max=channel_max, num_fp16_res=num_fp16_res, conv_clamp=conv_clamp,
            mapping_kwargs=mapping_kwargs, generator=generator, device=device)
        self.num_ws = self.backbone.num_ws
        self.decoder = OSGDecoder(
            lr_multiplier=rk["decoder_lr_mul"],
            activation=rk["decoder_activation"] if variant == "panohead" else "sigmoid",
            generator=generator, device=device)
        self.torgb = (ToRGBLayer(32, 3, w_dim, generator=generator, device=device)
                      if variant == "panohead" and rk["use_torgb_raw"] else None)
        self.superresolution = None if without_sr else make_superresolution(
            rk["superresolution_module"], channels=32, sr_num_fp16_res=sr_num_fp16_res,
            sr_antialias=rk["sr_antialias"], generator=generator, device=device)
        self.renderer = ImportanceRenderer(plane_variant=variant)
        # t_mapping and bcg_synthesis draw from a stream of their own, seeded
        # from the caller's generator's current state without advancing it.
        # This is for reproducibility alone: whatever the caller seeds next
        # from its generator (a decoder's heads) gets the weights it got
        # before the generator held these two networks, so the seeded data
        # of checks written before them is unchanged.
        side = None if generator is None else _side_stream(generator)
        self.t_mapping = (MappingNetwork(z_dim, c_dim, 3, num_ws=1, last_activation="linear",
                                         lr_multiplier=1.0, generator=side, device=device,
                                         **mapping_kwargs)
                          if variant == "panohead" else None)
        self.bcg_synthesis = (SynthesisNetwork(
            w_dim, sr_input_resolution(rk["superresolution_module"]), 32,
            channel_base=channel_base // 2, channel_max=channel_max, num_fp16_res=num_fp16_res,
            conv_clamp=conv_clamp, generator=side, device=device)
            if variant == "panohead" and rk["use_background"] else None)

    @classmethod
    def from_config(cls, config: TriPlaneGeneratorConfig,
                    generator: Optional[torch.Generator] = None, device=None
                    ) -> "TriPlaneGenerator":
        """The network `config` describes, with seeded random weights."""
        kw = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
        return cls(**kw, generator=generator, device=device)

    @property
    def plane_axes(self) -> np.ndarray:
        return generate_planes(self.variant)

    def mapping(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        """The f32 mapping network (reference semantics): c zeroed under
        c_gen_conditioning_zero, then scaled by c_scale."""
        if self.rk["c_gen_conditioning_zero"]:
            c = torch.zeros_like(c)
        return self.backbone.mapping(z, c * self.rk.get("c_scale", 0.0), truncation_psi,
                                     truncation_cutoff)

    def apply_delta_c(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        """PanoHead's self-adaptive camera (ref triplane.py:99-126) -> (c with
        t_mapping's (N, 3) translation added to the extrinsics' x, y and z
        (entries 3, 7, 11), that delta). Exact reference semantics: under
        c_gen_conditioning_zero, c is rebound to zeros BEFORE the delta is
        added, so the returned camera keeps none of the input's entries."""
        if self.t_mapping is None:
            raise ValueError("apply_delta_c is PanoHead-only: an EG3D generator has no t_mapping")
        c_in = torch.zeros_like(c) if self.rk["c_gen_conditioning_zero"] else c
        delta_c = self.t_mapping(z, c_in * self.rk.get("c_scale", 0.0), truncation_psi,
                                 truncation_cutoff)[:, 0]
        offset = torch.zeros_like(c_in)
        offset[:, [3, 7, 11]] = delta_c.to(c_in.dtype)
        return c_in + offset, delta_c

    def synthesis_planes(self, ws, noise_mode="const", noise_draws=None):
        """ws -> (N, 3, 32*D, H, W) f32 feature planes."""
        planes = self.backbone.synthesis(ws, noise_mode=noise_mode, draws=noise_draws)
        N = planes.shape[0]
        return planes.reshape(N, 3, 32 * self.triplane_depth,
                              planes.shape[-2], planes.shape[-1])

    def _render_draws(self, draws, N: int, res: int, rk, device) -> RenderDraws:
        """draws as given, or made by a torch.Generator (None: seeded 0) on
        its own device and moved, at rk's depth resolutions."""
        if isinstance(draws, RenderDraws):
            return draws
        if draws is None:
            draws = torch.Generator().manual_seed(0)
        d = RenderDraws.make(draws, N, res * res, rk["depth_resolution"],
                             rk["depth_resolution_importance"], draws.device)
        return RenderDraws(d.stratified.to(device), d.importance.to(device))

    def render_planes(self, planes, ws, c, draws=None,
                      neural_rendering_resolution: int = 64, plane_table=None,
                      noise_mode: str = "const", rk_overrides=None,
                      noise_draws=None) -> Dict[str, torch.Tensor]:
        """Volume render + raw ToRGB + SR from precomputed planes (the JAX
        package's render_planes). draws: the renderer's stratified and
        importance draws (a RenderDraws, or a torch.Generator that makes
        them); plane_table (build_sampling_table's output): the table both
        passes probe; rk_overrides: a dict merged over the rendering kwargs
        for this call (e.g. scaled depth resolutions); noise_draws: the SR
        stack's per-pixel noise under 'random'. -> {image_raw,
        image_depth, feature_planes[, image_mask][, image]}: PanoHead maps a
        sigmoid decoder's features to (-1, 1), blends the background forced
        to -1, runs the raw ToRGB and returns the mask; EG3D takes the first
        3 feature channels as rgb and has no mask."""
        rk = {**self.rk, **(rk_overrides or {})}
        if plane_table is not None:
            rk["plane_table"] = plane_table
        cam2world = c[:, :16].reshape(-1, 4, 4)
        intrinsics = c[:, 16:25].reshape(-1, 3, 3)
        N, res = c.shape[0], neural_rendering_resolution
        draws = self._render_draws(draws, N, res, rk, c.device)
        ray_origins, ray_directions = sample_rays(cam2world, intrinsics, res)
        feats, depth, weights = self.renderer(draws, planes, self.decoder, ray_origins,
                                              ray_directions, rk)
        feature_image = feats.permute(0, 2, 1).reshape(N, feats.shape[-1], res, res)
        depth_image = depth.permute(0, 2, 1).reshape(N, 1, res, res)
        weights_image = weights.permute(0, 2, 1).reshape(N, 1, res, res)
        panohead = self.variant == "panohead"
        if panohead and self.decoder.activation == "sigmoid":
            feature_image = feature_image * 2 - 1
        if self.bcg_synthesis is not None:
            # the reference blends a background forced to -1 (triplane.py:183-191)
            feature_image = feature_image + (1 - weights_image) * (-1.0)
        if self.torgb is not None:
            rgb_image = self.torgb(feature_image, ws[:, -1]).float()
        else:
            rgb_image = feature_image[:, :3]
        out = {"image_raw": rgb_image, "image_depth": depth_image, "feature_planes": planes}
        if panohead:
            out["image_mask"] = weights_image * (1 + 2 * 0.001) - 0.001
        if self.superresolution is None:
            return out
        # as JAX: a superresolution_noise_mode other than 'random' and 'none'
        # takes the call's noise_mode, and 'none' runs the const noise
        sr_noise_mode = rk["superresolution_noise_mode"]
        if sr_noise_mode not in ("random", "none"):
            sr_noise_mode = noise_mode
        image, raw_alias = self.superresolution(
            rgb_image, feature_image, ws,
            noise_mode="const" if sr_noise_mode == "none" else sr_noise_mode,
            draws=noise_draws)
        out["image"] = image
        if raw_alias is not None:
            out["image_raw"] = raw_alias.float()
        return out

    def synthesis(self, ws, c, draws=None, neural_rendering_resolution: int = 64,
                  noise_mode: str = "const", noise_draws=None) -> Dict[str, torch.Tensor]:
        """ws -> the full synthesis dict (ref triplane.py:128-225): the
        planes, then render_planes, both on the same noise_draws."""
        planes = self.synthesis_planes(ws, noise_mode, noise_draws)
        return self.render_planes(planes, ws, c, draws, neural_rendering_resolution,
                                  noise_mode=noise_mode, noise_draws=noise_draws)

    def apply(self, z, c, truncation_psi=1.0, truncation_cutoff=None,
              neural_rendering_resolution: int = 64, noise_mode: str = "const", draws=None,
              noise_draws=None):
        """The generator's forward (ref triplane.py:265-293): mapping, on
        PanoHead the self-adaptive camera (apply_delta_c), then synthesis."""
        ws = self.mapping(z, c, truncation_psi, truncation_cutoff)
        if self.variant == "panohead":
            c, _ = self.apply_delta_c(z, c, truncation_psi, truncation_cutoff)
        return self.synthesis(ws, c, draws, neural_rendering_resolution, noise_mode=noise_mode,
                              noise_draws=noise_draws)

    # -- point probes ------------------------------------------------------------

    def sample_mixed_from_planes(self, planes, coordinates, directions=None, table=None):
        """{rgb, sigma, xyz} of the OSG decoder at world coords (N, M, 3) from
        precomputed planes; table (build_sampling_table's output) reuses one
        brick table across chunked probes. directions are not read (the
        decoder takes none), as in the JAX package."""
        rk = self.rk if table is None else {**self.rk, "plane_table": table}
        return self.renderer.run_model(planes, self.decoder, coordinates, rk)

    def sample_mixed(self, coordinates, directions, ws, noise_mode="const"):
        """{rgb, sigma, xyz} at world coords from ws (the planes made here)."""
        planes = self.synthesis_planes(ws, noise_mode)
        return self.sample_mixed_from_planes(planes, coordinates, directions)

    def sample(self, coordinates, directions, z, c, truncation_psi=1.0):
        """{rgb, sigma, xyz} at world coords from a latent."""
        ws = self.mapping(z, c, truncation_psi=truncation_psi)
        return self.sample_mixed(coordinates, directions, ws)

    def build_sampling_table(self, planes, brick_dtype=None, pallas_build=False):
        """The probe table of the planes for render_planes / sample_mixed_from_planes
        (neuralfield.renderer.build_plane_table): on a tri-grid K10 builds it
        on the card (brick_dtype torch.int8, torch.bfloat16 or None: the
        planes' dtype; pallas_build True or False the rotate form, "select"
        the select form); a depth-1 tri-plane takes the bilinear float table
        and ignores pallas_build."""
        return build_plane_table(planes, self.triplane_depth, brick_dtype=brick_dtype,
                                 pallas_build=pallas_build if self.triplane_depth > 1 else False)
