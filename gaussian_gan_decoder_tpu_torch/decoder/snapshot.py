"""Decoder snapshots: save_decoder / load_decoder / render_with_decoder —
port of decoder/snapshot.py (the reference's main/load_decoder.py:12-43).

A snapshot is a train/checkpoint.save file holding the decoder's
reference-named state dict (heads + `G.` + the fine-tuned generator) and
the frozen target generator's state, with the configs beside it as JSON
(the decoder's GaussianDecoderConfig, and optionally the target sampler's
and the distillation's), so load_decoder rebuilds the same network and
loads it strictly. The reference pickles {decoder, dataloader}, which
carries both generator copies; so does this.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

from ..gaussians.cameras import make_camera
from ..models.triplane import TriPlaneGenerator
from ..splat.rasterize import RasterizeConfig, render_simple
from ..train import checkpoint
from .heads import GaussianDecoder
from .target_pipeline import TargetSamplerConfig


def save_decoder(path: str, decoder: GaussianDecoder,
                 frozen_generator: Optional[TriPlaneGenerator] = None,
                 target_cfg: Optional[TargetSamplerConfig] = None,
                 extra_configs: Optional[Dict[str, Any]] = None) -> None:
    configs: Dict[str, Any] = {"decoder": decoder.config}
    if target_cfg is not None:
        configs["target_cfg"] = target_cfg
    configs.update(extra_configs or {})
    tree = {"decoder": decoder.state_dict()}
    if frozen_generator is not None:
        tree["frozen_G"] = frozen_generator.state_dict()
    checkpoint.save(path, tree, configs=configs)


def load_decoder(path: str, device="cuda") -> Tuple[GaussianDecoder, Dict[str, Any]]:
    """-> (decoder with the snapshot's weights on `device`, configs).
    configs gains 'frozen_G', the frozen target generator with its
    weights, when the snapshot stored one (ref load_decoder.py:28-43)."""
    configs = checkpoint.load_configs(path)
    tree = checkpoint.restore(path)
    decoder = GaussianDecoder.from_config(configs["decoder"], device=device)
    decoder.load_state_dict(tree["decoder"], strict=True)
    if "frozen_G" in tree:
        frozen = TriPlaneGenerator.from_config(configs["decoder"].generator, device=device)
        frozen.load_state_dict(tree["frozen_G"], strict=True)
        configs["frozen_G"] = frozen.requires_grad_(False)
    return decoder, configs


@torch.no_grad()
def render_with_decoder(decoder: GaussianDecoder, z, camera_params, cam2world, vertices,
                        fov, image_size: int = 512, bg=(0.0, 0.0, 0.0),
                        truncation_psi: float = 1.0,
                        raster_cfg: RasterizeConfig = RasterizeConfig(),
                        backend: str = "pallas"):
    """decode -> scene -> camera -> render (ref load_decoder.py:12-26) ->
    ((3, H, W) image, decoded). fov in radians. backend 'pallas' blends
    with K3; 'xla' (the JAX function's default) with the f32 tile
    rasterizer (render_simple)."""
    decoded = decoder.apply(z, camera_params, vertices, truncation_psi)
    dev = vertices.device
    cam = make_camera(image_size, float(fov), cam2world, device=dev)
    out = render_simple(cam, decoded, torch.tensor(bg, dtype=torch.float32, device=dev),
                        raster_cfg, backend=backend)
    return out["render"][:3], decoded


def _mapping_plain(z, c, fm, truncation_psi=1.0):
    """K1's plain version with the wrapper's (B, num_ws, W) output."""
    from ..models.pallas_mapping import mapping_forward_plain
    ws = mapping_forward_plain(z, c, fm, truncation_psi)
    return ws[:, None, :].expand(ws.shape[0], fm.num_ws, ws.shape[1])


def _launch_counts():
    from ..models import pallas_mapping
    from ..neuralfield import pallas_expand
    from ..splat import pallas_blend
    from . import pallas_heads
    fns = (pallas_mapping.mapping_forward, pallas_heads.decode_heads, pallas_blend.blend_tiles,
           pallas_expand.brick_table, pallas_expand.brick_table_select)
    return {f"{fn.__name__}.{a}": v for fn in fns for a, v in vars(fn).items()
            if a.startswith("launches")}


@contextlib.contextmanager
def plain_kernels():
    """Within the block, render_with_decoder runs the plain PyTorch versions
    of its kernels on any device: K1 (a decoder's pallas_mapping), K6 in
    both forms and K3, each swapped in where its callers import it by name.
    On leaving, raises if K1, K6, K3 or K10 launched within the block: it
    is for holding a frame on the card against its plain version, which a
    kernel reached through a name not swapped here would make a hold of
    the kernel against itself."""
    from ..splat import fast_raster, pallas_blend
    from . import heads, pallas_heads, pallas_heads_vjp
    swaps = [(heads, "mapping_forward", _mapping_plain),
             (heads, "decode_heads", pallas_heads.decode_heads_plain),
             (pallas_heads_vjp, "decode_heads", pallas_heads.decode_heads_plain),
             (fast_raster, "blend_tiles", pallas_blend.blend_tiles_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    before = _launch_counts()
    try:
        for m, n, plain in swaps:
            setattr(m, n, plain)
        yield
    finally:
        for m, n, kernel in saved:
            setattr(m, n, kernel)
    after = _launch_counts()
    launched = {k: after[k] - v for k, v in before.items() if after[k] != v}
    if launched:
        raise RuntimeError(f"kernels launched within plain_kernels(): {launched}")

