"""Gaussian-attribute decoder heads — port of decoder/heads.py: the slab
and brick decode routes of the inference frame and the training side.

GaussianDecoder is an nn.Module holding the five heads
(`{color,opacity,rotation,scale,xyz}_decoder.backbone`, Linear layers at
Sequential indices 0/2/4/6 with GELU between, the reference's names) and
the fine-tunable generator copy `G`, so the JAX package's exported decoder
state dict loads with strict=True (port/from_jax.py).

The frame runs: synthesize_planes (mapping kernel K1 + StyleGAN2
synthesis) -> decode_project, on one of three routes, as the JAX
package's decode_project dispatches:
  * a slab context: the int8 slab volume + the fused slab decode K2;
    make_slab_context packs the static template once on the host (same
    packing and npz disk cache as the JAX package);
  * fused_sampling: the int8 brick table (K10), the per-plane brick-row
    gathers (sample_fused_inputs) and the gather-fused decode K9;
  * otherwise: the int8 brick table (K10), the table sample, the plane
    mean and the decode K8 over the prebuilt staging.
The brick routes need no per-template pack; their rows come out in template
order, padded to a multiple of 1024 points.

The training side (apply = synthesize_planes_train + decode_from_planes)
keeps the autograd graph: the f32 mapping and synthesis of the trainable G
copy, the float tri-grid sample at the surface points, and the f32 head
chain (kernels K6 / K7, decoder/pallas_heads_vjp.py).
"""
from __future__ import annotations

import hashlib
import os
import sys
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.pallas_mapping import FoldedMapping, fold_mapping, mapping_forward
from ..models.triplane import TriPlaneGenerator
from ..neuralfield.renderer import (build_plane_table, build_slab_volume, sample_from_planes,
                                   sample_fused_inputs)
from .pallas_heads import (C, ChainWeights, build_brick_staging, build_staging,
                           decode_project, decode_project_fused, decode_project_slab, pack_chain)
from .pallas_heads_vjp import decode_heads_pallas_diff
from .point_blocks import PointBlocks, build_point_blocks, compact_indices

# the reference default ('sequential_reversed'): head order, output widths;
# each head reads the features, the position and every earlier head's output
CHAIN = (("color", 3), ("opacity", 1), ("rotation", 4), ("scale", 3), ("xyz", 3))
SCALE_OFFSET = -2.5
HIDDEN = 128


class DecoderHead(nn.Module):
    """4-layer GELU MLP (Linear-GELU x3 -> Linear), torch.nn.Linear init."""

    def __init__(self, n_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dims = [(n_features, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, HIDDEN),
                (HIDDEN, out_features)]
        layers = []
        for i, (din, dout) in enumerate(dims):
            lin = nn.Linear(din, dout, device=device)
            bound = 1.0 / din ** 0.5
            gdev = generator.device if generator is not None else device
            with torch.no_grad():
                for p in (lin.weight, lin.bias):
                    p.copy_(torch.empty(p.shape, device=gdev).uniform_(
                        -bound, bound, generator=generator))
            layers.append(lin)
            if i < 3:
                layers.append(nn.GELU())
        self.backbone = nn.Sequential(*layers)


@dataclass(frozen=True)
class SlabContext:
    """Per-template static context of the slab decode (make_slab_context)."""
    positions: torch.Tensor   # (Mpad, 3) f32 permuted + zero-padded template
    idx16: torch.Tensor       # (Mpad, 12) int16 padded indices + validity bits
    aux: torch.Tensor         # (Mpad, 128) bf16 static staging (cond, init, valid)
    valid: torch.Tensor       # (Mpad,) f32
    inv_slot: torch.Tensor    # (M,) int64: template index -> slot
    inv_axes: torch.Tensor    # (3, 3, 3) f32
    origins: np.ndarray       # (n_blocks, 12) int32 host pack windows
    perm: np.ndarray          # (M,) Morton order of the real points
    box_warp: float
    sizes: Tuple[int, int, int]   # (D, H, W)
    n_points: int
    block: int
    m_padded: int


class InferenceWeights(NamedTuple):
    """Weights prepared once for the fused kernels (GaussianDecoder.fold)."""
    mapping: FoldedMapping
    chain: ChainWeights


class GaussianDecoder(nn.Module):
    """The 'sequential_reversed' decoder (the reference default): heads chained
    color -> opacity -> rotation -> scale -> xyz on the plane-mean feature and
    the raw position; the mapping sees a zeroed camera."""

    def __init__(self, generator: TriPlaneGenerator, gelu: str = "poly6",
                 rng: Optional[torch.Generator] = None, device=None,
                 fused_sampling: bool = False):
        super().__init__()
        self.G = generator
        self.gelu = gelu
        # brick route: the gather-fused decode K9 in place of the table
        # sample + K8 (the JAX decoder's fused_sampling)
        self.fused_sampling = fused_sampling
        self.position_dim = 3
        cond = self.position_dim
        for name, out_dim in CHAIN:
            setattr(self, f"{name}_decoder", DecoderHead(32 + cond, out_dim, generator=rng,
                                                         device=device))
            cond += out_dim

    def heads(self) -> Dict[str, DecoderHead]:
        return {name: getattr(self, f"{name}_decoder") for name, _ in CHAIN}

    # -- training (autograd) ------------------------------------------------

    def synthesize_planes_train(self, z, gan_camera_params, truncation_psi=1.0):
        """The trainable G copy: f32 mapping on the zeroed camera +
        synthesis -> feature planes (N, 3, 32*D, H, W), with gradient."""
        g = self.G
        ws = g.mapping(z.float(), torch.zeros_like(gan_camera_params, dtype=torch.float32),
                       truncation_psi)
        return g.synthesis_planes(ws, noise_mode="const")

    def decode_from_planes(self, planes, init_position) -> Dict[str, torch.Tensor]:
        """planes (1, 3, C*D, H, W), init_position (M, 3) -> the five head
        outputs {color, opacity, rotation, scale, xyz}, each (M, dim), scale
        activated and xyz offset applied (the JAX package's
        pallas_heads_train route)."""
        g = self.G
        feats = sample_from_planes(g.plane_axes, planes, init_position[None],
                                   float(g.rk["box_warp"]), g.triplane_depth)[0]
        packed = decode_heads_pallas_diff(self.heads(), CHAIN, feats.mean(0).float(),
                                          init_position, init_position, SCALE_OFFSET,
                                          gelu=self.gelu)
        out, col = {}, 0
        for name, dim in CHAIN:
            out[name] = packed[:, col:col + dim]
            col += dim
        return out

    def apply(self, z, gan_camera_params, init_position, truncation_psi=1.0):
        planes = self.synthesize_planes_train(z, gan_camera_params, truncation_psi)
        return self.decode_from_planes(planes, init_position)

    # -- inference ------------------------------------------------------------

    @torch.no_grad()
    def fold(self) -> InferenceWeights:
        """bf16 kernel weights for the mapping (lr_mult folded) and the packed
        head chain. Call once per weight set, not per frame."""
        return InferenceWeights(
            mapping=fold_mapping(self.G.backbone.mapping),
            chain=pack_chain(self.heads(), CHAIN, self.position_dim, SCALE_OFFSET, self.gelu))

    # -- per frame -----------------------------------------------------------

    @torch.no_grad()
    def synthesize_planes(self, weights: InferenceWeights, z, gan_camera_params,
                          truncation_psi=1.0, stage_timer=None):
        """Fused mapping on the zeroed camera + synthesis -> (planes
        (N, 3, 32*D, H, W) f32, ws)."""
        g = self.G
        c = torch.zeros_like(gan_camera_params, dtype=torch.float32)
        ws = mapping_forward(z.float().contiguous(), c if g.c_dim else None,
                             weights.mapping, truncation_psi)
        if stage_timer is not None:
            stage_timer("mapping")
        planes = g.synthesis_planes(ws, noise_mode="const")
        if stage_timer is not None:
            stage_timer("synthesis")
        return planes, ws

    @torch.no_grad()
    def decode_project(self, weights: InferenceWeights, planes, cam,
                       slab_ctx: Optional[SlabContext] = None, init_position=None,
                       stage_timer=None):
        """Decode + heads + projection of one frame's planes (1, 3, 32*D, H, W)
        -> (rows (NROWS, Mpad) f32, layout name -> (row, dim) of the raw head
        outputs). With slab_ctx, the slab route (K2), rows in the context's
        slot order. Without it, the brick route on the (M, 3) init_position
        (the template): rows in template order, columns >= M pad and not
        visible. stage_timer, when given, is called as each stage is issued:
        volume, decode (slab); table, sample, decode (brick)."""
        tick = stage_timer or (lambda name: None)
        cw = weights.chain
        g = self.G
        D = g.triplane_depth
        if slab_ctx is not None:
            vol, scales = build_slab_volume(planes, D)
            tick("volume")
            rows = decode_project_slab(cw, vol, scales, slab_ctx, cam)
            tick("decode")
            return rows, cw.layout
        if init_position is None:
            raise ValueError("decode_project needs a slab context or the init_position template")
        pos = init_position.float()
        M = pos.shape[0]
        box_warp = float(g.rk["box_warp"])
        table = build_plane_table(planes, D, brick_dtype=torch.int8)
        tick("table")
        if self.fused_sampling:
            aux, Mpad = build_brick_staging(pos.new_zeros((M, C)), pos, pos)
            rows_in, wts, scale_rows = sample_fused_inputs(
                g.plane_axes, planes, pos[None], box_warp, D, table=table, pad_to=Mpad)
            tick("sample")
            rows = decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M)
        else:
            feats = sample_from_planes(g.plane_axes, planes, pos[None], box_warp, D,
                                       table=table)[0]
            staging, _ = build_brick_staging(feats.mean(0), pos, pos)
            tick("sample")
            rows = decode_project(cw, staging, cam, M)
        tick("decode")
        return rows, cw.layout

    # -- per template --------------------------------------------------------

    def make_slab_context(self, init_position, block: int = 1024,
                          cache_dir: Optional[str] = None, device=None) -> SlabContext:
        """One-time packing of a static (M, 3) template for the slab decode.
        cache_dir persists the host products (perm, positions, origins,
        valid, idx16) as npz keyed on the template bytes, plane axes, grid
        dims and block geometry. The context lands on `device`, by default
        the decoder's own."""
        g = self.G
        if device is None:
            device = next(self.parameters()).device
        if g.triplane_depth < 2:
            raise NotImplementedError("the bilinear (depth-1, EG3D) slab variant is not ported")
        sizes = (g.triplane_depth, int(g.rk["triplane_size"]), int(g.rk["triplane_size"]))
        box_warp = float(g.rk["box_warp"])
        axes = g.plane_axes
        pos_np = np.asarray(init_position, np.float32)
        cache_path = None
        if cache_dir:
            h = hashlib.sha256()
            h.update(pos_np.tobytes())
            h.update(np.asarray(axes, np.float32).tobytes())
            h.update(repr((sizes, box_warp, block, "slab_pack_v1")).encode())
            cache_path = os.path.join(cache_dir, f"slab_pack_{h.hexdigest()[:24]}.npz")
        if cache_path and os.path.exists(cache_path):
            zf = np.load(cache_path)
            pb = PointBlocks(perm=zf["perm"], positions=zf["positions"],
                             origins=zf["origins"], idxw=None, valid=zf["valid"],
                             n_points=int(zf["n_points"]), block=int(zf["block"]))
            idx16 = zf["idx16"]
        else:
            pb = build_point_blocks(pos_np, axes, box_warp=box_warp, sizes=sizes, block=block)
            idx16 = compact_indices(pb, axes, box_warp, sizes)
            if cache_path:
                os.makedirs(cache_dir, exist_ok=True)
                tmp = cache_path + f".tmp{os.getpid()}.npz"
                np.savez(tmp, perm=pb.perm, positions=pb.positions, origins=pb.origins,
                         valid=pb.valid, idx16=idx16, n_points=pb.n_points,
                         block=pb.block)
                os.replace(tmp, cache_path)
        if pb.m_padded > 2 * pb.n_points:
            print(f"WARNING: slab packing {pb.m_padded / pb.n_points:.1f}x padded "
                  f"({pb.n_blocks} blocks for {pb.n_points} points)", file=sys.stderr)
        positions = torch.tensor(pb.positions, device=device)
        valid = torch.tensor(pb.valid, device=device)
        inv_slot = np.zeros(pb.n_points, np.int64)
        inv_slot[pb.perm] = np.where(pb.valid > 0)[0]
        inv = np.linalg.inv(axes).astype(np.float32)
        return SlabContext(
            positions=positions,
            idx16=torch.tensor(idx16, device=device),
            aux=build_staging(positions, positions, valid),
            valid=valid,
            inv_slot=torch.tensor(inv_slot, device=device),
            inv_axes=torch.tensor(inv, device=device),
            origins=pb.origins, perm=pb.perm, box_warp=box_warp, sizes=sizes,
            n_points=pb.n_points, block=pb.block, m_padded=pb.m_padded)
