"""Gaussian-attribute decoder heads — port of decoder/heads.py: the
reference's three decoder classes, the slab and brick decode routes of the
inference frame and the training side.

GaussianDecoder is an nn.Module holding the five heads
(`{color,opacity,rotation,scale,xyz}_decoder.backbone`, Linear layers at
Sequential indices 0/2/4/6 with GELU between, the reference's names) and
the fine-tunable generator copy `G`, so the JAX package's exported decoder
state dict loads with strict=True (port/from_jax.py). Its decoder_type is
one of the reference's classes (JAX `_CHAINS`):
  * 'sequential_reversed' (SequentialDecoderReverse, the default): heads
    chained color -> opacity -> rotation -> scale -> xyz, each reading the
    features, the position conditioning and every earlier head's output;
    scale offset -2.5; the mapping sees a zeroed camera;
  * 'sequential' (SequentialDecoder): chained xyz -> scale -> rotation ->
    opacity -> color; scale offset -2; the mapping sees the REAL camera;
  * 'parallel' (ParallelDecoder): every head reads the features and the
    position conditioning only; scale offset -2; zeroed camera.
The position conditioning is the raw xyz, or with use_xyz_embedding the
reference's NeRF embedding (decoder/pos_encoding.py, 63 columns).

The frame runs: synthesize_planes (mapping kernel K1 + StyleGAN2
synthesis) -> decode_project, on one of three routes, as the JAX
package's decode_project dispatches:
  * a slab context: the int8 slab volume + the fused slab decode K2;
    make_slab_context packs the static template once on the host (same
    packing and npz disk cache as the JAX package);
  * fused_sampling: the brick table, the per-plane brick-row gathers
    (sample_fused_inputs) and the gather-fused decode K9 with the
    fused_lerp option's lerp ('dots', the JAX default, or 'bcast');
  * otherwise: the brick table, the table sample, the plane mean and the
    decode K8 over the prebuilt staging.
Each decode kernel runs in the chain's dtype: bf16 (heads_bf16, the JAX
flagship's) or f32 (3xTF32 on the tensor cores, csrc/decode_f32.cu). The
brick routes need no per-template pack; their rows come out in template
order, padded to a multiple of 1024 points. Their table is the int8 brick
table of K10 on a PanoHead tri-grid (pallas_sampling False or True: K10's
rotate form, the JAX XLA and Pallas builds of the same table; "select": its
select form, the JAX _expand_kernel_select); on an EG3D tri-plane (depth 1,
which ignores pallas_sampling, as JAX does) it is
the plain bf16 bilinear table, the JAX decoder's brick dtype there, and the
slab route takes the bilinear pack and K2's bilinear form. decode_packed
runs the chain alone (K6 in the chain's dtype) on the table route's
features.

The training side (apply = synthesize_planes_train + decode_from_planes)
keeps the autograd graph: the f32 mapping and synthesis of the trainable G
copy, the float tri-grid sample at the surface points, and the head chain
on one of the JAX decode_from_planes routes: pallas_heads_train, the f32
chain K6 / K7 (decoder/pallas_heads_vjp.py); else pallas_heads, K6 in the
chain's dtype (a backward through the bf16 form raises, as the TPU
kernel has no VJP); else, and for any hidden width but 128, the plain per-head chain
(the JAX XLA chain).

`config` (a GaussianDecoderConfig: the generator's config and every
constructor option) rebuilds the same decoder through from_config.
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

from ..models.pallas_mapping import MAX_BATCH, FoldedMapping, fold_mapping, mapping_forward
from ..models.triplane import TriPlaneGenerator, TriPlaneGeneratorConfig
from ..neuralfield.renderer import (PALLAS_BUILDS, build_plane_table, build_slab_volume,
                                   decode_brick_dtype, sample_from_planes, sample_fused_inputs)
from .pallas_heads import (C, GELUS, LERPS, STAGE, ChainWeights, build_brick_staging, build_staging,
                           chain_dtype, decode_heads, decode_project, decode_project_fused,
                           decode_project_slab, pack_chain, softplus)
from .pallas_heads_vjp import decode_heads_pallas_diff
from .point_blocks import DZW, EY, PointBlocks, build_point_blocks, compact_indices
from .pos_encoding import Embedder

# decoder type (the reference's class) -> the heads in chain order with
# their output widths (JAX `_CHAINS`)
CHAINS = {
    "sequential_reversed": (("color", 3), ("opacity", 1), ("rotation", 4), ("scale", 3),
                            ("xyz", 3)),
    "sequential": (("xyz", 3), ("scale", 3), ("rotation", 4), ("opacity", 1), ("color", 3)),
    "parallel": (("xyz", 3), ("scale", 3), ("rotation", 4), ("opacity", 1), ("color", 3)),
}
# the reference default: each head reads the features, the position and
# every earlier head's output
CHAIN = CHAINS["sequential_reversed"]
SCALE_OFFSET = -2.5
HIDDEN = 128


class DecoderHead(nn.Module):
    """4-layer GELU MLP (Linear-GELU x3 -> Linear), torch.nn.Linear init."""

    def __init__(self, n_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None, device=None,
                 hidden_dim: int = HIDDEN):
        super().__init__()
        dims = [(n_features, hidden_dim), (hidden_dim, hidden_dim), (hidden_dim, hidden_dim),
                (hidden_dim, out_features)]
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
    aux: torch.Tensor         # (Mpad, 128) static staging (cond, init, valid), chain dtype
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


@dataclass(frozen=True)
class GaussianDecoderConfig:
    """The constructor arguments of a GaussianDecoder."""
    generator: TriPlaneGeneratorConfig = TriPlaneGeneratorConfig()
    gelu: str = "poly6"
    fused_sampling: bool = False
    decoder_type: str = "sequential_reversed"
    hidden_dim: int = HIDDEN
    use_xyz_embedding: bool = False
    heads_bf16: bool = False
    pallas_heads: bool = False
    pallas_heads_train: bool = False
    pallas_sampling: object = False   # False, True or "select"
    fused_lerp: str = "dots"          # 'dots' or 'bcast'
    pallas_mapping: bool = False      # apply's mapping fused (K1)


class _NoVJP(torch.autograd.Function):
    """fn() with no gradient: its backward raises `message`. The parameters
    only tie the output into the graph, so that differentiating it reaches
    the raise rather than a silent zero."""

    @staticmethod
    def forward(ctx, fn, message, *params):
        ctx.message = message
        return fn()

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(ctx.message)


class InferenceWeights(NamedTuple):
    """Weights prepared once for the fused kernels (GaussianDecoder.fold)."""
    mapping: FoldedMapping
    chain: ChainWeights


class GaussianDecoder(nn.Module):
    """The reference's decoders (module docstring): decoder_type
    'sequential_reversed' (the default), 'sequential' or 'parallel'; heads of
    width hidden_dim; the position conditioning raw or, with
    use_xyz_embedding, the 63-column NeRF embedding.

    The options follow the JAX GaussianDecoder's, with its defaults:
    heads_bf16 runs the inference chain in bf16 (decode_project,
    decode_packed and the pallas_heads route of decode_from_planes; else
    f32), pallas_heads and pallas_heads_train pick decode_from_planes'
    route. flagship.flagship_decoder sets heads_bf16 and pallas_heads, as
    the JAX flagship does; the trainer (apps/train_decoder.py) passes the
    JAX trainer's values. pallas_sampling (False, True or "select") picks
    the tri-grid brick table's build on the inference brick routes and
    fused_lerp ('dots' or 'bcast') K9's lerp, as in JAX (the training
    route's sample is the direct, differentiable gather whatever
    pallas_sampling says: the JAX Pallas build has no VJP). pallas_mapping
    runs apply's mapping fused (K1), as JAX's option does (its benchmark
    sets it; no trainer does). Every option is read from `config`, so a
    snapshot records what the decoder runs."""

    def __init__(self, generator: TriPlaneGenerator, gelu: str = "poly6",
                 rng: Optional[torch.Generator] = None, device=None,
                 fused_sampling: bool = False, decoder_type: str = "sequential_reversed",
                 hidden_dim: int = HIDDEN, use_xyz_embedding: bool = False,
                 heads_bf16: bool = False, pallas_heads: bool = False,
                 pallas_heads_train: bool = False, pallas_sampling=False,
                 fused_lerp: str = "dots", pallas_mapping: bool = False):
        super().__init__()
        if decoder_type not in CHAINS:
            raise ValueError(f"decoder_type {decoder_type!r}: one of {sorted(CHAINS)}")
        if gelu not in GELUS:
            raise ValueError(f"gelu {gelu!r}: one of {sorted(GELUS)}")
        if pallas_sampling not in PALLAS_BUILDS:
            raise ValueError(f"pallas_sampling {pallas_sampling!r}: one of {PALLAS_BUILDS}")
        if fused_lerp not in LERPS:
            raise ValueError(f"fused_lerp {fused_lerp!r}: one of {LERPS}")
        self.G = generator
        # fused_sampling: the brick route's gather-fused decode K9 in place
        # of the table sample + K8 (the JAX decoder's fused_sampling)
        self.config = GaussianDecoderConfig(
            generator.config, gelu, bool(fused_sampling), decoder_type, int(hidden_dim),
            bool(use_xyz_embedding), bool(heads_bf16), bool(pallas_heads),
            bool(pallas_heads_train),
            pallas_sampling if pallas_sampling == "select" else bool(pallas_sampling),
            fused_lerp, bool(pallas_mapping))
        self.chain_spec = CHAINS[decoder_type]
        self.parallel = decoder_type == "parallel"
        self.scale_offset = SCALE_OFFSET if decoder_type == "sequential_reversed" else -2.0
        self.embedder = Embedder() if use_xyz_embedding else None
        self.position_dim = self.embedder.out_dim if self.use_xyz_embedding else 3
        # name -> (column, width) of the packed head outputs, in chain order
        self.layout = {}
        extra = 0
        for name, out_dim in self.chain_spec:
            cond = self.position_dim + (0 if self.parallel else extra)
            setattr(self, f"{name}_decoder",
                    DecoderHead(32 + cond, out_dim, generator=rng, device=device,
                                hidden_dim=self.hidden_dim))
            self.layout[name] = (extra, out_dim)
            extra += out_dim

    @classmethod
    def from_config(cls, config: GaussianDecoderConfig,
                    rng: Optional[torch.Generator] = None, device=None) -> "GaussianDecoder":
        """The decoder `config` describes, with seeded random weights."""
        gen = TriPlaneGenerator.from_config(config.generator, generator=rng, device=device)
        return cls(gen, gelu=config.gelu, rng=rng, device=device,
                   fused_sampling=config.fused_sampling, decoder_type=config.decoder_type,
                   hidden_dim=config.hidden_dim, use_xyz_embedding=config.use_xyz_embedding,
                   heads_bf16=config.heads_bf16, pallas_heads=config.pallas_heads,
                   pallas_heads_train=config.pallas_heads_train,
                   pallas_sampling=config.pallas_sampling, fused_lerp=config.fused_lerp,
                   pallas_mapping=config.pallas_mapping)

    # the options, read from config (dataclasses.replace it to change a
    # runtime option: heads_bf16, pallas_heads, pallas_heads_train,
    # fused_sampling, gelu, pallas_sampling, fused_lerp, pallas_mapping; the
    # rest fix the heads' shapes)
    gelu = property(lambda self: self.config.gelu)
    fused_sampling = property(lambda self: self.config.fused_sampling)
    decoder_type = property(lambda self: self.config.decoder_type)
    hidden_dim = property(lambda self: self.config.hidden_dim)
    use_xyz_embedding = property(lambda self: self.config.use_xyz_embedding)
    heads_bf16 = property(lambda self: self.config.heads_bf16)
    pallas_heads = property(lambda self: self.config.pallas_heads)
    pallas_heads_train = property(lambda self: self.config.pallas_heads_train)
    pallas_sampling = property(lambda self: self.config.pallas_sampling)
    fused_lerp = property(lambda self: self.config.fused_lerp)
    pallas_mapping = property(lambda self: self.config.pallas_mapping)

    def heads(self) -> Dict[str, DecoderHead]:
        """name -> head, in chain order."""
        return {name: getattr(self, f"{name}_decoder") for name, _ in self.chain_spec}

    def cond0(self, init_position):
        """The position conditioning of the template: the raw xyz, or its
        embedding."""
        return self.embedder(init_position) if self.use_xyz_embedding else init_position

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.heads_bf16 else torch.float32

    # -- training (autograd) ------------------------------------------------

    def _mapping_camera(self, gan_camera_params):
        """The camera the mapping sees: the real one for 'sequential' (ref
        sequential_decoder.py:39-41), zeros for the other types."""
        if self.decoder_type == "sequential":
            return gan_camera_params.float()
        return torch.zeros_like(gan_camera_params, dtype=torch.float32)

    def mapping_condition(self, gan_camera_params):
        """The fused mapping's (K1's) conditioning input: the type's camera
        through TriPlaneGenerator.mapping's rule (zeros under
        c_gen_conditioning_zero, then times c_scale), which the JAX package
        applies before its fused mapping too."""
        c = self._mapping_camera(gan_camera_params)
        if self.G.rk["c_gen_conditioning_zero"]:
            c = torch.zeros_like(c)
        return c * self.G.rk.get("c_scale", 0.0)

    def synthesize_planes_train(self, z, gan_camera_params, truncation_psi=1.0):
        """The trainable G copy: f32 mapping on the type's camera (with the
        generator's own conditioning rule) + synthesis -> feature planes
        (N, 3, 32*D, H, W), with gradient."""
        g = self.G
        ws = g.mapping(z.float(), self._mapping_camera(gan_camera_params), truncation_psi)
        return g.synthesis_planes(ws, noise_mode="const")

    def activate_scale(self, scale):
        return -softplus(scale + 5.0) + self.scale_offset

    def _head_plain(self, head: DecoderHead, fm, cond):
        """One head as the JAX DecoderHead.apply: (features mean ++ cond)
        through 4 Linears, GELU between (torch's exact erf GELU for 'exact'
        and 'none', its tanh form for 'tanh', the polynomials as the
        kernels')."""
        x = torch.cat([fm, cond.to(fm.dtype)], dim=-1)
        layers = [m for m in head.backbone if isinstance(m, nn.Linear)]
        for i, lin in enumerate(layers):
            x = lin(x)
            if i < 3:
                if self.gelu.startswith("poly"):
                    x = GELUS[self.gelu](x)
                else:
                    x = torch.nn.functional.gelu(
                        x, approximate="tanh" if self.gelu == "tanh" else "none")
        return x

    def _decode_plain(self, fm, cond, init_position) -> Dict[str, torch.Tensor]:
        """The plain per-head chain (the JAX XLA chain), any hidden width."""
        out = {}
        for name, _ in self.chain_spec:
            v = self._head_plain(getattr(self, f"{name}_decoder"), fm, cond)
            if name == "xyz":
                v = v * 0.01 + init_position
            elif name == "scale":
                v = self.activate_scale(v)
            out[name] = v
            if not self.parallel:
                cond = torch.cat([cond, v.to(cond.dtype)], dim=-1)
        return out

    def decode_from_planes(self, planes, init_position) -> Dict[str, torch.Tensor]:
        """planes (1, 3, C*D, H, W), init_position (M, 3) -> the five head
        outputs {name: (M, dim)} in chain order, scale activated and xyz
        offset applied, on the JAX decode_from_planes' routes: the
        differentiable f32 kernel chain (pallas_heads_train), K6 in the
        chain's dtype (pallas_heads), or the plain chain (otherwise, and at
        any hidden width but 128)."""
        g = self.G
        feats = sample_from_planes(g.plane_axes, planes, init_position[None],
                                   float(g.rk["box_warp"]), g.triplane_depth)[0]
        fm = feats.mean(0).float()
        cond = self.cond0(init_position)
        M = init_position.shape[0]
        kernels = self.hidden_dim == STAGE
        if kernels and (self.pallas_heads_train
                        or (self.pallas_heads and not self.heads_bf16)):
            packed = decode_heads_pallas_diff(self.heads(), self.chain_spec, fm, cond,
                                              init_position, self.scale_offset,
                                              gelu=self.gelu, parallel=self.parallel)
        elif kernels and self.pallas_heads:
            # the bf16 chain alone (K6's bf16 form): it has no VJP, as the
            # TPU kernel has none, so a backward through it raises
            params = [p for head in self.heads().values() for p in head.parameters()]
            packed = _NoVJP.apply(
                lambda: self._decode_bf16(fm, cond, init_position),
                "decode_from_planes' bf16 pallas_heads route (K6's bf16 form) has no gradient, "
                "as the JAX kernel has no VJP: train with pallas_heads_train or f32 heads",
                *params)
        else:
            return self._decode_plain(fm, cond, init_position)
        return {name: packed[:M, c:c + d] for name, (c, d) in self.layout.items()}

    def _decode_bf16(self, fm, cond, init_position):
        staging, _ = build_brick_staging(fm, cond, init_position, dtype=torch.bfloat16)
        return decode_heads(staging, self._pack(torch.bfloat16))

    def apply(self, z, gan_camera_params, init_position, truncation_psi=1.0):
        """synthesis + decode_from_planes. Under pallas_mapping, at batch <=
        MAX_BATCH and on a mapping K1 takes (lrelu, no last activation,
        num_ws), the mapping runs fused as in JAX's apply: K1 on weights
        folded for this call, with no gradient (a backward through it
        raises, as the JAX kernel has no VJP); else the f32 mapping."""
        mn = self.G.backbone.mapping
        if not (self.pallas_mapping and mn.activation == "lrelu" and not mn.last_activation
                and mn.num_ws is not None and z.shape[0] <= MAX_BATCH):
            planes = self.synthesize_planes_train(z, gan_camera_params, truncation_psi)
            return self.decode_from_planes(planes, init_position)

        def fused():
            with torch.no_grad():
                return self._fused_ws(fold_mapping(mn), z, gan_camera_params, truncation_psi)
        ws = _NoVJP.apply(fused, "apply's fused mapping (pallas_mapping, K1) has no gradient, "
                          "as the JAX kernel has no VJP: train without pallas_mapping",
                          *mn.parameters())
        return self.decode_from_planes(self.G.synthesis_planes(ws, noise_mode="const"),
                                       init_position)

    # -- inference ------------------------------------------------------------

    def _pack(self, dtype) -> ChainWeights:
        if self.hidden_dim != STAGE:
            raise ValueError(
                f"hidden_dim {self.hidden_dim}: the kernels' chain takes {STAGE}-wide heads "
                f"(as the JAX package's Pallas kernels do); apply / decode_from_planes and "
                "training run other widths on the plain chain")
        return pack_chain(self.heads(), self.chain_spec, self.position_dim, self.scale_offset,
                          self.gelu, parallel=self.parallel, dtype=dtype)

    @torch.no_grad()
    def fold(self) -> InferenceWeights:
        """Kernel weights for the mapping (bf16, lr_mult folded) and the
        packed head chain in the decoder's compute dtype. Call once per
        weight set, not per frame."""
        return InferenceWeights(mapping=fold_mapping(self.G.backbone.mapping),
                                chain=self._pack(self.compute_dtype))

    # -- per frame -----------------------------------------------------------

    @torch.no_grad()
    def synthesize_planes(self, weights: InferenceWeights, z, gan_camera_params,
                          truncation_psi=1.0, stage_timer=None):
        """Fused mapping (K1) on mapping_condition(gan_camera_params) +
        synthesis -> (planes (N, 3, 32*D, H, W) f32, ws)."""
        ws = self._fused_ws(weights.mapping, z, gan_camera_params, truncation_psi)
        if stage_timer is not None:
            stage_timer("mapping")
        planes = self.G.synthesis_planes(ws, noise_mode="const")
        if stage_timer is not None:
            stage_timer("synthesis")
        return planes, ws

    def _fused_ws(self, folded: FoldedMapping, z, gan_camera_params, truncation_psi):
        """K1 on mapping_condition(gan_camera_params) -> ws (N, num_ws, w_dim)."""
        c = self.mapping_condition(gan_camera_params)
        return mapping_forward(z.float().contiguous(), c.contiguous() if self.G.c_dim else None,
                               folded, truncation_psi)

    def _brick_table(self, planes):
        D = self.G.triplane_depth
        return build_plane_table(planes, D, brick_dtype=decode_brick_dtype(D),
                                 pallas_build=self.pallas_sampling if D > 1 else False)

    @torch.no_grad()
    def decode_packed(self, weights: InferenceWeights, planes, init_position):
        """The chain alone on the table route's plane-mean features (JAX
        decode_packed) -> (out16 (Mpad, 16) f32 transformed head outputs,
        layout name -> (col, dim)); rows >= M are pad, Mpad a multiple of
        1024. K6 in the chain's dtype (bf16 or f32) on the card."""
        g = self.G
        cw = weights.chain
        pos = init_position.float()
        feats = sample_from_planes(g.plane_axes, planes, pos[None], float(g.rk["box_warp"]),
                                   g.triplane_depth, table=self._brick_table(planes))[0]
        staging, _ = build_brick_staging(feats.mean(0), self.cond0(pos), pos,
                                         dtype=chain_dtype(cw))
        return decode_heads(staging, cw), dict(cw.layout)

    @torch.no_grad()
    def apply_packed(self, weights: InferenceWeights, z, gan_camera_params, init_position,
                     truncation_psi=1.0):
        planes, _ = self.synthesize_planes(weights, z, gan_camera_params, truncation_psi)
        return self.decode_packed(weights, planes, init_position)

    @torch.no_grad()
    def apply_project(self, weights: InferenceWeights, z, gan_camera_params, init_position,
                      cam, truncation_psi=1.0, slab_ctx: Optional[SlabContext] = None):
        """synthesize_planes + decode_project -> (rows, layout) (JAX
        apply_project; slab_ctx takes the slab route)."""
        planes, _ = self.synthesize_planes(weights, z, gan_camera_params, truncation_psi)
        return self.decode_project(weights, planes, cam, slab_ctx=slab_ctx,
                                   init_position=init_position)

    @torch.no_grad()
    def decode_project(self, weights: InferenceWeights, planes, cam,
                       slab_ctx: Optional[SlabContext] = None, init_position=None,
                       stage_timer=None):
        """Decode + heads + projection of one frame's planes (1, 3, 32*D, H, W)
        -> (rows (NROWS, Mpad) f32, layout name -> (row, dim) of the raw head
        outputs), in the chain's dtype. With slab_ctx, the slab route (K2),
        rows in the context's slot order. Without it, the brick route on the
        (M, 3) init_position (the template): rows in template order, columns
        >= M pad and not visible. stage_timer, when given, is called as each
        stage is issued: volume, decode (slab); table, sample, decode
        (brick)."""
        tick = stage_timer or (lambda name: None)
        cw = weights.chain
        dt = chain_dtype(cw)
        g = self.G
        D = g.triplane_depth
        if slab_ctx is not None:
            if slab_ctx.aux.dtype != dt:
                raise ValueError(f"slab context staging {slab_ctx.aux.dtype}, chain {dt}: build "
                                 "the context with this decoder (make_slab_context)")
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
        cond = self.cond0(pos)
        table = self._brick_table(planes)
        tick("table")
        if self.fused_sampling:
            aux, Mpad = build_brick_staging(pos.new_zeros((M, C)), cond, pos, dtype=dt)
            rows_in, wts, scale_rows = sample_fused_inputs(
                g.plane_axes, planes, pos[None], box_warp, D, table=table, pad_to=Mpad)
            tick("sample")
            rows = decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M,
                                        lerp=self.fused_lerp)
        else:
            feats = sample_from_planes(g.plane_axes, planes, pos[None], box_warp, D,
                                       table=table)[0]
            staging, _ = build_brick_staging(feats.mean(0), cond, pos, dtype=dt)
            tick("sample")
            rows = decode_project(cw, staging, cam, M)
        tick("decode")
        return rows, cw.layout

    # -- per template --------------------------------------------------------

    def make_slab_context(self, init_position, block: int = 1024,
                          cache_dir: Optional[str] = None, device=None) -> SlabContext:
        """One-time packing of a static (M, 3) template for the slab decode,
        its static staging (the position conditioning, init, valid) in the
        decoder's compute dtype.
        A depth-1 (EG3D) tri-plane takes the JAX package's bilinear pack
        (2-D windows, ey = min(128, roundup(H + 2, 8))). cache_dir persists
        the host products (perm, positions, origins, valid, idx16) as npz
        keyed on the template bytes, plane axes, grid dims and block
        geometry. The context lands on `device`, by default the decoder's
        own."""
        g = self.G
        if device is None:
            device = next(self.parameters()).device
        sizes = (g.triplane_depth, int(g.rk["triplane_size"]), int(g.rk["triplane_size"]))
        box_warp = float(g.rk["box_warp"])
        axes = g.plane_axes
        # the JAX package's window geometry, which sets its slot order
        bilinear = g.triplane_depth == 1
        if bilinear:
            dzw, ey = 1, min(128, -(-(sizes[1] + 2) // 8) * 8)
        else:
            dzw, ey = DZW, EY
        pos_np = np.asarray(init_position, np.float32)
        cache_path = None
        if cache_dir:
            h = hashlib.sha256()
            h.update(pos_np.tobytes())
            h.update(np.asarray(axes, np.float32).tobytes())
            h.update(repr((sizes, box_warp, block, (dzw, ey, bilinear),
                           "slab_pack_v1")).encode())
            cache_path = os.path.join(cache_dir, f"slab_pack_{h.hexdigest()[:24]}.npz")
        if cache_path and os.path.exists(cache_path):
            zf = np.load(cache_path)
            pb = PointBlocks(perm=zf["perm"], positions=zf["positions"],
                             origins=zf["origins"], idxw=None, valid=zf["valid"],
                             n_points=int(zf["n_points"]), block=int(zf["block"]))
            idx16 = zf["idx16"]
        else:
            pb = build_point_blocks(pos_np, axes, box_warp=box_warp, sizes=sizes, block=block,
                                    ey=ey, bilinear=bilinear)
            idx16 = compact_indices(pb, axes, box_warp, sizes, bilinear=bilinear)
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
            aux=build_staging(self.cond0(positions), positions, valid, dtype=self.compute_dtype),
            valid=valid,
            inv_slot=torch.tensor(inv_slot, device=device),
            inv_axes=torch.tensor(inv, device=device),
            origins=pb.origins, perm=pb.perm, box_warp=box_warp, sizes=sizes,
            n_points=pb.n_points, block=pb.block, m_padded=pb.m_padded)
