"""Fused decode: 5-head chain + EWA projection, on the slab route (with
the trilinear sample fused) and on the brick route — port of
decoder/pallas_heads.py. The training chain (K6) is at the end.

Kernel K2, csrc/slab_decode.cu::slab_decode_kernel, replaces the TPU kernel
decoder/pallas_heads.py::decode_project_pallas_slab
(`_slab_heads_project_kernel` + `_chain_project_body`). It computes the
rows that kernel writes, not its block structure: the TPU's static (z,y)
weight matrices and x-segment matrix exist only to turn the trilinear gather
into matrix-unit contractions. On the H100 each point gathers its 8 corners
per plane directly from the int8 channels-last volume (32 channels = 32
contiguous bytes per corner) at the compact padded indices of the host pack,
with the corner weights recomputed in f32 from the slot position. Its
bilinear form (a second instantiation of the same kernel) takes a depth-1
EG3D tri-plane volume (3, 1, YP, XP*32): 4 corners a plane, no z weight,
the z validity bit always set (the TPU kernel's dzw=1, ey=128 form, whose
128-row window exists to fill one matrix-unit tile and is not kept).

What bounds it on the H100: the chain — 5 heads x 4 linears of width 128,
5.12e5 FLOPs per point (padded), ~3e11 FLOPs per flagship frame; the
gather reads only ~0.8 KB per point. Its design: one block of 256 threads
per 128 points (a ragged last block masked), the chain on the tensor cores
(bf16 mma.sync, f32 accumulators, each warp's 16 points carried in
registers from layer to layer), the bf16 weights streamed through a
two-slot shared-memory ring by cp.async, the projection tail fused.

Numerics, shared by the kernel and decode_project_slab_plain, follow the
TPU kernel's bf16 rounding points: the staging is bf16 — the plane-mean
feature, the position conditioning, the chain outputs fed to later heads
and the `init` position read by xyz = 0.01 o + init are all rounded to
bf16 — weights are bf16, every hidden activation is rounded to bf16 before
its product, accumulation is f32. First-layer weights are zero-padded to
the 128 staging columns; head h reads the staging prefix. Rows 14-15 of the
raw head block and rows 28-31 are written as zeros. Pad slots decode zero
features and are culled through the staging's valid column (visible, opac
and radius_f multiplied by it). The port reads the corners with f32
weights, where the TPU kernel's (z,y) weights are int8-quantised. The
kernels' lerp (K2's and K9's) rounds each product and sum on its own, in
the plain version's order, so their bf16 features equal the plain
version's bit for bit; what remains between kernel and plain is the
chain's summation order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernel_lib
from ..splat.projection import project_channels

STAGE = 128      # staging width
OUT_W = 16       # padded raw head-output width
INIT_COL = 120   # raw init_position stash (3 columns)
VALID_COL = 123  # pad-slot mask: 1 real / 0 pad
C = 32           # feature channels per plane
CORNERS = 8      # brick-row corners per tri-grid tap (K9)
SH_C0 = 0.28209479177387814

# output rows: [0:16) raw head outputs (channel-major), then screen space
PROJ_ROWS = {
    "px": 16, "py": 17, "conic_a": 18, "conic_b": 19, "conic_c": 20,
    "opac": 21, "col_r": 22, "col_g": 23, "col_b": 24,
    "depth": 25, "radius_f": 26, "visible": 27,
}
NROWS = 32
POINTS_PER_BLOCK = 128  # K2/K8/K9 block: 8 warps x 16 points; a ragged last block is masked
PLAIN_CHUNK = 131072    # slots per step of the plain version's gather


def _erf(x):
    """Abramowitz & Stegun 7.1.26 (the TPU kernel's erf)."""
    s = torch.sign(x)
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
           + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-a * a))


def _gelu_exact(x):
    return x * 0.5 * (1.0 + _erf(x * (2.0 ** -0.5)))


def _gelu_tanh(x):
    u = 0.7978845608028654 * (x + 0.044715 * x * x * x)
    e = torch.exp(-2.0 * u.abs())
    t = (1.0 - e) / (1.0 + e)
    return 0.5 * x * (1.0 + torch.sign(u) * t)


_GELU_POLY = (
    2.83848659e-05, 3.98631713e-01, -6.59243150e-02, 9.56686907e-03,
    -1.03506464e-03, 8.13021533e-05, -4.45819445e-06, 1.60138706e-07,
    -3.35935034e-09, 3.10310371e-11,
)
_GELU_POLY6 = (
    1.78927555e-03, 3.88399878e-01, -5.61855200e-02, 5.99722169e-03,
    -3.76970754e-04, 1.25452394e-05, -1.69796236e-07,
)


def _gelu_horner(coeffs):
    def gelu(x):
        u = x * x
        acc = torch.full_like(x, coeffs[-1])
        for c in coeffs[-2::-1]:
            acc = acc * u + c
        y = 0.5 * x + acc
        return torch.where(x > 4.5, x, torch.where(x < -4.5, torch.zeros_like(x), y))
    return gelu


GELUS = {"exact": _gelu_exact, "tanh": _gelu_tanh, "poly": _gelu_horner(_GELU_POLY),
         "poly6": _gelu_horner(_GELU_POLY6), "none": lambda x: x}
_GELU_IDS = {"exact": 0, "tanh": 1, "poly": 2, "poly6": 3, "none": 4}
_KINDS = {"scale": 1, "xyz": 2}


def softplus(x):
    """log(1 + exp(x)) as jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _bf16r(x):
    return x.to(torch.bfloat16).float()


class ChainWeights(NamedTuple):
    """The 5 heads packed for the fused chain (see pack_chain)."""
    w1: torch.Tensor   # (H, 128, 128) bf16, (in, out), rows >= n_in zero
    b1: torch.Tensor   # (H, 128) f32
    w2: torch.Tensor   # (H, 128, 128) bf16
    b2: torch.Tensor
    w3: torch.Tensor   # (H, 128, 128) bf16
    b3: torch.Tensor
    w4: torch.Tensor   # (H, 128, 16) bf16, columns >= out_dim zero
    b4: torch.Tensor   # (H, 16) f32
    chain: Tuple[Tuple[str, int, int, int], ...]   # (name, out_dim, stage_col, out_col)
    layout: Dict[str, Tuple[int, int]]             # name -> (out_col, out_dim)
    meta: torch.Tensor  # (32,) int32 chain description for the kernel
    scale_offset: float
    gelu: str


def pack_chain_f32(heads: Dict[str, torch.nn.Module], chain_spec: Sequence[Tuple[str, int]],
                   P: int, scale_offset: float, gelu: str) -> ChainWeights:
    """Head modules (name -> DecoderHead with backbone Linear layers at
    0, 2, 4, 6) -> f32 ChainWeights (the JAX package's _pack_chain with
    compute_dtype f32), built with differentiable ops: gradients of the
    packed tensors flow back to the heads' parameters."""
    n_heads = len(chain_spec)
    assert n_heads <= 5, "the kernels' chain description holds 5 heads"
    assert 32 + P + sum(d for _, d in chain_spec) <= INIT_COL
    ws = {k: [] for k in ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")}
    chain, layout = [], {}
    stage_col, out_col = 32 + P, 0
    for name, out_dim in chain_spec:
        seq = heads[name].backbone
        n_in = seq[0].weight.shape[1]
        if n_in > stage_col:
            # K6 multiplies the staging prefix only: w1's rows past it are zero
            raise ValueError(f"head {name!r} takes {n_in} inputs, past its staging prefix "
                             f"({stage_col} columns)")
        ws["w1"].append(F.pad(seq[0].weight.t(), (0, 0, 0, STAGE - n_in)))
        ws["w2"].append(seq[2].weight.t())
        ws["w3"].append(seq[4].weight.t())
        ws["w4"].append(F.pad(seq[6].weight.t(), (0, OUT_W - out_dim)))
        ws["b1"].append(seq[0].bias)
        ws["b2"].append(seq[2].bias)
        ws["b3"].append(seq[4].bias)
        ws["b4"].append(F.pad(seq[6].bias, (0, OUT_W - out_dim)))
        chain.append((name, out_dim, stage_col, out_col))
        layout[name] = (out_col, out_dim)
        stage_col += out_dim
        out_col += out_dim
    meta = [0] * 32
    meta[0] = n_heads
    for h, (name, out_dim, sc, oc) in enumerate(chain):
        meta[1 + h], meta[6 + h], meta[11 + h] = out_dim, sc, oc
        meta[16 + h] = _KINDS.get(name, 0)
    if all(n in layout for n in ("xyz", "rotation", "scale", "color", "opacity")):
        meta[21:26] = [layout[n][0] for n in ("xyz", "rotation", "scale", "color", "opacity")]
    meta[26] = _GELU_IDS[gelu]
    dev = ws["w1"][0].device
    st = {k: torch.stack(v).float().contiguous() for k, v in ws.items()}
    return ChainWeights(st["w1"], st["b1"], st["w2"], st["b2"], st["w3"], st["b3"],
                        st["w4"], st["b4"], tuple(chain), layout,
                        torch.tensor(meta, dtype=torch.int32, device=dev),
                        float(scale_offset), gelu)


@torch.no_grad()
def pack_chain(heads: Dict[str, torch.nn.Module], chain_spec: Sequence[Tuple[str, int]],
               P: int, scale_offset: float, gelu: str) -> ChainWeights:
    """Head modules -> ChainWeights for K2: pack_chain_f32 with the weight
    matrices in bf16. Call once per weight set, not per frame."""
    cw = pack_chain_f32(heads, chain_spec, P, scale_offset, gelu)
    bf = lambda w: w.to(torch.bfloat16).contiguous()  # noqa: E731
    return cw._replace(w1=bf(cw.w1), w2=bf(cw.w2), w3=bf(cw.w3), w4=bf(cw.w4))


def build_staging(cond0, init_position, valid):
    """Per-slot static staging (M, 128) in the compute dtype, bf16: feature
    columns [0:32) zero (the kernel fills them), conditioning at [32:32+P),
    init_position at [120:123), the valid mask at 123."""
    M, P = cond0.shape
    st = torch.zeros((M, STAGE), dtype=torch.float32, device=cond0.device)
    st[:, 32:32 + P] = cond0.float()
    st[:, INIT_COL:INIT_COL + 3] = init_position.float()
    st[:, VALID_COL] = valid.float()
    return st.to(torch.bfloat16).contiguous()


def slab_scale_rows(scales):
    """(3, 32) int8 dequant scales -> the scale rows K2 and its plain
    version multiply each plane's lerp by: the dequant scale with the 1/3
    plane mean folded in, computed once by this one op for both, so that
    their features agree bit for bit."""
    return (scales / 3.0).contiguous()


def slab_features_plain(vol, scales, positions, idx16, valid, inv_axes, box_warp, sizes):
    """Mean-over-planes trilinear sample of the int8 slab volume at every
    slot -> (M, 32) f32, zero at pad slots. Corner weights follow the
    align_corners=False contract from the slot position and the host's
    padded indices + validity bits (point_blocks.compact_indices). A
    depth-1 volume (DZ == 1) is sampled bilinearly: the single z layer
    weighs its validity bit (always set), the plane-local z is unused."""
    D, H, W = sizes
    n_planes, DZ, YP, XPC = vol.shape
    XP = XPC // C
    vflat = vol.reshape(n_planes, DZ * YP * XP, C)
    scale_rows = slab_scale_rows(scales)
    g = (2.0 / box_warp) * positions.float()
    idx = idx16.long()
    acc = torch.zeros((positions.shape[0], C), dtype=torch.float32, device=vol.device)

    def corner(x_cont, idxp, size, v0, v1):
        x = ((x_cont + 1.0) * size - 1.0) * 0.5
        w1 = x - (idxp.float() - 1.0)
        return (1.0 - w1) * v0, w1 * v1

    for p in range(n_planes):
        inv = inv_axes[p]
        proj = [g[:, 0] * inv[0, d] + g[:, 1] * inv[1, d] + g[:, 2] * inv[2, d]
                for d in range(3)]
        ix, iy, iz, bits = (idx[:, 4 * p + k] for k in range(4))
        vb = [((bits >> k) & 1).float() for k in range(6)]
        wx = corner(proj[0], ix, W, vb[0], vb[1])
        wy = corner(proj[1], iy, H, vb[2], vb[3])
        if DZ == 1:
            wz, dzs = (vb[4], vb[5]), (0,)
        else:
            wz, dzs = corner(proj[2], iz, D, vb[4], vb[5]), (0, 1)
        s = torch.zeros_like(acc)
        for dz in dzs:
            for dy in (0, 1):
                wzy = wz[dz] * wy[dy]
                base = (iz + dz) * YP + (iy + dy)
                for dx in (0, 1):
                    w = wzy * wx[dx]
                    s += w[:, None] * vflat[p, base * XP + ix + dx].float()
        acc += s * scale_rows[p]
    return acc * (valid.float() > 0)[:, None]


def chain_project_plain(staging, cw: ChainWeights, cam):
    """The 5-head chain + EWA projection over a bf16-valued f32 staging
    (M, 128) -> rows (NROWS, M) f32 (before the valid cull)."""
    x = staging.clone()
    M = x.shape[0]
    gelu = GELUS[cw.gelu]
    o16 = torch.zeros((M, OUT_W), dtype=torch.float32, device=x.device)
    init = x[:, INIT_COL:INIT_COL + 3]
    for h, (name, out_dim, stage_col, out_col) in enumerate(cw.chain):
        a = _bf16r(gelu(x @ cw.w1[h].float() + cw.b1[h]))
        a = _bf16r(gelu(a @ cw.w2[h].float() + cw.b2[h]))
        a = _bf16r(gelu(a @ cw.w3[h].float() + cw.b3[h]))
        o = (a @ cw.w4[h].float() + cw.b4[h])[:, :out_dim]
        if name == "scale":
            o = -softplus(o + 5.0) + cw.scale_offset
        elif name == "xyz":
            o = o * 0.01 + init
        x[:, stage_col:stage_col + out_dim] = _bf16r(o)
        o16[:, out_col:out_col + out_dim] = o
    return project_heads(o16, cw, cam)


def project_heads(o16, cw: ChainWeights, cam):
    """Raw head outputs (M, 16) f32 -> rows (NROWS, M): the outputs at rows
    [0:16), then the EWA projection, opacity and SH-C0 colour (before the
    valid cull). The projection tail of chain_project_plain and of K2."""
    M = o16.shape[0]
    rows = torch.zeros((NROWS, M), dtype=torch.float32, device=o16.device)
    rows[0:OUT_W] = o16.t()
    col = {n: o16[:, c] for n, (c, _) in cw.layout.items()}
    x0, r0, s0 = cw.layout["xyz"][0], cw.layout["rotation"][0], cw.layout["scale"][0]
    ch = project_channels(
        cam, o16[:, x0], o16[:, x0 + 1], o16[:, x0 + 2],
        tuple(o16[:, r0 + k] for k in range(4)),
        tuple(torch.exp(o16[:, s0 + k]) for k in range(3)))
    for k in ("px", "py", "conic_a", "conic_b", "conic_c", "depth", "radius_f"):
        rows[PROJ_ROWS[k]] = ch[k]
    rows[PROJ_ROWS["visible"]] = ch["visible"].float()
    rows[PROJ_ROWS["opac"]] = torch.sigmoid(col["opacity"])
    c0 = cw.layout["color"][0]
    for k in range(3):
        rows[PROJ_ROWS["col_r"] + k] = torch.clamp(SH_C0 * o16[:, c0 + k] + 0.5, min=0.0)
    return rows


def _cull(rows, valid):
    for k in ("visible", "opac", "radius_f"):
        rows[PROJ_ROWS[k]] *= valid


def decode_project_slab_plain(cw: ChainWeights, vol, scales, ctx, cam):
    """Plain PyTorch version of K2 -> rows (NROWS, Mpad) f32, slot order.
    Chunked over slots to bound the gather's memory at flagship size."""
    Mpad = ctx.positions.shape[0]
    rows = torch.empty((NROWS, Mpad), dtype=torch.float32, device=vol.device)
    for m0 in range(0, Mpad, PLAIN_CHUNK):
        sl = slice(m0, min(Mpad, m0 + PLAIN_CHUNK))
        staging = ctx.aux[sl].float()
        valid = staging[:, VALID_COL].clone()
        fm = slab_features_plain(vol, scales, ctx.positions[sl], ctx.idx16[sl], valid,
                                 ctx.inv_axes, ctx.box_warp, ctx.sizes)
        staging[:, 0:C] = _bf16r(fm)
        r = chain_project_plain(staging, cw, cam)
        _cull(r, valid)
        rows[:, sl] = r
    return rows


# ---------------------------------------------------------------------------
# brick route: K8 decode_project and K9 decode_project_fused
# (csrc/brick_decode.cu)
# ---------------------------------------------------------------------------
# Kernel K8, brick_decode_kernel, replaces the TPU kernel
# decoder/pallas_heads.py::decode_project_pallas: K2's chain-and-projection
# tail (csrc/chain.cuh::chain_project_tail) over a prebuilt bf16 staging,
# each 128-point block loading its rows. Kernel K9, fused_decode_kernel,
# replaces decode_project_pallas_fused: it builds the staging's feature
# columns from the raw brick rows (dequant, corner lerp and plane mean in
# f32, rounded to bf16), then runs the same tail. Two forms, instantiated
# from one template: the tri-grid's 8 int8 corners with per-(plane,
# channel) dequant scales, and the EG3D tri-plane's 4 bf16 corners, whose
# scale rows are the 1/3 plane mean alone. The TPU kernel's default
# 'dots' lerp rounds the corner weights and products to bf16 to feed its
# matrix unit; it is the same function at lower precision, so the port
# implements the f32 'bcast' form only. What bounds both on the H100: the
# chain's operations (as K2); K9 also reads ~0.8 KB of brick rows and
# weights per point. Numerics are K2's bf16 rounding points. Unlike K2 there
# is no valid column: pad slots are zero staging rows, and only `visible` is
# culled, by column < n_points, as the TPU kernels do.

DECODE_BLOCK = 1024   # the brick route's Mpad multiple (the JAX kernels' block)
# K9's forms: corners per tap -> brick-row dtype (tri-grid int8, tri-plane bf16)
FUSED_FORMS = {CORNERS: torch.int8, 4: torch.bfloat16}


def build_brick_staging(feats_mean, cond0, init_position, block: int = DECODE_BLOCK):
    """The brick route's staging (the JAX package's _build_staging): bf16
    (Mpad, 128), features [0:32), conditioning [32:32+P), zeros for the chain
    columns, init_position at [120:123), pad slots zero rows; Mpad = M rounded
    up to block. -> (staging, Mpad)."""
    M = cond0.shape[0]
    Mpad = -(-M // block) * block
    st = build_staging_f32(feats_mean, cond0, init_position)
    return F.pad(st, (0, 0, 0, Mpad - M)).to(torch.bfloat16).contiguous(), Mpad


def _check_chain_bf16(cw: ChainWeights):
    H_ = cw.w1.shape[0]
    chk = kernel_lib.check
    for name in ("w1", "w2", "w3"):
        chk(getattr(cw, name), name, torch.bfloat16, (H_, STAGE, STAGE))
    chk(cw.w4, "w4", torch.bfloat16, (H_, STAGE, OUT_W))
    for name in ("b1", "b2", "b3"):
        chk(getattr(cw, name), name, torch.float32, (H_, STAGE))
    chk(cw.b4, "b4", torch.float32, (H_, OUT_W))
    chk(cw.meta, "meta", torch.int32, (32,))


def _chain_ptrs(cw: ChainWeights, cam_c):
    return [t.data_ptr() for t in (cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4,
                                   cam_c, cw.meta)]


def _check_brick_args(Mpad: int, n_points: int):
    if Mpad <= 0:
        raise ValueError(f"Mpad {Mpad}: nothing to decode")
    if not 0 <= n_points <= Mpad:
        raise ValueError(f"n_points {n_points} outside [0, Mpad={Mpad}]")


def decode_project_plain(cw: ChainWeights, staging, cam, n_points: int):
    """Plain PyTorch version of K8 -> rows (NROWS, Mpad) f32, chunked over
    points to bound the chain's memory at flagship size."""
    Mpad = staging.shape[0]
    rows = torch.empty((NROWS, Mpad), dtype=torch.float32, device=staging.device)
    for m0 in range(0, Mpad, PLAIN_CHUNK):
        sl = slice(m0, min(Mpad, m0 + PLAIN_CHUNK))
        rows[:, sl] = chain_project_plain(staging[sl].float(), cw, cam)
    rows[PROJ_ROWS["visible"], n_points:] = 0.0
    return rows


def decode_project(cw: ChainWeights, staging: torch.Tensor, cam, n_points: int) -> torch.Tensor:
    """Heads + projection over a prebuilt staging (build_brick_staging) ->
    rows (NROWS, Mpad) f32 in point order; columns >= n_points are pad and
    not visible. CPU tensors take the plain version, CUDA tensors K8."""
    if not kernel_lib.use_kernel(staging, cw.w1):
        return decode_project_plain(cw, staging, cam, n_points)
    lib = kernel_lib.library()
    Mpad = staging.shape[0]
    _check_brick_args(Mpad, n_points)
    kernel_lib.check(staging, "staging", torch.bfloat16, (Mpad, STAGE))
    _check_chain_bf16(cw)
    rows = torch.empty((NROWS, Mpad), dtype=torch.float32, device=staging.device)
    ptrs = _chain_ptrs(cw, _cam_consts(cam, staging.device))
    code = lib.ggd_brick_decode(staging.data_ptr(), *ptrs, rows.data_ptr(), Mpad, n_points,
                                cw.scale_offset, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "brick_decode_kernel")
    decode_project.launches += 1
    return rows


decode_project.launches = 0


def fused_features_plain(rows, wts, scale_rows):
    """The plane-mean sample from raw brick rows: per plane sum_c row_c *
    w_c in f32, times the plane's scale row, summed over the planes -> (m,
    C) f32. rows n_planes x (m, K*C) (K = 8 tri-grid or 4 tri-plane
    corners), wts (WR, m)."""
    K = rows[0].shape[1] // C
    acc = 0.0
    for p, r in enumerate(rows):
        accp = 0.0
        for c in range(K):
            accp = accp + r[:, c * C:(c + 1) * C].float() * wts[p * K + c][:, None]
        acc = acc + accp * scale_rows[p][None, :]
    return acc


def decode_project_fused_plain(cw: ChainWeights, aux, rows, wts, scale_rows, cam,
                               n_points: int):
    """Plain PyTorch version of K9 -> rows (NROWS, Mpad) f32, chunked."""
    Mpad = aux.shape[0]
    out = torch.empty((NROWS, Mpad), dtype=torch.float32, device=aux.device)
    for m0 in range(0, Mpad, PLAIN_CHUNK):
        sl = slice(m0, min(Mpad, m0 + PLAIN_CHUNK))
        staging = aux[sl].float()
        staging[:, 0:C] = _bf16r(fused_features_plain([r[sl] for r in rows], wts[:, sl],
                                                      scale_rows))
        out[:, sl] = chain_project_plain(staging, cw, cam)
    out[PROJ_ROWS["visible"], n_points:] = 0.0
    return out


def decode_project_fused(cw: ChainWeights, aux: torch.Tensor, rows, wts: torch.Tensor,
                         scale_rows: torch.Tensor, cam, n_points: int) -> torch.Tensor:
    """Gather-fused heads + projection (inputs from renderer.
    sample_fused_inputs; aux = build_brick_staging with zero features) ->
    rows (NROWS, Mpad) f32 in point order, the contract of decode_project.
    rows: 3 planes of int8 (Mpad, 8*32) tri-grid rows, or bf16 (Mpad,
    4*32) tri-plane rows. CPU tensors take the plain version, CUDA tensors
    K9 in the matching form."""
    if len(rows) != 3:
        raise ValueError("the fused decode takes 3 planes")
    if not kernel_lib.use_kernel(aux, wts, cw.w1, *rows):
        return decode_project_fused_plain(cw, aux, rows, wts, scale_rows, cam, n_points)
    lib = kernel_lib.library()
    Mpad = aux.shape[0]
    _check_brick_args(Mpad, n_points)
    kernel_lib.check(aux, "aux", torch.bfloat16, (Mpad, STAGE))
    K = rows[0].shape[1] // C
    if K not in FUSED_FORMS:
        raise ValueError(f"rows {tuple(rows[0].shape)}: expected {sorted(FUSED_FORMS)} corners "
                         f"of {C} channels")
    for p, r in enumerate(rows):
        kernel_lib.check(r, f"rows[{p}]", FUSED_FORMS[K], (Mpad, K * C))
    kernel_lib.check(wts, "wts", torch.float32)
    if wts.shape[0] < 3 * K or wts.shape[1] != Mpad:
        raise ValueError(f"wts {tuple(wts.shape)}: expected (>= {3 * K}, {Mpad})")
    kernel_lib.check(scale_rows, "scale_rows", torch.float32, (3, C))
    _check_chain_bf16(cw)
    out = torch.empty((NROWS, Mpad), dtype=torch.float32, device=aux.device)
    ptrs = _chain_ptrs(cw, _cam_consts(cam, aux.device))
    code = lib.ggd_fused_decode(aux.data_ptr(), *[r.data_ptr() for r in rows], wts.data_ptr(),
                                scale_rows.data_ptr(), *ptrs, out.data_ptr(), Mpad, n_points, K,
                                cw.scale_offset, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "fused_decode_kernel")
    decode_project_fused.launches += 1
    return out


decode_project_fused.launches = 0


def _cam_consts(cam, device):
    return torch.cat([
        cam.world_view_transform.reshape(-1).float().to(device),
        cam.full_proj_transform.reshape(-1).float().to(device),
        torch.tensor([cam.tanfovx, cam.tanfovy, cam.image_width, cam.image_height],
                     dtype=torch.float32, device=device),
    ]).contiguous()


def decode_project_slab(cw: ChainWeights, vol: torch.Tensor, scales: torch.Tensor,
                        ctx, cam) -> torch.Tensor:
    """Fused slab decode + heads + projection -> rows (NROWS, Mpad) f32 in
    the context's slot order. vol (3, DZ, YP, XP*32) int8 and scales (3, 32)
    f32 from build_slab_volume; ctx from GaussianDecoder.make_slab_context.
    A depth-1 context (sizes[0] == 1, DZ == 1) takes K2's bilinear form.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if not kernel_lib.use_kernel(vol, ctx.aux, cw.w1):
        return decode_project_slab_plain(cw, vol, scales, ctx, cam)
    lib = kernel_lib.library()
    D, H, W = ctx.sizes
    n_planes, DZ, YP, XPC = vol.shape
    Mpad = ctx.aux.shape[0]
    if n_planes != 3 or XPC % C or DZ != (1 if D == 1 else D + 2):
        raise ValueError(f"vol {tuple(vol.shape)}: the kernel takes 3 planes of {C} channels, "
                         f"{1 if D == 1 else D + 2} z layers for depth {D}")
    if Mpad <= 0:
        raise ValueError(f"Mpad {Mpad}: nothing to decode")
    chk = kernel_lib.check
    chk(vol, "vol", torch.int8)
    chk(scales, "scales", torch.float32, (3, C))
    chk(ctx.positions, "positions", torch.float32, (Mpad, 3))
    chk(ctx.idx16, "idx16", torch.int16, (Mpad, 12))
    chk(ctx.aux, "aux", torch.bfloat16, (Mpad, STAGE))
    chk(ctx.inv_axes, "inv_axes", torch.float32, (3, 3, 3))
    _check_chain_bf16(cw)
    rows = torch.empty((NROWS, Mpad), dtype=torch.float32, device=vol.device)
    scale_rows = slab_scale_rows(scales)   # held until the launch is queued
    ptrs = [t.data_ptr() for t in (vol, scale_rows, ctx.positions, ctx.idx16, ctx.aux,
                                   ctx.inv_axes)]
    ptrs += _chain_ptrs(cw, _cam_consts(cam, vol.device)) + [rows.data_ptr()]
    code = lib.ggd_slab_decode(*ptrs, Mpad, D, H, W, DZ, YP, XPC // C, ctx.box_warp,
                               cw.scale_offset, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "slab_decode_kernel")
    decode_project_slab.launches += 1
    return rows


decode_project_slab.launches = 0


# ---------------------------------------------------------------------------
# training chain, f32: K6 forward (csrc/heads_train.cu)
# ---------------------------------------------------------------------------
# Kernel K6, csrc/heads_train.cu::heads_fwd_kernel, replaces the TPU kernel
# decoder/pallas_heads.py::decode_heads_pallas (_heads_kernel) in f32. What
# bounds it on the H100: operations, ~5.1e5 FLOPs per point, whose least
# time at f32 accuracy is 3xTF32 on the tensor cores (each f32 operand split
# into TF32 high and low parts, three mma.sync products): 1.16 ms for the
# train step's 500,000 points, against 2.86 ms as f32 FMAs on the CUDA
# cores, where K6 ran before (64-point blocks, 16 KB of weights a point from
# L2, activations through shared memory). Its design: one block of 8 warps
# per 128 points, each warp keeping its 16
# points' activations in registers through all 20 layers (the accumulator
# fragment of a layer is the next layer's A fragment), the staging in shared
# memory, the weights split into TF32 (hi, lo) pairs once per call and
# streamed by cp.async into a two-slot ring, half a layer a slot, while the
# stage before computes (12.5 KB a point from L2); layer 1 skips w1's zero
# rows past each head's staging prefix. A ragged last block is masked.

def build_staging_f32(feats_mean, cond0, init_position):
    """(M, 128) f32 staging of the training chain (the JAX package's
    _build_staging): features [0:32), conditioning [32:32+P), zeros for the
    chain columns, init_position at [120:123). Differentiable."""
    M, P = cond0.shape
    dev = feats_mean.device
    return torch.cat([
        feats_mean.float(), cond0.float(),
        torch.zeros((M, INIT_COL - 32 - P), dtype=torch.float32, device=dev),
        init_position.float(),
        torch.zeros((M, STAGE - INIT_COL - 3), dtype=torch.float32, device=dev),
    ], dim=1)


def _transform(o, name, cw: ChainWeights, init):
    if name == "scale":
        return -softplus(o + 5.0) + cw.scale_offset
    if name == "xyz":
        return o * 0.01 + init
    return o


def decode_heads_plain(staging, cw: ChainWeights):
    """Plain PyTorch version of K6: the f32 chain over a (M, 128) staging ->
    (M, 16) packed transformed head outputs. Written without in-place
    updates, so torch autograd differentiates it too."""
    x = staging
    cols = [None] * OUT_W
    init = staging[:, INIT_COL:INIT_COL + 3]
    gelu = GELUS[cw.gelu]
    for h, (name, od, sc, oc) in enumerate(cw.chain):
        a = gelu(x @ cw.w1[h] + cw.b1[h])
        a = gelu(a @ cw.w2[h] + cw.b2[h])
        a = gelu(a @ cw.w3[h] + cw.b3[h])
        o = _transform((a @ cw.w4[h] + cw.b4[h])[:, :od], name, cw, init[:, :od])
        if sc + od <= STAGE:
            x = torch.cat([x[:, :sc], o, x[:, sc + od:]], dim=1)
        for j in range(od):
            cols[oc + j] = o[:, j]
    zero = torch.zeros_like(staging[:, 0])
    return torch.stack([zero if c is None else c for c in cols], dim=1)


def check_chain_f32(cw: ChainWeights):
    H_ = cw.w1.shape[0]
    chk = kernel_lib.check
    for name in ("w1", "w2", "w3"):
        chk(getattr(cw, name), name, torch.float32, (H_, STAGE, STAGE))
    chk(cw.w4, "w4", torch.float32, (H_, STAGE, OUT_W))
    for name in ("b1", "b2", "b3"):
        chk(getattr(cw, name), name, torch.float32, (H_, STAGE))
    chk(cw.b4, "b4", torch.float32, (H_, OUT_W))
    chk(cw.meta, "meta", torch.int32, (32,))


def decode_heads(staging: torch.Tensor, cw: ChainWeights) -> torch.Tensor:
    """The f32 training chain -> (Mpad, 16) packed transformed outputs.
    staging (Mpad, 128) f32, Mpad > 0; cw from pack_chain_f32. CPU tensors
    take the plain version, CUDA tensors kernel K6 (after a small kernel
    that splits w1..w3 into TF32 (hi, lo) pairs, 2 MB of scratch)."""
    if not kernel_lib.use_kernel(staging, cw.w1):
        return decode_heads_plain(staging, cw)
    lib = kernel_lib.library()
    Mpad = staging.shape[0]
    if Mpad <= 0:
        raise ValueError(f"Mpad {Mpad}: no points")
    kernel_lib.check(staging, "staging", torch.float32, (Mpad, STAGE))
    check_chain_f32(cw)
    H_ = cw.w1.shape[0]
    out = torch.empty((Mpad, OUT_W), dtype=torch.float32, device=staging.device)
    wsplit = torch.empty((H_, 3, STAGE, STAGE, 2), dtype=torch.float32, device=staging.device)
    code = lib.ggd_heads_fwd(
        staging.data_ptr(), *[getattr(cw, n).data_ptr() for n in
                              ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")],
        cw.meta.data_ptr(), out.data_ptr(), wsplit.data_ptr(), Mpad, H_, _GELU_IDS[cw.gelu],
        cw.scale_offset, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "heads_fwd_kernel")
    decode_heads.launches += 1
    return out


decode_heads.launches = 0
