"""The differentiable f32 head chain of the training step — port of
decoder/pallas_heads_vjp.py.

Kernel K7, csrc/heads_train.cu::heads_bwd_kernel (+ heads_grad_reduce),
replaces the TPU kernel decoder/pallas_heads_vjp.py::_run_bwd
(_heads_bwd_kernel). What bounds it on the H100: operations, about three
times K6's 5.12e5 FLOPs per point (the recompute, the data gradient and
the weight gradient of every layer), which it runs on the tensor cores in
3xTF32 (f32 operands split into TF32 high and low parts, about f32
accuracy). Its design: the TPU kernel keeps 5 residual sets per head
(25 x block x 128 f32), which no Hopper block holds. K7 reads K6's packed
outputs instead: the staging before head h is the input staging plus the
outputs of heads < h, so each head's hidden layers are recomputed during
its reverse step. BWD_BLOCKS blocks walk 64-point tiles, heads outer (a
ragged last tile is masked); weight and bias gradients go to the block's
own partial slice and a second kernel sums the slices in a fixed order, so
the result is the same run to run.

decode_heads_pallas_diff is a torch.autograd.Function: forward K6 (or its
plain version on the CPU), backward K7 (or decode_heads_bwd_plain).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .. import kernel_lib
from .pallas_heads import (
    GELUS, INIT_COL, OUT_W, STAGE, ChainWeights, _erf,
    build_staging_f32, check_chain, decode_heads, pack_chain_f32)

BWD_TILE = 64          # K7 points per tile; a ragged last tile is masked in the kernel
BWD_BLOCKS = 132       # K7 blocks = weight-gradient partial slices (fixed: deterministic)
_HEAD_GRAD = 3 * (STAGE * STAGE + STAGE) + STAGE * OUT_W + OUT_W   # floats per head


def gelu_exact_grad(x):
    """d gelu / dx of the exact GELU on the package's A&S erf, the only GELU
    the training chain differentiates (the JAX CLI trains with it)."""
    cdf = 0.5 * (1.0 + _erf(x * (2.0 ** -0.5)))
    return cdf + x * 0.3989422804014327 * torch.exp(-0.5 * x * x)


def _check_exact(cw: ChainWeights):
    if cw.gelu != "exact":
        raise ValueError(f"gelu {cw.gelu!r}: the training chain differentiates the exact "
                         "GELU only")


def decode_heads_bwd_plain(staging, out16, dout, cw: ChainWeights):
    """Plain PyTorch version of K7: the reverse of the f32 chain ->
    (dstage (M, 128), (dw1, db1, dw2, db2, dw3, db3, dw4, db4)) with the
    weight gradients in ChainWeights' packed shapes."""
    _check_exact(cw)
    act, dact = GELUS[cw.gelu], gelu_exact_grad
    M = staging.shape[0]
    dx = torch.zeros_like(staging)
    grads = [torch.zeros_like(getattr(cw, n)) for n in
             ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")]
    dw1, db1, dw2, db2, dw3, db3, dw4, db4 = grads
    for h in range(len(cw.chain) - 1, -1, -1):
        name, od, sc, oc = cw.chain[h]
        x = staging.clone()                  # the staging before head h
        for nj, odj, scj, ocj in cw.chain[:h]:
            if scj + odj <= STAGE:
                x[:, scj:scj + odj] = out16[:, ocj:ocj + odj]
        z1 = x @ cw.w1[h] + cw.b1[h]
        a1 = act(z1)
        z2 = a1 @ cw.w2[h] + cw.b2[h]
        a2 = act(z2)
        z3 = a2 @ cw.w3[h] + cw.b3[h]
        a3 = act(z3)
        o_raw = a3 @ cw.w4[h] + cw.b4[h]
        dT = torch.zeros((M, OUT_W), dtype=torch.float32, device=staging.device)
        dT[:, :od] = dout[:, oc:oc + od]
        if sc + od <= STAGE:
            dT[:, :od] += dx[:, sc:sc + od]
            dx[:, sc:sc + od] = 0.0
        if name == "scale":
            dO = -torch.sigmoid(o_raw + 5.0) * dT
        elif name == "xyz":
            dO = dT * 0.01
            dx[:, INIT_COL:INIT_COL + 3] += dT[:, :3]
        else:
            dO = dT
        dw4[h] += a3.t() @ dO
        db4[h] += dO.sum(0)
        dz3 = (dO @ cw.w4[h].t()) * dact(z3)
        dw3[h] += a2.t() @ dz3
        db3[h] += dz3.sum(0)
        dz2 = (dz3 @ cw.w3[h].t()) * dact(z2)
        dw2[h] += a1.t() @ dz2
        db2[h] += dz2.sum(0)
        dz1 = (dz2 @ cw.w2[h].t()) * dact(z1)
        dw1[h] += x.t() @ dz1
        db1[h] += dz1.sum(0)
        dx += dz1 @ cw.w1[h].t()
    return dx, tuple(grads)


def decode_heads_bwd(staging: torch.Tensor, out16: torch.Tensor, dout: torch.Tensor,
                     cw: ChainWeights):
    """Reverse of the f32 chain: staging (Mpad, 128), K6's out16 and its
    cotangent dout (Mpad, 16) -> (dstage, weight gradients). CPU tensors
    take the plain version, CUDA tensors kernel K7."""
    if not kernel_lib.use_kernel(staging, out16, dout, cw.w1):
        return decode_heads_bwd_plain(staging, out16, dout, cw)
    lib = kernel_lib.library()
    _check_exact(cw)
    Mpad = staging.shape[0]
    if Mpad <= 0:
        raise ValueError(f"Mpad {Mpad}: no points")
    chk = kernel_lib.check
    chk(staging, "staging", torch.float32, (Mpad, STAGE))
    chk(out16, "out16", torch.float32, (Mpad, OUT_W))
    chk(dout, "dout", torch.float32, (Mpad, OUT_W))
    check_chain(cw, torch.float32)
    dev = staging.device
    n_part = min(BWD_BLOCKS, -(-Mpad // BWD_TILE))
    dstage = torch.empty_like(staging)
    partials = torch.zeros((n_part, 5 * _HEAD_GRAD), dtype=torch.float32, device=dev)
    flat = torch.empty((5, _HEAD_GRAD), dtype=torch.float32, device=dev)
    code = lib.ggd_heads_bwd(
        staging.data_ptr(), out16.data_ptr(), dout.data_ptr(),
        *[getattr(cw, n).data_ptr() for n in ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")],
        cw.meta.data_ptr(), dstage.data_ptr(), partials.data_ptr(), flat.data_ptr(), Mpad,
        n_part, cw.scale_offset, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "heads_bwd_kernel")
    decode_heads_bwd.launches += 1
    H_ = cw.w1.shape[0]
    sizes = [STAGE * STAGE, STAGE] * 3 + [STAGE * OUT_W, OUT_W]
    parts = torch.split(flat[:H_], sizes, dim=1)
    shapes = [(STAGE, STAGE), (STAGE,)] * 3 + [(STAGE, OUT_W), (OUT_W,)]
    return dstage, tuple(p.reshape(H_, *s) for p, s in zip(parts, shapes))


decode_heads_bwd.launches = 0


class _HeadsChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, staging, w1, b1, w2, b2, w3, b3, w4, b4, spec):
        cw = ChainWeights(w1, b1, w2, b2, w3, b3, w4, b4, *spec)
        st = staging.contiguous()
        out = decode_heads(st, cw)
        ctx.save_for_backward(st, out, w1, b1, w2, b2, w3, b3, w4, b4)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, dout):
        st, out, *ws = ctx.saved_tensors
        cw = ChainWeights(*ws, *ctx.spec)
        dstage, grads = decode_heads_bwd(st, out, dout.float().contiguous(), cw)
        return (dstage, *grads, None)


def decode_heads_pallas_diff(heads: Dict[str, torch.nn.Module],
                             chain_spec: Sequence[Tuple[str, int]],
                             feats_mean: torch.Tensor, cond0: torch.Tensor,
                             init_position: torch.Tensor, scale_offset: float,
                             gelu: str = "exact", parallel: bool = False) -> torch.Tensor:
    """Differentiable fused head chain -> (M, 16) packed TRANSFORMED outputs
    (columns as ChainWeights.layout). Gradients reach the heads' parameters,
    feats_mean, cond0 and init_position. parallel: the ParallelDecoder's
    chain (pack_chain_f32), whose heads read no earlier head's output."""
    cw = pack_chain_f32(heads, chain_spec, cond0.shape[1], scale_offset, gelu, parallel)
    staging = build_staging_f32(feats_mean, cond0, init_position)
    spec = (cw.chain, cw.layout, cw.meta, cw.scale_offset, cw.gelu, cw.n_in)
    return _HeadsChain.apply(staging, cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4,
                             cw.b4, spec)
