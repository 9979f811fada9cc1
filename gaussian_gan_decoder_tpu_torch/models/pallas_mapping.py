"""Fused mapping-network kernel (inference fast path) — port of
models/pallas_mapping.py.

Kernel K1, csrc/mapping.cu::mapping_kernel, replaces the TPU kernel
models/pallas_mapping.py::mapping_forward_pallas (`_mapping_kernel`).
What bounds it on the H100: at batch <= 8 the chain is 8 dependent 512-wide
layers, ~4 MFLOP a row, and its bf16 weights are 4.7 MB (1.4 us at the HBM
rate): the latency of the dependent layers, not FLOPs or bytes. Its design:
ONE cooperative launch of up to one block per SM (128 blocks at width 512)
runs the whole chain (normalize, c embed, 8 FC + lrelu, truncation lerp).
Each block owns W / nblk output columns of every layer and copies all of
its weight columns into shared memory by cp.async at its start, so the
weights arrive at once across the card; every block computes the two norms
itself; the B x W activations pass from layer to layer through L2 with a
grid barrier a layer. Before, one block on one SM walked the chain with
K dependent 2-byte weight loads per column (1.76 ms on the H100).

Numerics (both the kernel and mapping_forward_plain): bf16 weights with the
lr_mult/gain folded in once on the host (fold_mapping), activations rounded
to bf16 before every product — the TPU kernel's policy. Every sum (the
layers' and the embed's dot products, the norms' sums of squares) is taken
in float64 and rounded once to f32 where the TPU kernel holds an f32; a
product of two bf16 values (or an f32 squared) is exact in float64, so the
result does not depend on the order of the sum, and kernel and plain
version agree to the last bit or nearly, at any width and camera. Each
norm's factor is 1 / sqrt in float64 rounded to f32. Bias, lrelu, the bf16
roundings and the truncation lerp are f32 operations in the same order on
both sides. The kernel sums each column over K in a fixed order: the same
bits from run to run.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import kernel_lib

MAX_BATCH = 8


class FoldedMapping(NamedTuple):
    """Mapping weights prepared for the kernel: (in, out) layout, bf16,
    lr_mult and 1/sqrt(fan_in) folded in."""
    we: Optional[torch.Tensor]   # (c_dim, W) bf16, None when c_dim == 0
    be: Optional[torch.Tensor]   # (W,) f32
    w0: torch.Tensor             # (z_dim + embed, W) bf16
    b0: torch.Tensor             # (W,) f32
    wr: torch.Tensor             # (L-1, W, W) bf16
    br: torch.Tensor             # (L-1, W) f32
    w_avg: torch.Tensor          # (W,) f32
    num_ws: int


@torch.no_grad()
def fold_mapping(mn) -> FoldedMapping:
    """MappingNetwork module -> FoldedMapping. Call once per weight set, not
    per frame. Requires lrelu throughout, a w_avg buffer and num_ws."""
    if mn.activation != "lrelu" or mn.last_activation or mn.num_ws is None:
        raise ValueError("the fused mapping needs lrelu layers, no last_activation and num_ws")
    lg = mn.lr_multiplier

    def fold(fc):
        w = (fc.weight.float() * (lg / math.sqrt(fc.in_features))).t()
        return w.to(torch.bfloat16).contiguous(), (fc.bias.float() * lg).contiguous()

    we = be = None
    if mn.c_dim > 0:
        # the embed layer has lr_mult 1
        we = (mn.embed.weight.float() / math.sqrt(mn.c_dim)).t().to(torch.bfloat16).contiguous()
        be = mn.embed.bias.detach().float().clone()
    w0, b0 = fold(mn.fc0)
    rest = [fold(getattr(mn, f"fc{i}")) for i in range(1, mn.num_layers)]
    return FoldedMapping(
        we=we, be=be, w0=w0, b0=b0,
        wr=torch.stack([w for w, _ in rest]).contiguous(),
        br=torch.stack([b for _, b in rest]).contiguous(),
        w_avg=mn.w_avg.detach().float().clone(), num_ws=mn.num_ws)


def _bf16r(x):
    return x.to(torch.bfloat16).float()


def _lrelu(v):
    return (v.clamp(min=0) + 0.2 * v.clamp(max=0)) * math.sqrt(2.0)


def _dot64(x, w):
    """bf16(x) @ w summed in float64 (each product exact), rounded to f32."""
    return (_bf16r(x).double() @ w.double()).float()


def _norm(x, eps=1e-8):
    """x * 1/sqrt(mean(x^2) + eps): the sum of squares in float64 rounded to
    f32, the mean and eps in f32, 1/sqrt in float64 rounded to f32."""
    ss = (x.double() ** 2).sum(dim=1, keepdim=True).float()
    return x * (1.0 / torch.sqrt((ss / x.shape[1] + eps).double())).float()


def mapping_forward_plain(z, c, fm: FoldedMapping, truncation_psi=1.0):
    """Plain PyTorch version of K1 -> (B, W) f32 (before the num_ws repeat)."""
    x = _norm(z.float())
    if fm.we is not None:
        y = _dot64(c.float(), fm.we) + fm.be
        x = torch.cat([x, _norm(y)], dim=1)
    x = _lrelu(_dot64(x, fm.w0) + fm.b0)
    for k in range(fm.wr.shape[0]):
        x = _lrelu(_dot64(x, fm.wr[k]) + fm.br[k])
    return fm.w_avg + (x - fm.w_avg) * truncation_psi


def mapping_forward(z: torch.Tensor, c: Optional[torch.Tensor], fm: FoldedMapping,
                    truncation_psi: float = 1.0) -> torch.Tensor:
    """Fused mapping -> ws (B, num_ws, W). z (B, z_dim) with B <= 8; c
    (B, c_dim) or None when the mapping has no embed. CPU tensors take the
    plain version, CUDA tensors the kernel."""
    B = z.shape[0]
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} > {MAX_BATCH}")
    if not kernel_lib.use_kernel(z, fm.w0):
        ws = mapping_forward_plain(z, c, fm, truncation_psi)
    else:
        lib = kernel_lib.library()
        W = fm.w0.shape[1]
        Z = z.shape[1]
        Cd = 0 if fm.we is None else fm.we.shape[0]
        n_rest = fm.wr.shape[0]
        kernel_lib.check(z, "z", torch.float32)
        kernel_lib.check(fm.w0, "w0", torch.bfloat16, (Z + (W if Cd else 0), W))
        kernel_lib.check(fm.wr, "wr", torch.bfloat16, (n_rest, W, W))
        kernel_lib.check(fm.b0, "b0", torch.float32, (W,))
        kernel_lib.check(fm.br, "br", torch.float32, (n_rest, W))
        kernel_lib.check(fm.w_avg, "w_avg", torch.float32, (W,))
        if Cd:
            kernel_lib.check(c, "c", torch.float32, (B, Cd))
            kernel_lib.check(fm.we, "we", torch.bfloat16, (Cd, W))
            kernel_lib.check(fm.be, "be", torch.float32, (W,))
            cp, wep, bep = c.data_ptr(), fm.we.data_ptr(), fm.be.data_ptr()
        else:
            cp = wep = bep = None
        ws = torch.empty((B, W), dtype=torch.float32, device=z.device)
        act = torch.empty((2, B, W), dtype=torch.float32, device=z.device)
        code = lib.ggd_mapping_forward(
            z.data_ptr(), cp, wep, bep, *(t.data_ptr() for t in (fm.w0, fm.b0, fm.wr, fm.br,
                                                                 fm.w_avg)),
            float(truncation_psi), ws.data_ptr(), act.data_ptr(), B, Z, Cd, W, n_rest,
            kernel_lib.stream())
        kernel_lib.raise_on_error(code, "mapping_kernel")
        mapping_forward.launches += 1
    return ws[:, None, :].expand(B, fm.num_ws, ws.shape[1])


mapping_forward.launches = 0
