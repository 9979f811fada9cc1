"""Tri-grid corner-brick table build — port of neuralfield/pallas_expand.py.

The brick table pre-expands the (B, C, D, H, W) tri-grid volume so that one
row holds a 2x2x2 neighbourhood's channels: each sample point then reads one
row per plane (neuralfield/renderer.py::_trilinear_sample_table).

Kernel K10, csrc/brick_table.cu::brick_table_kernel, replaces the TPU kernel
neuralfield/pallas_expand.py::build_brick_table (_expand_kernel). The TPU
kernel streams y-blocks of the padded volume through VMEM with
double-buffered DMAs and writes the 8 corner groups as lane rotations; the
H100 needs none of that. It is a byte copy: the wrapper transposes the
volume to channels-last and zero-pads it in plain PyTorch (as the JAX
wrapper does in XLA), and the kernel writes every output row as 8 copies of
C * itemsize contiguous bytes, one thread per 16-byte chunk, so one kernel
serves int8, bf16 and f32. What bounds it on the H100: bytes, the table
written once (214.7 MB at flagship in int8) and the volume read once.

Output contract (the JAX function's): a table (B, (D+1) * NY * (W+1), 8C)
in the input dtype and NY, with NY = roundup(H+1, 16) for 1- and 2-byte
inputs and roundup(H+1, 8) for 4-byte ones. Row (z0 * NY + y0) * (W+1) + x0
holds the 8 corners in (dz, dy, dx) order. Rows with y0 > H are zeros here;
in the JAX package they hold garbage (the sampler never indexes them).

The select form, csrc/brick_table.cu::brick_table_kernel<true>, replaces
the TPU kernel's second body, _expand_kernel_select (build_brick_table(...,
select=True)): its source is the channels-last volume tiled to 128
elements a voxel (128 / C copies of the C channels, the JAX wrapper's
jnp.tile), and corner group g reads its channels at element (g mod 128 / C)
* C of the duplicated row, where the TPU kernel's masked selects find them.
It builds the same table byte for byte. As in JAX, select takes the
duplicated source only where 128 % C == 0 and 8C % 128 == 0, and the
rotate form otherwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernel_lib

YB = 16   # y alignment of NY for 1- and 2-byte bricks (8 for 4-byte)
LANE = 128  # elements a duplicated source row (the TPU's lane width)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def table_rows_ny(H: int, itemsize: int) -> int:
    """NY, the y extent of the table's rows (the gather's row stride)."""
    return _round_up(H + 1, YB if itemsize < 4 else YB // 2)


def padded_channels_last(feats: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, D+2, H+2, W+2, C) contiguous, one zero voxel on
    each side of every spatial axis (the padded-index contract of the corner
    weights: padded index = clip(x0 + 1, 0, size))."""
    return F.pad(feats.permute(0, 2, 3, 4, 1), (0, 0, 1, 1, 1, 1, 1, 1)).contiguous()


def concat_corners(fp: torch.Tensor) -> torch.Tensor:
    """The XLA formulation (renderer.py::_trilinear_table's 8-slice concat):
    padded channels-last (B, D+2, H+2, W+2, C) -> (B, D+1, H+1, W+1, 8C),
    one torch.cat of the 8 shifted views."""
    B, D2, H2, W2, C = fp.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    return torch.cat([fp[:, dz:dz + D + 1, dy:dy + H + 1, dx:dx + W + 1]
                      for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)], dim=-1)


def brick_table_plain(fp: torch.Tensor, NY: int) -> torch.Tensor:
    """Plain PyTorch version of K10: padded channels-last volume -> table
    (B, (D+1) * NY * (W+1), 8C), rows y0 > H zero."""
    B, D2, H2, W2, C = fp.shape
    e = concat_corners(fp)                                     # (B, D+1, H+1, W+1, 8C)
    e = F.pad(e, (0, 0, 0, 0, 0, NY - (H2 - 1)))               # y rows H+1..NY-1 zero
    return e.reshape(B, (D2 - 1) * NY * (W2 - 1), 8 * C)


def brick_table(fp: torch.Tensor, NY: int) -> torch.Tensor:
    """Padded channels-last volume (B, D+2, H+2, W+2, C) -> table (B,
    (D+1) * NY * (W+1), 8C). CPU tensors take the plain version, CUDA
    tensors K10 (C * itemsize a multiple of 16)."""
    if not kernel_lib.use_kernel(fp):
        return brick_table_plain(fp, NY)
    B, D2, H2, W2, C = fp.shape
    itemsize = fp.element_size()
    if (C * itemsize) % 16:
        raise ValueError(f"C * itemsize = {C * itemsize}: K10 copies 16-byte chunks")
    if NY < H2 - 1:
        raise ValueError(f"NY {NY} < H + 1 = {H2 - 1}")
    lib = kernel_lib.library()
    kernel_lib.check(fp, "padded volume", fp.dtype)
    out = torch.empty((B, (D2 - 1) * NY * (W2 - 1), 8 * C), dtype=fp.dtype, device=fp.device)
    code = lib.ggd_brick_table(fp.data_ptr(), out.data_ptr(), B, D2 - 2, H2 - 2, W2 - 2, NY,
                               C * itemsize // 16, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "brick_table_kernel")
    brick_table.launches += 1
    return out


brick_table.launches = 0


def select_applies(C: int) -> bool:
    """Whether select=True takes the duplicated source for C channels (the
    JAX build_brick_table's condition; the rotate form otherwise)."""
    return LANE % C == 0 and (8 * C) % LANE == 0


def duplicated_channels_last(feats: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> the select form's source (B, D+2, H+2, W+2, 128):
    padded_channels_last with each voxel's C channels tiled 128 / C times."""
    return padded_channels_last(feats).repeat(1, 1, 1, 1, LANE // feats.shape[1])


def brick_table_select_plain(fpd: torch.Tensor, NY: int, C: int) -> torch.Tensor:
    """Plain PyTorch version of K10's select form: the duplicated source
    (B, D+2, H+2, W+2, 128) -> table, corner group g from elements (g mod
    128 / C) * C of the shifted view."""
    B, D2, H2, W2, _ = fpd.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    gpt = LANE // C
    e = torch.cat([fpd[:, dz:dz + D + 1, dy:dy + H + 1, dx:dx + W + 1,
                       (g % gpt) * C:(g % gpt + 1) * C]
                   for g, (dz, dy, dx) in enumerate((dz, dy, dx) for dz in (0, 1)
                                                    for dy in (0, 1) for dx in (0, 1))],
                  dim=-1)
    e = F.pad(e, (0, 0, 0, 0, 0, NY - (H + 1)))
    return e.reshape(B, (D + 1) * NY * (W + 1), 8 * C)


def brick_table_select(fpd: torch.Tensor, NY: int, C: int) -> torch.Tensor:
    """K10's select form: the duplicated source (duplicated_channels_last)
    -> the table (B, (D+1) * NY * (W+1), 8C), byte for byte brick_table's.
    CPU tensors take the plain version, CUDA tensors the kernel (counted in
    brick_table_select.launches)."""
    if not select_applies(C) or fpd.shape[-1] != LANE:
        raise ValueError(f"select form: C {C} must divide {LANE} with 8C a multiple of it, "
                         f"the source {LANE} elements a voxel (got {fpd.shape[-1]})")
    if not kernel_lib.use_kernel(fpd):
        return brick_table_select_plain(fpd, NY, C)
    B, D2, H2, W2, _ = fpd.shape
    itemsize = fpd.element_size()
    if (C * itemsize) % 16:
        raise ValueError(f"C * itemsize = {C * itemsize}: K10 copies 16-byte chunks")
    if NY < H2 - 1:
        raise ValueError(f"NY {NY} < H + 1 = {H2 - 1}")
    lib = kernel_lib.library()
    kernel_lib.check(fpd, "duplicated volume", fpd.dtype)
    out = torch.empty((B, (D2 - 1) * NY * (W2 - 1), 8 * C), dtype=fpd.dtype, device=fpd.device)
    code = lib.ggd_brick_table_select(fpd.data_ptr(), out.data_ptr(), B, D2 - 2, H2 - 2, W2 - 2,
                                      NY, C * itemsize // 16, LANE // C, kernel_lib.stream())
    kernel_lib.raise_on_error(code, "brick_table_kernel<select>")
    brick_table_select.launches += 1
    return out


brick_table_select.launches = 0


def build_brick_table(feats: torch.Tensor, select: bool = False):
    """(B, C, D, H, W) volume -> (table (B, (D+1) * NY * (W+1), 8C), NY) in
    feats' dtype: the transpose and zero pad (with select, where
    select_applies, also the channel tile) in plain PyTorch, then
    brick_table or brick_table_select (K10's forms on the card)."""
    NY = table_rows_ny(feats.shape[3], feats.element_size())
    C = feats.shape[1]
    if select and select_applies(C):
        return brick_table_select(duplicated_channels_last(feats), NY, C), NY
    return brick_table(padded_channels_last(feats), NY), NY
