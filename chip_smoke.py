#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--dump FILE]

Builds the port's CUDA kernels from gaussian_gan_decoder_tpu_torch/csrc/
(nvcc, sm_90a, into gaussian_gan_decoder_tpu_torch/_build/), then:

  1. requires TF32 HMMA in K6's SASS and LDS.128 in K3's (cuobjdump -sass
     of the built library; every kernel's HMMA, SHFL, LDS.128 and local
     load / store counts are printed, and each f32 decode kernel's
     registers, stack and spills), then checks each kernel against its
     plain PyTorch version on the card, at the flagship frame's own
     shapes, and times both; K1 at
     batch 1 and at the stream's batch 4 with a random camera; K1 and K3-K5
     timed by CUDA events around calls queued behind a device sleep (their
     device time, not the wrappers' host time); the training blend kernels
     (K4, K5) are held on the
     frame's pairs too, and on those pairs widened and made more opaque
     until pixels saturate (K4's chunk entries against the plain forward's
     cumulative product, K4 and K5 each launched twice: the same bits); each
     pair set's per-tile pair statistics, and the share of (pixel, chunk)
     entries whose chunk K4's scan replayed pair by pair, are printed;
  2. drives the port's main path — flagship.decode_and_render on the slab
     route of the PanoHead flagship (z/w 512, 256^2 tri-grid of depth 3,
     500k seeded template Gaussians, 512^2 frame, seeded random weights,
     "poly6" GELU) — for one
     warm-up frame and FRAMES timed frames from distinct latents, with the
     kernels' launch counters set to 0 first; checks every frame (finite,
     not constant, visible Gaussians and pairs, no dropped pair), that every
     kernel launched at least once per frame, and the first frame against
     the same frame computed with the plain versions;
  3. runs FRAMES more frames under torch.profiler for the device busy share
     and the largest kernels;
  4. the brick route (no slab context), on the same decoder weights, planes,
     template and camera: the brick-table build (K10) on the frame's int8
     tri-grid, bit-exact against its plain version and timed beside it and
     beside torch.cat of the 8 shifted views; the decode K8 on the gathered,
     plane-meaned staging and the gather-fused decode K9 on
     sample_fused_inputs, each held to K2's checks; the cross-route witness
     (the same planes and GELU decoded on both routes, in template order,
     at limits derived from both routes' stagings' sound references, with
     a 6-bit control that must fail them: hold_cross_route); 1 + FRAMES
     frames on the table route (K10 + K8) and on the fused route (K10 + K9)
     with the JAX flagship's "poly" GELU,
     counters at 0 first, each first frame against an all-plain brick frame,
     then FRAMES more frames of each route under torch.profiler; then
     decode_and_render_stream over STREAM latents at STREAM_BATCH per
     backbone batch, each frame against decode_and_render;
  5. drives the training path — the distillation step of
     apps/train_decoder.py as `--random_init` builds it (flagship generator
     and a trainable copy, exact-GELU heads, 500k surface points from a 128^3
     sigma grid, 512^2 target and render, random VGG16 LPIPS, Adam) — for one
     warm-up step and TRAIN_STEPS timed steps, with the launch counters set
     to 0 first; checks finite losses, that the heads and the G copy moved
     after the first step and that each training kernel launched in every
     step; then holds the training kernels against their plain versions on
     the inputs and cotangents the warm-up step gave them, times both, and
     profiles one more step for the device busy share;
  5b. the snapshot phase, on the same trainer and state: checkpoint.save
     of the train state, one more step, checkpoint.restore (every decoder
     tensor, Adam moment and the step bit-identical to what was saved; the
     same step from the restored state within 1e-6 of its loss);
     save_decoder / load_decoder (decoder and frozen generator
     bit-identical; write and read times and bytes); the ID term with a
     seeded random IR-SE50 (non-zero and in Loss/total on a frontal draw,
     0 on another; that step's time beside the plain step's); run_eval
     for 4 steps at full width with the VGG16 and the IR-SE50 (six finite
     Metrics10k, K3 and K6 launched at least 4 times each); and
     render_with_decoder on the loaded snapshot (backend 'pallas', K3, a
     finite 512^2 image) with save_ply of its 500k Gaussians, read back
     bit for bit by load_ply_arrays (file size and write time);
  5c. the EG3D phase: the EG3D tri-plane generator at full width
     (flagship_generator("eg3d"), depth-1 256^2 planes, SR to 512^2, the
     same template and camera, a black background): K2's bilinear form and
     K9's tri-plane form against their plain versions and timed, each one's
     rows bit-identical to K8's on the staging of its plain version's
     features; 1 + EG3D_FRAMES frames on each of the slab, table and fused
     routes (each counted kernel launched in every frame, the first frame
     against the route's all-plain frame), FRAMES more of each under
     torch.profiler; and apps/train_decoder.py --generator_arch eg3d_ffhq
     --random_init for 1 + EG3D_TRAIN_STEPS steps and one profiled step;
     the f32 forms of K2's bilinear and K9's tri-plane forms against their
     plain versions, timed beside their bounds, and 1 + 1 frames of each
     ('bcast') on an f32 chain of the same heads;
  5d. the decoder-options phase (decoder_options_phase): on the flagship
     generator, D-par (parallel heads, the xyz embedding, f32 heads, exact
     GELU) and D-seq (sequential heads: the real camera at the mapping;
     bf16, "poly"): each route's decode kernel against its plain version
     (the f32 forms of K2, K8, K9 for D-par; the bf16 forms on the
     sequential chain for D-seq), 1 + OPT_FRAMES frames on the slab, table
     and fused routes with each form's own launch counter, each first frame
     against the route's all-plain frame, FRAMES profiled frames; D-seq's K1
     on the real camera bit for bit; apply_packed with K6's bf16 form (the
     flagship decoder, its heads seeded, held at limits derived from the
     staging's sound references with a 6-bit control: hold_heads_gap) and
     K6 (D-par) against their plain versions; and
     apps/train_decoder.py --random_init with --decoder_type parallel
     --use_pos_encoding and with --decoder_type sequential, 1 +
     OPT_TRAIN_STEPS steps and one profiled step each;
  5e. the frame-options phase (frame_options_phase): slab frames in every
     K3 payload form, packed_v3 (the default, flagship_raster_config())
     and f32 timed and profiled, each first frame against its all-plain
     frame; every K3 form on one frame's binned pairs against its plain
     version, timed; K9's 'dots' lerp (dots_route) on the flagship, EG3D
     and D-par fused routes against its plain version, the bf16 forms
     bit for bit K8's on the plain 'dots' features and their gap to the
     plain version held by hold_chain_gap (limits from the staging's two
     sound references; a 6-bit control must fail them); K10's select form
     byte for byte K10's table, timed beside K10's sources and torch.cat,
     and table-route frames with pallas_sampling "select";
  5f. the trainer-options phase (trainer_options_phase): on the flagship
     trainer of phase 5, built from the CLI's flags, on the same draws:
     --int8_probe --pallas_probe_build --no-sigma_separable for 1 + 2 steps
     (K10 builds the frozen target's probe table in every step, byte for
     byte its plain version's, timed; the int8 and f32 targets by PSNR; the
     gather sigma grid of the f32 table against the separable grid at the
     CPU test's limit; K10 at bf16 and f32 too; the target's parts timed
     with and without the table), 1 + 1 steps each with --bf16_probe,
     --no-mt_two_stage, --no-use_marching_cubes and --bf16_lpips (single-
     and two-stage face counts; the voxels over sigma 10), 1 + 1
     --batch_views 2 steps (the first one's loss the mean of its two
     single-view losses), 1 + 1 --raster_backend xla steps (JAX's
     RasterizeConfig; n_dropped, the loss beside the pallas_diff loss; no
     K4 launch), each with its device time, stage split and peak memory;
     then
     apps/render_decoder.py with --backend xla and --backend pallas on a
     snapshot (PSNR printed at 500k points, held at >= 50 dB on 200k with
     tile_capacity 2176);
  5g. the generation phase (generation_phase): the PanoHead flagship
     generator at full width, TriPlaneGenerator.apply at batch 1 (checked,
     timed, and held against the same call on the CPU: image by PSNR,
     image_raw by max abs), gen_shapes' path at 128^3, apps/gen_videos.py's
     frame on a reloaded flagship decoder snapshot with pallas_mapping (1 +
     2 frames with --backend pallas, K1, K3, K6's bf16 form and K10 in every
     frame, the first frame against the same frame with the plain versions
     of K1, K6 and K3 on 200k points at >= 50 dB, one --backend xla frame),
     gen_interpolation's grid and
     gen_videos_proj from a --finetuned checkpoint;
  5h. the classic 3DGS phase (gs3d_phase): the apps' defaults (capacity
     2^20, SH degree 3, 100k Blender-init points, 512^2) on a synthetic
     8-view Blender ring rendered from a seeded teacher: GS_STEPS steps at
     degree 0, one densify_step, reset_opacity, GS_STEPS steps at degree 3
     (finite losses; device and host time, pairs and drops, the pad slots'
     share of the requested pairs, peak memory, the densify stats);
     save_ply, render_3dgs with metrics, train_3dgs and full_eval_3dgs at
     --iterations 3; the card against the CPU at GS_SMALL on the same
     draws (losses within GS_LOSS_RTOL, the last render at >=
     GS_RENDER_PSNR); no kernel launch counter may move in the phase;
  5i. the 3D-GAN training phase (gan_phase): apps/train_gan.py's
     full-width PanoHead config (z/w 512, 512^2, mask_dual D with the
     segmentation branch, bf16 blocks at the top 4 resolutions, nrr 64,
     batch 4, --aug fixed --ada_p 0.2) on seeded random weights and a
     synthetic zip of 16 images and segmentations: 5 steps (G
     regularisation on steps 0 and 4, R1 on step 0), each step's G and D
     halves by CUDA events, host wall, losses (finite; R1 > 0 on step 0),
     peak memory, one profiled step's busy share; EG3D (dual D) for 2
     steps; train_gan --smoke on the card (snapshot, fakes) and a --resume
     of its snapshot restoring the train state bit for bit; the smoke
     step's losses and gradients on the card against the CPU (GAN_LOSS_RTOL,
     GAN_GRAD_TOL); no kernel launch counter may move in the phase;
  6. prints the per-frame and per-step times, stage splits, each kernel's
     time beside its plain version's and its bound, peak device memory,
     then a JSON line of per-kernel results, the card's name and power
     limit, and as its last line {"ok": true, "device": {...}}.

The random-weight generator's density has no meaningful iso-level, so the
marching-tetrahedra level of the training phase is the SURFACE_QUANTILE
quantile of the first latent's sigma grid (the JAX CLI's level 10 crosses
no cube of a random field).

It exits non-zero, printing no result, when no CUDA device is present or a
phase fails. It never imports jax. --dump FILE saves the frame's and the
warm-up train step's blend inputs (torch.save) for scripts/blend_time.py,
which times K3-K5 of this or another checkout on them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FOV = 0.227
IMAGE = 512
POINTS = 500_000   # the flagship template
FRAMES = 3         # timed frames, after one warm-up frame
TRAIN_STEPS = 3    # timed training steps, after one warm-up step
STREAM = 8         # latents of the frame stream, at STREAM_BATCH per backbone batch
STREAM_BATCH = 4
SURFACE_QUANTILE = 0.9
EG3D_FRAMES = 2       # timed EG3D frames per route, after one warm-up frame
EG3D_TRAIN_STEPS = 2  # timed EG3D train steps, after one warm-up step
EG3D_BG = (0.0, 0.0, 0.0)   # the eg3d presets' background (apps/train_decoder.py)
OPT_FRAMES = 2        # timed decoder-options frames per route, after one warm-up frame
OPT_TRAIN_STEPS = 2   # timed decoder-options train steps, after one warm-up step
# 5g(a): the flagship apply on the card against the same call on the CPU
APPLY_PSNR = 40.0      # image, dB over [0, 1]
APPLY_RAW_ERR = 5e-2   # image_raw, max abs
# the classic 3DGS phase (5h): the apps' defaults, and the card-vs-CPU hold's size
GS_CAPACITY, GS_POINTS, GS_VIEWS, GS_STEPS = 2 ** 20, 100_000, 8, 3
GS_SMALL = dict(capacity=2 ** 14, size=128, points=2_000)
GS_LOSS_RTOL = 1e-3    # card vs CPU losses, relative
GS_RENDER_PSNR = 35.0  # card vs CPU final render, dB over [0, 1]
# the 3D-GAN training phase (5i): train_gan's full-width config, cut in steps
GAN_STEPS, GAN_EG3D_STEPS, GAN_IMAGES, GAN_BATCH, GAN_ADA_P = 5, 2, 16, 4, 0.2
GAN_LOSS_RTOL = 1e-4   # card vs CPU smoke losses and metrics, relative
GAN_GRAD_TOL = 1e-2    # card vs CPU smoke gradients, of each tensor's CPU max |g|

# the card's published peaks (H100 SXM data sheet, dense), for the bounds.
# "tf32x3" is f32 accuracy on the tensor cores: each f32 product as three
# TF32 products (hi*hi + hi*lo + lo*hi), a third of the 495 TFLOP/s TF32
# rate, above the 67 TFLOP/s of f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "tf32x3": 495e12 / 3, "bf16": 989e12}
PEAK_NAMES = {"f32": "f32 CUDA cores 67 TFLOP/s", "tf32": "TF32 495 TFLOP/s",
              "tf32x3": "3xTF32 165 TFLOP/s", "bf16": "bf16 989 TFLOP/s"}
# FLOPs of one (pair, pixel) evaluation of a blend: the falloff, alpha and
# the blend (K3, K4), and the training replay with its gradient terms and
# their pixel sums (K5: with the 8 pixels of a column sharing dx, the 5
# conic and position terms come from 3 running sums)
BLEND_EVAL_FLOPS = {"blend": 20, "blend_train_fwd": 25, "blend_train_bwd": 45}

# kernel name -> (source, TPU kernel it replaces: file:line of its pallas_call)
KERNELS = {
    "mapping": ("gaussian_gan_decoder_tpu_torch/csrc/mapping.cu",
                "gaussian_gan_decoder_tpu/models/pallas_mapping.py:119"),
    "slab_decode": ("gaussian_gan_decoder_tpu_torch/csrc/slab_decode.cu",
                    "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:836"),
    "blend": ("gaussian_gan_decoder_tpu_torch/csrc/blend.cu",
              "gaussian_gan_decoder_tpu/splat/pallas_blend.py:311"),
    "blend_train_fwd": ("gaussian_gan_decoder_tpu_torch/csrc/blend_train.cu",
                        "gaussian_gan_decoder_tpu/splat/pallas_blend.py:525"),
    "blend_train_bwd": ("gaussian_gan_decoder_tpu_torch/csrc/blend_train.cu",
                        "gaussian_gan_decoder_tpu/splat/pallas_blend.py:562"),
    "heads_fwd": ("gaussian_gan_decoder_tpu_torch/csrc/heads_train.cu",
                  "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:255"),
    "heads_bwd": ("gaussian_gan_decoder_tpu_torch/csrc/heads_train.cu",
                  "gaussian_gan_decoder_tpu/decoder/pallas_heads_vjp.py:245"),
    "brick_decode": ("gaussian_gan_decoder_tpu_torch/csrc/brick_decode.cu",
                     "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:533"),
    "fused_decode": ("gaussian_gan_decoder_tpu_torch/csrc/brick_decode.cu",
                     "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:615"),
    "brick_table": ("gaussian_gan_decoder_tpu_torch/csrc/brick_table.cu",
                    "gaussian_gan_decoder_tpu/neuralfield/pallas_expand.py:149"),
    # the EG3D tri-plane forms of K2 and K9 (the EG3D phase)
    "slab_decode_bilinear": ("gaussian_gan_decoder_tpu_torch/csrc/slab_decode.cu",
                             "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:836"),
    "fused_decode_triplane": ("gaussian_gan_decoder_tpu_torch/csrc/brick_decode.cu",
                              "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:615"),
    # the f32 forms of K2, K8, K9 and K6's bf16 form (the decoder-options phase)
    "slab_decode_f32": ("gaussian_gan_decoder_tpu_torch/csrc/decode_f32.cu",
                        "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:836"),
    "brick_decode_f32": ("gaussian_gan_decoder_tpu_torch/csrc/decode_f32.cu",
                         "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:533"),
    "fused_decode_f32": ("gaussian_gan_decoder_tpu_torch/csrc/decode_f32.cu",
                         "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:615"),
    "heads_fwd_bf16": ("gaussian_gan_decoder_tpu_torch/csrc/heads_bf16.cu",
                       "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:255"),
    # the f32 forms of K2's bilinear and K9's tri-plane forms (the EG3D phase)
    "slab_decode_bilinear_f32": ("gaussian_gan_decoder_tpu_torch/csrc/decode_f32.cu",
                                 "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:836"),
    "fused_decode_triplane_f32": ("gaussian_gan_decoder_tpu_torch/csrc/decode_f32.cu",
                                  "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:615"),
    # K3's payload forms, K9's 'dots' lerp and K10's select form (the
    # frame-options phase; K9-dots also in the EG3D and decoder-options
    # phases)
    "blend_bf16_colors": ("gaussian_gan_decoder_tpu_torch/csrc/blend.cu",
                          "gaussian_gan_decoder_tpu/splat/pallas_blend.py:311"),
    "blend_packed_v2": ("gaussian_gan_decoder_tpu_torch/csrc/blend.cu",
                        "gaussian_gan_decoder_tpu/splat/pallas_blend.py:311"),
    "blend_packed_v3": ("gaussian_gan_decoder_tpu_torch/csrc/blend.cu",
                        "gaussian_gan_decoder_tpu/splat/pallas_blend.py:311"),
    "blend_packed_v2_mxu": ("gaussian_gan_decoder_tpu_torch/csrc/blend.cu",
                            "gaussian_gan_decoder_tpu/splat/pallas_blend.py:311"),
    "blend_packed_v3_mxu": ("gaussian_gan_decoder_tpu_torch/csrc/blend.cu",
                            "gaussian_gan_decoder_tpu/splat/pallas_blend.py:311"),
    "fused_decode_dots": ("gaussian_gan_decoder_tpu_torch/csrc/brick_decode.cu",
                          "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:615"),
    "fused_decode_triplane_dots": ("gaussian_gan_decoder_tpu_torch/csrc/brick_decode.cu",
                                   "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:615"),
    "fused_decode_dots_f32": ("gaussian_gan_decoder_tpu_torch/csrc/decode_f32.cu",
                              "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:615"),
    "fused_decode_triplane_dots_f32": ("gaussian_gan_decoder_tpu_torch/csrc/decode_f32.cu",
                                       "gaussian_gan_decoder_tpu/decoder/pallas_heads.py:615"),
    "brick_table_select": ("gaussian_gan_decoder_tpu_torch/csrc/brick_table.cu",
                           "gaussian_gan_decoder_tpu/neuralfield/pallas_expand.py:149"),
    # K10 on the training path: the frozen target's int8 probe table (the
    # trainer-options phase)
    "brick_table_probe": ("gaussian_gan_decoder_tpu_torch/csrc/brick_table.cu",
                          "gaussian_gan_decoder_tpu/neuralfield/pallas_expand.py:149"),
}
# K3's forms: kernels-line name -> (payload_format, mxu_power)
K3_FORMS = {"blend": ("f32", False), "blend_bf16_colors": ("bf16_colors", False),
               "blend_packed_v2": ("packed_v2", False), "blend_packed_v3": ("packed_v3", False),
               "blend_packed_v2_mxu": ("packed_v2", True),
               "blend_packed_v3_mxu": ("packed_v3", True)}


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(torch, fn, iters):
    """Mean device ms per call of fn over iters calls (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters):
    """Mean device ms per call of fn, a kernel wrapper that never waits on
    the device: CUDA events around iters calls queued behind a ~10 ms
    device sleep, so that the device runs them back to back whatever the
    host's launch path costs (events around calls on an idle device read
    that path where it is the longer)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_tool(name):
    from gaussian_gan_decoder_tpu_torch import kernel_lib
    return os.path.join(os.path.dirname(kernel_lib._nvcc()), name)


def sass_counts(so):
    """The instructions that show each kernel's design, from cuobjdump -sass
    of the built library -> {kernel: {mnemonic: count}}: HMMA (tensor
    cores), SHFL (warp shuffles), LDS.128 (16-byte shared loads), and LDL /
    STL (local memory: register spills)."""
    import re
    text = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    pattern = re.compile(r"\b(HMMA\.[\w.]+|SHFL\.\w+|LDS\.128|LDL|STL)\b")
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts.setdefault(fn, {})
        elif fn is not None and (m := pattern.search(line)):
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    return counts


def res_usage(so):
    """Each kernel's registers a thread at launch, stack and local memory
    (cuobjdump -res-usage of the built library) -> {kernel: {REG, STACK,
    LOCAL}}, with the demangled name beside: {kernel: (name, usage)}."""
    import re
    text = subprocess.run([cuda_tool("cuobjdump"), "-res-usage", str(so)], capture_output=True,
                          text=True, check=True).stdout
    use, fn = {}, None
    for line in text.splitlines():
        if "Function " in line:
            fn = line.split("Function ", 1)[1].strip().rstrip(":")
        elif fn is not None and "REG:" in line:
            use[fn] = {k: int(v) for k, v in re.findall(r"\b(REG|STACK|LOCAL):(\d+)", line)}
    names = list(use)
    filt = cuda_tool("cu++filt")
    pretty = names
    if names and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        pretty = out if len(out) == len(names) else names
    return {fn: (name, use[fn]) for fn, name in zip(names, pretty)}


def tile_stats(torch, starts, max_k, label):
    """Pairs per tile of one binning: the largest count, the mean and p99
    within max_k, the tiles at max_k and the empty ones. Printed."""
    counts = (starts[1:] - starts[:-1]).long()
    within = torch.clamp(counts, max=max_k).float()
    st = dict(tiles=int(counts.numel()), largest=int(counts.max()), mean=float(within.mean()),
              p99=float(torch.quantile(within, 0.99)), at_max_k=int((counts >= max_k).sum()),
              empty=int((counts == 0).sum()), pairs=int(within.sum()))
    print(f"tile pairs ({label}, max_k {max_k}): {st['pairs']} pairs within max_k over "
          f"{st['tiles']} tiles; largest {st['largest']}, mean {st['mean']:.2f}, p99 "
          f"{st['p99']:.1f}; {st['at_max_k']} tiles at max_k, {st['empty']} empty")
    return st


def paired_ms(torch, kernel_fn, plain_fn, iters):
    """Kernel and plain times taken in turns (plain, kernel, kernel, plain)."""
    p1 = cuda_ms(torch, plain_fn, iters)
    k1 = cuda_ms(torch, kernel_fn, iters)
    k2 = cuda_ms(torch, kernel_fn, iters)
    p2 = cuda_ms(torch, plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes, flops, kind):
    """(bound_ms, bound_by, rate): the larger of the bytes over the HBM rate
    and the operations over the card's peak rate for their type; rate names
    the rate that bounds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", "HBM 3.35 TB/s"
    return t_ops * 1e3, "operations", PEAK_NAMES[kind]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def chain_flops(cw):
    """FLOPs of the 5-head chain for one point, at each head's input width
    as packed (cw.n_in: its staging prefix, or 32 + P on the parallel
    chain), not the kernels' zero padding."""
    return sum(2 * (n_in * 128 + 2 * 128 * 128 + 128 * od)
               for n_in, (_, od, _, _) in zip(cw.n_in, cw.chain))


class FormCount:
    """The launch count of one kernel form on a wrapper that launches two
    (pallas_heads' `launches` and `launches_f32` / `launches_bf16`), as a
    counter frame_run and train_path can set to 0 and read."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


def blend_v3_counter(pallas_blend):
    """The launch counter of K3's packed_v3 form, the default frame's."""
    return FormCount(pallas_blend.blend_tiles, "launches_packed_v3")


def hold_decode(torch, rows_k, rows_p, real, cw, cam, label, rows_limit=1e-2,
                conic_b_limit=2e-2):
    """Hold a decode kernel's rows (K2, K8, K9) against a reference's on the
    real columns; pad columns must not be visible. rows_limit: the rows'
    worst row-relative gap, conic_b_limit conic_b's (hold_chain_gap sets
    both, hold_cross_route the first, from the staging's own sound
    references). -> max |d| of the rows compared."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
    pr = pallas_heads.PROJ_ROWS
    require(bool(torch.isfinite(rows_k).all()), f"{label}: non-finite rows")
    d = (rows_k - rows_p)[:, real].abs()
    rmax = rows_p[:, real].abs().amax(dim=1).clamp(min=1e-3)
    rel_rows = d.amax(dim=1) / rmax
    cb = pr["conic_b"]
    cont = [r for r in list(range(0, 14)) + list(range(16, 26)) if r != cb]
    worst = float(rel_rows[cont].max())
    own_b = float(rel_rows[cb])
    b_over_a = float(rmax[cb] / rmax[cb - 1])
    # witness for the screen rows: the plain projection of the kernel's own
    # head outputs (rows 0:16) must give the kernel's rows 16:26 at f32
    # rounding, each row (conic_b too) at its own scale
    proj = pallas_heads.project_heads(rows_k[:16].t(), cw, cam)
    dp = (rows_k - proj)[16:26][:, real].abs().amax(dim=1)
    proj_worst = float((dp / proj[16:26][:, real].abs().amax(dim=1).clamp(min=1e-3)).max())
    rad_d = d[pr["radius_f"]]
    vis_k, vis_p = rows_k[pr["visible"]] > 0.5, rows_p[pr["visible"]] > 0.5
    vis_agree = float((vis_k == vis_p)[real].float().mean())
    print(f"{label}: rows 0:14,16:26 but conic_b worst row-relative {worst:.3e}; "
          f"conic_b {own_b:.3e} of its own row max (which is {b_over_a:.3e} of "
          f"conic_a's); plain projection of the kernel's head rows vs its screen "
          f"rows {proj_worst:.3e}; radius |d| max {float(rad_d.max()):.0f}, exact on "
          f"{float((rad_d == 0).float().mean()):.5f}; visible agreement {vis_agree:.5f}; "
          f"visible {int(vis_k[real].sum())}/{int(real.sum())}")
    require(worst <= rows_limit, f"{label}: rows disagree (limit {rows_limit:.3e}): "
            f"{rel_rows.tolist()}")
    # conic_b = -cov_b / det is the near-cancelling off-diagonal of nearly
    # isotropic Gaussians: the chain rows' gap (bf16 flips from the f32
    # summation order, up to 1e-2 of their scale) reads larger at its
    # smaller scale. Its limit is twice the chain rows' (or derived from
    # its own sound references); a sign error reads 2, a dropped term ~1.
    # The projection witness holds the kernel's own conic math to f32
    # rounding.
    require(own_b <= conic_b_limit, f"{label}: conic_b disagrees: {own_b:.3e} of its row "
            f"max (limit {conic_b_limit:.3e})")
    require(proj_worst <= 1e-3, f"{label}: screen rows are not the projection of its "
            f"head rows: {dp.tolist()}")
    require(float(rad_d.max()) <= 1.0 and float((rad_d == 0).float().mean()) >= 0.999,
            f"{label}: radius rows disagree")
    require(vis_agree >= 0.999, f"{label}: visibility agreement {vis_agree}")
    require(not bool(vis_k[~real].any()), f"{label}: pad columns visible")
    return float(d[cont + [cb]].max())


def point_gaps(torch, rows_a, rows_b, real, cols):
    """Per real point, the largest gap of rows_a to rows_b over the rows
    cols, each row's |d| over rows_b's largest |value| in that row on the
    real columns: hold_decode's row-relative measure, point by point (its
    largest is hold_decode's worst) -> (n_real,) f32."""
    b = rows_b[cols][:, real]
    d = (rows_a[cols][:, real] - b).abs()
    return (d / b.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)).amax(dim=0)


def round_mantissa(torch, x, bits):
    """x rounded to `bits` stored mantissa bits: 7 is bf16's (to nearest
    even), fewer a lower-precision control (on the f32 bits, half away from
    zero)."""
    if bits == 7:
        return x.to(torch.bfloat16).to(x.dtype)
    drop = 23 - bits
    i = x.float().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32).to(x.dtype)


def chain_heads(torch, staging, cw, acc, hidden_bits=7):
    """decode_heads_plain's bf16 chain on a staging (M, 128) of bf16 values,
    with its sums in acc (torch.float32: the plain version's;
    torch.float64: a reference whose sums are exact far below bf16's
    rounding) and its hidden activations rounded to hidden_bits stored
    mantissa bits (7: bf16's; fewer: a lower-precision control); the
    written-back outputs are rounded to bf16 -> heads (M, 16) f32, K6's
    output layout."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    gelu, out = ph.GELUS[cw.gelu], []
    for m0 in range(0, staging.shape[0], ph.PLAIN_CHUNK):
        x = staging[m0:m0 + ph.PLAIN_CHUNK].to(acc)
        init = x[:, ph.INIT_COL:ph.INIT_COL + 3]
        cols = [None] * ph.OUT_W
        for h, (name, od, sc, oc) in enumerate(cw.chain):
            a = x
            for w, b in ((cw.w1, cw.b1), (cw.w2, cw.b2), (cw.w3, cw.b3)):
                a = round_mantissa(torch, gelu(a @ w[h].to(acc) + b[h].to(acc)), hidden_bits)
            o = ph._transform((a @ cw.w4[h].to(acc) + cw.b4[h].to(acc))[:, :od], name, cw,
                              init[:, :od])
            if sc + od <= ph.STAGE:
                x = torch.cat([x[:, :sc], round_mantissa(torch, o, 7), x[:, sc + od:]], dim=1)
            for j in range(od):
                cols[oc + j] = o[:, j]
        zero = torch.zeros_like(x[:, 0])
        out.append(torch.stack([zero if c is None else c for c in cols], dim=1).float())
    return torch.cat(out, dim=0)


def chain_rows(torch, staging, cw, cam, acc, hidden_bits=7):
    """chain_heads, then project_heads -> rows (NROWS, M) f32 (before the
    valid cull)."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    return ph.project_heads(chain_heads(torch, staging, cw, acc, hidden_bits), cw, cam)


CHAIN_TAIL = 1e-3   # a chain hold's tail: points beyond this share of a row's scale
CHAIN_GAPS = []     # each chain_gap_limits call's readings, for scripts/decode_hold_spread.py


def chain_gap_limits(torch, label, floor, reading, kernel, control):
    """The limits of a bf16 chain's hold, from the gap of two sound
    computations of the same chain (the plain version, f32 sums, and the
    chain with f64 sums), and the check that they can see a bit's loss.
    floor: per point, the plain version's gap to the f64-sum reference, as
    a share of each row's (or column's) scale. reading(x) -> (x's worst gap
    to what the kernel is held against, x's points more than CHAIN_TAIL
    from the f64-sum reference). Limits: worst max(1e-2, twice the largest
    floor); tail twice the floor's points beyond CHAIN_TAIL, + 100. The
    control (the plain chain with its hidden activations rounded to 6
    stored mantissa bits in place of bf16's 7) must fail them; the kernel's
    tail must pass (each reading printed). -> (the worst limit, the
    kernel's worst)."""
    limit = max(1e-2, 2.0 * float(floor.max()))
    tail = 2 * int((floor > CHAIN_TAIL).sum()) + 100
    (k_worst, k_tail), (c_worst, c_tail) = reading(kernel), reading(control)
    print(f"{label}: plain vs the f64-sum chain worst {float(floor.max()):.3e}, "
          f"{int((floor > CHAIN_TAIL).sum())} points above {CHAIN_TAIL:g}; limits: worst "
          f"{limit:.3e}, tail {tail} points; kernel worst {k_worst:.3e}, tail {k_tail}; "
          f"6-bit control worst {c_worst:.3e}, tail {c_tail}")
    CHAIN_GAPS.append(dict(label=label, floor=float(floor.max()), limit=limit, tail_limit=tail,
                           kernel=k_worst, kernel_tail=k_tail, control=c_worst,
                           control_tail=c_tail))
    require(c_worst > limit or c_tail > tail,
            f"{label}: the 6-bit control passes the limits: they cannot see a bit's loss")
    require(k_tail <= tail, f"{label}: {k_tail} points beyond {CHAIN_TAIL:g} of a row's scale "
            f"(limit {tail})")
    return limit, k_worst


def _gap_cols(ph):
    """The rows point_gaps reads: heads 0:14 and screen 16:26 but conic_b."""
    cb = ph.PROJ_ROWS["conic_b"]
    return [r for r in list(range(0, 14)) + list(range(16, 26)) if r != cb]


def hold_chain_gap(torch, rows_k, rows_p, staging, real, cw, cam, label):
    """Hold a bf16 decode kernel's rows against its plain version's where
    the staging makes the bf16 chain's rounding flips large (the gap of two
    sound computations of the same chain: its largest share of a row's
    scale over 500k points, 3.4e-3 on the flagship's 'dots' staging,
    1.43e-2 on EG3D's; scripts/dots_gap.py). staging: the plain version's
    (bf16 values). The limits (chain_gap_limits) come from the plain
    version's gap to chain_rows with f64 sums on it; hold_decode holds the
    worst row at that limit, and conic_b at twice the plain version's
    conic_b gap to the same reference (at least 2e-2). -> hold_decode's
    max |d|."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    cols = _gap_cols(ph)
    st = staging.float()
    ref = chain_rows(torch, st, cw, cam, torch.float64)
    ctl = chain_rows(torch, st, cw, cam, torch.float32, hidden_bits=6)

    def gaps(a, b):
        return point_gaps(torch, a, b, real, cols)

    limit, _ = chain_gap_limits(
        torch, label, gaps(rows_p, ref),
        lambda r: (float(gaps(r, rows_p).max()), int((gaps(r, ref) > CHAIN_TAIL).sum())),
        rows_k, ctl)
    # conic_b's limit from the same references: twice the plain version's
    # conic_b gap to the f64-sum chain, at least the fixed 2e-2 it had
    floor_b = float(point_gaps(torch, rows_p, ref, real, [ph.PROJ_ROWS["conic_b"]]).max())
    b_limit = max(2e-2, 2.0 * floor_b)
    CHAIN_GAPS[-1]["conic_b_limit"] = b_limit
    print(f"{label}: conic_b, plain vs the f64-sum chain {floor_b:.3e}; limit {b_limit:.3e}")
    del ref, ctl
    return hold_decode(torch, rows_k, rows_p, real, cw, cam, label, rows_limit=limit,
                       conic_b_limit=b_limit)


def hold_heads_gap(torch, o_k, o_p, staging, cw, M, label):
    """Hold K6's bf16 form (the chain alone: heads (Mpad, 16)) against its
    plain version on the staging they share, over the first M points, by
    each output column's share of that column's largest |value| (columns
    0:14), at the limits chain_gap_limits derives from the plain version's
    gap to chain_heads with f64 sums. -> (worst column-relative gap,
    limit)."""
    def gaps(a, b):
        d = (a - b)[:M, :14].abs()
        return (d / b[:M, :14].abs().amax(dim=0).clamp(min=1e-3)).amax(dim=1)

    st = staging.float()
    ref = chain_heads(torch, st, cw, torch.float64)
    ctl = chain_heads(torch, st, cw, torch.float32, hidden_bits=6)
    limit, worst = chain_gap_limits(
        torch, label, gaps(o_p, ref),
        lambda o: (float(gaps(o, o_p).max()), int((gaps(o, ref) > CHAIN_TAIL).sum())),
        o_k, ctl)
    return worst, limit


def slab_staging(torch, cw, vol, scales, ctx):
    """decode_project_slab_plain's staging: the context's static staging
    with the plain slab features rounded to the chain's dtype -> (Mpad,
    128) f32 of those values, slot order."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    out = []
    for m0 in range(0, ctx.positions.shape[0], ph.PLAIN_CHUNK):
        sl = slice(m0, m0 + ph.PLAIN_CHUNK)
        st = ctx.aux[sl].float()
        fm = ph.slab_features_plain(vol, scales, ctx.positions[sl], ctx.idx16[sl],
                                    st[:, ph.VALID_COL].clone(), ctx.inv_axes, ctx.box_warp,
                                    ctx.sizes)
        st[:, 0:ph.C] = ph._round_to(fm, ph.chain_dtype(cw))
        out.append(st)
    return torch.cat(out, dim=0)


def fused_staging(torch, cw, aux, rows_in, wts, scale_rows, lerp="bcast"):
    """decode_project_fused_plain's staging: aux with the plain fused
    features rounded to the chain's dtype -> (Mpad, 128) f32 of those
    values."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    st = aux.float()
    st[:, 0:ph.C] = ph._round_to(ph.fused_features_plain(rows_in, wts, scale_rows, lerp),
                                 ph.chain_dtype(cw))
    return st


def hold_cross_route(torch, dec, weights, planes, rows_slab, ctx, pos, cam, label):
    """The cross-route witness: the brick route's rows (the table, the
    gather, K8) against the slab route's (K2) on the same planes and GELU,
    in template order. The two routes' stagings differ (each route's own
    lerp of the same int8 values), so the limits (chain_gap_limits) come
    from both routes' sound references: per point, the larger of the gap
    of the plain chain on the brick staging to the f64-sum chain on the
    slab staging and the gap the other way round. The control is the
    6-bit chain on the brick staging, the tail counted against the
    f64-sum chain on the slab staging. -> (the worst row-relative gap, the
    worst limit)."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (build_slab_volume,
                                                                     sample_from_planes)
    g, cw = dec.G, weights.chain
    M = pos.shape[0]
    real = torch.ones(M, dtype=torch.bool, device=pos.device)
    cols = _gap_cols(ph)
    rows_b, _ = dec.decode_project(weights, planes, cam, init_position=pos)
    rows_b, rows_s = rows_b[:, :M], rows_slab[:, ctx.inv_slot]
    feats = sample_from_planes(g.plane_axes, planes, pos[None], float(g.rk["box_warp"]),
                               g.triplane_depth, table=dec._brick_table(planes))[0]
    st_b = ph.build_brick_staging(feats.mean(0), dec.cond0(pos), pos,
                                  dtype=ph.chain_dtype(cw))[0][:M].float()
    vol, scales = build_slab_volume(planes, g.triplane_depth)
    st_s = slab_staging(torch, cw, vol, scales, ctx)[ctx.inv_slot]
    del feats, vol, scales

    def gaps(a, b):
        return point_gaps(torch, a, b, real, cols)

    ref_s = chain_rows(torch, st_s, cw, cam, torch.float64)
    floor = gaps(chain_rows(torch, st_b, cw, cam, torch.float32), ref_s)
    floor = torch.maximum(floor, gaps(chain_rows(torch, st_s, cw, cam, torch.float32),
                                      chain_rows(torch, st_b, cw, cam, torch.float64)))
    ctl = chain_rows(torch, st_b, cw, cam, torch.float32, hidden_bits=6)
    limit, worst = chain_gap_limits(
        torch, label, floor,
        lambda r: (float(gaps(r, rows_s).max()), int((gaps(r, ref_s) > CHAIN_TAIL).sum())),
        rows_b, ctl)
    del ref_s, ctl, st_b, st_s
    hold_decode(torch, rows_b, rows_s, real, cw, cam, label, rows_limit=limit)
    return worst, limit


def hold_decode_f32(torch, rows_k, rows_p, real, cw, cam, label):
    """Hold an f32 decode kernel's rows (K2, K8, K9 at f32: the 3xTF32 chain,
    f32 up to the summation order) against its plain version's on the real
    columns: the raw head rows 0:14 and the continuous screen rows within
    1e-4 of each row's scale (conic_b, the near-cancelling off-diagonal,
    within 1e-3 of its own), radius within one pixel and exact on 0.999 of
    the points, the screen rows the plain projection of the kernel's own
    head rows at 1e-4, visibility agreement >= 0.999, rows 14:16 and 28:
    zero, pad columns not visible. -> max |d| of the rows compared."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
    pr = pallas_heads.PROJ_ROWS
    require(bool(torch.isfinite(rows_k).all()), f"{label}: non-finite rows")
    d = (rows_k - rows_p)[:, real].abs()
    rel = d.amax(dim=1) / rows_p[:, real].abs().amax(dim=1).clamp(min=1e-3)
    cb = pr["conic_b"]
    screen = [r for r in range(16, 26) if r != cb]
    proj = pallas_heads.project_heads(rows_k[:16].t(), cw, cam)
    perr = ((rows_k - proj)[screen][:, real].abs().amax(dim=1)
            / proj[screen][:, real].abs().amax(dim=1).clamp(min=1e-3))
    rad = d[pr["radius_f"]]
    vis_k, vis_p = rows_k[pr["visible"]] > 0.5, rows_p[pr["visible"]] > 0.5
    vis_agree = float((vis_k == vis_p)[real].float().mean())
    heads_w, screen_w = float(rel[:14].max()), float(rel[screen].max())
    print(f"{label}: rows 0:14 worst row-relative {heads_w:.3e}, screen rows {screen_w:.3e}, "
          f"conic_b {float(rel[cb]):.3e}; projection of the kernel's head rows vs its screen "
          f"rows {float(perr.max()):.3e}; radius |d| max {float(rad.max()):.0f}, exact on "
          f"{float((rad == 0).float().mean()):.5f}; visible agreement {vis_agree:.5f}; visible "
          f"{int(vis_k[real].sum())}/{int(real.sum())}")
    require(heads_w <= 1e-4 and screen_w <= 1e-4, f"{label}: rows disagree: {rel.tolist()}")
    require(float(rel[cb]) <= 1e-3, f"{label}: conic_b disagrees: {float(rel[cb]):.3e}")
    require(float(perr.max()) <= 1e-4, f"{label}: screen rows are not the projection of its "
            "head rows")
    require(float(rad.max()) <= 1.0 and float((rad == 0).float().mean()) >= 0.999,
            f"{label}: radius rows disagree")
    require(vis_agree >= 0.999, f"{label}: visibility agreement {vis_agree}")
    require(not bool(rows_k[14:16].any()) and not bool(rows_k[28:].any()),
            f"{label}: rows 14:16 or 28: not zero")
    require(not bool(vis_k[~real].any()), f"{label}: pad columns visible")
    return float(d[list(range(14)) + list(range(16, 26))].max())


def plain_image(torch, rows, grid, cap, dev, bg=None, cfg=None):
    """Binning + the plain blend of decode rows -> (3, H, W) image, over bg
    (the flagship's background by default), in cfg's payload format and
    sort key (flagship_raster_config()'s by default) at capacity cap."""
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.splat import fast_raster, pallas_blend
    cfg = dataclasses.replace(cfg or flagship.flagship_raster_config(), tile_capacity=cap)
    st, at = fast_raster.bin_pairs(rows, grid, grid, 16, cfg)
    acc, tr = pallas_blend.blend_tiles_plain(st, at, grid, grid, 16, cap, cfg.payload_format,
                                             cfg.mxu_power)
    bg = torch.tensor(flagship.DEFAULT_BG if bg is None else bg, device=dev)
    img = acc + tr[:, :, None] * bg
    return img.reshape(grid, grid, 16, 16, 3).permute(4, 0, 2, 1, 3).reshape(3, IMAGE, IMAGE)


def stage_split(torch, stage_ms):
    """Per-stage median of the timed runs."""
    names = [n for n, _ in stage_ms[0]]
    return {n: sorted(s[k][1] for s in stage_ms)[len(stage_ms) // 2]
            for k, n in enumerate(names)}


def make_timer(torch, marks):
    def timer(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    return timer


def psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def surface_level(torch, gen, z, shape_res, face_capacity):
    """The training phase's marching-tetrahedra level: SURFACE_QUANTILE of
    the sigma grid of z's planes -> (level, faces at that level)."""
    from gaussian_gan_decoder_tpu_torch.decoder.surface import (
        marching_tetrahedra_faces, sigma_grid_separable)
    with torch.no_grad():
        ws = gen.mapping(z, torch.zeros((1, gen.c_dim), device=z.device), truncation_psi=1.0)
        sig = sigma_grid_separable(gen, gen.synthesis_planes(ws, noise_mode="const"),
                                   shape_res=shape_res)
        level = float(torch.quantile(sig.flatten(), SURFACE_QUANTILE))
        _, n_faces, _ = marching_tetrahedra_faces(sig, level, face_capacity)
    return level, n_faces


# the training kernels' wrappers, as the autograd Functions call them
def train_wrappers():
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads_vjp
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    return {"blend_train_fwd": (pallas_blend, "blend_train"),
            "blend_train_bwd": (pallas_blend, "blend_train_bwd"),
            "heads_fwd": (pallas_heads_vjp, "decode_heads"),
            "heads_bwd": (pallas_heads_vjp, "decode_heads_bwd")}


def _detached(torch, x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_replace"):   # ChainWeights
        return x._replace(**{k: v.detach() for k, v in x._asdict().items()
                             if torch.is_tensor(v)})
    return x


def train_path(torch, run, steps):
    """Drive run.step (apps/train_decoder.build, one view a step) for one
    warm-up step and `steps` timed ones, launch counters at 0 first; each
    training kernel must launch in every step. The warm-up step's
    kernel inputs (and cotangents) are recorded on the way through the
    wrappers, which still launch their kernels. -> dict of the readings."""
    from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetDraws
    dev = run.dev
    wrappers = train_wrappers()
    draw_rng = torch.Generator().manual_seed(1)
    zs = [torch.randn((1, run.gen.z_dim), generator=draw_rng).to(dev) for _ in range(steps + 1)]
    draws = [TargetDraws.make(draw_rng, run.gen, run.tcfg, dev) for _ in range(steps + 1)]
    before = {n: p.detach().clone() for n, p in run.decoder.named_parameters()}
    frozen = {n: p.detach().clone() for n, p in run.gen.named_parameters()}
    captured = {}
    originals = {k: getattr(mod, fn) for k, (mod, fn) in wrappers.items()}

    def recording(key, fn):
        def rec(*a, **kw):
            captured.setdefault(key, tuple(_detached(torch, x) for x in a))
            return fn(*a, **kw)
        # a wrapper that counts itself through its module's global name
        # counts on the recorder while it stands in that name
        rec.launches = 0
        return rec

    recorders = {k: recording(k, fn) for k, fn in originals.items()}
    for fn in originals.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    state, step_ms, stage_ms, losses = run.state, [], [], []
    seen = {k: 0 for k in originals}
    for i in range(steps + 1):           # step 0 is the warm-up
        for k, (mod, fn) in wrappers.items():
            setattr(mod, fn, recorders[k] if i == 0 else originals[k])
        marks = []
        timer = make_timer(torch, marks)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        timer("start")
        state, metrics, _ = run.step(state, [draws[i]], zs[i][None], i, stage_timer=timer)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3
        loss = float(metrics["Loss/total"])
        require(np.isfinite(loss), f"train step {i}: loss {loss}")
        for k, fn in originals.items():
            n = fn.launches + recorders[k].launches
            require(n > seen[k], f"{k} kernel not launched in train step {i}")
            seen[k] = n
        require(int(metrics["General/n_dropped"]) == 0, f"train step {i}: dropped pairs")
        losses.append(loss)
        if i == 0:
            n_pairs = int(metrics["General/n_pairs"])
            moved = {n for n, p in run.decoder.named_parameters()
                     if not torch.equal(p.detach(), before[n])}
            require(any(n.endswith("_decoder.backbone.0.weight") for n in moved),
                    "the heads did not change in the first step")
            require(any(n.startswith("G.backbone.synthesis.") for n in moved),
                    "the G copy did not change in the first step")
            continue
        step_ms.append((marks[0][1].elapsed_time(marks[-1][1]), host_ms))
        stage_ms.append([(name, a.elapsed_time(b)) for (_, a), (name, b)
                         in zip(marks[:-1], marks[1:])])
    launches = {k: fn.launches + recorders[k].launches for k, fn in originals.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for k, n in launches.items():
        require(n >= steps + 1, f"{k} kernel launched {n} times in {steps + 1} train steps")
    require(all(torch.equal(p.detach(), frozen[n]) for n, p in run.gen.named_parameters()),
            "the frozen generator changed")
    require(n_pairs > 0, "the first train step blended no pair")
    require(set(captured) == set(wrappers), f"kernel inputs recorded: {sorted(captured)}")
    return dict(state=state, losses=losses, step_ms=step_ms, stage_ms=stage_ms,
                launches=launches, peak=peak, n_pairs=n_pairs, captured=captured,
                zs=zs, draws=draws)


def blend_evaluations(torch, starts, attrs, grid, max_k, training):
    """(pair, pixel) evaluations of a blend -> (blended, live): blended, the
    pairs of each pixel's tile (up to max_k), for the training rule only
    until T falls below 1e-4; live, those of them whose alpha reaches the
    1/255 cut, the evaluations whose result the output needs (the bounds
    count these: a blend may skip the others, as K3 and K5 do beyond a
    pair's reach)."""
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend as pb
    T, blended, live_n, dev = grid * grid, 0, 0, attrs.device
    for t0 in range(0, T, pb.PLAIN_TILES_PER_CHUNK):
        t1 = min(T, t0 + pb.PLAIN_TILES_PER_CHUNK)
        pairs = pb._pairs_of_tiles(starts, t0, t1, max_k, dev)
        if pairs is None:
            continue
        valid, idx = pairs
        *_, alpha, live = pb._falloff_plain(attrs, idx, valid, torch.arange(t0, t1, device=dev),
                                            grid, 16)
        if training:
            _, live, t_i, _ = pb._train_mask(alpha, live)
            blended += int(((t_i >= 1e-4) & valid[:, None, :]).sum())
        else:
            blended += 256 * int(valid.sum())
        live_n += int(live.sum())
    return blended, live_n


def scan_replays(torch, out, ent, tile, slot):
    """The (pixel, chunk) entries whose chunk K4's scan replayed pair by
    pair, from K4's own entries: those that enter the chunk open (T >=
    1e-4) and leave it below pallas_blend.FAST_T, which the product path
    never does (a replay that ends within ~8e-6 relative above FAST_T is
    not counted). tile, slot: entry_slots, tile by tile in chunk order."""
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend as pb
    t_in = ent[slot][..., 3]
    last = torch.ones_like(tile, dtype=torch.bool)
    last[:-1] = tile[1:] != tile[:-1]
    t_out = torch.where(last[:, None], out[tile][..., 3], ent[torch.roll(slot, -1)][..., 3])
    return int(((t_in >= 1e-4) & (t_out < pb.FAST_T)).sum())


def blend_train_kernels(torch, starts, attrs, gx, gy, ts, max_k, dout, label):
    """Hold K4 (with its chunk entries) and K5 against their plain versions
    on one blend's sorted pairs and a cotangent dout (T, 256, 4) of K4's
    output, each launched twice (the same bits); count the chunks K4's scan
    replayed; time both in turns; work out each bound. -> {kernel name:
    readings}."""
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend as pb
    readings = {}
    tile_stats(torch, starts, max_k, label)
    # -- K4: training blend forward, with the chunk entries K5 starts from --
    out, ent = pb.blend_train(starts, attrs, gx, gy, ts, max_k, entries=True)
    out_2, ent_2 = pb.blend_train(starts, attrs, gx, gy, ts, max_k, entries=True)
    acc_p, tr_p = pb.blend_train_plain(starts, attrs, gx, gy, ts, max_k)
    ent_p = pb.blend_train_entries_plain(starts, attrs, gx, gy, ts, max_k)
    tile, _, slot = pb.entry_slots(starts, max_k)
    torch.cuda.synchronize()
    same4 = torch.equal(out, out_2) and torch.equal(ent[slot], ent_2[slot])
    del out_2, ent_2
    replayed = scan_replays(torch, out, ent, tile, slot)
    dpix = torch.maximum((out[..., :3] - acc_p).abs().amax(dim=2), (out[..., 3] - tr_p).abs())
    err, frac = float(dpix.max()), float((dpix <= 1e-5).float().mean())
    dent = (ent[slot] - ent_p[slot]).abs().amax(dim=2)
    e_err, e_frac = float(dent.max()), float((dent <= 1e-5).float().mean())
    e_exact = float((ent[slot][..., 3] == ent_p[slot][..., 3]).float().mean())
    del ent_p
    ev_ms, plain_ms = paired_ms(
        torch, lambda: pb.blend_train(starts, attrs, gx, gy, ts, max_k, entries=True),
        lambda: pb.blend_train_plain(starts, attrs, gx, gy, ts, max_k), 5)
    ms = queued_ms(torch, lambda: pb.blend_train(starts, attrs, gx, gy, ts, max_k, entries=True),
                   20)
    evals, live = blend_evaluations(torch, starts, attrs, gx, max_k, True)
    blended = int(torch.clamp(starts[1:] - starts[:-1], max=max_k).sum())
    saturated = float((out[..., 3] < 1e-4).float().mean())
    ent_bytes = int(slot.numel()) * 256 * 4 * 4
    b4 = bound(blended * 9 * 4 + nbytes(starts, out) + ent_bytes,
               BLEND_EVAL_FLOPS["blend_train_fwd"] * live, "f32")
    print(f"K4 blend train fwd ({label}): {attrs.shape[1]} pairs, {blended} within max_k "
          f"{max_k}; {evals} (pair, pixel) evaluations before saturation of {256 * blended} "
          f"({evals / max(1, 256 * blended):.4f}), {live} of them live (alpha >= 1/255); "
          f"{saturated:.5f} of pixels end below "
          f"T 1e-4; max|d| {err:.3e}, within 1e-5 on {frac:.5f} of pixels; chunk entries "
          f"({slot.numel()} chunks of {pb.ENTRY_CHUNK}) against the plain forward's "
          f"cumulative product and sum: max|d| {e_err:.3e}, within 1e-5 on {e_frac:.5f}, T "
          f"bit-exact on {e_exact:.5f}; the scan replayed {replayed} of the {256 * slot.numel()} "
          f"(pixel, chunk) entries ({replayed / max(1, 256 * slot.numel()):.6f}); two launches "
          f"bit-identical: {same4}; kernel {ms:.4f} ms device (queued events), {ev_ms:.4f} ms "
          f"a call (events), plain {plain_ms:.3f} ms, bound {b4[0]:.4f} ms")
    # a pixel whose T crosses 1e-4 at another pair in the plain version's
    # cumprod differs by that pair's weight (< 1e-4 times its colour)
    require(frac >= 0.999 and err <= 1e-3, f"K4 disagrees ({label}): max {err}, frac {frac}")
    require(e_frac >= 0.999 and e_err <= 1e-3,
            f"K4's entries disagree ({label}): max {e_err}, frac {e_frac}")
    require(same4, f"K4 is not bit-identical from launch to launch ({label})")
    readings["blend_train_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b4,
                                       saturated=saturated,
                                       eval_share=evals / max(1, 256 * blended))

    # -- K5: training blend backward, from K4's entries ------------------------
    d_k = pb.blend_train_bwd(starts, attrs, out, dout, gx, gy, ts, max_k, ent)
    d_2 = pb.blend_train_bwd(starts, attrs, out, dout, gx, gy, ts, max_k, ent)
    d_p = pb.blend_train_bwd_plain(starts, attrs, out[..., :3], out[..., 3], dout[..., :3],
                                   dout[..., 3], gx, gy, ts, max_k)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(d_k).all()), f"K5 wrote non-finite gradients ({label})")
    same = torch.equal(d_k, d_2)
    del d_2
    rel = ((d_k - d_p).abs().amax(dim=1) / d_p.abs().amax(dim=1).clamp(min=1e-30))
    err = float((d_k - d_p).abs().max())
    # a pair gets no gradient from a pixel past that pixel's stop, so none
    # at all behind a saturated tile (and none past max_k)
    zero_k, zero_p = (d_k == 0).all(dim=0), (d_p == 0).all(dim=0)
    zero, zero_agree = float(zero_p.float().mean()), float((zero_k == zero_p).float().mean())
    ev_ms, plain_ms = paired_ms(
        torch, lambda: pb.blend_train_bwd(starts, attrs, out, dout, gx, gy, ts, max_k, ent),
        lambda: pb.blend_train_bwd_plain(starts, attrs, out[..., :3], out[..., 3],
                                         dout[..., :3], dout[..., 3], gx, gy, ts, max_k), 2)
    ms = queued_ms(torch,
                   lambda: pb.blend_train_bwd(starts, attrs, out, dout, gx, gy, ts, max_k, ent), 20)
    b5 = bound(2 * blended * 9 * 4 + nbytes(starts, out, dout) + ent_bytes,
               BLEND_EVAL_FLOPS["blend_train_bwd"] * live, "f32")
    print(f"K5 blend train bwd ({label}): per-field max|d| / max|plain| "
          f"{', '.join(f'{v:.2e}' for v in rel.tolist())}; zero gradient on {zero:.5f} of "
          f"the pairs (kernel and plain agree on {zero_agree:.6f}); two launches "
          f"bit-identical: {same}; kernel {ms:.4f} ms device (queued events), {ev_ms:.4f} ms a "
          f"call (events), plain {plain_ms:.3f} ms, bound {b5[0]:.4f} ms")
    # S_i = (accum - accum_entry) . dC - local_i (K5) against the plain
    # version's cumsum, divided by 1 - alpha >= 0.01: f32 rounding read up
    # to ~1e-5 of a field's largest gradient, saturation flips below 1e-4
    require(float(rel.max()) <= 1e-3, f"K5 disagrees ({label}): {rel.tolist()}")
    require(zero_agree >= 0.999, f"K5 zero-gradient pairs disagree ({label}): {zero_agree}")
    require(same, f"K5 is not bit-identical from launch to launch ({label})")
    readings["blend_train_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b5)
    return readings


def train_kernels(torch, captured, results):
    """Hold K4-K7 against their plain versions on the warm-up step's own
    inputs and cotangents; time both in turns; work out each bound."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads, pallas_heads_vjp
    with torch.no_grad():
        # -- K4 / K5 on the step's own pairs and cotangent ------------------
        starts, attrs, _, dout, gx, gy, ts, max_k, _ = captured["blend_train_bwd"]
        results.update(blend_train_kernels(torch, starts, attrs, gx, gy, ts, max_k, dout,
                                           "train step"))

        # -- K6: f32 head chain forward ----------------------------------
        st, cw = captured["heads_fwd"]
        o_k = pallas_heads.decode_heads(st, cw)
        o_p = pallas_heads.decode_heads_plain(st, cw)
        torch.cuda.synchronize()
        err = float((o_k - o_p).abs().max())
        rel = err / float(o_p.abs().max())
        ms, plain_ms = paired_ms(torch, lambda: pallas_heads.decode_heads(st, cw),
                                 lambda: pallas_heads.decode_heads_plain(st, cw), 3)
        print(f"K6 heads fwd: {st.shape[0]} points; max|d| {err:.3e} ({rel:.3e} of max); "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        require(rel <= 1e-5, f"K6 disagrees: {rel:.3e}")   # f32 summation order only
        weights = (cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4, cw.meta)
        fwd_flops = st.shape[0] * chain_flops(cw)
        # the least time for these FLOPs at f32 accuracy: 3xTF32 on the
        # tensor cores
        results["heads_fwd"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound=bound(nbytes(st, o_k, *weights), fwd_flops, "tf32x3"))

        # -- K7: f32 head chain backward, on the step's own cotangent --------
        st, out16, dout, cw = captured["heads_bwd"]
        dst_k, g_k = pallas_heads_vjp.decode_heads_bwd(st, out16, dout, cw)
        dst_2, g_2 = pallas_heads_vjp.decode_heads_bwd(st, out16, dout, cw)
        dst_p, g_p = pallas_heads_vjp.decode_heads_bwd_plain(st, out16, dout, cw)
        torch.cuda.synchronize()
        # the JAX grid sums in order; K7's block partials and their reduce
        # are summed in a fixed order, without atomics
        same = torch.equal(dst_k, dst_2) and all(torch.equal(a, b) for a, b in zip(g_k, g_2))
        print(f"K7 heads bwd: two launches bit-identical: {same}")
        require(same, "K7 is not bit-identical from launch to launch")
        del dst_2, g_2
        pairs = [("dstage", dst_k, dst_p)] + [
            (n, a, b) for n, a, b in zip(("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4"),
                                         g_k, g_p)]
        rels = {n: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for n, a, b in pairs}
        err = max(float((a - b).abs().max()) for _, a, b in pairs)
        ms, plain_ms = paired_ms(
            torch, lambda: pallas_heads_vjp.decode_heads_bwd(st, out16, dout, cw),
            lambda: pallas_heads_vjp.decode_heads_bwd_plain(st, out16, dout, cw), 2)
        print("K7 heads bwd: max|d| / max|plain| "
              + ", ".join(f"{n} {v:.2e}" for n, v in rels.items())
              + f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        # the weight gradients sum the points' terms in another order (block
        # partials, then slices, against cuBLAS)
        require(max(rels.values()) <= 1e-3, f"K7 disagrees: {rels}")
        # recompute the forward, then the data and the weight gradient of
        # every layer: three times the forward's FLOPs
        results["heads_bwd"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound=bound(nbytes(st, out16, dout, dst_k, *weights, *g_k), 3 * fwd_flops,
                        "tf32x3"))


def profile_step(torch, run, state, draws, z, iteration):
    """One more step under torch.profiler -> (device ms, largest kernels);
    draws and z are one view's, or a list of views' and their (B, 1, z_dim)
    latents."""
    if not isinstance(draws, list):
        draws, z = [draws], z[None]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run.step(state, draws, z, iteration)
        torch.cuda.synchronize()
    on_card = sorted(((e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    return sum(t for t, _ in on_card), on_card



def _timed_step(torch, step, state, draws, z, iteration):
    """One train step -> (metrics as floats, device ms by events, host ms)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    _, metrics, _ = step(state, draws, z, iteration)
    b.record()
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in metrics.items()}, a.elapsed_time(b),
            (time.perf_counter() - t0) * 1e3)


def _draw_until(torch, rng, run, cfg, frontal):
    """CPU-drawn (z, draws) whose camera is (or is not) frontal for the ID
    term's gate."""
    from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetDraws
    from gaussian_gan_decoder_tpu_torch.train.distill import frontal_view
    while True:
        z = torch.randn((1, run.gen.z_dim), generator=rng).to(run.dev)
        draws = TargetDraws.make(rng, run.gen, run.tcfg, run.dev)
        if frontal_view(draws, cfg, run.tcfg) == frontal:
            return z, draws


def snapshot_phase(torch, run, state, seed, workdir):
    """The training slice's outputs on the flagship trainer: the train-state
    checkpoint round trip, the decoder snapshot round trip, the ID term,
    run_eval at full width and render_with_decoder with the .ply export.
    -> the readings."""
    import dataclasses
    import math
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
    from gaussian_gan_decoder_tpu_torch.decoder.snapshot import (
        load_decoder, render_with_decoder, save_decoder)
    from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetDraws, sample_target
    from gaussian_gan_decoder_tpu_torch.gaussians.model import gaussian_scene_from_decoded
    from gaussian_gan_decoder_tpu_torch.gaussians.ply import load_ply_arrays, save_ply
    from gaussian_gan_decoder_tpu_torch.losses import random_irse50
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    from gaussian_gan_decoder_tpu_torch.train import checkpoint
    from gaussian_gan_decoder_tpu_torch.train.distill import make_train_step
    from gaussian_gan_decoder_tpu_torch.train.eval import run_eval
    out = {}
    rng = torch.Generator().manual_seed(seed + 11)

    # -- 1. the train state: save, one more step, restore, the same step again
    def clone(x):
        if torch.is_tensor(x):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x
    path = os.path.join(workdir, "train_state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, state, {"decoder": run.decoder.config, "target_cfg": run.tcfg,
                                  "distill_cfg": run.cfg})
    out["state_write_s"] = time.perf_counter() - t0
    out["state_bytes"] = os.path.getsize(path)
    saved_sd, saved_opt, saved_step = (clone(run.decoder.state_dict()),
                                       clone(state.optimizer.state_dict()), state.step)
    z1, d1 = _draw_until(torch, rng, run, run.cfg, False)
    m_next, _, _ = _timed_step(torch, run.step, state, [d1], z1[None], saved_step)
    t0 = time.perf_counter()
    checkpoint.restore(path, state)
    torch.cuda.synchronize()
    out["state_read_s"] = time.perf_counter() - t0
    require(state.step == saved_step, f"restored step {state.step}, saved {saved_step}")
    sd = run.decoder.state_dict()
    require(all(torch.equal(sd[k], v) for k, v in saved_sd.items()),
            "a restored decoder tensor differs from the saved one")
    opt = state.optimizer.state_dict()
    n_moments = 0
    for i, st in saved_opt["state"].items():
        for k, v in st.items():
            require(torch.equal(opt["state"][i][k].to(v.device), v),
                    f"restored optimizer state {i}/{k} differs from the saved one")
            n_moments += k.startswith("exp_avg")
    require(opt["param_groups"] == saved_opt["param_groups"], "optimizer groups differ")
    m_again, _, _ = _timed_step(torch, run.step, state, [d1], z1[None], saved_step)
    rel = abs(m_again["Loss/total"] - m_next["Loss/total"]) / abs(m_next["Loss/total"])
    print(f"train state: {out['state_bytes']} bytes, write {out['state_write_s']:.3f} s, "
          f"read {out['state_read_s']:.3f} s; step {saved_step}, {len(saved_sd)} decoder "
          f"tensors and {n_moments} Adam moments bit-identical after the round trip; the "
          f"next step's loss {m_next['Loss/total']:.7f}, from the restored state "
          f"{m_again['Loss/total']:.7f} (rel {rel:.2e})")
    require(rel <= 1e-6, f"the step from the restored state differs: rel {rel:.3e}")
    del saved_sd, saved_opt

    # -- 2. the decoder snapshot -------------------------------------------------
    snap = os.path.join(workdir, "decoder_snapshot")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_decoder(snap, run.decoder, run.gen, target_cfg=run.tcfg,
                 extra_configs={"distill_cfg": run.cfg})
    out["snapshot_write_s"] = time.perf_counter() - t0
    out["snapshot_bytes"] = os.path.getsize(snap)
    t0 = time.perf_counter()
    loaded, configs = load_decoder(snap, device=run.dev)
    torch.cuda.synchronize()
    out["snapshot_read_s"] = time.perf_counter() - t0
    for mine, theirs, what in ((run.decoder, loaded, "decoder"),
                               (run.gen, configs["frozen_G"], "frozen generator")):
        a, b = mine.state_dict(), theirs.state_dict()
        require(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a),
                f"the loaded snapshot's {what} state differs")
    require(configs["decoder"] == run.decoder.config and configs["target_cfg"] == run.tcfg,
            "the snapshot's configs differ")
    print(f"decoder snapshot: {out['snapshot_bytes']} bytes, write "
          f"{out['snapshot_write_s']:.3f} s, read (rebuild + load) "
          f"{out['snapshot_read_s']:.3f} s; decoder and frozen generator bit-identical")

    # -- 3. the ID term: a seeded random IR-SE50, frontal and non-frontal draws
    irse = random_irse50(torch.Generator(device=run.dev).manual_seed(seed), device=run.dev)
    cfg_id = dataclasses.replace(run.cfg, id_loss_weight=1.0)
    step_id = make_train_step(run.decoder, run.gen, run.vgg, cfg_id, run.tcfg, run.rcfg, irse)
    zf, df = _draw_until(torch, rng, run, cfg_id, True)
    zn, dn = _draw_until(torch, rng, run, cfg_id, False)
    i = state.step
    m_f, _, _ = _timed_step(torch, step_id, state, df, zf, i)
    m_n, _, _ = _timed_step(torch, step_id, state, dn, zn, i + 1)
    m_f2, id_dev, id_host = _timed_step(torch, step_id, state, df, zf, i + 2)
    _, plain_dev, plain_host = _timed_step(torch, run.step, state, [df], zf[None], i + 3)
    w = cfg_id
    parts = (m_f["Loss/L1"] * w.l1_weight + m_f["Loss/L2"] * w.l2_weight
             + m_f["Loss/LPIPS"] * w.lpips_weight + m_f["Loss/DSSIM"] * w.ssim_weight
             + m_f["Loss/Sobel"] * w.sobel_weight)
    print(f"ID term (seeded random IR-SE50): frontal draw Loss/id {m_f['Loss/id']:.6f}, "
          f"total {m_f['Loss/total']:.6f} = other terms {parts:.6f} + id; non-frontal draw "
          f"Loss/id {m_n['Loss/id']}; step with the ID term {id_dev:.3f} ms device (events), "
          f"{id_host:.3f} ms host wall, without {plain_dev:.3f} / {plain_host:.3f} ms "
          f"(the same frontal draw)")
    require(math.isfinite(m_f["Loss/id"]) and m_f["Loss/id"] != 0.0, "no ID term on a frontal draw")
    require(abs(m_f["Loss/total"] - parts - m_f["Loss/id"]) <= 1e-5 * abs(m_f["Loss/total"]),
            "the ID term is not in Loss/total")
    require(m_n["Loss/id"] == 0.0 and m_f2["Loss/id"] != 0.0, "the ID term's gate is wrong")
    out.update(id_step_ms=id_dev, plain_step_ms=plain_dev)

    # -- 4. run_eval at full width: 4 steps, the random VGG16 and the IR-SE50
    pallas_blend.blend_tiles.launches = 0
    pallas_heads.decode_heads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run_eval(torch.Generator().manual_seed(seed + 99), run.decoder, run.gen,
                       run.vgg, irse, eval_steps=4, cfg=run.cfg, target_cfg=run.tcfg,
                       raster_cfg=run.rcfg)
    torch.cuda.synchronize()
    out["eval_step_ms"] = (time.perf_counter() - t0) * 1e3 / 4
    k3, k6 = pallas_blend.blend_tiles.launches, pallas_heads.decode_heads.launches
    print(f"run_eval (4 steps, 512^2, 500k points, with the ID loop): "
          f"{out['eval_step_ms']:.1f} ms a step (host wall); K3 launched {k3}, K6 {k6}; "
          + json.dumps(metrics))
    require(len(metrics) == 6 and all(math.isfinite(v) for v in metrics.values()),
            f"eval metrics: {metrics}")
    require(k3 >= 4 and k6 >= 4, f"eval launched K3 {k3} and K6 {k6} times in 4 steps")
    del irse, step_id

    # -- 5. render the loaded snapshot (K3) and export its 500k Gaussians -----
    cp, c2w = flagship.default_camera_params(fov_deg=13.0, device=run.dev)
    z = torch.randn((1, run.gen.z_dim), generator=rng).to(run.dev)
    frozen = configs["frozen_G"]
    target = sample_target(TargetDraws.make(rng, frozen, run.tcfg, run.dev), frozen, z,
                           cfg=run.tcfg, camera_params=cp)
    k3 = pallas_blend.blend_tiles.launches
    img, decoded = render_with_decoder(loaded, z, cp, c2w, target.vertices, math.radians(13.0),
                                       image_size=IMAGE, backend="pallas")
    torch.cuda.synchronize()
    require(tuple(img.shape) == (3, IMAGE, IMAGE) and bool(torch.isfinite(img).all())
            and float(img.std()) > 0, "render_with_decoder: bad image")
    require(pallas_blend.blend_tiles.launches == k3 + 1, "render_with_decoder did not launch K3")
    scene = gaussian_scene_from_decoded(decoded)
    ply_path = os.path.join(workdir, "scene.ply")
    t0 = time.perf_counter()
    save_ply(scene, ply_path)
    out["ply_write_s"] = time.perf_counter() - t0
    out["ply_bytes"] = os.path.getsize(ply_path)
    cols = load_ply_arrays(ply_path)
    want = {"x": ("xyz", 0), "y": ("xyz", 1), "z": ("xyz", 2), "opacity": ("opacity", 0)}
    want.update({f"f_dc_{c}": ("color", c) for c in range(3)})
    want.update({f"scale_{c}": ("scale", c) for c in range(3)})
    want.update({f"rot_{c}": ("rotation", c) for c in range(4)})
    n = len(cols["x"])
    same = all(np.array_equal(cols[k], decoded[a][:, c].detach().cpu().numpy())
               for k, (a, c) in want.items())
    print(f"render_with_decoder (loaded snapshot, 512^2, K3): image mean "
          f"{float(img.mean()):.4f}, std {float(img.std()):.4f}; .ply of {n} Gaussians: "
          f"{out['ply_bytes']} bytes, write {out['ply_write_s']:.3f} s, read back bit for "
          f"bit: {same}")
    require(n == run.tcfg.num_points and same, "the .ply does not read back bit for bit")
    return out


def profile_frames(torch, frame, host_med, label):
    """FRAMES more frames, frame(i, stage_timer), under torch.profiler: the
    device time per frame, its share of the median host-wall frame, each
    stage's host time beside the device time of the kernels it launched,
    the driver allocations and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    state, names = {"k": 0, "open": None}, {}

    def stage_timer(name):
        # a call ends the stage `name` and opens the next one
        if name == "start":
            state["k"] = 0
        if state["open"] is not None:
            state["open"].__exit__(None, None, None)
            names[state["k"]] = name
            state["k"] += 1
            state["open"] = None
        if name != "end":
            state["open"] = record_function(f"stage{state['k']}")
            state["open"].__enter__()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(FRAMES):
            stage_timer("start")
            frame(i, stage_timer)
            stage_timer("end")
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_card = sorted(((e.self_device_time_total / 1e3 / FRAMES, e.key) for e in events
                      if e.device_type == DeviceType.CUDA and not e.key.startswith("stage")),
                     reverse=True)
    busy_ms = sum(t for t, _ in on_card)
    require(busy_ms > 0, f"the profiler saw no device time in the {label} frames")
    stages = {e.key: e for e in events
              if e.device_type == DeviceType.CPU and e.key.startswith("stage")}
    # device memory the caching allocator takes from or gives back to the
    # driver inside the frames (host time the card may idle through)
    alloc = {k: [0.0, 0.0] for k in ("cudaMalloc", "cudaFree")}
    for e in events:
        for k, v in alloc.items():
            if e.key.startswith(k):
                v[0] += e.count / FRAMES
                v[1] += e.cpu_time_total / 1e3 / FRAMES
    print(f"{label} profiler: {busy_ms:.3f} ms device time per frame, busy "
          f"{busy_ms / host_med:.3f} of the median host-wall frame ({host_med:.3f} ms); "
          + ", ".join(f"{k} {n:.1f} calls {t:.3f} ms host" for k, (n, t) in alloc.items())
          + " per frame; largest: " + "; ".join(f"{k[:48]} {t:.3f} ms ({t / busy_ms:.1%})"
                                                for t, k in on_card[:6]))
    print(f"{label} stages, host ms / device ms of the kernels each launched (per frame): "
          + ", ".join(f"{names[k]} {stages[f'stage{k}'].cpu_time_total / 1e3 / FRAMES:.3f} / "
                      f"{stages[f'stage{k}'].device_time_total / 1e3 / FRAMES:.3f}"
                      for k in sorted(names) if f"stage{k}" in stages))


def frame_run(torch, decoder, weights, zs, cp, c2w, counters, frames, **route):
    """Drive flagship.decode_and_render for one warm-up frame and `frames`
    timed ones, launch counters at 0 first; each counted kernel must launch
    in every frame. route: slab_ctx or init_position, bg (the flagship's
    background by default) and raster_cfg (flagship_raster_config() by
    default). -> dict of the readings."""
    from gaussian_gan_decoder_tpu_torch import flagship
    dev = zs.device
    for fn in counters.values():
        fn.launches = 0
    seen = dict.fromkeys(counters, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    frame_ms, stage_ms, first = [], [], None
    for i in range(frames + 1):          # frame 0 is the warm-up
        marks = []
        timer = make_timer(torch, marks)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        timer("start")
        img, decoded, aux = flagship.decode_and_render(
            decoder, weights, zs[i], cp, c2w, route.get("slab_ctx"), FOV, image_size=IMAGE,
            bg=route.get("bg", flagship.DEFAULT_BG), return_aux=True, stage_timer=timer,
            init_position=route.get("init_position"), raster_cfg=route.get("raster_cfg"))
        timer("end")
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3
        for name, fn in counters.items():
            require(fn.launches > seen[name], f"{name} kernel not launched in frame {i}")
            seen[name] = fn.launches
        require(tuple(img.shape) == (3, IMAGE, IMAGE), f"image shape {tuple(img.shape)}")
        require(bool(torch.isfinite(img).all()), f"frame {i}: non-finite image")
        require(float(img.std()) > 1e-4, f"frame {i}: constant image")
        n_vis = int(aux["visibility_filter"].sum())
        require(n_vis > 0 and aux["n_pairs"] > 0, f"frame {i}: nothing visible")
        require(aux["n_dropped"] == 0, f"frame {i}: dropped pairs")
        require(all(decoded[k].shape[0] == POINTS for k in decoded), "decoded shape")
        if i == 0:
            first = (img.clone(), n_vis, aux["n_pairs"])
            continue
        frame_ms.append((marks[0][1].elapsed_time(marks[-1][1]), host_ms))
        stage_ms.append([(name, a.elapsed_time(b)) for (_, a), (name, b)
                         in zip(marks[:-1], marks[1:])])
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        require(n >= frames + 1, f"{name} kernel launched {n} times in {frames + 1} frames")
    return dict(frame_ms=frame_ms, stage_ms=stage_ms, first=first, launches=launches,
                peak=torch.cuda.max_memory_allocated(dev))


def report_frames(torch, run, label):
    dev_ms = sorted(d for d, _ in run["frame_ms"])
    host = sorted(h for _, h in run["frame_ms"])
    med = dev_ms[len(dev_ms) // 2]
    print(f"{label} frame (512^2, {POINTS} Gaussians): median {med:.3f} ms device "
          f"({1e3 / med:.2f} fps), median {host[len(host) // 2]:.3f} ms host wall; "
          f"first frame {run['first'][1]} visible, {run['first'][2]} pairs")
    print(f"{label} stage split (median ms): " + ", ".join(
        f"{n} {t:.3f}" for n, t in stage_split(torch, run["stage_ms"]).items()))
    print(f"{label} peak device memory: {run['peak'] / 2 ** 30:.3f} GiB; launches "
          f"{run['launches']}")
    return med, host[len(host) // 2]


def brick_phase(torch, dec, weights, planes, rows_slab, ctx, template, cam, cp, c2w, seed,
                results):
    """The brick route (no slab context) at full width, on the slab frame's
    decoder weights, planes, template and camera: K10, K8 and K9 against
    their plain versions; the cross-route witness; 1 + FRAMES frames on the
    table route (K10 + K8) and on the fused route (K10 + K9); the frame
    stream. -> the launches of K8-K10 on the brick-route frames."""
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand as pe
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
        _quantize_int8, build_plane_table, sample_from_planes, sample_fused_inputs)
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    dev = planes.device
    pos = torch.tensor(template, device=dev)
    M = pos.shape[0]
    G = dec.G
    D, box_warp = G.triplane_depth, float(G.rk["box_warp"])
    n_planes, CD, H, W = planes.shape[1:]

    def brick_decoder(fused):
        # the JAX flagship decoder (poly GELU) with the slab frame's weights;
        # its fused route here holds K9's 'bcast' lerp (the frame-options
        # phase runs the default 'dots')
        d = flagship.flagship_decoder(gen=G, device=dev, fused_sampling=fused)
        d.config = dataclasses.replace(d.config, fused_lerp="bcast")
        d.load_state_dict(dec.state_dict())
        return d.eval()

    bdec, fdec = brick_decoder(False), brick_decoder(True)
    bweights = bdec.fold()
    cw = bweights.chain
    weights_of = (cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4, cw.meta)
    with torch.inference_mode():
        # -- K10: the frame's int8 tri-grid -> brick table ------------------
        q8, _ = _quantize_int8(planes.float().reshape(n_planes, CD // D, D, H, W))
        fp = pe.padded_channels_last(q8)
        NY = pe.table_rows_ny(H, 1)
        e_k = pe.brick_table(fp, NY)
        e_p = pe.brick_table_plain(fp, NY)
        torch.cuda.synchronize()
        err = int((e_k.int() - e_p.int()).abs().max())
        # queued events: K10 takes ~0.1 ms, under its wrapper's host path
        p1 = queued_ms(torch, lambda: pe.brick_table_plain(fp, NY), 20)
        lib1 = queued_ms(torch, lambda: pe.concat_corners(fp), 20)
        k1 = queued_ms(torch, lambda: pe.brick_table(fp, NY), 20)
        k2 = queued_ms(torch, lambda: pe.brick_table(fp, NY), 20)
        lib2 = queued_ms(torch, lambda: pe.concat_corners(fp), 20)
        p2 = queued_ms(torch, lambda: pe.brick_table_plain(fp, NY), 20)
        ms, plain_ms, lib_ms = (k1 + k2) / 2, (p1 + p2) / 2, (lib1 + lib2) / 2
        print(f"K10 brick table: volume {tuple(q8.shape)} int8 -> table {tuple(e_k.shape)} "
              f"(NY {NY}); max |d| {err} (bit-exact: {err == 0}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.cat of the 8 views {lib_ms:.4f} ms")
        require(torch.equal(e_k, e_p), "K10 disagrees with its plain version")
        results["brick_table"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound=bound(nbytes(q8, e_k), 0, "bf16"))
        del e_k, e_p, fp

        # -- K8 on the gathered, plane-meaned staging -----------------------
        table = build_plane_table(planes, D, brick_dtype=torch.int8)
        feats = sample_from_planes(G.plane_axes, planes, pos[None], box_warp, D, table=table)[0]
        staging, Mpad = ph.build_brick_staging(feats.mean(0), pos, pos)
        real = torch.arange(Mpad, device=dev) < M
        rows_k = ph.decode_project(cw, staging, cam, M)
        rows_p = ph.decode_project_plain(cw, staging, cam, M)
        torch.cuda.synchronize()
        # the plain version's staging is the kernel's input itself
        err = hold_chain_gap(torch, rows_k, rows_p, staging, real, cw, cam,
                             f"K8 brick decode (Mpad {Mpad})")
        ms, plain_ms = paired_ms(torch, lambda: ph.decode_project(cw, staging, cam, M),
                                 lambda: ph.decode_project_plain(cw, staging, cam, M), 3)
        print(f"K8 brick decode: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        # per point: the chain and ~150 FLOPs of projection
        results["brick_decode"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound=bound(nbytes(staging, *weights_of, rows_k), M * (chain_flops(cw) + 150),
                        "bf16"))
        del rows_k, rows_p, staging, feats

        # -- K9 on sample_fused_inputs ---------------------------------------
        rows_in, wts, scale_rows = sample_fused_inputs(G.plane_axes, planes, pos[None], box_warp,
                                                       D, table=table, pad_to=Mpad)
        aux, _ = ph.build_brick_staging(pos.new_zeros((M, ph.C)), pos, pos)
        f_k = ph.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M)
        f_p = ph.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam, M)
        torch.cuda.synchronize()
        st = fused_staging(torch, cw, aux, rows_in, wts, scale_rows)
        err = hold_chain_gap(torch, f_k, f_p, st, real, cw, cam, "K9 fused decode")
        del st
        ms, plain_ms = paired_ms(
            torch, lambda: ph.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M),
            lambda: ph.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam, M),
            3)
        print(f"K9 fused decode: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        # per point: the chain, 3 planes x 8 corners x 32 channels of lerp,
        # ~150 FLOPs of projection
        results["fused_decode"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound=bound(nbytes(aux, *rows_in, wts, scale_rows, *weights_of, f_k),
                        M * (chain_flops(cw) + 3 * 8 * 32 * 2 + 150), "bf16"))
        del f_k, f_p, rows_in, wts, aux, table

        # -- cross-route witness: the same planes and GELU on both routes ----
        # Both quantise with the same absmax scales and lerp in f32, so this
        # holds the K10 table, the gather and K8 against K2, at limits from
        # both routes' sound references (hold_cross_route)
        hold_cross_route(torch, dec, weights, planes, rows_slab, ctx, pos, cam,
                         "cross-route: brick route (K10 + gather + K8) vs slab route (K2), "
                         "template order")

        # -- the all-plain brick frame ----------------------------------------
        g = IMAGE // 16
        cap = flagship.flagship_raster_config().tile_capacity
        c0 = torch.zeros((1, 25), dtype=torch.float32, device=dev)

        def plain_brick_frame(z):
            ws = pallas_mapping.mapping_forward_plain(z, c0, bweights.mapping)
            ws = ws[:, None].expand(1, bweights.mapping.num_ws, ws.shape[1])
            pl = G.synthesis_planes(ws, noise_mode="const")
            q, sc = _quantize_int8(pl.float().reshape(n_planes, CD // D, D, H, W))
            tb = (pe.brick_table_plain(pe.padded_channels_last(q), NY), NY, sc)
            ft = sample_from_planes(G.plane_axes, pl, pos[None], box_warp, D, table=tb)[0]
            st, _ = ph.build_brick_staging(ft.mean(0), pos, pos)
            return plain_image(torch, ph.decode_project_plain(cw, st, cam, M), g, cap, dev)

        nprng = np.random.RandomState(seed + 1)
        zs = torch.tensor(nprng.randn(FRAMES + 1, 1, 512).astype(np.float32), device=dev)
        ref_img = plain_brick_frame(zs[0])
        plain_ms = cuda_ms(torch, lambda: plain_brick_frame(zs[0]), 2)

    # -- the brick-route main paths: table (K10 + K8) and fused (K10 + K9) ---
    runs = {}
    for label, d, kernel in (("brick", bdec, ph.decode_project),
                             ("fused", fdec, ph.decode_project_fused)):
        w = bweights if d is bdec else fdec.fold()
        counters = {"mapping": pallas_mapping.mapping_forward, "brick_table": pe.brick_table,
                    ("brick_decode" if d is bdec else "fused_decode"): kernel,
                    "blend_packed_v3": blend_v3_counter(pallas_blend)}
        runs[label] = frame_run(torch, d, w, zs, cp, c2w, counters, FRAMES, init_position=pos)
        _, host_med = report_frames(torch, runs[label], f"{label}-route")
        profile_frames(torch, lambda i, timer, d=d, w=w: flagship.decode_and_render(
            d, w, zs[i + 1], cp, c2w, None, FOV, image_size=IMAGE, init_position=pos,
            stage_timer=timer), host_med, f"{label}-route")
        fr_psnr = psnr(runs[label]["first"][0], ref_img)
        print(f"{label}-route first frame vs the all-plain brick frame: {fr_psnr:.2f} dB")
        require(fr_psnr >= 30.0, f"{label}-route frame disagrees with the plain frame: "
                f"{fr_psnr:.2f} dB")
    print(f"all-plain brick frame (the same stages, the plain versions): {plain_ms:.3f} ms "
          "device")

    # -- the stream: backbone batched STREAM_BATCH at a time ------------------
    zs8 = torch.tensor(nprng.randn(STREAM, 1, 512).astype(np.float32), device=dev)
    with torch.inference_mode():
        flagship.decode_and_render_stream(bdec, bweights, zs8[:STREAM_BATCH], cp, c2w, FOV,
                                          init_position=pos, frame_batch=STREAM_BATCH)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t_host = time.perf_counter()
        start.record()
        frames = flagship.decode_and_render_stream(bdec, bweights, zs8, cp, c2w, FOV,
                                                   init_position=pos, frame_batch=STREAM_BATCH)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3
        stream_ms = start.elapsed_time(end)
        worst = float("inf")
        for i in range(STREAM):
            img, _ = flagship.decode_and_render(bdec, bweights, zs8[i], cp, c2w, None, FOV,
                                                init_position=pos)
            worst = min(worst, psnr(frames[i], img))
    print(f"stream ({STREAM} latents, frame batch {STREAM_BATCH}, brick route): "
          f"{stream_ms / STREAM:.3f} ms device per frame ({1e3 * STREAM / stream_ms:.2f} fps), "
          f"{host_ms / STREAM:.3f} ms host wall per frame; worst frame vs decode_and_render "
          f"{worst:.2f} dB")
    require(worst >= 30.0, f"stream frames disagree with single frames: {worst:.2f} dB")
    launches = {"brick_table": runs["brick"]["launches"]["brick_table"]
                + runs["fused"]["launches"]["brick_table"],
                "brick_decode": runs["brick"]["launches"]["brick_decode"],
                "fused_decode": runs["fused"]["launches"]["fused_decode"]}
    del bdec, fdec, frames
    torch.cuda.empty_cache()
    return launches


def eg3d_phase(torch, seed, results):
    """The EG3D tri-plane generator at full width (flagship_generator("eg3d"):
    z/w 512, 256^2 tri-planes of 3 x 32 channels, depth 1, SR to 512^2;
    width-128 heads, "poly" GELU), seeded random weights, the 500k template
    and the frame's camera over a black background: K2's bilinear form on
    the bilinear slab pack and K9's tri-plane form on the bf16 gathers
    against their plain versions, timed beside them with their bounds, and
    each form's rows bit-identical to K8's on the staging of its plain
    version's features (the lerp's witness); 1 +
    EG3D_FRAMES frames on the slab (K2 bilinear), table (bf16 bilinear
    table + K8) and fused (K9 tri-plane) routes, counters at 0 first, each
    first frame against the all-plain frame of its route, then FRAMES more
    under torch.profiler; then apps/train_decoder.py --generator_arch
    eg3d_ffhq --random_init for 1 + EG3D_TRAIN_STEPS steps (marching level
    the SURFACE_QUANTILE rule) and one profiled step. -> launches of the
    two forms on their routes' frames."""
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.apps import train_decoder
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
        build_plane_table, build_slab_volume, sample_from_planes, sample_fused_inputs)
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    dev = torch.device("cuda:0")
    rng = torch.Generator().manual_seed(seed + 9)
    dec = flagship.flagship_decoder(gen=flagship.flagship_generator("eg3d", rng=rng, device=dev),
                                    rng=rng, device=dev).eval()
    fdec = flagship.flagship_decoder(gen=dec.G, device=dev, fused_sampling=True).eval()
    fdec.load_state_dict(dec.state_dict())
    # the fused route below holds K9's 'bcast' tri-plane form; the default
    # 'dots' runs in dots_route at the end of the phase
    fdec.config = dataclasses.replace(fdec.config, fused_lerp="bcast")
    G = dec.G
    require(G.triplane_depth == 1 and G.variant == "eg3d", "not an EG3D tri-plane generator")
    weights = dec.fold()
    cw = weights.chain
    weights_of = (cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4, cw.meta)
    nprng = np.random.RandomState(seed + 9)
    template = ((nprng.rand(POINTS, 3) - 0.5) * 0.4).astype(np.float32)
    pos = torch.tensor(template, device=dev)
    M, box_warp = POINTS, float(G.rk["box_warp"])
    t0 = time.perf_counter()
    ctx = dec.make_slab_context(template, device=dev)
    print(f"EG3D bilinear slab pack: {time.perf_counter() - t0:.2f} s host, "
          f"{ctx.m_padded // ctx.block} blocks, Mpad {ctx.m_padded}")
    cp, c2w = flagship.default_camera_params(device=dev)
    cam = make_camera(IMAGE, FOV, c2w, device=dev)
    zs = torch.tensor(nprng.randn(EG3D_FRAMES + 2, 1, 512).astype(np.float32), device=dev)
    g = IMAGE // 16
    cap = flagship.flagship_raster_config().tile_capacity
    c0 = torch.zeros((1, 25), dtype=torch.float32, device=dev)
    with torch.inference_mode():
        planes, _ = dec.synthesize_planes(weights, zs[0], cp)
        require(tuple(planes.shape[1:]) == (3, 32, 256, 256), f"planes {tuple(planes.shape)}")

        # -- K2's bilinear form over the full EG3D pack ----------------------
        vol, scales = build_slab_volume(planes, 1)
        rows_k = ph.decode_project_slab(cw, vol, scales, ctx, cam)
        rows_p = ph.decode_project_slab_plain(cw, vol, scales, ctx, cam)
        torch.cuda.synchronize()
        v = ctx.valid > 0
        st = slab_staging(torch, cw, vol, scales, ctx)
        err = hold_chain_gap(torch, rows_k, rows_p, st, v, cw, cam,
                             f"K2 bilinear slab decode (vol {tuple(vol.shape)})")
        require(bool((rows_k[16:28, ~v][[5, 10, 11]] == 0).all()),
                "K2 bilinear: pad slots not culled")
        ms, plain_ms = paired_ms(torch, lambda: ph.decode_project_slab(cw, vol, scales, ctx, cam),
                                 lambda: ph.decode_project_slab_plain(cw, vol, scales, ctx, cam),
                                 3)
        # per point the chain, 3 planes x 4 corners x 32 channels of bilinear
        # lerp, ~150 FLOPs of projection, over the template's points, as
        # the flagship K2 row counts them (the kernel also runs the pack's
        # pad slots: the Mpad figure beside it)
        per_point = chain_flops(cw) + 3 * 4 * 32 * 2 + 150
        b = bound(nbytes(vol, scales, ctx.positions, ctx.idx16, ctx.aux, ctx.inv_axes,
                         *weights_of, rows_k), ctx.n_points * per_point, "bf16")
        b_slots = bound(0, ctx.m_padded * per_point, "bf16")[0]
        print(f"K2 bilinear slab decode: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
              f"{b[0]:.4f} ms over the {ctx.n_points} points ({b[1]}, {b[2]}), {b_slots:.4f} "
              f"ms over Mpad {ctx.m_padded}")
        results["slab_decode_bilinear"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)
        # the lerp's witness: K8 (chain only) on the staging of the plain
        # version's features gives K2's rows bit for bit on the real slots,
        # so K2's features are the plain version's and the gap above is the
        # chain's summation order
        rows_w = ph.decode_project(cw, st.to(torch.bfloat16).contiguous(), cam, ctx.m_padded)
        same = torch.equal(rows_k[:, v], rows_w[:, v])
        print(f"K2 bilinear: rows bit-identical to K8's on the plain features: {same}")
        require(same, "K2 bilinear: its features differ from the plain version's")
        del rows_k, rows_p, rows_w, st

        # -- K9's tri-plane form on the bf16 gathers -------------------------
        aux, Mpad = ph.build_brick_staging(pos.new_zeros((M, ph.C)), pos, pos)
        rows_in, wts, scale_rows = sample_fused_inputs(G.plane_axes, planes, pos[None], box_warp,
                                                       1, pad_to=Mpad)
        require(rows_in[0].dtype == torch.bfloat16 and rows_in[0].shape == (Mpad, 4 * ph.C),
                f"tri-plane rows {rows_in[0].dtype} {tuple(rows_in[0].shape)}")
        real = torch.arange(Mpad, device=dev) < M
        f_k = ph.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M)
        f_p = ph.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam, M)
        torch.cuda.synchronize()
        st = fused_staging(torch, cw, aux, rows_in, wts, scale_rows)
        err = hold_chain_gap(torch, f_k, f_p, st, real, cw, cam, "K9 tri-plane fused decode")
        del st
        ms, plain_ms = paired_ms(
            torch, lambda: ph.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M),
            lambda: ph.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam, M), 3)
        b = bound(nbytes(aux, *rows_in, wts, scale_rows, *weights_of, f_k),
                  M * (chain_flops(cw) + 3 * 4 * 32 * 2 + 150), "bf16")
        print(f"K9 tri-plane fused decode: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
              f"{b[0]:.4f} ms ({b[1]}, {b[2]})")
        results["fused_decode_triplane"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                bound=b)
        st, _ = ph.build_brick_staging(ph.fused_features_plain(rows_in, wts, scale_rows)[:M],
                                       pos, pos)
        same = torch.equal(f_k, ph.decode_project(cw, st, cam, M))
        print(f"K9 tri-plane: rows bit-identical to K8's on the plain features: {same}")
        require(same, "K9 tri-plane: its features differ from the plain version's")
        del st

        # -- the f32 forms of K2's bilinear form and K9's tri-plane form, on
        # an f32 chain of the same heads (held, timed beside their bounds;
        # their frames follow the main paths')
        cw32 = ph.pack_chain(dec.heads(), dec.chain_spec, dec.position_dim, dec.scale_offset,
                             dec.gelu, dtype=torch.float32)
        ctx32 = dataclasses.replace(ctx, aux=ph.build_staging(ctx.positions, ctx.positions,
                                                              ctx.valid, dtype=torch.float32))
        aux32, _ = ph.build_brick_staging(pos.new_zeros((M, ph.C)), pos, pos, dtype=torch.float32)
        weights32 = (cw32.w1, cw32.b1, cw32.w2, cw32.b2, cw32.w3, cw32.b3, cw32.w4, cw32.b4,
                     cw32.meta)
        for label, key, kern, plain, real_r, ins, lerp_flops in (
                ("K2-f32 bilinear slab decode", "slab_decode_bilinear_f32",
                 lambda: ph.decode_project_slab(cw32, vol, scales, ctx32, cam),
                 lambda: ph.decode_project_slab_plain(cw32, vol, scales, ctx32, cam), v,
                 (vol, scales, ctx32.positions, ctx32.idx16, ctx32.aux, ctx32.inv_axes), 4),
                ("K9-f32 tri-plane fused decode", "fused_decode_triplane_f32",
                 lambda: ph.decode_project_fused(cw32, aux32, rows_in, wts, scale_rows, cam, M),
                 lambda: ph.decode_project_fused_plain(cw32, aux32, rows_in, wts, scale_rows,
                                                       cam, M), real,
                 (aux32, *rows_in, wts, scale_rows), 4)):
            rows32 = kern()
            err = hold_decode_f32(torch, rows32, plain(), real_r, cw32, cam, label)
            ms, plain_ms = paired_ms(torch, kern, plain, 2)
            # per point the chain, the 3 x 4-corner lerp of 32 channels and
            # ~150 FLOPs of projection, over the template's points
            b = bound(nbytes(*ins, *weights32, rows32),
                      M * (chain_flops(cw32) + 3 * lerp_flops * 32 * 2 + 150), "tf32x3")
            print(f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound {b[0]:.4f} ms "
                  f"({b[1]}, {b[2]})")
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)
            del rows32
        del f_k, f_p, rows_in, wts, aux, vol, aux32

        # -- the all-plain frames of the three routes -------------------------
        def plain_frame(z, route):
            ws = pallas_mapping.mapping_forward_plain(z, c0, weights.mapping)
            ws = ws[:, None].expand(1, weights.mapping.num_ws, ws.shape[1])
            pl = G.synthesis_planes(ws, noise_mode="const")
            if route == "slab":
                vo, sc = build_slab_volume(pl, 1)
                rows = ph.decode_project_slab_plain(cw, vo, sc, ctx, cam)
            elif route == "table":
                tb = build_plane_table(pl, 1, brick_dtype=torch.bfloat16)
                ft = sample_from_planes(G.plane_axes, pl, pos[None], box_warp, 1, table=tb)[0]
                st, _ = ph.build_brick_staging(ft.mean(0), pos, pos)
                rows = ph.decode_project_plain(cw, st, cam, M)
            else:
                au, mp = ph.build_brick_staging(pos.new_zeros((M, ph.C)), pos, pos)
                ri, wt, sr = sample_fused_inputs(G.plane_axes, pl, pos[None], box_warp, 1,
                                                 pad_to=mp)
                rows = ph.decode_project_fused_plain(cw, au, ri, wt, sr, cam, M)
            return plain_image(torch, rows, g, cap, dev, bg=EG3D_BG)

        ref_imgs = {route: plain_frame(zs[1], route) for route in ("slab", "table", "fused")}

    # -- the EG3D main paths: slab (K2 bilinear), table (K8), fused (K9) ------
    launches = {}
    for route, d, kernel in (("slab", dec, ph.decode_project_slab),
                             ("table", dec, ph.decode_project),
                             ("fused", fdec, ph.decode_project_fused)):
        w = weights if d is dec else fdec.fold()
        kw = {"slab_ctx": ctx} if route == "slab" else {"init_position": pos}
        counters = {"mapping": pallas_mapping.mapping_forward, f"{route}_decode": kernel,
                    "blend_packed_v3": blend_v3_counter(pallas_blend)}
        run = frame_run(torch, d, w, zs[1:], cp, c2w, counters, EG3D_FRAMES, bg=EG3D_BG, **kw)
        label = f"EG3D {route}-route"
        _, host_med = report_frames(torch, run, label)
        profile_frames(torch, lambda i, timer, d=d, w=w, kw=kw: flagship.decode_and_render(
            d, w, zs[1 + i % (EG3D_FRAMES + 1)], cp, c2w, kw.get("slab_ctx"), FOV,
            image_size=IMAGE, bg=EG3D_BG, init_position=kw.get("init_position"),
            stage_timer=timer), host_med, label)
        fr_psnr = psnr(run["first"][0], ref_imgs[route])
        print(f"{label} first frame vs its all-plain frame: {fr_psnr:.2f} dB")
        require(fr_psnr >= 30.0, f"{label} frame disagrees with the plain frame: "
                f"{fr_psnr:.2f} dB")
        launches[route] = run["launches"][f"{route}_decode"]
    # -- the f32 'bcast' forms on their routes: an f32 chain of the same heads
    for route, key, kernel in (("slab", "slab_decode_bilinear_f32", ph.decode_project_slab),
                               ("fused", "fused_decode_triplane_f32", ph.decode_project_fused)):
        d32 = flagship.flagship_decoder(gen=G, device=dev, fused_sampling=route == "fused")
        d32.config = dataclasses.replace(d32.config, heads_bf16=False, fused_lerp="bcast")
        d32.load_state_dict(dec.state_dict())
        d32 = d32.eval()
        kw = {"slab_ctx": ctx32} if route == "slab" else {"init_position": pos}
        counters = {key: FormCount(kernel, "launches_f32")}
        run = frame_run(torch, d32, d32.fold(), zs[1:], cp, c2w, counters, 1, bg=EG3D_BG, **kw)
        report_frames(torch, run, f"EG3D {route}-route (f32 heads)")
        launches[key] = run["launches"][key]
        del d32, run
    del fdec, weights, ctx, ctx32, planes, ref_imgs
    torch.cuda.empty_cache()

    # -- K9's 'dots' tri-plane forms on the fused route: the flagship decoder's
    # bf16 chain, then an f32 chain of the same heads ---------------------------
    for chain, n, key in (("bf16", EG3D_FRAMES, "fused_decode_triplane_dots"),
                          ("f32", 1, "fused_decode_triplane_dots_f32")):
        ddec = flagship.flagship_decoder(gen=G, device=dev, fused_sampling=True).eval()
        ddec.config = dataclasses.replace(ddec.config, heads_bf16=chain == "bf16")
        ddec.load_state_dict(dec.state_dict())
        launches[key] = dots_route(torch, ddec, pos, cam, cp, c2w, zs[1:], n, key, results,
                                   f"EG3D ({chain} heads)", bg=EG3D_BG)
        del ddec
    del dec
    torch.cuda.empty_cache()

    # -- the EG3D train step: apps/train_decoder.py --generator_arch eg3d_ffhq -
    gen = flagship.flagship_generator("eg3d", rng=torch.Generator().manual_seed(seed))
    z0 = torch.randn((1, gen.z_dim), generator=torch.Generator().manual_seed(1)).to(dev)
    level, n_faces = surface_level(torch, gen, z0, 128, 2 ** 20)
    del gen
    print(f"EG3D surface level {level:.4f} ({SURFACE_QUANTILE} quantile of the first latent's "
          f"128^3 sigma grid): {n_faces} faces")
    require(n_faces > 0, "EG3D: no surface at the chosen level")
    run = train_decoder.build(train_decoder.build_argparser().parse_args(
        ["--generator_arch", "eg3d_ffhq", "--random_init", "--seed", str(seed),
         "--mc_level", repr(level)]))
    require(run.gen.variant == "eg3d" and run.cfg.bg_color == EG3D_BG, "not the eg3d_ffhq preset")
    tr = train_path(torch, run, EG3D_TRAIN_STEPS)
    step_dev = sorted(d for d, _ in tr["step_ms"])
    step_host = sorted(h for _, h in tr["step_ms"])
    step_med, step_host_med = step_dev[len(step_dev) // 2], step_host[len(step_host) // 2]
    print(f"EG3D train step (500k points, 512^2): median {step_med:.3f} ms device, "
          f"{step_host_med:.3f} ms host wall; losses "
          + ", ".join(f"{v:.5f}" for v in tr["losses"])
          + f"; first step {tr['n_pairs']} pairs; launches {tr['launches']}")
    print("EG3D train stage split (median ms): "
          + ", ".join(f"{n} {t:.3f}" for n, t in stage_split(torch, tr["stage_ms"]).items()))
    print(f"EG3D peak device memory (train path): {tr['peak'] / 2 ** 30:.3f} GiB")
    busy_ms, on_card = profile_step(torch, run, tr["state"], tr["draws"][0], tr["zs"][0],
                                    EG3D_TRAIN_STEPS + 1)
    require(busy_ms > 0, "the profiler saw no device time in the EG3D train step")
    print(f"EG3D profiler: {busy_ms:.3f} ms device time in one train step, busy "
          f"{busy_ms / step_host_med:.3f} of the median host-wall step; largest: "
          + "; ".join(f"{k[:48]} {t:.3f} ms ({t / busy_ms:.1%})" for t, k in on_card[:6]))
    del run, tr
    torch.cuda.empty_cache()
    return {"slab_decode_bilinear": launches["slab"],
            "fused_decode_triplane": launches["fused"],
            "fused_decode_triplane_dots": launches["fused_decode_triplane_dots"],
            "fused_decode_triplane_dots_f32": launches["fused_decode_triplane_dots_f32"],
            "slab_decode_bilinear_f32": launches["slab_decode_bilinear_f32"],
            "fused_decode_triplane_f32": launches["fused_decode_triplane_f32"]}


def hold_heads_train(torch, captured, label):
    """K6 and K7 against their plain versions on a train step's own inputs
    and cotangent, at train_kernels' limits (K7 twice: bit-identical)."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads, pallas_heads_vjp
    with torch.no_grad():
        st, cw = captured["heads_fwd"]
        o_k = pallas_heads.decode_heads(st, cw)
        o_p = pallas_heads.decode_heads_plain(st, cw)
        st, out16, dout, cw = captured["heads_bwd"]
        dst_k, g_k = pallas_heads_vjp.decode_heads_bwd(st, out16, dout, cw)
        dst_2, g_2 = pallas_heads_vjp.decode_heads_bwd(st, out16, dout, cw)
        dst_p, g_p = pallas_heads_vjp.decode_heads_bwd_plain(st, out16, dout, cw)
        torch.cuda.synchronize()
    rel6 = float((o_k - o_p).abs().max() / o_p.abs().max())
    same = torch.equal(dst_k, dst_2) and all(torch.equal(a, b) for a, b in zip(g_k, g_2))
    rel7 = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip((dst_k, *g_k), (dst_p, *g_p)))
    print(f"{label}: K6 vs plain {rel6:.3e} of max ({st.shape[0]} points, chain "
          f"{[c[:3] for c in cw.chain]}); K7 worst {rel7:.3e} of each gradient's max, two "
          f"launches bit-identical: {same}")
    require(rel6 <= 1e-5, f"{label}: K6 disagrees: {rel6:.3e}")
    require(rel7 <= 1e-3 and same, f"{label}: K7 disagrees ({rel7:.3e}) or is not repeatable")


def decoder_options_phase(torch, seed, template, results):
    """The decoder's other types and options at full width: the PanoHead
    flagship generator (seeded), the 500k template, 512^2, and three
    decoders of its weights' generator with seeded heads:
      D-par: decoder_type 'parallel', the xyz embedding (P = 63), f32 heads
        (the JAX GaussianDecoder's default dtype), exact GELU;
      D-seq: 'sequential' (the real camera at the mapping, scale offset -2),
        bf16 heads, "poly" GELU;
      the flagship decoder ('sequential_reversed', bf16, "poly").
    For D-par and D-seq: each route's decode kernel (K2, K8, K9: f32 forms
    for D-par, bf16 for D-seq, the parallel chain's write-back guard)
    against its plain version, timed; 1 + OPT_FRAMES frames on the slab,
    table and fused routes (each counted kernel form launched in every
    frame, each first frame against the route's all-plain frame), FRAMES
    profiled frames each. D-seq's mapping with the real camera against its
    plain version bit for bit. decode_packed / apply_packed on the flagship
    decoder (K6's bf16 form) and on D-par (K6 f32) against their plain
    versions. Then apps/train_decoder.py --random_init with --decoder_type
    parallel --use_pos_encoding and with --decoder_type sequential for 1 +
    OPT_TRAIN_STEPS steps each and one profiled step, K6 / K7 held on each
    step's own inputs. -> the launches of the four new kernel forms on
    their main paths."""
    import tempfile
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.apps import train_decoder
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand as pe
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
        _quantize_int8, build_plane_table, build_slab_volume, sample_from_planes,
        sample_fused_inputs)
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    dev = torch.device("cuda:0")
    rng = torch.Generator().manual_seed(seed + 21)
    gen = flagship.flagship_generator(rng=rng, device=dev).eval()
    pos = torch.tensor(template, device=dev)
    M, D, box_warp = POINTS, gen.triplane_depth, float(gen.rk["box_warp"])
    cp, c2w = flagship.default_camera_params(device=dev)
    # the sequential decoder maps the real camera: a non-frontal one
    cp_real = cp.clone()
    cp_real[0, :16] = torch.tensor(np.asarray(
        [[0.9, 0.0, 0.4359, 1.18], [0.0, 1.0, 0.0, 0.0], [-0.4359, 0.0, 0.9, 2.43],
         [0.0, 0.0, 0.0, 1.0]], np.float32).reshape(-1), device=dev)
    cam = make_camera(IMAGE, FOV, c2w, device=dev)
    nprng = np.random.RandomState(seed + 21)
    zs = torch.tensor(nprng.randn(OPT_FRAMES + 2, 1, 512).astype(np.float32), device=dev)
    g = IMAGE // 16
    cap = flagship.flagship_raster_config().tile_capacity
    launches = {}

    def decoder(decoder_type, emb, bf16, gelu, fused=False, lerp="bcast"):
        # the routes below hold K9's 'bcast' forms; D-par's 'dots' runs in
        # dots_route
        d = GaussianDecoder(gen, gelu=gelu, rng=torch.Generator().manual_seed(seed + 22),
                            device=dev, fused_sampling=fused, decoder_type=decoder_type,
                            use_xyz_embedding=emb, heads_bf16=bf16, fused_lerp=lerp)
        return d.eval()

    def plain_frame(d, w, ctx, z, route):
        """The frame's stages with the plain versions: mapping on the type's
        camera, synthesis, the route's plain decode, binning and the plain
        blend."""
        ws = pallas_mapping.mapping_forward_plain(z, d.mapping_condition(cp_real), w.mapping)
        ws = ws[:, None].expand(1, w.mapping.num_ws, ws.shape[1])
        pl = gen.synthesis_planes(ws, noise_mode="const")
        cw, dt = w.chain, ph.chain_dtype(w.chain)
        if route == "slab":
            vo, sc = build_slab_volume(pl, D)
            rows = ph.decode_project_slab_plain(cw, vo, sc, ctx, cam)
        else:
            n_planes, CD, H, W = pl.shape[1:]
            q, qs = _quantize_int8(pl.float().reshape(n_planes, CD // D, D, H, W))
            NY = pe.table_rows_ny(H, 1)
            tb = (pe.brick_table_plain(pe.padded_channels_last(q), NY), NY, qs)
            if route == "table":
                ft = sample_from_planes(gen.plane_axes, pl, pos[None], box_warp, D, table=tb)[0]
                st, _ = ph.build_brick_staging(ft.mean(0), d.cond0(pos), pos, dtype=dt)
                rows = ph.decode_project_plain(cw, st, cam, M)
            else:
                au, mp = ph.build_brick_staging(pos.new_zeros((M, ph.C)), d.cond0(pos), pos,
                                                dtype=dt)
                ri, wt, sr = sample_fused_inputs(gen.plane_axes, pl, pos[None], box_warp, D,
                                                 table=tb, pad_to=mp)
                rows = ph.decode_project_fused_plain(cw, au, ri, wt, sr, cam, M)
        return plain_image(torch, rows, g, cap, dev)

    cache = tempfile.mkdtemp(prefix="slab_pack_")
    forms = {"slab": ph.decode_project_slab, "table": ph.decode_project,
             "fused": ph.decode_project_fused}
    names = {"slab": "slab_decode", "table": "brick_decode", "fused": "fused_decode"}
    for label, (decoder_type, emb, bf16, gelu) in (
            ("D-par", ("parallel", True, False, "exact")),
            ("D-seq", ("sequential", False, True, "poly"))):
        dec = decoder(decoder_type, emb, bf16, gelu)
        fdec = decoder(decoder_type, emb, bf16, gelu, fused=True)
        fdec.load_state_dict(dec.state_dict())
        w = dec.fold()
        cw = w.chain
        dt = ph.chain_dtype(cw)
        require(dt == (torch.bfloat16 if bf16 else torch.float32), f"{label}: chain {dt}")
        if decoder_type == "parallel":
            require(all(sc == ph.STAGE for _, _, sc, _ in cw.chain),
                    f"{label}: the parallel chain writes back: {cw.chain}")
        t0 = time.perf_counter()
        ctx = dec.make_slab_context(template, device=dev, cache_dir=cache)
        print(f"{label}: slab context {time.perf_counter() - t0:.2f} s host (staging "
              f"{ctx.aux.dtype}, P {dec.position_dim}); chain {cw.chain}")
        weights_of = (cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4, cw.meta)
        hold = hold_decode if bf16 else hold_decode_f32
        kind = "bf16" if bf16 else "tf32x3"
        per_point = chain_flops(cw) + 150
        with torch.inference_mode():
            planes, _ = dec.synthesize_planes(w, zs[0], cp_real)
            if decoder_type == "sequential":
                # K1 on the preconditioned real camera, bit for bit
                c = dec.mapping_condition(cp_real)
                require(bool(c.any()), "the flagship zeroes the camera")
                ws_k = pallas_mapping.mapping_forward(zs[0], c, w.mapping)[:, 0]
                ws_p = pallas_mapping.mapping_forward_plain(zs[0], c, w.mapping)
                torch.cuda.synchronize()
                same = torch.equal(ws_k, ws_p)
                print(f"{label}: K1 on the real camera (c * c_scale) vs its plain version: "
                      f"bit-identical {same}, max|d| {float((ws_k - ws_p).abs().max()):.3e}")
                require(same, f"{label}: K1 differs from its plain version on the real camera")
            # -- the three routes' decode kernels against their plain versions
            vol, scales = build_slab_volume(planes, D)
            table = build_plane_table(planes, D, brick_dtype=torch.int8)
            feats = sample_from_planes(gen.plane_axes, planes, pos[None], box_warp, D,
                                       table=table)[0]
            staging, Mpad = ph.build_brick_staging(feats.mean(0), dec.cond0(pos), pos, dtype=dt)
            aux, _ = ph.build_brick_staging(pos.new_zeros((M, ph.C)), dec.cond0(pos), pos,
                                            dtype=dt)
            rows_in, wts, scale_rows = sample_fused_inputs(gen.plane_axes, planes, pos[None],
                                                           box_warp, D, table=table, pad_to=Mpad)
            real = torch.arange(Mpad, device=dev) < M
            calls = {
                "slab": (lambda: ph.decode_project_slab(cw, vol, scales, ctx, cam),
                         lambda: ph.decode_project_slab_plain(cw, vol, scales, ctx, cam),
                         ctx.valid > 0, ctx.n_points * (per_point + 3 * 8 * 32 * 2),
                         (vol, scales, ctx.positions, ctx.idx16, ctx.aux, ctx.inv_axes)),
                "table": (lambda: ph.decode_project(cw, staging, cam, M),
                          lambda: ph.decode_project_plain(cw, staging, cam, M),
                          real, M * per_point, (staging,)),
                "fused": (lambda: ph.decode_project_fused(cw, aux, rows_in, wts, scale_rows,
                                                          cam, M),
                          lambda: ph.decode_project_fused_plain(cw, aux, rows_in, wts,
                                                                scale_rows, cam, M),
                          real, M * (per_point + 3 * 8 * 32 * 2),
                          (aux, *rows_in, wts, scale_rows)),
            }
            for route, (kern, plain, real_r, flops, ins) in calls.items():
                rows_k, rows_p = kern(), plain()
                torch.cuda.synchronize()
                err = hold(torch, rows_k, rows_p, real_r, cw, cam,
                           f"{label} {names[route]} ({'bf16' if bf16 else 'f32'})")
                ms, plain_ms = paired_ms(torch, kern, plain, 3)
                b = bound(nbytes(*ins, *weights_of, rows_k), flops, kind)
                print(f"{label} {names[route]}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                      f"bound {b[0]:.4f} ms over the {M} points ({b[1]}, {b[2]})"
                      + (f", {b[0] * ctx.m_padded / M:.4f} ms over Mpad {ctx.m_padded}"
                         if route == "slab" and b[1] == "operations" else ""))
                if not bf16:
                    results[f"{names[route]}_f32"] = dict(max_abs_err=err, ms=ms,
                                                          plain_ms=plain_ms, bound=b)
                del rows_k, rows_p
            ref_imgs = {route: plain_frame(dec, w, ctx, zs[1], route) for route in forms}
            del vol, scales, table, feats, staging, aux, rows_in, wts, planes

        # -- the frames: slab, table and fused routes -------------------------
        for route, fn in forms.items():
            d = fdec if route == "fused" else dec
            wr = fdec.fold() if route == "fused" else w
            kw = {"slab_ctx": ctx} if route == "slab" else {"init_position": pos}
            form = f"{names[route]}{'' if bf16 else '_f32'}"
            counters = {"mapping": pallas_mapping.mapping_forward,
                        form: FormCount(fn, "launches" if bf16 else "launches_f32"),
                        "blend_packed_v3": blend_v3_counter(pallas_blend)}
            if route != "slab":
                counters["brick_table"] = pe.brick_table
            run = frame_run(torch, d, wr, zs[1:], cp_real, c2w, counters, OPT_FRAMES, **kw)
            rlabel = f"{label} {route}-route"
            _, host_med = report_frames(torch, run, rlabel)
            profile_frames(torch, lambda i, timer, d=d, wr=wr, kw=kw: flagship.decode_and_render(
                d, wr, zs[1 + i % (OPT_FRAMES + 1)], cp_real, c2w, kw.get("slab_ctx"), FOV,
                image_size=IMAGE, init_position=kw.get("init_position"), stage_timer=timer),
                host_med, rlabel)
            fr_psnr = psnr(run["first"][0], ref_imgs[route])
            print(f"{rlabel} first frame vs its all-plain frame: {fr_psnr:.2f} dB")
            require(fr_psnr >= 30.0, f"{rlabel} frame disagrees with the plain frame: "
                    f"{fr_psnr:.2f} dB")
            if not bf16:
                launches[form] = run["launches"][form]
        if label == "D-par":
            # K9's 'dots' lerp at f32 heads (the JAX decoder's default)
            ddec = decoder(decoder_type, emb, bf16, gelu, fused=True, lerp="dots")
            ddec.load_state_dict(dec.state_dict())
            launches["fused_decode_dots_f32"] = dots_route(
                torch, ddec, pos, cam, cp_real, c2w, zs[1:], OPT_FRAMES, "fused_decode_dots_f32",
                results, label)
            del ddec
        del ref_imgs, ctx, dec, fdec
        torch.cuda.empty_cache()

    # -- decode_packed: the flagship decoder (K6 bf16) and D-par (K6 f32) -----
    # the flagship decoder's heads from their own seeded stream
    fdec_rng = torch.Generator().manual_seed(seed + 22)
    for label, d in (("flagship decoder", flagship.flagship_decoder(gen=gen, device=dev,
                                                                    rng=fdec_rng)),
                     ("D-par", decoder("parallel", True, False, "exact"))):
        d = d.eval()
        w = d.fold()
        cw = w.chain
        bf16 = ph.chain_dtype(cw) == torch.bfloat16
        counter = FormCount(ph.decode_heads, "launches_bf16" if bf16 else "launches")
        with torch.inference_mode():
            counter.launches = 0
            outs = [d.apply_packed(w, zs[i], cp, pos)[0] for i in range(OPT_FRAMES + 1)]
            torch.cuda.synchronize()
            n = counter.launches
            require(n == OPT_FRAMES + 1, f"{label}: K6 launched {n} times in "
                    f"{OPT_FRAMES + 1} apply_packed calls")
            planes, _ = d.synthesize_planes(w, zs[0], cp)
            if bf16:
                # decode_from_planes on the flagship decoder's route
                # (pallas_heads without pallas_heads_train): K6's bf16 form
                # on the float sample's staging
                require(d.pallas_heads and not d.pallas_heads_train, f"{label}: {d.config}")
                counter.launches = 0
                dfp = d.decode_from_planes(planes, pos)
                n_dfp = counter.launches
                fs = sample_from_planes(gen.plane_axes, planes, pos[None], box_warp, D)[0]
                sf, _ = ph.build_brick_staging(fs.mean(0).float(), d.cond0(pos), pos,
                                               dtype=torch.bfloat16)
                of = ph.decode_heads(sf, cw)
                torch.cuda.synchronize()
                require(n_dfp == 1 and all(torch.equal(dfp[k], of[:M, c:c + nc])
                                           for k, (c, nc) in d.layout.items()),
                        f"{label}: decode_from_planes did not run K6's bf16 form once "
                        f"({n_dfp} launches)")
                print(f"{label} decode_from_planes (pallas_heads, bf16): K6 bf16 launched "
                      f"{n_dfp} time, outputs equal to K6 on its staging")
                del dfp, fs, sf, of
            table = build_plane_table(planes, D, brick_dtype=torch.int8)
            feats = sample_from_planes(gen.plane_axes, planes, pos[None], box_warp, D,
                                       table=table)[0]
            st, _ = ph.build_brick_staging(feats.mean(0), d.cond0(pos), pos,
                                           dtype=ph.chain_dtype(cw))
            o_k, o_p = ph.decode_heads(st, cw), ph.decode_heads_plain(st, cw)
            torch.cuda.synchronize()
            require(torch.equal(o_k, outs[0]), f"{label}: decode_packed is not K6 on its staging")
            col = ((o_k - o_p)[:M, :14].abs().amax(dim=0)
                   / o_p[:M, :14].abs().amax(dim=0).clamp(min=1e-3))
            err = float((o_k - o_p)[:M].abs().max())
            # bf16: limits from the staging's two sound references, with a
            # control that must fail them (hold_heads_gap); f32: 1e-5
            lim = (hold_heads_gap(torch, o_k, o_p, st, cw, M, f"{label} decode_packed (K6 bf16)")[1]
                   if bf16 else 1e-5)
            print(f"{label} decode_packed (K6 {'bf16' if bf16 else 'f32'}): worst column-relative "
                  f"{float(col.max()):.3e} (limit {lim:.3e}); launches {n} in {OPT_FRAMES + 1} "
                  f"apply_packed")
            require(float(col.max()) <= lim and not bool(o_k[:, 14:].any()),
                    f"{label}: K6 disagrees with its plain version: {col.tolist()}")
            ms, plain_ms = paired_ms(torch, lambda: ph.decode_heads(st, cw),
                                     lambda: ph.decode_heads_plain(st, cw), 3)
            weights_of = (cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4, cw.meta)
            b = bound(nbytes(st, o_k, *weights_of), st.shape[0] * chain_flops(cw),
                      "bf16" if bf16 else "tf32x3")
            print(f"{label} K6 ({'bf16' if bf16 else 'f32'}) on {st.shape[0]} points: kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}, {b[2]})")
            if bf16:
                results["heads_fwd_bf16"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                 bound=b)
                launches["heads_fwd_bf16"] = n
            del outs, planes, table, feats, st, o_k, o_p
        del d
    del gen
    torch.cuda.empty_cache()

    # -- the trainer with the options: 1 + OPT_TRAIN_STEPS steps each ---------
    fgen = flagship.flagship_generator(rng=torch.Generator().manual_seed(seed))
    z0 = torch.randn((1, fgen.z_dim), generator=torch.Generator().manual_seed(1)).to(dev)
    level, _ = surface_level(torch, fgen, z0, 128, 2 ** 20)
    del fgen
    for flags in (["--decoder_type", "parallel", "--use_pos_encoding"],
                  ["--decoder_type", "sequential"]):
        run = train_decoder.build(train_decoder.build_argparser().parse_args(
            ["--random_init", "--seed", str(seed), "--mc_level", repr(level)] + flags))
        tlabel = "train " + " ".join(flags)
        require(run.decoder.decoder_type == flags[1] and not run.decoder.heads_bf16,
                f"{tlabel}: decoder {run.decoder.config}")
        tr = train_path(torch, run, OPT_TRAIN_STEPS)
        step_dev = sorted(d for d, _ in tr["step_ms"])
        step_host = sorted(h for _, h in tr["step_ms"])
        print(f"{tlabel} (500k points, 512^2): median {step_dev[len(step_dev) // 2]:.3f} ms "
              f"device, {step_host[len(step_host) // 2]:.3f} ms host wall; losses "
              + ", ".join(f"{v:.5f}" for v in tr["losses"])
              + f"; first step {tr['n_pairs']} pairs; launches {tr['launches']}")
        print(f"{tlabel} stage split (median ms): "
              + ", ".join(f"{n} {t:.3f}" for n, t in stage_split(torch, tr["stage_ms"]).items()))
        print(f"{tlabel} peak device memory: {tr['peak'] / 2 ** 30:.3f} GiB")
        busy_ms, on_card = profile_step(torch, run, tr["state"], tr["draws"][0], tr["zs"][0],
                                        OPT_TRAIN_STEPS + 1)
        require(busy_ms > 0, f"{tlabel}: the profiler saw no device time")
        print(f"{tlabel} profiler: {busy_ms:.3f} ms device time in one train step, busy "
              f"{busy_ms / step_host[len(step_host) // 2]:.3f} of the median host-wall step; "
              "largest: " + "; ".join(f"{k[:48]} {t:.3f} ms ({t / busy_ms:.1%})"
                                      for t, k in on_card[:6]))
        hold_heads_train(torch, tr["captured"], tlabel)
        del run, tr
        torch.cuda.empty_cache()
    return launches

def dots_route(torch, d, pos, cam, cp, c2w, zs, frames, key, results, label, bg=None):
    """K9's 'dots' lerp (the JAX decoder's default fused_lerp) on decoder
    d's fused route: the kernel against its plain version on the planes of
    zs[0] (sample_fused_inputs), timed beside it with its bound; a bf16
    form's rows bit-identical to K8's on the staging of the plain 'dots'
    features (the lerp's witness), then held by hold_chain_gap (an f32
    form by hold_decode_f32); then 1 + frames frames of
    decode_and_render from zs, the form's own launch counter at 0 first, the
    first frame against its all-plain frame by PSNR. -> the form's launches
    in those frames."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand as pe
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
        _quantize_int8, build_plane_table, sample_fused_inputs)
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    require(d.fused_sampling and d.fused_lerp == "dots", f"{label}: {d.config}")
    dev, G, M = pos.device, d.G, pos.shape[0]
    D, box_warp = G.triplane_depth, float(G.rk["box_warp"])
    K = ph.CORNERS if D > 1 else 4
    w = d.fold()
    cw = w.chain
    dt = ph.chain_dtype(cw)
    bf16 = dt == torch.bfloat16
    weights_of = (cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4, cw.meta)
    g = IMAGE // 16
    with torch.inference_mode():
        planes, _ = d.synthesize_planes(w, zs[0], cp)
        cond = d.cond0(pos)
        aux, Mpad = ph.build_brick_staging(pos.new_zeros((M, ph.C)), cond, pos, dtype=dt)
        rows_in, wts, scale_rows = sample_fused_inputs(
            G.plane_axes, planes, pos[None], box_warp, D, table=d._brick_table(planes),
            pad_to=Mpad)
        real = torch.arange(Mpad, device=dev) < M

        def kern():
            return ph.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M, lerp="dots")

        def plain():
            return ph.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam, M,
                                                 lerp="dots")

        f_k, f_p = kern(), plain()
        torch.cuda.synchronize()
        form = f"{label} K9-dots ({K} corners, {'bf16' if bf16 else 'f32'} chain)"
        if bf16:
            # the lerp's witness first: K8 (the chain alone) on the staging
            # of the plain 'dots' features gives these rows bit for bit
            st, _ = ph.build_brick_staging(
                ph.fused_features_plain(rows_in, wts, scale_rows, "dots")[:M], cond, pos)
            same = torch.equal(f_k, ph.decode_project(cw, st, cam, M))
            print(f"{form}: rows bit-identical to K8's on the plain 'dots' features: {same}")
            require(same, f"{form}: its features differ from the plain version's")
            # so the gap to the plain version is the chain's (K8's on this
            # staging), held against the staging's own sound references
            err = hold_chain_gap(torch, f_k, f_p, st, real, cw, cam, form)
            del st
        else:
            err = hold_decode_f32(torch, f_k, f_p, real, cw, cam, form)
        ms, plain_ms = paired_ms(torch, kern, plain, 3 if bf16 else 2)
        # per point: the chain, 3 planes x K corners x 32 channels of lerp
        # (product, scale, sum), ~150 FLOPs of projection
        b = bound(nbytes(aux, *rows_in, wts, scale_rows, *weights_of, f_k),
                  M * (chain_flops(cw) + 3 * K * 32 * 3 + 150), "bf16" if bf16 else "tf32x3")
        print(f"{form}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound {b[0]:.4f} ms "
              f"({b[1]}, {b[2]})")
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)
        del f_k, f_p, rows_in, wts, planes
        # the all-plain frame of zs[0]: plain mapping, synthesis, plain table,
        # the plain 'dots' decode, binning and the plain blend
        ws = pallas_mapping.mapping_forward_plain(zs[0], d.mapping_condition(cp), w.mapping)
        pl = G.synthesis_planes(ws[:, None].expand(1, w.mapping.num_ws, ws.shape[1]),
                                noise_mode="const")
        if D > 1:
            n_planes, CD, H, W = pl.shape[1:]
            q, qs = _quantize_int8(pl.float().reshape(n_planes, CD // D, D, H, W))
            NY = pe.table_rows_ny(H, 1)
            tb = (pe.brick_table_plain(pe.padded_channels_last(q), NY), NY, qs)
        else:
            tb = build_plane_table(pl, 1, brick_dtype=torch.bfloat16)
        ri, wt, sr = sample_fused_inputs(G.plane_axes, pl, pos[None], box_warp, D, table=tb,
                                         pad_to=Mpad)
        ref_img = plain_image(torch, ph.decode_project_fused_plain(cw, aux, ri, wt, sr, cam, M,
                                                                   lerp="dots"),
                              g, flagship_cap(), dev, bg=bg)
        del pl, tb, ri, wt, sr
    counters = {"mapping": pallas_mapping.mapping_forward,
                key: FormCount(ph.decode_project_fused,
                               "launches_dots" if bf16 else "launches_dots_f32"),
                "blend_packed_v3": blend_v3_counter(pallas_blend)}
    if D > 1:
        counters["brick_table"] = pe.brick_table
    run = frame_run(torch, d, w, zs, cp, c2w, counters, frames, init_position=pos,
                    **({"bg": bg} if bg is not None else {}))
    report_frames(torch, run, f"{label} fused-route ('dots')")
    fr_psnr = psnr(run["first"][0], ref_img)
    print(f"{label} fused-route ('dots') first frame vs its all-plain frame: {fr_psnr:.2f} dB")
    require(fr_psnr >= 30.0, f"{label} 'dots' frame disagrees with the plain frame: "
            f"{fr_psnr:.2f} dB")
    del ref_img, aux
    torch.cuda.empty_cache()
    return run["launches"][key]


def flagship_cap():
    from gaussian_gan_decoder_tpu_torch import flagship
    return flagship.flagship_raster_config().tile_capacity


def blend_config(fmt, mxu):
    """The RasterizeConfig of one K3 form at the flagship's capacity and
    static copies (the packed forms with the fused key, as JAX pairs them;
    packed_v3 without mxu_power is flagship_raster_config())."""
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
    packed = fmt.startswith("packed")
    return RasterizeConfig(tile_size=16, tile_capacity=flagship_cap(), static_copies=2,
                           bf16_colors=fmt != "f32", packed_payloads=packed,
                           rgb10_payloads=fmt == "packed_v3", fused_sort_key=packed,
                           blend_mxu_power=mxu)


def frame_options_phase(torch, dec, weights, rows_k, ctx, template, cam, cp, c2w, seed,
                        results):
    """The JAX flagship frame's own settings and the last TPU kernel forms,
    on the flagship slab decoder, template and camera:
      - slab frames in every K3 form (blend_config: f32, bf16_colors,
        packed_v2, packed_v3 = flagship_raster_config(), and the packed two
        with mxu_power), counters at 0 first: 1 + FRAMES frames and FRAMES
        profiled ones for packed_v3 and f32 (device time, host wall, busy
        share, the binning and blend stages, the pair count), 1 + 1 for the
        others; each first frame against the all-plain frame (plain mapping,
        synthesis and decode, the plain K3 of that form) by PSNR;
      - every K3 form but f32 (held in the main phase on the same pairs) on
        the binned pairs of one frame's kernel rows, against its plain
        version, timed (queued events) beside it, bound by the bytes of its
        payload words and the live evaluations;
      - K9's 'dots' lerp on the flagship fused route (dots_route);
      - K10's select form on the frame's int8 tri-grid: byte-identical to
        K10's table and its plain version, timed beside them and beside
        torch.cat of the 8 views; 1 + 1 table-route frames with
        pallas_sampling "select", each image equal to pallas_sampling True's.
    -> the launches of these forms on their frames."""
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand as pe
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
        _quantize_int8, build_slab_volume)
    from gaussian_gan_decoder_tpu_torch.splat import fast_raster, pallas_blend
    dev = rows_k.device
    G = dec.G
    D = G.triplane_depth
    g, cap = IMAGE // 16, flagship_cap()
    pos = torch.tensor(template, device=dev)
    nprng = np.random.RandomState(seed + 31)
    zs = torch.tensor(nprng.randn(FRAMES + 1, 1, 512).astype(np.float32), device=dev)
    c0 = torch.zeros((1, 25), dtype=torch.float32, device=dev)
    require(blend_config("packed_v3", False) == flagship.flagship_raster_config(),
            "packed_v3 is not the flagship raster config")
    launches, frame_ms = {}, {}
    with torch.inference_mode():
        ws = pallas_mapping.mapping_forward_plain(zs[0], c0, weights.mapping)
        pl = G.synthesis_planes(ws[:, None].expand(1, weights.mapping.num_ws, ws.shape[1]),
                                noise_mode="const")
        vo, sc = build_slab_volume(pl, D)
        rows_plain = ph.decode_project_slab_plain(weights.chain, vo, sc, ctx, cam)
        del pl, vo, sc

    # -- slab frames in every K3 form ----------------------------------------
    for name, (fmt, mxu) in K3_FORMS.items():
        cfg = blend_config(fmt, mxu)
        main = name in ("blend", "blend_packed_v3")
        counters = {"mapping": pallas_mapping.mapping_forward,
                    "slab_decode": ph.decode_project_slab,
                    name: FormCount(pallas_blend.blend_tiles,
                                    "launches" if fmt == "f32"
                                    else f"launches_{pallas_blend.blend_form(fmt, mxu)}")}
        run = frame_run(torch, dec, weights, zs, cp, c2w, counters, FRAMES if main else 1,
                        slab_ctx=ctx, raster_cfg=cfg)
        label = f"slab frame, K3 {name}"
        frame_ms[name] = report_frames(torch, run, label) + (run["first"][2],)
        if main:
            profile_frames(torch, lambda i, timer, cfg=cfg: flagship.decode_and_render(
                dec, weights, zs[1 + i % FRAMES], cp, c2w, ctx, FOV, image_size=IMAGE,
                raster_cfg=cfg, stage_timer=timer), frame_ms[name][1], label)
        with torch.inference_mode():
            ref = plain_image(torch, rows_plain, g, cap, dev, cfg=cfg)
        fr_psnr = psnr(run["first"][0], ref)
        print(f"{label}: first frame vs its all-plain frame {fr_psnr:.2f} dB")
        require(fr_psnr >= 30.0, f"{label}: the frame disagrees with its plain frame")
        launches[name] = run["launches"][name]
    (v3_dev, v3_host, v3_pairs), (f_dev, f_host, f_pairs) = (frame_ms["blend_packed_v3"],
                                                              frame_ms["blend"])
    print(f"slab frame, packed_v3 + fused key (the flagship's) vs f32 payloads: device "
          f"{v3_dev:.3f} vs {f_dev:.3f} ms, host wall {v3_host:.3f} vs {f_host:.3f} ms, pairs "
          f"{v3_pairs} vs {f_pairs}")
    del rows_plain

    # -- K3's forms on one frame's binned pairs -------------------------------
    with torch.inference_mode():
        for name, (fmt, mxu) in K3_FORMS.items():
            if name == "blend":
                continue
            cfg = blend_config(fmt, mxu)
            starts, attrs = fast_raster.bin_pairs(rows_k, g, g, 16, cfg)

            def kern(starts=starts, attrs=attrs, fmt=fmt, mxu=mxu):
                return pallas_blend.blend_tiles(starts, attrs, g, g, 16, cap, fmt, mxu)

            def plain(starts=starts, attrs=attrs, fmt=fmt, mxu=mxu):
                return pallas_blend.blend_tiles_plain(starts, attrs, g, g, 16, cap, fmt, mxu)

            (acc_k, tr_k), (acc_p, tr_p) = kern(), plain()
            torch.cuda.synchronize()
            dpix = torch.maximum((acc_k - acc_p).abs().amax(dim=2), (tr_k - tr_p).abs())
            err, frac = float(dpix.max()), float((dpix <= 1e-4).float().mean())
            ev_ms, plain_ms = paired_ms(torch, kern, plain, 5)
            ms = queued_ms(torch, kern, 20)
            # the live evaluations, on the unpacked fields at global pixel
            # coordinates (the packed forms' are tile-local)
            f = torch.stack(pallas_blend.unpack_payload(attrs, fmt))
            if fmt in pallas_blend.PACKED:
                counts = (starts[1:] - starts[:-1]).long()
                tile = torch.repeat_interleave(torch.arange(g * g, device=dev), counts)
                f[0] += ((tile % g) * 16).float()
                f[1] += ((tile // g) * 16).float()
            evals, live = blend_evaluations(torch, starts, f, g, cap, False)
            blended = int(torch.clamp(starts[1:] - starts[:-1], max=cap).sum())
            b = bound(blended * attrs.shape[0] * 4 + nbytes(starts, acc_k, tr_k),
                      BLEND_EVAL_FLOPS["blend"] * live, "f32")
            print(f"K3 {name}: {attrs.shape[1]} pairs of {attrs.shape[0]} words; {evals} "
                  f"evaluations, {live} live; max|d| {err:.3e}, within 1e-4 on {frac:.5f} of "
                  f"pixels; kernel {ms:.4f} ms device (queued events), {ev_ms:.4f} ms a call, "
                  f"plain {plain_ms:.3f} ms; bound {b[0]:.4f} ms ({b[1]})")
            require(frac >= 0.999 and err <= 1e-2, f"K3 {name} disagrees: {err} {frac}")
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)
            del starts, attrs, acc_k, tr_k, acc_p, tr_p, f

    # -- K9 'dots' on the flagship fused route ---------------------------------
    fdec = flagship.flagship_decoder(gen=G, device=dev, fused_sampling=True).eval()
    fdec.load_state_dict(dec.state_dict())
    launches["fused_decode_dots"] = dots_route(torch, fdec, pos, cam, cp, c2w, zs, FRAMES,
                                               "fused_decode_dots", results, "flagship")
    del fdec

    # -- K10's select form ------------------------------------------------------
    with torch.inference_mode():
        planes, _ = dec.synthesize_planes(weights, zs[0], cp)
        n_planes, CD, H, W = planes.shape[1:]
        C = CD // D
        q8, _ = _quantize_int8(planes.float().reshape(n_planes, C, D, H, W))
        NY = pe.table_rows_ny(H, 1)
        fp, fpd = pe.padded_channels_last(q8), pe.duplicated_channels_last(q8)
        e_sel = pe.brick_table_select(fpd, NY, C)
        e_rot = pe.brick_table(fp, NY)
        e_pl = pe.brick_table_select_plain(fpd, NY, C)
        torch.cuda.synchronize()
        same = torch.equal(e_sel, e_rot) and torch.equal(e_sel, e_pl)
        # queued events, as K10's row
        p1 = queued_ms(torch, lambda: pe.brick_table_select_plain(fpd, NY, C), 20)
        lib1 = queued_ms(torch, lambda: pe.concat_corners(fp), 20)
        k1 = queued_ms(torch, lambda: pe.brick_table_select(fpd, NY, C), 20)
        k2 = queued_ms(torch, lambda: pe.brick_table_select(fpd, NY, C), 20)
        lib2 = queued_ms(torch, lambda: pe.concat_corners(fp), 20)
        p2 = queued_ms(torch, lambda: pe.brick_table_select_plain(fpd, NY, C), 20)
        ms, plain_ms, lib_ms = (k1 + k2) / 2, (p1 + p2) / 2, (lib1 + lib2) / 2
        # the plain-PyTorch sources each form reads, built before its kernel:
        # K10's padded transpose, the select form's channel-tiled copy of it
        src_ms = queued_ms(torch, lambda: pe.padded_channels_last(q8), 20)
        dup_ms = queued_ms(torch, lambda: pe.duplicated_channels_last(q8), 20)
        # bound by the function's bytes, as K10's row: the int8 volume read
        # once, the table written once (the same table, the same bound); the
        # duplicated source's bytes, which this form reads, printed beside it
        b = bound(nbytes(q8, e_sel), 0, "bf16")
        b_src = bound(nbytes(fpd, e_sel), 0, "bf16")[0]
        print(f"K10 select: duplicated source {tuple(fpd.shape)} int8 -> table "
              f"{tuple(e_sel.shape)}; byte-identical to K10's table and its plain version: "
              f"{same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.cat of the 8 views "
              f"{lib_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}: the {nbytes(q8)} B volume and "
              f"the {nbytes(e_sel)} B table), {b_src:.4f} ms over the {nbytes(fpd)} B "
              f"duplicated source it reads; building that source (pad + transpose + "
              f"channel tile) {dup_ms:.4f} ms, K10's padded source {src_ms:.4f} ms")
        require(same, "K10's select form differs from K10's table or its plain version")
        results["brick_table_select"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                             library_ms=lib_ms, bound=b)
        del q8, fp, fpd, e_sel, e_rot, e_pl
    sdec = flagship.flagship_decoder(gen=G, device=dev).eval()
    sdec.load_state_dict(dec.state_dict())
    sdec.config = dataclasses.replace(sdec.config, pallas_sampling="select")
    sw = sdec.fold()
    with torch.inference_mode():
        # the decoder's table route on the same planes, select vs rotate build
        rows_s, _ = sdec.decode_project(sw, planes, cam, init_position=pos)
        sdec.config = dataclasses.replace(sdec.config, pallas_sampling=True)
        rows_r, _ = sdec.decode_project(sw, planes, cam, init_position=pos)
        sdec.config = dataclasses.replace(sdec.config, pallas_sampling="select")
        same = torch.equal(rows_s, rows_r)
    print(f"table route: pallas_sampling 'select' rows equal True's on the same planes: {same}")
    require(same, "the 'select' table route's rows differ from the rotate table's")
    del planes, rows_s, rows_r
    run = frame_run(torch, sdec, sw, zs, cp, c2w,
                    {"mapping": pallas_mapping.mapping_forward,
                     "brick_table_select": pe.brick_table_select,
                     "brick_decode": ph.decode_project,
                     "blend_packed_v3": blend_v3_counter(pallas_blend)}, 1, init_position=pos)
    report_frames(torch, run, "table route, pallas_sampling 'select'")
    launches["brick_table_select"] = run["launches"]["brick_table_select"]
    del sdec, run
    torch.cuda.empty_cache()
    return launches



def option_steps(torch, run, steps, counters, label):
    """run.step (apps/train_decoder.build) over steps, a list of (draws, z)
    (with --batch_views: (a list of draws, zs (B, 1, z_dim))), step 0 a
    warm-up, each counter at 0 first and launched in every step. -> dict of
    losses, metrics (the last step's), the timed steps' median (device,
    host) ms and stage split, peak memory, launches."""
    dev = run.dev
    batched = isinstance(steps[0][0], list)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state, losses, step_ms, stage_ms, seen, metrics = run.state, [], [], [], dict.fromkeys(
        counters, 0), None
    for i, (d, z) in enumerate(steps):
        marks = []
        timer = make_timer(torch, marks)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        timer("start")
        if not batched:
            d, z = [d], z[None]
        state, metrics, _ = run.step(state, d, z, i, stage_timer=timer)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3
        loss = float(metrics["Loss/total"])
        require(np.isfinite(loss), f"{label} step {i}: loss {loss}")
        losses.append(loss)
        for k, fn in counters.items():
            require(fn.launches > seen[k], f"{label}: {k} not launched in step {i}")
            seen[k] = fn.launches
        if i == 0 and len(steps) > 1:
            continue
        step_ms.append((marks[0][1].elapsed_time(marks[-1][1]), host_ms))
        stage_ms.append([(name, a.elapsed_time(b)) for (_, a), (name, b)
                         in zip(marks[:-1], marks[1:])])
    peak = torch.cuda.max_memory_allocated(dev)
    dev_ms = sorted(d for d, _ in step_ms)[len(step_ms) // 2]
    host_ms = sorted(h for _, h in step_ms)[len(step_ms) // 2]
    if batched:       # each stage summed over the views, median over the steps
        sums = []
        for st in stage_ms:
            split = {}
            for n, t in st:
                split[n] = split.get(n, 0.0) + t
            sums.append(list(split.items()))
        stage_ms = sums
    split = stage_split(torch, stage_ms)
    print(f"{label}: 1 + {len(steps) - 1} step(s), median {dev_ms:.3f} ms device, {host_ms:.3f} "
          f"ms host wall; losses "
          + ", ".join(f"{v:.5f}" for v in losses)
          + f"; peak device memory {peak / 2 ** 30:.3f} GiB; launches "
          + str({k: fn.launches for k, fn in counters.items()}))
    print(f"{label} stage split (ms): " + ", ".join(f"{n} {t:.3f}" for n, t in split.items()))
    return dict(state=state, losses=losses, metrics=metrics, dev_ms=dev_ms, host_ms=host_ms,
                peak=peak, launches={k: fn.launches for k, fn in counters.items()})


def profile_option(torch, run, state, draws, z, label):
    """One more step of run under torch.profiler: its device time and the
    largest kernels, printed."""
    busy, on_card = profile_step(torch, run, state, draws, z, 2)
    print(f"{label} profiler: {busy:.3f} ms device time in one step; largest: "
          + "; ".join(f"{k[:48]} {t:.3f} ms" for t, k in on_card[:6]))


def trainer_options_phase(torch, seed, level, results):
    """5f: the trainer's options on the flagship trainer of phase 5
    (apps/train_decoder.py --random_init, 500k points, 128^3 sigma grid,
    512^2 target and render), each from the CLI's flags, on the same draws:
    (a) the int8 probe table built by K10 (--int8_probe --pallas_probe_build
    --no-sigma_separable: 1 + 2 steps, K10 launched in every step, its table
    byte for byte its plain version's, the int8-probe target against the f32
    one, the gather sigma grid of the f32 table against the separable grid,
    the target's parts) and --bf16_probe; (b) --no-mt_two_stage,
    --no-use_marching_cubes and --bf16_lpips, the single- and two-stage face
    counts; (c) --batch_views 2, its loss against its two single-view
    losses; (d) --raster_backend xla beside the pallas_diff loss; each
    option 1 + 1 steps; (e) the render app with --backend xla and --backend
    pallas. -> K10's launches on the target path."""
    import tempfile
    from gaussian_gan_decoder_tpu_torch.apps import render_decoder, train_decoder
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads_vjp, surface
    from gaussian_gan_decoder_tpu_torch.decoder.snapshot import (
        load_decoder, render_with_decoder, save_decoder)
    from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetDraws, sample_target
    from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand as pe
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import _quantize_int8
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
    from gaussian_gan_decoder_tpu_torch.train.distill import make_loss_fn

    base = ["--random_init", "--seed", str(seed), "--mc_level", repr(level)]

    def build(*flags):
        torch.cuda.empty_cache()
        return train_decoder.build(train_decoder.build_argparser().parse_args(base + list(flags)))

    train_counters = {"blend_train_fwd": pallas_blend.blend_train,
                      "heads_bwd": pallas_heads_vjp.decode_heads_bwd}
    run = build("--int8_probe", "--pallas_probe_build", "--no-sigma_separable")
    dev, gen = run.dev, run.gen
    rng = torch.Generator().manual_seed(seed + 5)
    zs = [torch.randn((1, gen.z_dim), generator=rng).to(dev) for _ in range(4)]
    draws = [TargetDraws.make(rng, gen, run.tcfg, dev) for _ in range(4)]
    steps = list(zip(draws, zs))

    # -- (a) the probe tables: K10 on the frozen target's tri-grid ----------
    a = option_steps(torch, run, steps[:3], {"brick_table": pe.brick_table, **train_counters},
                     "5f(a) --int8_probe --pallas_probe_build --no-sigma_separable")
    probe_launches = a["launches"]["brick_table"]
    profile_option(torch, run, a["state"], draws[3], zs[3], "5f(a)")
    f32_cfg = dataclasses.replace(run.tcfg, int8_probe=False, pallas_probe_build=False,
                                  sigma_separable=True)
    with torch.no_grad():
        t8 = sample_target(draws[0], gen, zs[0], 0, run.tcfg)
        t32 = sample_target(draws[0], gen, zs[0], 0, f32_cfg)
        print(f"5f(a) target image, int8 probe table vs the planes sampled directly (f32), "
              f"same draws: {psnr(t8.img, t32.img):.2f} dB")
        planes = t32.feature_planes
        n_planes, CD, H, W = planes.shape[1:]
        D = gen.triplane_depth
        table = gen.build_sampling_table(planes, brick_dtype=torch.int8, pallas_build=True)
        q8, scales = _quantize_int8(planes.float().reshape(n_planes, CD // D, D, H, W))
        fp = pe.padded_channels_last(q8)
        NY = table[1]
        e_p = pe.brick_table_plain(fp, NY)
        torch.cuda.synchronize()
        err = int((table[0].int() - e_p.int()).abs().max())
        require(torch.equal(table[0], e_p) and torch.equal(table[2], scales),
                "the int8 probe table (K10) differs from its plain version")
        # the card's int8 scales against the quotient that the CPU and JAX take
        absmax = planes.float().reshape(n_planes, CD // D, -1).abs().amax(dim=2).cpu().numpy()
        host = np.maximum(absmax / np.float32(127.0), np.float32(1e-12))
        off = int((table[2].cpu().numpy() != host).sum())
        print(f"5f(a) int8 probe scales: {off} of {host.size} differ from the host quotient")
        require(off == 0, "the card's int8 scales are not the host's quotient")
        p1 = queued_ms(torch, lambda: pe.brick_table_plain(fp, NY), 20)
        lib1 = queued_ms(torch, lambda: pe.concat_corners(fp), 20)
        k1 = queued_ms(torch, lambda: pe.brick_table(fp, NY), 20)
        k2 = queued_ms(torch, lambda: pe.brick_table(fp, NY), 20)
        lib2 = queued_ms(torch, lambda: pe.concat_corners(fp), 20)
        p2 = queued_ms(torch, lambda: pe.brick_table_plain(fp, NY), 20)
        ms, plain_ms, lib_ms = (k1 + k2) / 2, (p1 + p2) / 2, (lib1 + lib2) / 2
        results["brick_table_probe"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                                            library_ms=lib_ms,
                                            bound=bound(nbytes(q8, table[0]), 0, "bf16"))
        print(f"5f(a) K10 probe table (int8, {tuple(table[0].shape)}): bit-exact to its plain "
              f"version {err == 0}, scales equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.cat of the 8 views {lib_ms:.4f} ms; launches {probe_launches} in "
              f"{len(draws)} steps")
        del table, q8, fp, e_p
        for dt in (torch.bfloat16, torch.float32):
            vol = planes.to(dt).reshape(n_planes, CD // D, D, H, W)
            fpd = pe.padded_channels_last(vol)
            ny = pe.table_rows_ny(H, fpd.element_size())
            same = torch.equal(pe.brick_table(fpd, ny), pe.brick_table_plain(fpd, ny))
            kt = queued_ms(torch, lambda: pe.brick_table(fpd, ny), 10)
            print(f"5f(a) K10 probe table ({dt}): bit-exact to its plain version {same}; "
                  f"kernel {kt:.4f} ms")
            require(same, f"K10 ({dt}) differs from its plain version")
            del vol, fpd
        f32_table = gen.build_sampling_table(planes, pallas_build=True)
        res, chunk = run.tcfg.shape_res, run.tcfg.sigma_chunk
        gather = surface.sigma_grid(gen, planes, res, chunk, table=f32_table, separable=False)
        sep = surface.sigma_grid(gen, planes, res, chunk)
        d = (gather - sep).abs()
        worst = float((d / (2e-5 + 2e-5 * sep.abs())).max())
        print(f"5f(a) gather sigma grid (f32 table) vs separable ({tuple(sep.shape)}): max |d| "
              f"{float(d.max()):.3e}, {worst:.3f} of the CPU test's limit (2e-5 + 2e-5 |s|)")
        require(worst <= 1.0, "the gather sigma grid departs from the separable one")
        # the target stage's parts with and without the int8 table (events)
        table8 = gen.build_sampling_table(planes, brick_dtype=torch.int8, pallas_build=True)
        ws, cp = t32.ws, t32.gan_camera_params
        nr = run.tcfg.neural_rendering_resolution
        parts = {
            "int8 table": lambda: gen.build_sampling_table(planes, brick_dtype=torch.int8,
                                                           pallas_build=True),
            "render, int8 table": lambda: gen.render_planes(planes, ws, cp, draws[0].render, nr,
                                                            plane_table=table8),
            "render, planes": lambda: gen.render_planes(planes, ws, cp, draws[0].render, nr),
            "gather grid, int8 table": lambda: surface.sigma_grid(
                gen, planes, res, chunk, table=table8, separable=False),
            "separable grid": lambda: surface.sigma_grid(gen, planes, res, chunk),
            "marching tetrahedra + sample": lambda: surface.marching_tetrahedra_sample(
                sep, draws[0].face_u, draws[0].weight_u, draws[0].thickness_n, level,
                face_capacity=run.tcfg.face_capacity)}
        print("5f(a) target parts, device ms (events, mean of 3): "
              + ", ".join(f"{k} {cuda_ms(torch, fn, 3):.3f}" for k, fn in parts.items()))
        del table8, parts
        sig = t32.sigmas
        faces = {two: surface.marching_tetrahedra_faces(sig, level, run.tcfg.face_capacity,
                                                        two_stage=two)[1:]
                 for two in (True, False)}
        over10 = int((sig > 10.0).sum())
        del f32_table, gather, sep, d, t8, t32, ws, cp
    print(f"5f(b) marching tetrahedra at level {level:.4f}: two-stage {faces[True][0]} faces "
          f"({faces[True][1]} cubes dropped), single-stage {faces[False][0]}; voxels over "
          f"sigma 10: {over10}")
    require(faces[True][1] > 0 or faces[True][0] == faces[False][0],
            "single- and two-stage marching tetrahedra disagree with no cube dropped")
    del run, gen, a
    option_runs = {"bf16_probe": ("--bf16_probe",), "single_stage": ("--no-mt_two_stage",),
                   "voxel_filter": ("--no-use_marching_cubes",), "bf16_lpips": ("--bf16_lpips",)}
    for name, flags in option_runs.items():
        run = build(*flags)
        counters = dict(train_counters, **({"brick_table": pe.brick_table}
                                           if name == "bf16_probe" else {}))
        o = option_steps(torch, run, steps[:2], counters, f"5f {' '.join(flags)}")
        profile_option(torch, run, o["state"], draws[2], zs[2], f"5f {' '.join(flags)}")
        del run, o

    # -- (c) two views a step -----------------------------------------------
    run = build("--batch_views", "2")
    loss_fn = make_loss_fn(run.decoder, run.gen, run.vgg, run.cfg, run.tcfg, run.rcfg, run.irse)
    with torch.no_grad():
        single = [float(loss_fn(draws[b], zs[b], 0)[0]) for b in range(2)]
    c = option_steps(torch, run, [(draws[:2], torch.stack(zs[:2])),
                                  (draws[2:4], torch.stack(zs[2:4]))],
                     train_counters, "5f(c) --batch_views 2")
    profile_option(torch, run, c["state"], draws[:2], torch.stack(zs[:2]), "5f(c)")
    mean = (single[0] + single[1]) / 2
    print(f"5f(c) batched loss {c['losses'][0]:.7f}, mean of the two single-view losses "
          f"{mean:.7f} ({single[0]:.7f}, {single[1]:.7f}); |d| {abs(c['losses'][0] - mean):.3e}")
    require(abs(c["losses"][0] - mean) <= 1e-6 * abs(mean),
            "the batched loss is not the mean of its views' losses")
    del run, c

    # -- (d) the f32 tile rasterizer in the step, JAX's RasterizeConfig ------
    run = build("--raster_backend", "xla")
    require(run.rcfg.max_pairs == 2 ** 21 and run.rcfg.tile_capacity == 1024
            and run.rcfg.chunk == 64, f"not JAX's RasterizeConfig defaults: {run.rcfg}")
    diff_fn = make_loss_fn(run.decoder, run.gen, run.vgg,
                           dataclasses.replace(run.cfg, raster_backend="pallas_diff"),
                           run.tcfg, run.rcfg, run.irse)
    with torch.no_grad():
        diff_loss = float(diff_fn(draws[0], zs[0], 0)[0])
    blend_before = pallas_blend.blend_train.launches
    x = option_steps(torch, run, steps[:2], {"heads_bwd": pallas_heads_vjp.decode_heads_bwd},
                     "5f(d) --raster_backend xla")
    require(pallas_blend.blend_train.launches == blend_before, "K4 launched in the 'xla' steps")
    profile_option(torch, run, x["state"], draws[2], zs[2], "5f(d)")
    m = {k: float(v) for k, v in x["metrics"].items()}
    print(f"5f(d) xla step 0: loss {x['losses'][0]:.6f} beside the pallas_diff loss "
          f"{diff_loss:.6f} on the same draws and weights; step 1: n_dropped "
          f"{int(m['General/n_dropped'])}, {int(m['General/n_pairs'])} pairs blended")

    # -- (e) the render app on both backends ---------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snap")
        save_decoder(snap, run.decoder, run.gen, target_cfg=run.tcfg)
        del run, x
        outs = {}
        for backend in ("xla", "pallas"):
            t0 = time.perf_counter()
            outs[backend] = render_decoder.main(["--checkpoint", snap, "--backend", backend,
                                                 "--out", os.path.join(tmp, f"{backend}.png")])
            torch.cuda.synchronize()
            print(f"5f(e) render_decoder --backend {backend}: {time.perf_counter() - t0:.2f} s "
                  f"host wall (snapshot load and surface included)")
        full = psnr(outs["xla"]["render"], outs["pallas"]["render"])
        o = outs["xla"]
        dec, _ = load_decoder(snap, device=dev)
        n = 200_000
        cfg = RasterizeConfig(tile_capacity=2176)
        with torch.no_grad():
            imgs = [render_with_decoder(dec, o["z"], o["camera_params"], o["cam2world"],
                                        o["vertices"][:n], float(np.radians(13.0)), raster_cfg=cfg,
                                        backend=b)[0] for b in ("xla", "pallas")]
        held = psnr(*imgs)
        print(f"5f(e) render app, xla vs pallas: {full:.2f} dB on the snapshot's 500k surface "
              f"points (tile_capacity 1024); {held:.2f} dB on the first {n} (tile_capacity "
              f"2176, f32 payload)")
        require(held >= 50.0, f"xla and pallas renders disagree: {held:.2f} dB")
        del dec, outs, imgs
    torch.cuda.empty_cache()
    return {"brick_table_probe": probe_launches}


def timed(torch, fn):
    """fn() -> (its result, device ms by CUDA events, host wall ms)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def launch_counts():
    """Every kernel wrapper's launch counters -> {module.wrapper.counter: n}."""
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads, pallas_heads_vjp
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    out = {}
    for mod in (pallas_mapping, pallas_heads, pallas_heads_vjp, pallas_expand, pallas_blend):
        for name, fn in vars(mod).items():
            for k, v in getattr(fn, "__dict__", {}).items():
                if callable(fn) and k.startswith("launches"):
                    out[f"{mod.__name__.rsplit('.', 1)[-1]}.{name}.{k}"] = v
    return out


def ring_scene(torch, root, size, dev, seed, n_views=GS_VIEWS):
    """A synthetic Blender scene in root: n_views cameras on a ring 4 units
    out at 0.3 rad elevation, looking at the origin (camera_angle_x 0.69),
    each view a size^2 PNG rendered by the port's rasterize from a seeded
    teacher cloud (20k Gaussians in a ball of radius 0.8). -> root."""
    import math
    from PIL import Image
    from gaussian_gan_decoder_tpu_torch.data.scene_io import (camera_to_render_inputs,
                                                               read_blender_scene)
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import rasterize
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = []
    for i in range(n_views):
        th, el = 2 * math.pi * i / n_views, 0.3
        p = 4.0 * np.array([math.cos(th) * math.cos(el), math.sin(th) * math.cos(el),
                            math.sin(el)])
        zc = p / np.linalg.norm(p)                   # Blender cameras look down -z
        xc = np.cross([0.0, 0.0, 1.0], zc)
        xc /= np.linalg.norm(xc)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = xc, np.cross(zc, xc), zc, p
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    rng = np.random.RandomState(seed)
    n = 20_000
    d = rng.randn(n, 3)
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * 0.8 * rng.rand(n, 1) ** (1 / 3)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    teacher = (t(pts), t(np.exp(rng.randn(n, 3) * 0.3 - 4.0)), t(rng.randn(n, 4)),
               t(np.full(n, 0.7)), t(rng.rand(n, 3)))
    with torch.no_grad():
        for sc in read_blender_scene(root, n_random_points=1).cameras:
            cam2world, fov = camera_to_render_inputs(sc)
            cam = make_camera(size, fov, cam2world, device=dev)
            img = rasterize(cam, *teacher[:4], colors_precomp=teacher[4])["render"]
            Image.fromarray(np.clip(img.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255)
                            .astype(np.uint8)).save(sc.image_path)
    return root


def gs_views(torch, root, size, dev, n_points):
    """The ring scene read as train_3dgs reads it -> (SceneInfo, [(camera,
    ground truth)] a view)."""
    from gaussian_gan_decoder_tpu_torch.apps.train_3dgs import load_image, read_scene
    from gaussian_gan_decoder_tpu_torch.data.scene_io import camera_to_render_inputs
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    info = read_scene(root, False, n_random_points=n_points)
    views = []
    for sc in info.cameras:
        cam2world, fov = camera_to_render_inputs(sc)
        views.append((make_camera(size, fov, cam2world, device=dev),
                      load_image(sc.image_path, size, dev)))
    return info, views


class FixedSplitDraws:
    """Within the block, densify's split_draws returns these (2, N, 3)
    normals on the scene's device: the same draws on the card and the CPU."""

    def __init__(self, torch, z):
        from gaussian_gan_decoder_tpu_torch.gaussians import densify
        self.densify, self.z, self.old = densify, z, densify.split_draws

    def __enter__(self):
        self.densify.split_draws = lambda key, n, dtype: (self.z[0].to(key.device),
                                                          self.z[1].to(key.device))

    def __exit__(self, *exc):
        self.densify.split_draws = self.old


def gs_small_run(torch, root, dev, z, threshold=None):
    """The card-vs-CPU hold's run on one device: init_gs_state at
    GS_SMALL's capacity and points, two steps at SH degree 0 on views 0 and
    1, densify_step (draws z; threshold: the given one, else the 0.9
    quantile of the seen valid slots' mean screen gradients), one step at
    degree 3 on view 2, then the render of view 3 -> dict."""
    import dataclasses as dc
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig, rasterize
    from gaussian_gan_decoder_tpu_torch.train import gaussian_splatting as gs
    info, views = gs_views(torch, root, GS_SMALL["size"], dev, GS_SMALL["points"])
    cfg = gs.GSOptimizationConfig(capacity=GS_SMALL["capacity"], sh_degree=3)
    state = gs.init_gs_state(info.points, info.colors, cfg, info.extent, device=dev)
    step = gs.make_train_step(cfg, RasterizeConfig(), GS_SMALL["size"], info.extent)
    bg = torch.zeros(3, device=dev)
    losses = []
    for i, deg in enumerate((0, 0, 3)):
        if i == 2:
            seen = (state.denom > 0) & state.scene.valid
            grads = state.grad_accum / state.denom.clamp(min=1e-12)
            if threshold is None:
                threshold = float(torch.quantile(grads[seen], 0.9))
            with FixedSplitDraws(torch, z):
                state, stats = gs.densify_step(
                    state, torch.Generator(device=dev),
                    dc.replace(cfg, densify_grad_threshold=threshold), info.extent, None)
        state, m = step(state, *views[i], bg, sh_degree=deg)
        losses.append(float(m["loss"]))
    sc = state.scene
    with torch.no_grad():
        img = rasterize(views[3][0], sc.get_xyz, sc.get_scaling, sc.get_rotation,
                        sc.get_opacity, shs=torch.cat([sc.features_dc, sc.features_rest], 1),
                        sh_degree=3, bg=bg)["render"]
    return dict(losses=losses, stats=tuple(int(v) for v in stats), threshold=threshold,
                image=img.cpu(), n_valid=int(sc.valid.sum()))


def gs3d_phase(torch, seed):
    """5h: classic photogrammetric 3DGS (train_3dgs / render_3dgs /
    full_eval_3dgs) at the apps' full width, on a synthetic Blender ring
    scene (GS_VIEWS 512^2 views rendered from a seeded teacher cloud):
    init_gs_state at capacity 2^20, SH degree 3, 100k Blender-init points
    (the KNN init); GS_STEPS steps at degree 0, one densify_step at the 0.9
    quantile of the mean screen gradients, one reset_opacity, GS_STEPS
    steps at degree 3 (each loss finite; device and host time, pairs,
    drops; the pads' share of the requested pairs; peak memory); save_ply;
    render_3dgs with metrics, train_3dgs --iterations 3 and full_eval_3dgs
    --iterations 3 at 512^2; then the card-vs-CPU hold at GS_SMALL (the
    same draws, the same densify threshold). No kernel launches in the
    phase: the JAX package runs no Pallas kernel on this path either."""
    import dataclasses as dc
    import math
    import tempfile
    from gaussian_gan_decoder_tpu_torch.apps import full_eval_3dgs, render_3dgs, train_3dgs
    from gaussian_gan_decoder_tpu_torch.gaussians.densify import reset_opacity
    from gaussian_gan_decoder_tpu_torch.gaussians.ply import save_ply
    from gaussian_gan_decoder_tpu_torch.splat.projection import project_gaussians
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig, _tile_rects
    from gaussian_gan_decoder_tpu_torch.train import gaussian_splatting as gs
    dev = torch.device("cuda:0")
    before = launch_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        root = ring_scene(torch, os.path.join(work, "ring"), IMAGE, dev, seed + 31)
        info, views = gs_views(torch, root, IMAGE, dev, GS_POINTS)
        cfg = gs.GSOptimizationConfig(capacity=GS_CAPACITY, sh_degree=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = gs.init_gs_state(info.points, info.colors, cfg, info.extent, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        sc = state.scene
        print(f"5h 3DGS: {len(views)} views {IMAGE}^2, {len(info.points)} Blender-init points, "
              f"capacity {sc.num_points}, extent {info.extent:.4f}; init (KNN) {init_s:.3f} s; "
              f"init log-scale median {float(sc.scaling.detach()[sc.valid].median()):.4f}")
        # the pads' share of the requested pairs (view 0, the initial scene)
        with torch.no_grad():
            cam = views[0][0]
            proj = project_gaussians(cam, sc.get_xyz, sc.get_scaling, sc.get_rotation)
            _, _, rw, rh = _tile_rects(proj.pix_xy, proj.radius.float(), IMAGE // 16,
                                       IMAGE // 16, 16)
            counts = torch.where(proj.visible, rw * rh, torch.zeros_like(rw)).long()
            req, pad_req = int(counts.sum()), int(counts[~sc.valid].sum())
            pad_r = proj.radius[~sc.valid].float()
            print(f"5h pairs requested on view 0: {req} ({pad_req} by the "
                  f"{int((~sc.valid).sum())} pad slots: {pad_req / req:.6f} of them; pad radius "
                  f"median {float(pad_r.median()):.0f} px, pads visible "
                  f"{float(proj.visible[~sc.valid].float().mean()):.4f}); max_pairs "
                  f"{RasterizeConfig().max_pairs}")
            del proj, counts
        step = gs.make_train_step(cfg, RasterizeConfig(), IMAGE, info.extent)
        bg = torch.zeros(3, device=dev)
        torch.cuda.reset_peak_memory_stats()
        rows = []

        def run_step(i, deg):
            nonlocal state
            (state, m), dev_ms, host_ms = timed(torch, lambda: step(
                state, *views[i % len(views)], bg, sh_degree=deg))
            loss = float(m["loss"])
            rows.append((dev_ms, host_ms))
            print(f"5h step {i} (SH degree {deg}): loss {loss:.6f}, {dev_ms:.3f} ms device "
                  f"(events), {host_ms:.3f} ms host wall; n_pairs {m['n_pairs']}, n_dropped "
                  f"{m['n_dropped']}, n_valid {int(m['n_valid'])}")
            require(math.isfinite(loss), f"5h: step {i} loss {loss}")

        for i in range(GS_STEPS):
            run_step(i, 0)
        seen = (state.denom > 0) & state.scene.valid
        grads = state.grad_accum / state.denom.clamp(min=1e-12)
        thr = float(torch.quantile(grads[seen], 0.9))
        (state, stats), d_ms, d_host = timed(torch, lambda: gs.densify_step(
            state, torch.Generator(device=dev).manual_seed(seed),
            dc.replace(cfg, densify_grad_threshold=thr), info.extent, None))
        stats = {k: int(v) for k, v in stats._asdict().items()}
        print(f"5h densify_step at threshold {thr:.6e} (0.9 quantile of {int(seen.sum())} seen "
              f"slots' mean screen gradients): {stats}; valid {int(state.scene.valid.sum())}; "
              f"{d_ms:.3f} ms device, {d_host:.3f} ms host wall")
        require(stats["n_cloned"] + stats["n_split"] > 0, "5h: densify added nothing")
        state = gs.assign_scene(state, reset_opacity(state.scene))
        op = torch.sigmoid(state.scene.opacity.detach()[state.scene.valid])
        print(f"5h reset_opacity: valid opacity max {float(op.max()):.6f}")
        require(float(op.max()) <= 0.0101, "5h: reset_opacity left an opacity above 0.01")
        for i in range(GS_STEPS, 2 * GS_STEPS):
            run_step(i, 3)
        torch.cuda.synchronize()
        med = sorted(rows)[len(rows) // 2]
        print(f"5h train step: median {med[0]:.3f} ms device (events), {med[1]:.3f} ms host "
              f"wall; peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

        ply = os.path.join(work, "scene.ply")
        t0 = time.perf_counter()
        save_ply(state.scene, ply)
        print(f"5h save_ply: {os.path.getsize(ply)} bytes in {time.perf_counter() - t0:.3f} s")
        del state, step, views
        torch.cuda.empty_cache()
        app_s = {}
        t0 = time.perf_counter()
        metrics = render_3dgs.main(["--ply", ply, "-s", root, "--out",
                                    os.path.join(work, "renders"), "--image_size", str(IMAGE)])
        app_s["render_3dgs"] = time.perf_counter() - t0
        require(metrics is not None and all(math.isfinite(v) for v in metrics["mean"].values())
                and set(metrics["mean"]) == {"PSNR", "SSIM", "L1", "LPIPS"},
                f"5h: render_3dgs metrics {metrics}")
        t0 = time.perf_counter()
        out = train_3dgs.main(["-s", root, "-m", os.path.join(work, "model"), "--iterations",
                               str(GS_STEPS), "--save_iterations", "--image_size", str(IMAGE)])
        app_s["train_3dgs"] = time.perf_counter() - t0
        require(os.path.exists(out["ply"]), "5h: train_3dgs wrote no .ply")
        del out
        t0 = time.perf_counter()
        summary = full_eval_3dgs.main(["--scenes", root, "--output_path",
                                       os.path.join(work, "eval"), "--iterations", str(GS_STEPS),
                                       "--image_size", str(IMAGE)])
        app_s["full_eval_3dgs"] = time.perf_counter() - t0
        mean = summary["ring"]["mean"]
        require(all(math.isfinite(v) for v in mean.values()), f"5h: full_eval {mean}")
        print(f"5h apps (host wall): " + ", ".join(f"{k} {v:.2f} s" for k, v in app_s.items())
              + f"; render_3dgs of the trained .ply: {metrics['mean']}; full_eval_3dgs: {mean}")
        torch.cuda.empty_cache()

        # -- the card against the CPU, at GS_SMALL, on the same draws --------
        small = ring_scene(torch, os.path.join(work, "small"), GS_SMALL["size"], dev, seed + 32)
        z = torch.randn((2, GS_SMALL["capacity"], 3), generator=torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()
        cpu = gs_small_run(torch, small, torch.device("cpu"), z)
        cpu_s = time.perf_counter() - t0
        gpu = gs_small_run(torch, small, dev, z, threshold=cpu["threshold"])
        rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["losses"], cpu["losses"]))
        fr = psnr(gpu["image"], cpu["image"])
        print(f"5h card vs CPU (capacity {GS_SMALL['capacity']}, {GS_SMALL['size']}^2, "
              f"{GS_SMALL['points']} points; CPU run {cpu_s:.2f} s): losses card "
              f"{gpu['losses']} CPU {cpu['losses']}, worst relative {rel:.3e} (limit "
              f"{GS_LOSS_RTOL:g}); densify at {cpu['threshold']:.6e}: card {gpu['stats']}, CPU "
              f"{cpu['stats']}; valid {gpu['n_valid']} / {cpu['n_valid']}; final render "
              f"{fr:.2f} dB (limit {GS_RENDER_PSNR:g})")
        require(rel <= GS_LOSS_RTOL, f"5h: card and CPU losses differ by {rel:.3e}")
        require(fr >= GS_RENDER_PSNR, f"5h: card and CPU renders differ: {fr:.2f} dB")
        require(gpu["stats"][0] + gpu["stats"][1] > 0, "5h: the small densify added nothing")
    after = launch_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    print(f"5h: {time.perf_counter() - t_phase:.1f} s host wall; kernel launches in the phase: "
          f"{moved or 'none'}")
    require(not moved, f"5h: a kernel launched on the 3DGS path: {moved}")


def gan_label(yaw, pitch=0.0, radius=2.7):
    """A 25-value camera label: a cam2world looking at the origin from
    (yaw, pitch) at radius, and EG3D's normalised intrinsics."""
    import math
    eye = radius * np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                             math.cos(yaw) * math.cos(pitch)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, -up, fwd, eye
    return pose.reshape(-1).tolist() + [4.2647, 0, 0.5, 0, 4.2647, 0.5, 0, 0, 1]


def gan_dataset(root, n, size, seed):
    """A synthetic GAN dataset in root: imgs.zip (n RGB PNGs, seeded noise
    blurred into blobs, with dataset.json camera labels on a yaw arc from
    -150 to 150 degrees) and segs.zip (n grey PNGs, a disc) -> the two
    paths."""
    import io
    import json as js
    import zipfile
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    names = [f"img{i:05d}.png" for i in range(n)]
    yaws = np.linspace(-2.6, 2.6, n)
    labels = {"labels": [[nm, gan_label(y, 0.1 * rng.randn())] for nm, y in zip(names, yaws)]}

    def png(arr, mode):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG")
        return buf.getvalue()

    imgs, segs = os.path.join(root, "imgs.zip"), os.path.join(root, "segs.zip")
    with zipfile.ZipFile(imgs, "w") as zi, zipfile.ZipFile(segs, "w") as zs:
        for nm in names:
            c = rng.rand(3)
            r2 = (xx - 0.2 * rng.randn()) ** 2 + (yy - 0.2 * rng.randn()) ** 2
            img = np.clip(c[None, None] * np.exp(-r2 / 0.05)[..., None] * 255
                          + rng.rand(size, size, 3) * 20, 0, 255).astype(np.uint8)
            zi.writestr(nm, png(img, "RGB"))
            zs.writestr(nm, png(((r2 < 0.1) * 255).astype(np.uint8), "L"))
        zi.writestr("dataset.json", js.dumps(labels))
    return imgs, segs


def gan_steps(torch, argv, steps, label):
    """train_gan's networks, config, augment and dataset for argv, at full
    width on the card; `steps` steps (the first warms up nothing: its time
    is printed apart), one warm step with both regularisations, then one
    more under torch.profiler. Each step's G and D halves by CUDA events at
    the step's stage marks, its host wall, its losses; peak memory; the
    profiled step's device time. -> dict."""
    from gaussian_gan_decoder_tpu_torch.apps import train_gan
    from gaussian_gan_decoder_tpu_torch.train.gan import init_gan_state, make_gan_train_step
    from gaussian_gan_decoder_tpu_torch.utils.draws import TorchDraws
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda:0")
    args = train_gan.build_argparser().parse_args(argv)
    G, D, G_ema, nrr = train_gan.build_networks(args, dev)
    cfg = train_gan.loss_config(args, nrr)
    state = init_gan_state(G, D, G_ema, cfg)
    step = make_gan_train_step(G, D, cfg, augment_fn=train_gan.augment_for(args))
    batches = train_gan.real_batches(args, D.img_resolution, args.batch)
    rng = torch.Generator(device=dev).manual_seed(args.seed + 1)
    draws = TorchDraws(rng, dev)
    n_g = sum(t.numel() for t in G.parameters())
    n_d = sum(t.numel() for t in D.parameters())
    print(f"5i {label}: G {n_g / 1e6:.2f} M parameters (img {G.img_resolution}^2, w {G.w_dim}, "
          f"nrr {nrr}, bf16 blocks {G.config.num_fp16_res}), D {n_d / 1e6:.2f} M ({D.mode}, "
          f"{D.img_resolution}^2), batch {args.batch}, aug {args.aug} p {args.ada_p}")

    def one(i, prof=False):
        img, seg, lab = next(batches)
        real = train_gan.real_images(img, seg, nrr, dev)
        z = torch.randn((img.shape[0], G.z_dim), generator=rng, device=dev)
        c = torch.from_numpy(lab).to(dev)
        ev = {}

        def mark(name):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        _, metrics = step(state, draws, z, c, real, c, stage_timer=mark)
        mark("end")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in metrics.items()}
        return dict(step=i, wall=wall, g=ev["G"].elapsed_time(ev["D"]),
                    d=ev["D"].elapsed_time(ev["ema"]), ema=ev["ema"].elapsed_time(ev["end"]),
                    total=ev["start"].elapsed_time(ev["end"]), metrics=m,
                    g_reg=i % cfg.g_reg_interval == 0, d_reg=i % cfg.d_reg_interval == 0)

    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(steps):
        r = one(i)
        rows.append(r)
        print(f"5i {label} step {i} (G reg {r['g_reg']}, R1 {r['d_reg']}): G half "
              f"{r['g']:.3f} ms, D half {r['d']:.3f} ms, EMA {r['ema']:.3f} ms device (events); "
              f"{r['total']:.3f} ms device, {r['wall']:.3f} ms host wall; "
              + ", ".join(f"{k} {v:.5g}" for k, v in r["metrics"].items()))
        require(all(np.isfinite(v) for v in r["metrics"].values()),
                f"5i {label}: step {i} has a non-finite loss: {r['metrics']}")
        if r["d_reg"]:
            require(r["metrics"]["Loss/r1_penalty"] > 0, f"5i {label}: R1 is 0 on step {i}")
        if r["g_reg"] and cfg.density_reg > 0:
            require(r["metrics"]["Loss/G/reg"] > 0, f"5i {label}: G reg is 0 on step {i}")
    # the first step pays the first calls' costs (the R1 double backward's
    # above all): a lazy step with R1 once more, warm (the step counter at
    # d_reg_interval, where both regularisations run)
    at, state.step = state.step, cfg.d_reg_interval
    r = one(cfg.d_reg_interval)
    state.step = at + 1
    print(f"5i {label} warm step with G reg and R1: G half {r['g']:.3f} ms, D half "
          f"{r['d']:.3f} ms device (events), {r['wall']:.3f} ms host wall; R1 "
          f"{r['metrics']['Loss/r1_penalty']:.5g}")
    require(all(np.isfinite(v) for v in r["metrics"].values()),
            f"5i {label}: the warm R1 step has a non-finite loss: {r['metrics']}")
    warm_reg = r
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one(state.step)
        torch.cuda.synchronize()
    on_card = sorted(((e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(t for t, _ in on_card)
    return dict(rows=rows, warm_reg=warm_reg, peak=peak, busy_ms=busy_ms, on_card=on_card,
                state=state)


def gan_report(rows, busy_ms, peak, label):
    """Median G / D halves and host wall of the steps with and without
    lazy regularisation (the first step apart), the busy share."""
    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else float("nan")

    later = rows[1:]
    reg = [r for r in later if r["g_reg"] or r["d_reg"]]
    plain = [r for r in later if not (r["g_reg"] or r["d_reg"])]
    for name, rs in (("with regularisation", reg), ("without", plain)):
        if rs:
            print(f"5i {label} {name} ({len(rs)} steps): G half {med([r['g'] for r in rs]):.3f} "
                  f"ms, D half {med([r['d'] for r in rs]):.3f} ms device (events), host wall "
                  f"{med([r['wall'] for r in rs]):.3f} ms a step")
    host = med([r["wall"] for r in plain or later])
    print(f"5i {label}: first step {rows[0]['wall']:.1f} ms host wall (G reg and R1); peak "
          f"{peak:.3f} GiB; profiled step {busy_ms:.3f} ms of device time, busy "
          f"{busy_ms / host:.3f} of the median host-wall step ({host:.3f} ms)")
    return host


def gan_card_vs_cpu(torch, seed):
    """The --smoke G and D, with the same weights and draws on the CPU and
    on the card: the G loss and the D loss at step 0 (the density term,
    the camera-translation term and R1 on), their metrics and every
    gradient. -> the worst relative loss gap and the worst gradient gap
    (each tensor's max |d| over its CPU max |g|)."""
    from gaussian_gan_decoder_tpu_torch.apps import train_gan
    from gaussian_gan_decoder_tpu_torch.train import gan
    from gaussian_gan_decoder_tpu_torch.utils.draws import TorchDraws
    args = train_gan.build_argparser().parse_args(["--smoke", "--batch", "2", "--seed",
                                                   str(seed)])
    rng = np.random.RandomState(seed)
    data = dict(z=rng.randn(2, 32), c=rng.randn(2, 25) * 0.1,
                image=rng.rand(2, 3, 16, 16) * 2 - 1, image_raw=rng.rand(2, 3, 16, 16) * 2 - 1,
                image_mask=rng.rand(2, 1, 16, 16))
    data = {k: torch.tensor(v.astype(np.float32)) for k, v in data.items()}
    out = {}
    for name in ("cpu", "cuda:0"):
        dev = torch.device(name)
        G, D, _, nrr = train_gan.build_networks(args, dev)
        cfg = train_gan.loss_config(args, nrr)
        step = gan.make_gan_train_step(G, D, cfg)
        d = {k: v.to(dev) for k, v in data.items()}
        real = {k: d[k] for k in ("image", "image_raw", "image_mask")}
        res = {}
        for phase, net in (("G", G), ("D", D)):
            tensors = gan.trained_tensors(net)
            for t in tensors:
                t.requires_grad_(True)
            draws = TorchDraws(torch.Generator().manual_seed(seed + 5), dev)
            if phase == "G":
                loss, m = step.g_loss(draws, d["z"], d["c"], 0.0, True)
            else:
                loss, m = step.d_loss(draws, d["z"], d["c"], real, d["c"], 0.0, True)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
            res[phase] = (float(loss.detach()), {k: float(v) for k, v in m.items()},
                          [None if g is None else g.detach().cpu() for g in grads])
        out[name] = res
    loss_gap, grad_gap = 0.0, 0.0
    for phase in ("G", "D"):
        (lc, mc, gc), (lg, mg, gg) = out["cpu"][phase], out["cuda:0"][phase]
        loss_gap = max([loss_gap, abs(lg - lc) / abs(lc)]
                       + [abs(mg[k] - v) / max(abs(v), 1e-3) for k, v in mc.items()])
        for a, b in zip(gg, gc):
            if a is not None and b is not None and float(b.abs().max()) > 0:
                grad_gap = max(grad_gap, float((a - b).abs().max() / b.abs().max()))
            else:
                require((a is None) == (b is None), "5i card vs CPU: a gradient is missing")
        print(f"5i card vs CPU, smoke {phase} loss at step 0: card {lg:.7f}, CPU {lc:.7f}; "
              + ", ".join(f"{k} {mg[k]:.6g}/{v:.6g}" for k, v in mc.items()))
    return loss_gap, grad_gap


def gan_phase(torch, seed):
    """5i: 3D-GAN training (apps/train_gan.py) at full width on the card:
    the PanoHead config (z/w 512, 512^2 images, mask_dual D with its
    segmentation branch, bf16 blocks at the top 4 resolutions, neural
    rendering 64, batch 4, --aug fixed --ada_p 0.2) on seeded random
    weights and a synthetic zip of GAN_IMAGES 512^2 images and
    segmentations, GAN_STEPS steps (steps 0 and 4 run the G
    regularisation, step 0 R1) and one profiled step; EG3D (dual D, no
    segmentation) for GAN_EG3D_STEPS steps; the app (--smoke) writing its
    snapshot and fakes, and a --resume of the snapshot restoring the whole
    train state; the --smoke step's losses and gradients on the card
    against the CPU. No kernel launches: the JAX package runs no Pallas
    kernel on this path either."""
    import tempfile
    from gaussian_gan_decoder_tpu_torch.apps import train_gan
    from gaussian_gan_decoder_tpu_torch.train.gan import init_gan_state
    before = launch_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        imgs, segs = gan_dataset(os.path.join(work, "data"), GAN_IMAGES, IMAGE, seed + 41)
        print(f"5i dataset: {GAN_IMAGES} {IMAGE}^2 images and segmentations written in "
              f"{time.perf_counter() - t0:.2f} s")
        common = ["--batch", str(GAN_BATCH), "--aug", "fixed", "--ada_p", str(GAN_ADA_P),
                  "--seed", str(seed + 41), "--data", imgs]
        pano = gan_steps(torch, common + ["--seg_data", segs], GAN_STEPS, "PanoHead")
        gan_report(pano["rows"], pano["busy_ms"], pano["peak"], "PanoHead")
        print("5i PanoHead profiled step, largest: "
              + "; ".join(f"{k[:48]} {t:.3f} ms" for t, k in pano["on_card"][:5]))
        del pano
        torch.cuda.empty_cache()
        eg3d = gan_steps(torch, common + ["--variant", "eg3d"], GAN_EG3D_STEPS, "EG3D")
        gan_report(eg3d["rows"], eg3d["busy_ms"], eg3d["peak"], "EG3D")
        del eg3d
        torch.cuda.empty_cache()

        # -- the app on the card: snapshot, fakes, resume ----------------------
        t0 = time.perf_counter()
        out = train_gan.main(["--smoke", "--kimg", "0.004", "--batch", "2",
                              "--outdir", os.path.join(work, "app")])
        app_s = time.perf_counter() - t0
        snap = os.path.join(work, "app", "snapshot_final")
        require(out["state"].step == 2 and os.path.isfile(snap) and len(out["fakes"]) == 2
                and all(os.path.isfile(p) for p in out["fakes"]),
                f"5i: train_gan wrote {os.listdir(os.path.join(work, 'app'))}")
        args = train_gan.build_argparser().parse_args(["--smoke"])
        G, D, G_ema, nrr = train_gan.build_networks(args, torch.device("cuda:0"))
        fresh = train_gan.resume(snap, init_gan_state(G, D, G_ema,
                                                      train_gan.loss_config(args, nrr)))
        same = all(torch.equal(getattr(fresh, n).state_dict()[k],
                               getattr(out["state"], n).state_dict()[k])
                   for n in ("G", "D", "G_ema") for k in getattr(fresh, n).state_dict())
        same_opt = all(torch.equal(getattr(fresh, o).state_dict()["state"][i][m],
                                   getattr(out["state"], o).state_dict()["state"][i][m])
                       for o in ("g_opt", "d_opt")
                       for i in getattr(fresh, o).state_dict()["state"]
                       for m in getattr(fresh, o).state_dict()["state"][i])
        print(f"5i train_gan --smoke --kimg 0.004 on the card: {app_s:.2f} s host wall, "
              f"snapshot {os.path.getsize(snap)} bytes, fakes "
              f"{[os.path.basename(p) for p in out['fakes']]}; --resume restores G, D, G_ema "
              f"bit for bit: {same}, both Adams: {same_opt}, step {fresh.step}, cur_nimg "
              f"{fresh.cur_nimg}")
        require(same and same_opt and fresh.step == 2 and fresh.cur_nimg == 4.0,
                "5i: the resumed train state differs from the saved one")
        out2 = train_gan.main(["--smoke", "--kimg", "0.002", "--batch", "2", "--resume", snap,
                               "--outdir", os.path.join(work, "app2")])
        require(out2["state"].step == 3, "5i: the resumed run did not go on from step 2")
        del out, out2, fresh

    # -- the smoke step on the card against the CPU ------------------------------
    loss_gap, grad_gap = gan_card_vs_cpu(torch, seed)
    print(f"5i card vs CPU: losses and metrics worst relative {loss_gap:.3e} (limit "
          f"{GAN_LOSS_RTOL:g}); gradients worst {grad_gap:.3e} of each tensor's CPU max "
          f"(limit {GAN_GRAD_TOL:g})")
    require(loss_gap <= GAN_LOSS_RTOL, f"5i: card and CPU losses differ by {loss_gap:.3e}")
    require(grad_gap <= GAN_GRAD_TOL, f"5i: card and CPU gradients differ by {grad_gap:.3e}")
    after = launch_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    print(f"5i: {time.perf_counter() - t_phase:.1f} s host wall; kernel launches in the phase: "
          f"{moved or 'none'}")
    require(not moved, f"5i: a kernel launched on the GAN path: {moved}")


def generation_phase(torch, seed, card):
    """5g: the GAN side and the generation apps on the PanoHead flagship
    generator at full width (z/w 512, 256^2 tri-grid of depth 3, neural
    rendering 64, 48 + 48 samples, SR to 512^2, seeded random weights):
    (a) TriPlaneGenerator.apply at batch 1 (mapping, t_mapping, synthesis,
    the two-pass render, raw ToRGB, SR), checked and timed, and the same call
    on the CPU with the same weights and draws (image by PSNR, image_raw by
    max abs); (b) gen_shapes' path on the same generator: the gather sigma
    grid at 128^3, single-stage marching tetrahedra at the SURFACE_QUANTILE
    level, the .mrc and .ply; (c) gen_videos' per-frame path on a flagship
    decoder snapshot saved and reloaded here, with pallas_mapping as the
    JAX benchmark's decoder (int8 probe table built by K10 in its target
    config): 1 warm-up + 2 timed frames with --backend pallas, counters at 0
    first, K1, K3, K6's bf16 form and K10 in every frame; the first frame
    on its first 200k points with tile_capacity 2176 against the same frame
    with the plain versions of K1, K6 and K3 (decoder/snapshot.py::
    plain_kernels), at 5f(e)'s >= 50 dB; one --backend xla frame; (d) gen_interpolation (2 cuts x 3 views) and gen_videos_proj (2
    frames from an npz of ws, image and image_depth) at full width. ->
    {kernel: phase-5g launches}."""
    import math
    import tempfile
    from types import SimpleNamespace

    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.apps import (gen_interpolation, gen_samples, gen_shapes,
                                                     gen_videos, gen_videos_proj)
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
    from gaussian_gan_decoder_tpu_torch.decoder.snapshot import (load_decoder, plain_kernels,
                                                                 render_with_decoder,
                                                                 save_decoder)
    from gaussian_gan_decoder_tpu_torch.decoder.surface import sigma_grid
    from gaussian_gan_decoder_tpu_torch.decoder.target_pipeline import TargetSamplerConfig
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.neuralfield import pallas_expand
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import RenderDraws
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend
    from gaussian_gan_decoder_tpu_torch.splat.rasterize import RasterizeConfig
    from gaussian_gan_decoder_tpu_torch.train import checkpoint

    dev = torch.device("cuda:0")
    gseed = seed + 31
    gen = flagship.flagship_generator(rng=torch.Generator().manual_seed(gseed), device=dev).eval()
    assert gen.t_mapping is not None and gen.bcg_synthesis is not None
    nrr, S = 64, gen.rk["depth_resolution"]
    rng = torch.Generator().manual_seed(seed + 32)
    z = torch.randn((1, 512), generator=rng)
    c = gen_samples.orbit_camera(math.pi / 2 + 0.3, math.pi / 2 - 0.1, 18.837)[0]
    draws = RenderDraws.make(rng, 1, nrr * nrr, S, gen.rk["depth_resolution_importance"], "cpu")
    on_card = RenderDraws(draws.stratified.to(dev), draws.importance.to(dev))

    # -- (a) TriPlaneGenerator.apply at batch 1, and on the CPU ---------------
    def apply():
        with torch.no_grad():
            return gen.apply(z.to(dev), c.to(dev), truncation_psi=0.7,
                             neural_rendering_resolution=nrr, draws=on_card)
    apply()
    runs = [timed(torch, apply) for _ in range(3)]
    out = runs[-1][0]
    dev_ms = sorted(r[1] for r in runs)[1]
    host_ms = sorted(r[2] for r in runs)[1]
    shapes = {k: tuple(out[k].shape) for k in ("image", "image_raw", "image_depth", "image_mask")}
    require(shapes == {"image": (1, 3, 512, 512), "image_raw": (1, 3, nrr, nrr),
                       "image_depth": (1, 1, nrr, nrr), "image_mask": (1, 1, nrr, nrr)},
            f"5g(a) apply: shapes {shapes}")
    for k in shapes:
        require(bool(torch.isfinite(out[k]).all()) and float(out[k].std()) > 0,
                f"5g(a) apply: {k} not finite or constant")
    mask = out["image_mask"]
    # the bounds in f32, as the mask is computed: weights * 1.002 - 0.001
    require(float(mask.min()) >= float(np.float32(-0.001))
            and float(mask.max()) <= float(np.float32(1.001)),
            f"5g(a) mask outside [-0.001, 1.001]: {float(mask.min())}..{float(mask.max())}")
    print(f"5g(a) apply (batch 1, 64^2 render of 48 + 48 samples, SR to 512^2): median "
          f"{dev_ms:.3f} ms device, {host_ms:.3f} ms host wall of 3 calls; image mean "
          f"{float(out['image'].mean()):.4f} std {float(out['image'].std()):.4f}; mask "
          f"{float(mask.min()):.4f}..{float(mask.max()):.4f} ({card})")
    cpu = flagship.flagship_generator(rng=torch.Generator().manual_seed(gseed), device="cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu.eval().apply(z, c, truncation_psi=0.7, neural_rendering_resolution=nrr,
                               draws=draws)
    cpu_s = time.perf_counter() - t0
    del cpu
    img_psnr = psnr((out["image"].cpu() + 1) / 2, (ref["image"] + 1) / 2)
    raw_err = float((out["image_raw"].cpu() - ref["image_raw"]).abs().max())
    print(f"5g(a) apply, card vs CPU (the same weights and draws; CPU call {cpu_s:.1f} s host, "
          f"{torch.get_num_threads()} threads): image {img_psnr:.2f} dB (limit >= "
          f"{APPLY_PSNR} dB), image_raw max|d| {raw_err:.3e} (limit <= {APPLY_RAW_ERR})")
    require(img_psnr >= APPLY_PSNR, f"5g(a) card and CPU images disagree: {img_psnr:.2f} dB")
    require(raw_err <= APPLY_RAW_ERR, f"5g(a) card and CPU raw images disagree: {raw_err:.3e}")
    del out, ref, runs

    with tempfile.TemporaryDirectory() as tmp:
        # -- (b) gen_shapes' path: gather sigma grid, marching tetrahedra -----
        zd = z.to(dev)
        level, _ = surface_level(torch, gen, zd, 128, 2 ** 20)
        shape = os.path.join(tmp, "shape")
        sh, sh_ms, sh_host = timed(torch, lambda: gen_shapes.export_shape(
            gen, zd, shape, shape_res=128, level=level))
        require(sh["n_faces"] > 0 and sh["n_dropped"] == 0, f"5g(b) no surface: {sh}")
        print(f"5g(b) gen_shapes path (128^3 gather grid, single-stage marching tetrahedra at "
              f"level {level:.4f}): {sh['n_faces']} faces; .mrc {os.path.getsize(shape + '.mrc')} "
              f"bytes, .ply {os.path.getsize(shape + '.ply')} bytes; {sh_ms:.3f} ms device, "
              f"{sh_host:.3f} ms host wall (files included)")
        with torch.no_grad():
            planes = gen.synthesis_planes(gen.mapping(zd, torch.zeros_like(c).to(dev), 0.7))
        _, grid_ms, _ = timed(torch, lambda: sigma_grid(gen, planes, shape_res=128,
                                                        separable=False))
        print(f"5g(b) the gather sigma grid alone: {grid_ms:.3f} ms device")
        del planes, sh

        # -- (c) gen_videos' per-frame path on a reloaded flagship snapshot ---
        tcfg = TargetSamplerConfig(mc_level=level, int8_probe=True, pallas_probe_build=True)
        snap = os.path.join(tmp, "snap")
        dec = flagship.flagship_decoder(gen, rng=torch.Generator().manual_seed(seed + 33),
                                        device=dev)
        dec.config = dataclasses.replace(dec.config, pallas_mapping=True)
        save_decoder(snap, dec, gen, target_cfg=tcfg)
        del dec
        dec, configs = load_decoder(snap, device=dev)
        dec.eval()
        frozen = configs["frozen_G"]
        require(configs["target_cfg"] == tcfg and dec.config.heads_bf16
                and dec.config.pallas_heads and dec.config.pallas_mapping,
                "5g(c) the snapshot's configs")
        args = gen_videos.build_argparser().parse_args(
            ["--checkpoint", snap, "--backend", "pallas", "--seeds", "0,1,2",
             "--frames_per_seed", "1"])
        zs = gen_videos.seed_latents([0, 1, 2], frozen.z_dim)
        counters = {"mapping": (pallas_mapping.mapping_forward, "launches"),
                    "blend": (pallas_blend.blend_tiles, "launches"),
                    "heads_fwd_bf16": (pallas_heads.decode_heads, "launches_bf16"),
                    "brick_table_probe": (pallas_expand.brick_table, "launches")}
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        seen, frame_ms, first = dict.fromkeys(counters, 0), [], None
        for i in range(3):
            f, d_ms, h_ms = timed(torch, lambda: gen_videos.frame(dec, frozen, tcfg, zs, i,
                                                                  args))
            for name, (fn, attr) in counters.items():
                n = getattr(fn, attr)
                require(n > seen[name], f"5g(c) {name} not launched in frame {i}")
                seen[name] = n
            img = f.image
            require(tuple(img.shape) == (3, IMAGE, IMAGE) and bool(torch.isfinite(img).all())
                    and float(img.std()) > 1e-4, f"5g(c) frame {i}: bad image")
            if i == 0:
                first = f
            else:
                frame_ms.append((d_ms, h_ms))
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        print(f"5g(c) gen_videos frame (--backend pallas, {f.vertices.shape[0]} points, 512^2; "
              f"target with K10's int8 probe table, mapping K1, decode K6 bf16, blend K3): "
              + ", ".join(f"{d:.3f} ms device / {h:.3f} ms host" for d, h in frame_ms)
              + f"; phase-5g launches {launches} in 3 frames ({card})")
        n = 200_000
        cfg = RasterizeConfig(tile_capacity=2176)

        def hold():
            return render_with_decoder(dec, first.z, first.camera_params, first.cam2world,
                                       first.vertices[:n], math.radians(args.fov_deg),
                                       raster_cfg=cfg, backend="pallas")[0]
        k_img = hold()
        with plain_kernels():
            p_img = hold()
        torch.cuda.synchronize()
        held = psnr(k_img, p_img)
        print(f"5g(c) first frame on its first {n} points (tile_capacity 2176), kernels vs "
              f"plain versions of K1, K6 and K3: {held:.2f} dB (limit >= 50 dB)")
        require(held >= 50.0, f"5g(c) the frame disagrees with its plain version: {held:.2f} dB")
        xla = SimpleNamespace(**{**vars(args), "backend": "xla"})
        xf, x_ms, x_host = timed(torch, lambda: gen_videos.frame(dec, frozen, tcfg, zs, 1, xla))
        require(bool(torch.isfinite(xf.image).all()), "5g(c) --backend xla: bad image")
        print(f"5g(c) gen_videos frame --backend xla: {x_ms:.3f} ms device, {x_host:.3f} ms host")
        del dec, frozen, configs, first, xf, k_img, p_img
        torch.cuda.empty_cache()

        # -- (d) gen_interpolation and gen_videos_proj at full width -----------
        z0, z1 = (torch.tensor(np.random.RandomState(s).randn(1, 512), dtype=torch.float32,
                               device=dev) for s in (521, 329))
        grid, g_ms, g_host = timed(torch, lambda: gen_interpolation.interpolation_grid(
            gen, z0, z1, [0, 4], neural_rendering_resolution=nrr))
        require(tuple(grid.shape) == (3, 3 * IMAGE, 3 * IMAGE)
                and bool(torch.isfinite(grid).all()) and float(grid.std()) > 0,
                f"5g(d) gen_interpolation grid {tuple(grid.shape)}")
        print(f"5g(d) gen_interpolation (2 cuts x 3 views, 9 syntheses at 512^2): {g_ms:.3f} "
              f"ms device, {g_host:.3f} ms host")
        with torch.no_grad():
            ws = gen.mapping(z0, torch.zeros((1, 25), device=dev), 0.7)
        npz = os.path.join(tmp, "projected_w.npz")
        np.savez(npz, w=ws.cpu().numpy())
        ck = os.path.join(tmp, "G")
        checkpoint.save(ck, gen.state_dict(), configs={"G": gen.config})
        for mode in ("image", "image_depth"):
            res, p_ms, p_host = timed(torch, lambda: gen_videos_proj.main(
                ["--latents", npz, "--finetuned", ck, "--w_frames", "2", "--image_mode", mode,
                 "--outdir", os.path.join(tmp, mode)]))
            traj = np.load(res["trajectory"])
            require(len(res["frames"]) == 2 and traj.shape == (2, 16)
                    and np.isfinite(traj).all(), f"5g(d) gen_videos_proj {mode}")
            print(f"5g(d) gen_videos_proj --image_mode {mode} (2 frames, --finetuned load "
                  f"included): {p_ms:.3f} ms device, {p_host:.3f} ms host")
    del gen
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dump", default=None,
                    help="save the frame's and the train step's blend inputs to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on an NVIDIA GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from gaussian_gan_decoder_tpu_torch import flagship, kernel_lib
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to this script ({e})",
              file=sys.stderr)
        return 2
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    from gaussian_gan_decoder_tpu_torch.models import pallas_mapping
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import build_slab_volume
    from gaussian_gan_decoder_tpu_torch.splat import fast_raster, pallas_blend

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = f"{smi} (nvidia-smi)"
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # the plain versions are f32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernel_lib.library()
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")
    # the kernels' designs, by their SASS: K6's 128 x 128 products must be
    # TF32 HMMA (mma.sync), not FMAs; K3 reads each staged pair by 16-byte
    # shared loads; K5 reduces a pair's 9 sums with one reduce-scatter
    sass = sass_counts(kernel_lib.build())
    for fn, ops in sorted(sass.items()):
        if ops:
            print(f"SASS {fn[:90]}: " + ", ".join(f"{op} x {n}" for op, n in sorted(ops.items())))
    k6_sass = [ops for fn, ops in sass.items() if "heads_fwd_kernel" in fn]
    require(k6_sass and all(any("TF32" in op for op in ops) for ops in k6_sass),
            "heads_fwd_kernel has no TF32 HMMA in its SASS")
    f32_sass = [ops for fn, ops in sass.items() if "decode_f32_kernel" in fn]
    # 7 forms x 5 GELU kinds (a template argument, as K6's)
    require(len(f32_sass) == 35 and all(any("TF32" in op for op in ops) for ops in f32_sass),
            "the f32 decode kernels lack TF32 HMMA in their SASS")
    # the f32 decode kernels' registers and spills (and their projection
    # kernel's): registers a thread, stack and local memory, and the local
    # loads and stores in the SASS
    for fn, (name, use) in sorted(res_usage(kernel_lib.build()).items(), key=lambda x: x[1][0]):
        if "decode_f32_kernel" in fn or "project_rows_kernel" in fn:
            ops = sass.get(fn, {})
            print(f"registers {name[:110]}: {use.get('REG')} a thread, stack {use.get('STACK')} "
                  f"B, local {use.get('LOCAL')} B; spills: STL x {ops.get('STL', 0)}, LDL x "
                  f"{ops.get('LDL', 0)}")
    bf16_sass = [ops for fn, ops in sass.items() if "heads_bf16_kernel" in fn]
    require(bf16_sass and all(any("BF16" in op for op in ops) for ops in bf16_sass),
            "heads_bf16_kernel has no bf16 HMMA in its SASS")
    k3_sass = [ops for fn, ops in sass.items() if "blend_kernel" in fn]
    require(k3_sass and all(ops.get("LDS.128", 0) > 0 for ops in k3_sass),
            "blend_kernel has no LDS.128 in its SASS")

    # -- the flagship model, template and camera ---------------------------
    rng = torch.Generator().manual_seed(args.seed)
    # the slab route's decoder: the JAX flagship's with the "poly6" GELU the
    # JAX benchmark sets on that route
    dec = flagship.flagship_decoder(rng=rng, device=dev, gelu="poly6").eval()
    weights = dec.fold()
    nprng = np.random.RandomState(args.seed)
    template = ((nprng.rand(POINTS, 3) - 0.5) * 0.4).astype(np.float32)
    t0 = time.perf_counter()
    ctx = dec.make_slab_context(template, device=dev)
    pack_s = time.perf_counter() - t0
    print(f"slab pack: {pack_s:.2f} s host, {ctx.m_padded // ctx.block} blocks, "
          f"Mpad {ctx.m_padded}")
    cp, c2w = flagship.default_camera_params(device=dev)
    cam = make_camera(IMAGE, FOV, c2w, device=dev)
    zs = torch.tensor(nprng.randn(FRAMES + 2, 1, 512).astype(np.float32), device=dev)
    results = {}

    with torch.inference_mode():
        # -- K1: mapping at B = 1 (the frames) and B = 4 (the stream) --------
        # Events around 50 wrapper calls on an idle device read the host's
        # launch path at tens of microseconds: the kernels line takes the
        # calls queued behind a device sleep. (torch.profiler's device time,
        # used before, has been seen to miss launches: 42 of 50, 0 of 20.)
        # A random camera (the frames give K1 the zeroed one): both sides
        # sum in float64, so the order of the sums does not show.
        fm = weights.mapping
        cams = torch.tensor(nprng.randn(STREAM_BATCH, 25).astype(np.float32), device=dev)
        for B in (1, STREAM_BATCH):
            zb, cb = zs[:B, 0], cams[:B]
            ws_k = pallas_mapping.mapping_forward(zb, cb, fm)[:, 0]
            ws_2 = pallas_mapping.mapping_forward(zb, cb, fm)[:, 0]
            ws_p = pallas_mapping.mapping_forward_plain(zb, cb, fm)
            torch.cuda.synchronize()
            err = float((ws_k - ws_p).abs().max())
            rel = err / float(ws_p.abs().max())
            exact = float((ws_k == ws_p).float().mean())
            same = torch.equal(ws_k, ws_2)
            ev_ms, plain_ms = paired_ms(
                torch, lambda: pallas_mapping.mapping_forward(zb, cb, fm),
                lambda: pallas_mapping.mapping_forward_plain(zb, cb, fm), 50)
            ms = queued_ms(torch, lambda: pallas_mapping.mapping_forward(zb, cb, fm), 50)
            b1 = bound(nbytes(fm.we, fm.be, fm.w0, fm.b0, fm.wr, fm.br, fm.w_avg, zb, cb, ws_k),
                       2 * B * sum(w.numel() for w in (fm.we, fm.w0, fm.wr) if w is not None),
                       "bf16")
            print(f"K1 mapping (B {B}, random camera): max|d| {err:.3e} (rel {rel:.3e}), "
                  f"bit-exact on {exact:.5f} of the outputs, two launches bit-identical: "
                  f"{same}; kernel {ms:.4f} ms device (queued events), {ev_ms:.4f} ms a call "
                  f"(events), plain {plain_ms:.4f} ms, bound {b1[0]:.4f} ms")
            require(rel <= 1e-3, f"K1 disagrees with its plain version at B {B}: rel {rel:.3e}")
            require(same, f"K1 is not bit-identical from launch to launch at B {B}")
            if B == 1:
                results["mapping"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b1)
        z = zs[0]
        c0 = torch.zeros((1, 25), dtype=torch.float32, device=dev)

        # -- K2: slab decode over the full flagship pack --------------------
        planes, _ = dec.synthesize_planes(weights, z, cp)
        vol, scales = build_slab_volume(planes, dec.G.triplane_depth)
        rows_k = pallas_heads.decode_project_slab(weights.chain, vol, scales, ctx, cam)
        rows_p = pallas_heads.decode_project_slab_plain(weights.chain, vol, scales, ctx, cam)
        torch.cuda.synchronize()
        v = ctx.valid > 0
        st = slab_staging(torch, weights.chain, vol, scales, ctx)
        k2_err = hold_chain_gap(torch, rows_k, rows_p, st, v, weights.chain, cam,
                                "K2 slab decode")
        del st
        ms, plain_ms = paired_ms(
            torch, lambda: pallas_heads.decode_project_slab(weights.chain, vol, scales, ctx, cam),
            lambda: pallas_heads.decode_project_slab_plain(weights.chain, vol, scales, ctx, cam),
            3)
        print(f"K2 slab decode: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        require(bool((rows_k[16:28, ~v][[5, 10, 11]] == 0).all()), "K2 pad slots not culled")
        cw = weights.chain
        # per point: the chain, 3 planes x 8 corners x 32 channels of
        # trilinear lerp, ~150 FLOPs of projection
        results["slab_decode"] = dict(
            max_abs_err=k2_err, ms=ms, plain_ms=plain_ms,
            bound=bound(nbytes(vol, scales, ctx.positions, ctx.idx16, ctx.aux, ctx.inv_axes,
                               cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4, cw.meta,
                               rows_k),
                        ctx.n_points * (chain_flops(cw) + 3 * 8 * 32 * 2 + 150), "bf16"))

        # -- K3: blend of the flagship frame's binned pairs ------------------
        g = IMAGE // 16
        starts, attrs = fast_raster.bin_pairs(rows_k, g, g, 16)
        cap = flagship.flagship_raster_config().tile_capacity
        tile_stats(torch, starts, cap, "frame pairs")
        acc_k, tr_k = pallas_blend.blend_tiles(starts, attrs, g, g, 16, cap)
        acc_p, tr_p = pallas_blend.blend_tiles_plain(starts, attrs, g, g, 16, cap)
        torch.cuda.synchronize()
        dpix = torch.maximum((acc_k - acc_p).abs().amax(dim=2), (tr_k - tr_p).abs())
        err = float(dpix.max())
        frac = float((dpix <= 1e-4).float().mean())
        ev_ms, plain_ms = paired_ms(
            torch, lambda: pallas_blend.blend_tiles(starts, attrs, g, g, 16, cap),
            lambda: pallas_blend.blend_tiles_plain(starts, attrs, g, g, 16, cap), 5)
        ms = queued_ms(torch, lambda: pallas_blend.blend_tiles(starts, attrs, g, g, 16, cap), 20)
        # the inference rule keeps T decaying past the stop, so no pixel
        # stops early; the bound counts the live evaluations
        evals, live = blend_evaluations(torch, starts, attrs, g, cap, False)
        print(f"K3 blend: {attrs.shape[1]} pairs; {evals} (pair, pixel) evaluations, {live} "
              f"of them live (alpha >= 1/255); max|d| {err:.3e}, within 1e-4 on {frac:.5f} of "
              f"pixels; kernel {ms:.4f} ms device (queued events), {ev_ms:.4f} ms a call "
              f"(events), plain {plain_ms:.3f} ms")
        require(frac >= 0.999 and err <= 1e-2, f"K3 disagrees: max {err}, frac {frac}")
        blended = int(torch.clamp(starts[1:] - starts[:-1], max=cap).sum())
        results["blend"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound=bound(blended * 9 * 4 + nbytes(starts, acc_k, tr_k),
                        BLEND_EVAL_FLOPS["blend"] * live, "f32"))

        # -- K4 / K5 on the frame's pairs (max_k 1024, a seeded cotangent),
        # then on the same pairs 4x wider and more opaque: the random heads'
        # Gaussians are too small and faint for pixels to saturate, and the
        # second set makes them, so the training rule's stop, early exit and
        # zero gradients are held at full size. Printed; the kernels line
        # keeps the train step's readings.
        dout = torch.randn((g * g, 256, 4), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(args.seed))
        dump = {"frame": (starts, attrs, dout)}
        blend_train_kernels(torch, starts, attrs, g, g, 16, 1024, dout, "frame pairs")
        wide = attrs.clone()
        wide[2:5] /= 16.0
        wide[5] = 0.6 + 0.4 * wide[5]
        sat = blend_train_kernels(torch, starts, wide, g, g, 16, 1024, dout,
                                  "frame pairs, 4x wider, opacity 0.6 + 0.4 op")
        sat = sat["blend_train_fwd"]
        require(sat["saturated"] >= 0.01 and sat["eval_share"] <= 0.9,
                f"the widened frame pairs do not saturate: {sat}")
        del wide

        # -- reference frame: the plain versions, stage by stage -------------
        def plain_frame(z):
            ws = pallas_mapping.mapping_forward_plain(z, c0, weights.mapping)
            ws = ws[:, None].expand(1, weights.mapping.num_ws, ws.shape[1])
            pl = dec.G.synthesis_planes(ws, noise_mode="const")
            vo, sc = build_slab_volume(pl, dec.G.triplane_depth)
            rows = pallas_heads.decode_project_slab_plain(weights.chain, vo, sc, ctx, cam)
            return plain_image(torch, rows, g, cap, dev)

        ref_img = plain_frame(zs[1])
        plain_frame_ms = cuda_ms(torch, lambda: plain_frame(zs[1]), 2)

    # -- the main path -------------------------------------------------------
    slab = frame_run(torch, dec, weights, zs[1:], cp, c2w,
                     {"mapping": pallas_mapping.mapping_forward,
                      "slab_decode": pallas_heads.decode_project_slab,
                      "blend_packed_v3": blend_v3_counter(pallas_blend)}, FRAMES, slab_ctx=ctx)
    launches, first = dict(slab["launches"]), slab["first"]
    _, host_med = report_frames(torch, slab, "slab-route")
    print(f"all-plain frame (the same stages, the three plain versions): "
          f"{plain_frame_ms:.3f} ms device")

    # -- device busy share: FRAMES more frames under torch.profiler ----------
    profile_frames(torch, lambda i, timer: flagship.decode_and_render(
        dec, weights, zs[i + 1], cp, c2w, ctx, FOV, image_size=IMAGE, stage_timer=timer),
        host_med, "slab-route")
    fr_psnr = psnr(first[0], ref_img)
    print(f"first frame vs the plain-version frame: {fr_psnr:.2f} dB")
    require(fr_psnr >= 30.0, f"frame disagrees with the plain-version frame: {fr_psnr:.2f} dB")

    del ref_img, first, slab, vol, scales, rows_p
    torch.cuda.empty_cache()

    # -- the brick route: K10, K8, K9, their frames and the stream ------------
    launches.update(brick_phase(torch, dec, weights, planes, rows_k, ctx, template, cam, cp, c2w,
                                args.seed, results))

    # -- the frame-options phase: K3's payload forms, K9 'dots', K10 select ---
    launches.update(frame_options_phase(torch, dec, weights, rows_k, ctx, template, cam, cp,
                                        c2w, args.seed, results))
    del dec, weights, ctx, rows_k, planes
    torch.cuda.empty_cache()

    # -- the training path: apps/train_decoder.py --random_init ---------------
    from gaussian_gan_decoder_tpu_torch.apps import train_decoder
    flags = ["--random_init", "--seed", str(args.seed)]
    gen = flagship.flagship_generator(rng=torch.Generator().manual_seed(args.seed))
    z0 = torch.randn((1, gen.z_dim), generator=torch.Generator().manual_seed(1)).to(dev)
    level, n_faces = surface_level(torch, gen, z0, 128, 2 ** 20)
    del gen
    print(f"surface level {level:.4f} ({SURFACE_QUANTILE} quantile of the first latent's "
          f"128^3 sigma grid): {n_faces} faces")
    require(n_faces > 0, "no surface at the chosen level")
    run = train_decoder.build(train_decoder.build_argparser().parse_args(
        flags + ["--mc_level", repr(level)]))
    tr = train_path(torch, run, TRAIN_STEPS)
    launches.update(tr["launches"])
    step_dev = sorted(d for d, _ in tr["step_ms"])
    step_host = sorted(h for _, h in tr["step_ms"])
    step_med, step_host_med = step_dev[len(step_dev) // 2], step_host[len(step_host) // 2]
    print(f"train step (500k points, 512^2): median {step_med:.3f} ms device, "
          f"{step_host_med:.3f} ms host wall; losses "
          + ", ".join(f"{v:.5f}" for v in tr["losses"])
          + f"; first step {tr['n_pairs']} pairs")
    print("train stage split (median ms): "
          + ", ".join(f"{n} {t:.3f}" for n, t in stage_split(torch, tr["stage_ms"]).items()))
    print(f"peak device memory (train path): {tr['peak'] / 2 ** 30:.3f} GiB; "
          f"launches {tr['launches']}")
    busy_ms, on_card = profile_step(torch, run, tr["state"], tr["draws"][0], tr["zs"][0],
                                    TRAIN_STEPS + 1)
    require(busy_ms > 0, "the profiler saw no device time in the train step")
    print(f"profiler: {busy_ms:.3f} ms device time in one train step, busy "
          f"{busy_ms / step_host_med:.3f} of the median host-wall step; largest: "
          + "; ".join(f"{k[:48]} {t:.3f} ms ({t / busy_ms:.1%})" for t, k in on_card[:6]))
    captured = tr.pop("captured")

    # -- the snapshot phase: checkpoint, snapshot, ID term, eval, render, .ply -
    import tempfile
    with tempfile.TemporaryDirectory() as workdir:
        snapshot_phase(torch, run, tr["state"], args.seed, workdir)
    del run, tr
    torch.cuda.empty_cache()
    train_kernels(torch, captured, results)
    if args.dump:
        st, at, _, dt, *_ = captured["blend_train_bwd"]
        dump["step"] = (st, at, dt)
        torch.save({k: tuple(x.cpu() for x in v) for k, v in dump.items()}, args.dump)
        print(f"blend inputs saved to {args.dump}")
    del captured, dump
    torch.cuda.empty_cache()

    # -- the trainer-options phase: the probe tables (K10 on the target path),
    # the surface options, bf16 LPIPS, two views a step, the 'xla' rasterizer
    launches.update(trainer_options_phase(torch, args.seed, level, results))

    # -- the EG3D phase: the tri-plane forms of K2 and K9, frames and steps ---
    launches.update(eg3d_phase(torch, args.seed, results))

    # -- the decoder-options phase: D-par, D-seq, decode_packed, their steps --
    launches.update(decoder_options_phase(torch, args.seed, template, results))

    # -- the generation phase: the GAN side and the five apps' paths ----------
    t0 = time.perf_counter()
    gen_launches = generation_phase(torch, args.seed, card)
    print(f"5g: {time.perf_counter() - t0:.1f} s host wall; launches {gen_launches}")

    # -- the classic 3DGS phase: train_3dgs / render_3dgs / full_eval_3dgs ---
    gs3d_phase(torch, args.seed)

    # -- the 3D-GAN training phase: train_gan at full width, the app, card vs CPU
    gan_phase(torch, args.seed)

    rec = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"], "bound_ms": results[name]["bound"][0],
         "bound_by": results[name]["bound"][1], "bound_rate": results[name]["bound"][2],
         "library_ms": results[name].get("library_ms")}
        for name in KERNELS]}
    print(json.dumps(rec))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
