"""Distillation training CLI — port of apps/train_decoder.py for the
configuration it runs by default with --random_init.

    python -m gaussian_gan_decoder_tpu_torch.apps.train_decoder --random_init \\
        --num_iter N [--outdir ./results] [--force_cpu] [--smoke]

Flagship PanoHead generator with seeded random weights, sequential_reversed
heads (hidden 128, exact GELU), the trainable G copy, normal camera
sampling, marching-tetrahedra surface points, the training rasterizer and a
seeded random VGG16 for LPIPS. Per-step losses go to
<outdir>/run<run_name>_<n>/stats.jsonl. --smoke swaps in the JAX CLI's tiny
generator and shapes (CPU runs). Flags of paths the port does not run raise
NotImplementedError naming the ROADMAP item; checkpoints, .ply export and
the final eval are not written (ROADMAP queue A item 7).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time
from types import SimpleNamespace

import torch

ARCH_PRESETS = {
    # (vertical_std, horizontal_std, fov_offset, fov_offset_scale, bg, variant)
    "panohead": (0.3, 1.0, 5.0, 12.0, (0.55717, 0.52256, 0.51045), "panohead"),
    "eg3d_ffhq": (0.2, 0.2, 5.0, 12.0, (0.0, 0.0, 0.0), "eg3d"),
    "eg3d_lpff": (0.2, 0.2, 5.0, 12.0, (0.0, 0.0, 0.0), "eg3d"),
    "eg3d_cats": (0.2, 0.2, 5.0, 12.0, (0.0, 0.0, 0.0), "eg3d"),
}
ROADMAP_TRAIN = "ROADMAP.md queue A item 7 (training)"


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=303)
    p.add_argument("--lr", type=float, default=0.00009)
    p.add_argument("--num_iter", type=int, default=100_001)
    p.add_argument("--eval_steps", type=int, default=10_000)
    p.add_argument("--l1_weight", type=float, default=0.2)
    p.add_argument("--l2_weight", type=float, default=0.1)
    p.add_argument("--lpips_weight", type=float, default=1.0)
    p.add_argument("--ssim_weight", type=float, default=0.5)
    p.add_argument("--sobel_weight", type=float, default=0.2)
    p.add_argument("--id_loss_weight", type=float, default=1.0)
    p.add_argument("--generator_arch", default="panohead", choices=sorted(ARCH_PRESETS))
    p.add_argument("--network_pkl", default="")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--load_checkpoint", default="")
    p.add_argument("--decoder_type", default="sequential_reversed",
                   choices=["sequential", "parallel", "sequential_reversed"])
    bo = argparse.BooleanOptionalAction
    p.add_argument("--use_pos_encoding", action=bo, default=False)
    p.add_argument("--use_gen_finetune", action=bo, default=True)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--use_marching_cubes", action=bo, default=True)
    p.add_argument("--surface_thickness", type=float, default=0.1)
    p.add_argument("--apply_mask_to_rendering", action=bo, default=False)
    p.add_argument("--truncation", type=float, default=1.0)
    p.add_argument("--init_truncation", type=float, default=1.0)
    p.add_argument("--truncation_ramp", type=int, default=20_000)
    p.add_argument("--camera_sampling", default="normal", choices=["uniform", "normal"])
    p.add_argument("--repeat_id", type=int, default=1)
    p.add_argument("--run_name", default="test")
    p.add_argument("--save_model_interval", type=int, default=25_000)
    p.add_argument("--logging_interval", type=int, default=1_000)
    p.add_argument("--use_wandb", action=bo, default=False)
    p.add_argument("--outdir", default="./results")
    p.add_argument("--num_points", type=int, default=500_000)
    p.add_argument("--shape_res", type=int, default=128)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--mc_level", type=float, default=10.0)
    p.add_argument("--id_weights", default="")
    p.add_argument("--vgg_weights", default="", help="state dict (.npz) for VGG16 LPIPS")
    p.add_argument("--batch_views", type=int, default=0)
    p.add_argument("--bf16_probe", action=bo, default=False)
    p.add_argument("--reuse_frozen_planes", action=bo, default=True)
    p.add_argument("--int8_probe", action=bo, default=False)
    p.add_argument("--bf16_lpips", action=bo, default=False)
    p.add_argument("--pallas_probe_build", action=bo, default=False)
    p.add_argument("--mt_two_stage", action=bo, default=True)
    p.add_argument("--sigma_separable", action=bo, default=True)
    p.add_argument("--pallas_heads_train", action=bo, default=True)
    p.add_argument("--raster_backend", default="pallas_diff", choices=["xla", "pallas_diff"])
    p.add_argument("--smoke", action="store_true", help="tiny generator + tiny shapes")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def _refuse_unported(args):
    """Raise NotImplementedError for every flag whose path the port lacks."""
    unported = {
        "--generator_arch eg3d_*": args.generator_arch != "panohead",
        "--network_pkl": bool(args.network_pkl),
        "--load_checkpoint": bool(args.load_checkpoint),
        "--batch_views": args.batch_views > 0,
        "--pallas_probe_build": args.pallas_probe_build,
        "--int8_probe": args.int8_probe,
        "--bf16_probe": args.bf16_probe,
        "--id_weights": bool(args.id_weights),
        "--bf16_lpips": args.bf16_lpips,
        "--decoder_type other than sequential_reversed":
            args.decoder_type != "sequential_reversed",
        "--use_pos_encoding": args.use_pos_encoding,
        "--hidden_dim other than 128": args.hidden_dim != 128,
        "--no-use_marching_cubes": not args.use_marching_cubes,
        "--no-mt_two_stage": not args.mt_two_stage,
        "--no-sigma_separable": not args.sigma_separable,
        "--no-pallas_heads_train": not args.pallas_heads_train,
        "--raster_backend xla": args.raster_backend != "pallas_diff",
        "--use_wandb": args.use_wandb,
    }
    # the final eval, the ID loss, checkpoints, the compare-image log and the
    # decode through the frozen copy's own synthesis are not ported: their
    # flags are accepted at their defaults only, so that none is ignored
    defaults = build_argparser()
    for name in ("eval_steps", "id_loss_weight", "save_model_interval", "logging_interval",
                 "reuse_frozen_planes"):
        if getattr(args, name) != defaults.get_default(name):
            unported[f"--{name} away from its default"] = True
    bad = [flag for flag, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"{', '.join(bad)}: not ported to the PyTorch trainer "
                                  f"yet ({ROADMAP_TRAIN})")
    if not args.random_init:
        raise SystemExit("--random_init is required (ported weights: --network_pkl, "
                         f"not ported yet, {ROADMAP_TRAIN})")


def build(args):
    """Parsed flags -> SimpleNamespace(dev, gen, decoder, vgg, cfg, tcfg,
    state, step): the frozen generator, the decoder with its trainable G
    copy, the LPIPS VGG16, the configs, the train state and the step of
    make_train_step. Raises for a flag whose path is not ported."""
    _refuse_unported(args)
    from ..decoder.heads import GaussianDecoder
    from ..decoder.target_pipeline import TargetSamplerConfig
    from ..flagship import flagship_generator, resolve_device
    from ..losses import VGG16LPIPS
    from ..models.triplane import TriPlaneGenerator
    from ..port.from_jax import load_vgg16_lpips_state
    from ..splat.rasterize import RasterizeConfig
    from ..train.distill import DistillConfig, init_train_state, make_train_step

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    v_std, h_std, fov_off, fov_scale, bg, variant = ARCH_PRESETS[args.generator_arch]
    rng = torch.Generator().manual_seed(args.seed)
    if args.smoke:
        gen = TriPlaneGenerator(
            z_dim=32, c_dim=25, w_dim=32, img_resolution=32, variant=variant, without_sr=True,
            channel_base=512, channel_max=32, generator=rng, device=dev,
            rendering_kwargs={"triplane_size": 16, "depth_resolution": 4,
                              "depth_resolution_importance": 4,
                              "c_gen_conditioning_zero": True})
        args.num_points = min(args.num_points, 1024)
        args.shape_res = min(args.shape_res, 16)
        args.image_size = min(args.image_size, 16)
        args.mc_level = 0.5
        print("smoke generator")
    else:
        gen = flagship_generator(variant=variant, rng=rng, device=dev)
        print("random-init generator (full shapes)")
    decoder = GaussianDecoder(copy.deepcopy(gen), gelu="exact", rng=rng, device=dev)
    cfg = DistillConfig(
        lr=args.lr, l1_weight=args.l1_weight, l2_weight=args.l2_weight,
        lpips_weight=args.lpips_weight, ssim_weight=args.ssim_weight,
        sobel_weight=args.sobel_weight, image_size=args.image_size,
        apply_mask_to_rendering=args.apply_mask_to_rendering, bg_color=bg,
        use_gen_finetune=args.use_gen_finetune)
    tcfg = TargetSamplerConfig(
        truncation=args.truncation, init_truncation=args.init_truncation,
        truncation_ramp=args.truncation_ramp, camera_sampling=args.camera_sampling,
        vertical_stddev=v_std, horizontal_stddev=h_std, fov_offset=fov_off,
        fov_offset_scale=fov_scale, surface_thickness=args.surface_thickness,
        shape_res=args.shape_res, num_points=args.num_points, mc_level=args.mc_level,
        face_capacity=min(2 ** 20, 12 * (args.shape_res - 1) ** 3),
        neural_rendering_resolution=min(64, args.image_size))
    vgg = VGG16LPIPS(generator=torch.Generator().manual_seed(7), device=dev)
    if args.vgg_weights:
        load_vgg16_lpips_state(vgg, args.vgg_weights)
    else:
        print("WARNING: random VGG16 (supply --vgg_weights for calibrated LPIPS)")
    state = init_train_state(decoder, gen, cfg)
    step = make_train_step(decoder, gen, vgg, cfg, tcfg, RasterizeConfig())
    return SimpleNamespace(dev=dev, gen=gen, decoder=decoder, vgg=vgg, cfg=cfg, tcfg=tcfg,
                           state=state, step=step)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    run = build(args)
    from ..decoder.target_pipeline import TargetDraws

    os.makedirs(args.outdir, exist_ok=True)
    number = len(os.listdir(args.outdir))
    outdir = os.path.join(args.outdir, f"run{args.run_name}_{number}")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "training_options.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    state = run.state
    draw_rng = torch.Generator().manual_seed(args.seed + 1)
    z, last = None, {}
    with open(os.path.join(outdir, "stats.jsonl"), "a") as stats:
        for i in range(args.num_iter):
            if z is None or args.repeat_id <= 1 or i % args.repeat_id == 0:
                z = torch.randn((1, run.gen.z_dim), generator=draw_rng).to(run.dev)
            draws = TargetDraws.make(draw_rng, run.gen, run.tcfg, run.dev)
            t0 = time.perf_counter()
            state, metrics, _ = run.step(state, draws, z, i)
            last = {k: float(v) for k, v in metrics.items()}
            row = {"step": i, "seconds": time.perf_counter() - t0, **last}
            stats.write(json.dumps(row) + "\n")
            stats.flush()
            if i % 50 == 0 or i == args.num_iter - 1:
                print(f"[{i}] total={last['Loss/total']:.4f} L1={last['Loss/L1']:.4f}")
    return {"outdir": outdir, "last_metrics": last}


if __name__ == "__main__":
    main()
