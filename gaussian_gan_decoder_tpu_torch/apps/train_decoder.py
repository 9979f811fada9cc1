"""Distillation training CLI — port of apps/train_decoder.py.

    python -m gaussian_gan_decoder_tpu_torch.apps.train_decoder --random_init \\
        --num_iter N [--outdir ./results] [--force_cpu] [--smoke]
    python -m gaussian_gan_decoder_tpu_torch.apps.train_decoder \\
        --network_pkl easy-khair.pkl --id_weights model_ir_se50.pth
    python -m gaussian_gan_decoder_tpu_torch.apps.train_decoder \\
        --generator_arch eg3d_ffhq --random_init --smoke --force_cpu --num_iter 3

The generator of --generator_arch (the PanoHead tri-grid, or an EG3D
tri-plane preset: eg3d_ffhq, eg3d_lpff, eg3d_cats, each with its camera
stddevs and background) from a reference pickle (--network_pkl, through
port/torch_pickle.py) or with seeded random weights (--random_init; --smoke
swaps in the JAX CLI's tiny generator and shapes, for CPU runs), the heads
of --decoder_type (sequential_reversed, sequential or parallel; exact GELU,
--hidden_dim wide, the xyz embedding with --use_pos_encoding; the f32
kernel chain K6 / K7 unless --no-pallas_heads_train or a width other than
128 takes the plain chain), the trainable G copy,
normal camera sampling, marching-tetrahedra surface points, the training
rasterizer, a VGG16 for LPIPS (seeded random without --vgg_weights) and,
with --id_weights, the IR-SE50 ID term on frontal views.

Outputs in <outdir>/run<run_name>_<n>/, as the JAX loop writes them:
stats.jsonl (scalars every --scalars_interval steps, 50 as in the JAX
loop, then the final eval), images/render_<step>.png (render | target every
--logging_interval steps), decoder_<step:06d> snapshots with decoder<i>.npz
and the reference-named decoder<i>.pt every --save_model_interval steps,
then run_eval over min(--eval_steps, 100) steps and decoder_final.
--load_checkpoint restores a train state written by train/checkpoint.save
and runs on from its step (the JAX loop writes no train state itself; on
resume, as in the JAX loop, the draws start again from the seed). Flags of
paths the port does not run raise NotImplementedError naming the ROADMAP
item.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
from types import SimpleNamespace

import torch

ARCH_PRESETS = {
    # (vertical_std, horizontal_std, fov_offset, fov_offset_scale, bg, variant)
    "panohead": (0.3, 1.0, 5.0, 12.0, (0.55717, 0.52256, 0.51045), "panohead"),
    "eg3d_ffhq": (0.2, 0.2, 5.0, 12.0, (0.0, 0.0, 0.0), "eg3d"),
    "eg3d_lpff": (0.2, 0.2, 5.0, 12.0, (0.0, 0.0, 0.0), "eg3d"),
    "eg3d_cats": (0.2, 0.2, 5.0, 12.0, (0.0, 0.0, 0.0), "eg3d"),
}
ROADMAP_DECODE = "ROADMAP.md queue A item A4"
ROADMAP_RASTER = "ROADMAP.md queue A item A3"


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
    p.add_argument("--scalars_interval", type=int, default=50,
                   help="steps between stats.jsonl rows (the JAX loop's fixed 50)")
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
        "--batch_views": (args.batch_views > 0, ROADMAP_DECODE),
        "--pallas_probe_build": (args.pallas_probe_build, ROADMAP_DECODE),
        "--int8_probe": (args.int8_probe, ROADMAP_DECODE),
        "--bf16_probe": (args.bf16_probe, ROADMAP_DECODE),
        "--bf16_lpips": (args.bf16_lpips, ROADMAP_DECODE),
        "--no-use_marching_cubes": (not args.use_marching_cubes, ROADMAP_DECODE),
        "--no-mt_two_stage": (not args.mt_two_stage, ROADMAP_DECODE),
        "--no-sigma_separable": (not args.sigma_separable, ROADMAP_DECODE),
        "--raster_backend xla": (args.raster_backend != "pallas_diff", ROADMAP_RASTER),
    }
    bad = [(flag, item) for flag, (on, item) in unported.items() if on]
    if bad:
        raise NotImplementedError("; ".join(f"{flag}: not ported to the PyTorch trainer yet "
                                            f"({item})" for flag, item in bad))
    if not (args.random_init or args.network_pkl or args.smoke):
        raise SystemExit("--network_pkl or --random_init required")


def build(args):
    """Parsed flags -> SimpleNamespace(dev, gen, decoder, vgg, irse, cfg,
    tcfg, rcfg, state, step): the frozen generator, the decoder with its
    trainable G copy, the LPIPS VGG16, the IR-SE50 (or None), the configs,
    the train state and the step of make_train_step. Raises for a flag
    whose path is not ported."""
    _refuse_unported(args)
    from ..decoder.heads import GaussianDecoder
    from ..decoder.target_pipeline import TargetSamplerConfig
    from ..flagship import flagship_generator, resolve_device
    from ..losses import IRSE50, VGG16LPIPS, load_irse50_state
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
        args.id_loss_weight = 0.0
        print("smoke generator")
    elif args.network_pkl:
        from ..port.torch_pickle import load_generator_pkl

        gen, _ = load_generator_pkl(args.network_pkl, variant=variant, device=dev)
        print(f"ported generator from {args.network_pkl}: {gen.variant}")
    else:
        gen = flagship_generator(variant=variant, rng=rng, device=dev)
        print("random-init generator (full shapes)")
    # the JAX trainer's decoder: exact GELU, f32 heads; --no-pallas_heads_train
    # (and any hidden width but 128) trains the plain chain
    decoder = GaussianDecoder(copy.deepcopy(gen), gelu="exact", rng=rng, device=dev,
                              decoder_type=args.decoder_type, hidden_dim=args.hidden_dim,
                              use_xyz_embedding=args.use_pos_encoding, heads_bf16=False,
                              pallas_heads=False, pallas_heads_train=args.pallas_heads_train)
    cfg = DistillConfig(
        lr=args.lr, l1_weight=args.l1_weight, l2_weight=args.l2_weight,
        lpips_weight=args.lpips_weight, ssim_weight=args.ssim_weight,
        sobel_weight=args.sobel_weight, id_loss_weight=args.id_loss_weight,
        image_size=args.image_size, apply_mask_to_rendering=args.apply_mask_to_rendering,
        bg_color=bg, use_gen_finetune=args.use_gen_finetune,
        reuse_frozen_planes=args.reuse_frozen_planes)
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
    irse = None
    if args.id_loss_weight > 0 and args.id_weights:
        irse = IRSE50(device=dev)
        load_irse50_state(irse, args.id_weights)
    rcfg = RasterizeConfig()
    state = init_train_state(decoder, gen, cfg)
    step = make_train_step(decoder, gen, vgg, cfg, tcfg, rcfg, irse)
    return SimpleNamespace(dev=dev, gen=gen, decoder=decoder, vgg=vgg, irse=irse, cfg=cfg,
                           tcfg=tcfg, rcfg=rcfg, state=state, step=step)


def reference_state_dict(decoder):
    """The decoder's reference-named state dict as CPU float32 tensors (the
    reference's decoder{i}.pt, ref train_pano2gaussian_decoder.py:307; the
    JAX package writes the same names, port/torch_export.py)."""
    return {k: v.detach().to("cpu", torch.float32, copy=True).contiguous()
            for k, v in decoder.state_dict().items()}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    run = build(args)
    from ..decoder.snapshot import save_decoder
    from ..decoder.target_pipeline import TargetDraws
    from ..train import checkpoint
    from ..train.eval import run_eval
    from ..utils.loggers import TrainLogger

    os.makedirs(args.outdir, exist_ok=True)
    number = len(os.listdir(args.outdir))
    name = f"run{args.run_name}_{number}"
    outdir = os.path.join(args.outdir, name)
    os.makedirs(outdir, exist_ok=True)
    logger = TrainLogger(outdir, use_wandb=args.use_wandb, run_name=name)
    with open(os.path.join(outdir, "training_options.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    state = run.state
    if args.load_checkpoint:
        state = checkpoint.restore(args.load_checkpoint, state)
        print(f"resumed from {args.load_checkpoint} at step {state.step}")
    snapshot_configs = dict(target_cfg=run.tcfg, extra_configs={"distill_cfg": run.cfg})
    draw_rng = torch.Generator().manual_seed(args.seed + 1)
    z, last = None, {}
    for i in range(state.step, args.num_iter):
        if z is None or args.repeat_id <= 1 or i % args.repeat_id == 0:
            z = torch.randn((1, run.gen.z_dim), generator=draw_rng).to(run.dev)
        draws = TargetDraws.make(draw_rng, run.gen, run.tcfg, run.dev)
        state, metrics, aux = run.step(state, draws, z, i)
        last = metrics
        if i % args.scalars_interval == 0:
            row = logger.log_scalars(i, metrics)
            print(f"[{i}] total={row['Loss/total']:.4f} L1={row['Loss/L1']:.4f}")
        if i % args.logging_interval == 0:
            logger.log_compare_image(i, aux["image"], aux["target"])
        if i % args.save_model_interval == 0 and i > 0:
            save_decoder(os.path.join(outdir, f"decoder_{i:06d}"), run.decoder, run.gen,
                         **snapshot_configs)
            checkpoint.save_npz(os.path.join(outdir, f"decoder{i}.npz"),
                                run.decoder.state_dict())
            torch.save(reference_state_dict(run.decoder), os.path.join(outdir, f"decoder{i}.pt"))

    metrics = run_eval(torch.Generator().manual_seed(args.seed + 99), run.decoder, run.gen,
                       run.vgg, run.irse, eval_steps=min(args.eval_steps, 100), cfg=run.cfg,
                       target_cfg=run.tcfg, raster_cfg=run.rcfg)
    logger.write_raw({"final_eval": metrics})
    print(json.dumps(metrics, indent=2))
    save_decoder(os.path.join(outdir, "decoder_final"), run.decoder, run.gen, **snapshot_configs)
    logger.close()
    return {"final_eval": metrics, "outdir": outdir, "state": state,
            "last_metrics": {k: float(v) for k, v in last.items()}}


if __name__ == "__main__":
    main()
