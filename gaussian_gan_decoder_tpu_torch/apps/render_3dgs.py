"""Render a scene's views from a trained 3DGS .ply, with per-view metrics —
port of apps/render_3dgs.py.

    python -m gaussian_gan_decoder_tpu_torch.apps.render_3dgs --ply P.ply \\
        -s SCENE [--out DIR] [--vgg_weights W.npz] [--force_cpu]

The reference's render.py:24 (render_set) and metrics.py:36 (evaluate):
one PNG a view and metrics.json with PSNR, SSIM, L1 and LPIPS (VGG16
features; seeded random without --vgg_weights, for relative comparisons
only) per view and their means, which main returns. Runs on the card
unless --force_cpu.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ply", required=True)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--out", default="./renders")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--max_views", type=int, default=0)
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--skip_lpips", action="store_true")
    p.add_argument("--vgg_weights", default="",
                   help="VGG16 LPIPS weights (.npz of torchvision keys); without one, "
                        "seeded random features are used with a warning (relative "
                        "comparisons only)")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch
    from PIL import Image

    from ..data.scene_io import camera_to_render_inputs
    from ..flagship import resolve_device
    from ..gaussians.cameras import make_camera
    from ..gaussians.ply import load_ply
    from ..losses.image import l1_loss, ssim
    from ..losses.lpips import VGG16LPIPS
    from ..port.from_jax import load_vgg16_lpips_state
    from ..splat.rasterize import RasterizeConfig, rasterize
    from .train_3dgs import load_image, read_scene

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    scene = load_ply(args.ply, max_sh_degree=args.sh_degree, device=dev)
    info = read_scene(args.source_path, args.white_background)
    bg = torch.full((3,), 1.0 if args.white_background else 0.0, device=dev)
    rcfg = RasterizeConfig()
    os.makedirs(args.out, exist_ok=True)

    lpips_fn = None
    if not (args.skip_metrics or args.skip_lpips):
        # the per-view LPIPS column (ref metrics.py:36-55, lpipsPyTorch 'vgg')
        vgg = VGG16LPIPS(generator=torch.Generator().manual_seed(0), device=dev).eval()
        if args.vgg_weights:
            load_vgg16_lpips_state(vgg, args.vgg_weights)
        else:
            print("WARNING: no --vgg_weights; LPIPS uses random VGG16 features "
                  "(valid for relative comparisons only)")

        def lpips_fn(a, b):
            # [0, 1] images -> the embedding's [0, 255] domain; the squared
            # difference of two embeddings summed is the LPIPS distance
            d = vgg.embed(a[None] * 255.0) - vgg.embed(b[None] * 255.0)
            return torch.sum(torch.square(d.float()))

    rows = []
    views = info.cameras[: args.max_views or None]
    with torch.no_grad():
        for i, sc in enumerate(views):
            cam2world, fov = camera_to_render_inputs(sc)
            cam = make_camera(args.image_size, fov, cam2world, device=dev)
            img = rasterize(cam, scene.get_xyz, scene.get_scaling, scene.get_rotation,
                            scene.get_opacity, shs=scene.get_features,
                            sh_degree=scene.active_sh_degree, bg=bg, config=rcfg)["render"]
            arr = np.clip(img.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(args.out, f"{i:05d}.png"))
            if not args.skip_metrics and os.path.exists(sc.image_path):
                gt = load_image(sc.image_path, args.image_size, dev)
                mse = float(torch.mean(torch.square(img - gt)))
                row = {"view": i, "PSNR": 10 * math.log10(1.0 / max(mse, 1e-12)),
                       "SSIM": float(ssim(img, gt)[0]), "L1": float(l1_loss(img, gt))}
                if lpips_fn is not None:
                    row["LPIPS"] = float(lpips_fn(img, gt))
                rows.append(row)
    metrics = None
    if rows:
        cols = [k for k in ("PSNR", "SSIM", "L1", "LPIPS") if k in rows[0]]
        metrics = {"per_view": rows,
                   "mean": {k: float(np.mean([r[k] for r in rows])) for k in cols}}
        with open(os.path.join(args.out, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        print(json.dumps(metrics["mean"], indent=2))
    print(f"rendered {len(views)} views to {args.out}")
    return metrics


if __name__ == "__main__":
    main()
