"""Batch 3DGS evaluation: train + render + metrics over many scenes — port
of apps/full_eval_3dgs.py.

Equivalent of the reference's gaussian_splatting/full_eval.py — the
benchmark orchestrator (MipNeRF-360 / Tanks&Temples / DeepBlending style
runs). The reference shells out per scene; here each stage is a direct
call into the train/render apps, scene lists come from the command line
(the canonical benchmark scene names are provided as defaults), and the
per-scene metric JSONs are merged into one summary.

Usage:
  python -m gaussian_gan_decoder_tpu_torch.apps.full_eval_3dgs \\
      --scenes data/garden data/room --output_path ./eval
"""
from __future__ import annotations

import argparse
import json
import os

# the reference's benchmark scene lists (full_eval.py:15-18) — used when
# --scene_root is given instead of explicit --scenes paths
MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenes", nargs="*", default=[],
                   help="explicit scene dirs (COLMAP sparse/ or Blender)")
    p.add_argument("--scene_root", default="",
                   help="root holding the canonical benchmark scenes")
    p.add_argument("--output_path", default="./eval")
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--capacity", type=int, default=2 ** 20)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    scenes = list(args.scenes)
    if args.scene_root:
        for name in (MIPNERF360_OUTDOOR + MIPNERF360_INDOOR
                     + TANKS_AND_TEMPLES + DEEP_BLENDING):
            cand = os.path.join(args.scene_root, name)
            if os.path.isdir(cand):
                scenes.append(cand)
    if not scenes:
        raise SystemExit("no scenes (use --scenes or --scene_root)")

    from .render_3dgs import main as render_main
    from .train_3dgs import main as train_main

    os.makedirs(args.output_path, exist_ok=True)
    summary = {}
    for scene in scenes:
        name = os.path.basename(os.path.normpath(scene))
        model_dir = os.path.join(args.output_path, name)
        common = ["--force_cpu"] if args.force_cpu else []
        if not args.skip_training:
            train_main(["-s", scene, "-m", model_dir,
                        "--iterations", str(args.iterations),
                        "--capacity", str(args.capacity),
                        "--image_size", str(args.image_size)] + common)
        ply = os.path.join(
            model_dir, "point_cloud", f"iteration_{args.iterations}",
            "point_cloud.ply")
        if not os.path.exists(ply):   # trainer may save under 'final'
            alt = os.path.join(model_dir, "point_cloud", "final",
                               "point_cloud.ply")
            ply = alt if os.path.exists(alt) else ply
        if not args.skip_rendering:
            render_args = ["--ply", ply, "-s", scene,
                           "--out", os.path.join(model_dir, "renders"),
                           "--image_size", str(args.image_size)] + common
            if args.skip_metrics:
                render_args.append("--skip_metrics")
            result = render_main(render_args)
            if isinstance(result, dict):
                summary[name] = result
        mfile = os.path.join(model_dir, "renders", "metrics.json")
        if name not in summary and os.path.exists(mfile):
            with open(mfile) as f:
                summary[name] = json.load(f)

    out_file = os.path.join(args.output_path, "full_eval.json")
    with open(out_file, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"wrote {out_file}")
    return summary


if __name__ == "__main__":
    main()
