"""Style-mixing interpolation grid between two seeds — port of
apps/gen_interpolation.py (ref PanoHead/gen_interpolation.py:87-196).

    python -m gaussian_gan_decoder_tpu_torch.apps.gen_interpolation \\
        (--network_pkl network.pkl | --smoke) [--seeds 521,329] \\
        [--cuts 0,2,3,4,6,8] [--outdir interpolation_out] [--force_cpu]

Maps two seeds to W+, builds the style-mixed latents (the first seed's ws
below each cut, the second's from it on), synthesizes each under a
frontal, a side (45 deg) and a back conditioning camera, and tiles them
into one grid image, img_interpolation_seed<a>_<b>.png (PIL) or .png.npy:
rows the cuts and then the pure first seed, columns the three views.

The latents come from numpy RandomState(seed), as in the JAX app, so a
seed gives the JAX app's z.
"""
from __future__ import annotations

import argparse
import math
import os


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network_pkl", default="")
    p.add_argument("--smoke", action="store_true",
                   help="tiny random generator instead of --network_pkl")
    p.add_argument("--seeds", default="521,329", help="two comma seeds (ref defaults)")
    p.add_argument("--cuts", default="0,2,3,4,6,8",
                   help="style-mixing cut layers (ref interpolation_idx list)")
    p.add_argument("--trunc", type=float, default=0.7)
    p.add_argument("--pose_cond_deg", type=float, default=90.0)
    p.add_argument("--fov_deg", type=float, default=18.837)
    p.add_argument("--neural_rendering_resolution", type=int, default=64)
    p.add_argument("--outdir", default="interpolation_out")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def interpolation_grid(gen, z0, z1, cuts, trunc=0.7, pose_cond_deg=90.0, fov_deg=18.837,
                       neural_rendering_resolution=64):
    """-> (3, rows * H, 3 * W) float grid in [0, 1]: per view (frontal, side,
    back), the mixed ws of each cut and then ws0, stacked downwards."""
    import torch

    from .gen_samples import orbit_camera
    dev = z0.device
    radius = gen.rk.get("avg_camera_radius", 2.7)

    def cam(yaw_rad):
        return orbit_camera(yaw_rad, math.pi / 2, fov_deg, radius,
                            lookat=torch.zeros((1, 3)))[0].to(dev)

    pose_cond = pose_cond_deg / 180 * math.pi
    # frontal / side (45 deg) / back conditioning (ref :139-148)
    cams = [cam(pose_cond), cam(45 / 180 * math.pi), cam(-pose_cond)]
    with torch.no_grad():
        ws0 = gen.mapping(z0, cams[0], truncation_psi=trunc)
        ws1 = gen.mapping(z1, cams[0], truncation_psi=trunc)

        def synth(ws, c):
            # the renderer's draws seeded 0, as the JAX app's key=None
            out = gen.synthesis(ws, c, torch.Generator().manual_seed(0),
                                neural_rendering_resolution)
            img = (out["image"] if "image" in out else out["image_raw"])[0]
            return torch.clamp((img + 1) / 2, 0, 1)   # ref norm_range to [0, 1]

        cols = []
        for c in cams:
            rows = []
            for cut in cuts:
                # ws0 below the cut, ws1 from the cut on (ref :174-175)
                mask = (torch.arange(gen.num_ws, device=dev) >= cut)[None, :, None]
                rows.append(synth(torch.where(mask, ws1, ws0), c))
            rows.append(synth(ws0, c))
            cols.append(torch.cat(rows, dim=1))
        return torch.cat(cols, dim=2)


def main(argv=None):
    """-> {image (the path written), grid (3, rows * H, 3 * W)}."""
    args = build_argparser().parse_args(argv)
    import numpy as np
    import torch

    from ..flagship import resolve_device
    from ..utils.loggers import write_image

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    if args.smoke:
        from .gen_samples import smoke_generator
        gen = smoke_generator(dev)
        args.neural_rendering_resolution = min(args.neural_rendering_resolution, 16)
    else:
        if not args.network_pkl:
            raise SystemExit("gen_interpolation: need --network_pkl (or --smoke)")
        from ..port.torch_pickle import load_generator_pkl
        gen = load_generator_pkl(args.network_pkl, device=dev)[0]
    gen.eval()
    seed1, seed2 = (int(s) for s in args.seeds.split(","))
    cuts = [int(c) for c in args.cuts.split(",")]
    z0, z1 = (torch.tensor(np.random.RandomState(s).randn(1, gen.z_dim), dtype=torch.float32,
                           device=dev) for s in (seed1, seed2))
    grid = interpolation_grid(gen, z0, z1, cuts, args.trunc, args.pose_cond_deg, args.fov_deg,
                              args.neural_rendering_resolution)
    os.makedirs(args.outdir, exist_ok=True)
    arr = np.clip(grid.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
    path = write_image(arr, os.path.join(args.outdir, f"img_interpolation_seed{seed1}_{seed2}.png"))
    print(f"wrote {path} ({arr.shape[1]}x{arr.shape[0]})")
    return {"image": path, "grid": grid}


if __name__ == "__main__":
    main()
