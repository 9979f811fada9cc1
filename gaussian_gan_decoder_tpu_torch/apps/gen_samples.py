"""Sample images (and optional shapes) straight from a 3D GAN — port of
apps/gen_samples.py (ref PanoHead/gen_samples.py).

    python -m gaussian_gan_decoder_tpu_torch.apps.gen_samples \\
        --network_pkl network.pkl --seeds 0,1,2 [--random_views 4] [--shapes] \\
        [--outdir out_samples] [--force_cpu]

Per seed, the generator's volume-rendering forward (TriPlaneGenerator.apply:
mapping, PanoHead's self-adaptive camera, synthesis) at the given yaw
offsets, or at --random_views random views (yaw in [-45, 45] deg, pitch in
[-0.2, 0.2] deg: the ID-evaluation pairs of ref gen_samples_forID.py),
written as seedNNNN_<view>.png (PIL) or .png.npy (without PIL); --shapes
adds the density grid as seedNNNN.mrc. --smoke takes the JAX app's tiny
random generator instead of a pickle.

z is the JAX app's jax.random.normal(PRNGKey(seed), (1, z_dim)), drawn by
the port's numpy threefry (utils/jax_random.py), so a seed gives the JAX
app's head. The view draws (numpy RandomState(seed)) are the JAX app's.
"""
from __future__ import annotations

import argparse
import math
import os


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network_pkl", default="", help="reference GAN .pkl")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--trunc", type=float, default=0.7)
    p.add_argument("--fov_deg", type=float, default=18.837)
    p.add_argument("--yaws", default="0.0", help="comma yaw offsets (rad)")
    p.add_argument("--random_views", type=int, default=0,
                   help=">0: per seed render N random views (yaw in [-45,45] deg, pitch in "
                        "[-0.2,0.2] deg) saved as seedNNNN_i.png")
    p.add_argument("--outdir", default="out_samples")
    p.add_argument("--shapes", action="store_true")
    p.add_argument("--shape_res", type=int, default=128)
    p.add_argument("--smoke", action="store_true",
                   help="the tiny random generator instead of --network_pkl")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def smoke_generator(device):
    """The JAX apps' --smoke generator (z/w 32, 16^2 tri-grid of depth 3, 4 + 4
    depth samples, no SR) with weights seeded 0."""
    import torch

    from ..models.triplane import TriPlaneGenerator
    return TriPlaneGenerator(
        z_dim=32, c_dim=25, w_dim=32, img_resolution=32, variant="panohead", without_sr=True,
        channel_base=512, channel_max=32,
        rendering_kwargs={"triplane_size": 16, "depth_resolution": 4,
                          "depth_resolution_importance": 4},
        generator=torch.Generator().manual_seed(0), device=device)


def orbit_camera(h, v, fov_deg, radius=2.7, lookat=None):
    """The y-up orbit camera at angles (h, v) in radians ((pi/2, pi/2):
    frontal, level), looking at lookat ((1, 3); the origin when None) ->
    ((1, 25) camera params, cam2world (1, 4, 4)), on the CPU."""
    import torch

    from ..decoder.camera_sampling import fov_to_intrinsics, pose_from_hv
    pose = pose_from_hv(torch.tensor([[h]]), torch.tensor([[v]]), radius, lookat=lookat)
    intr = fov_to_intrinsics(torch.tensor(float(fov_deg)))
    return torch.cat([pose.reshape(1, 16), intr.reshape(1, 9)], dim=1), pose


def main(argv=None):
    """-> {images: [paths], shapes: [paths]}."""
    args = build_argparser().parse_args(argv)
    import numpy as np
    import torch

    from ..flagship import resolve_device
    from ..utils.jax_random import seed_normal
    from ..utils.loggers import write_image

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    if args.smoke:
        gen, nrr = smoke_generator(dev), 32
    else:
        from ..port.torch_pickle import load_generator_pkl
        gen, nrr = load_generator_pkl(args.network_pkl, device=dev)[0], 64
    gen.eval()
    os.makedirs(args.outdir, exist_ok=True)
    out = {"images": [], "shapes": []}
    with torch.no_grad():
        for seed in [int(s) for s in args.seeds.split(",")]:
            z = torch.from_numpy(seed_normal(seed, (1, gen.z_dim))).to(dev)
            rnd = np.random.RandomState(seed)
            if args.random_views > 0:
                views = [((-45 + 90 * rnd.random_sample()) / 180 * math.pi,
                          (-0.2 + 0.4 * rnd.random_sample()) / 180 * math.pi, f"{i}")
                         for i in range(args.random_views)]
            else:
                views = [(float(y), 0.0, f"yaw{float(y):+.2f}") for y in args.yaws.split(",")]
            for yaw, pitch, tag in views:
                c = orbit_camera(math.pi / 2 + yaw, math.pi / 2 + pitch,
                                 args.fov_deg)[0].to(dev)
                # the renderer's draws from a generator seeded 0 each view, as
                # the JAX app renders every view with PRNGKey(0)
                res = gen.apply(z, c, truncation_psi=args.trunc, neural_rendering_resolution=nrr,
                                draws=torch.Generator().manual_seed(0))
                img = res["image"] if "image" in res else res["image_raw"]
                img = torch.clamp((img + 1) * 127.5, 0, 255)
                arr = img[0].cpu().numpy().transpose(1, 2, 0).astype(np.uint8)
                path = write_image(arr, os.path.join(args.outdir, f"seed{seed:04d}_{tag}.png"))
                out["images"].append(path)
                print(f"wrote {path}")
            if args.shapes:
                from ..decoder.surface import sigma_grid
                from ..gaussians.shape_export import save_mrc

                ws = gen.mapping(z, torch.zeros((1, gen.c_dim), device=dev),
                                 truncation_psi=args.trunc)
                planes = gen.synthesis_planes(ws, noise_mode="const")
                # the gather grid: the JAX function's default
                sig = sigma_grid(gen, planes, shape_res=args.shape_res,
                                 chunk=min(2 ** 18, args.shape_res ** 3), separable=False)
                path = os.path.join(args.outdir, f"seed{seed:04d}.mrc")
                save_mrc(path, sig.cpu().numpy())
                out["shapes"].append(path)
                print(f"wrote seed{seed:04d}.mrc")
    return out


if __name__ == "__main__":
    main()
