"""Export GAN geometry: density grid -> .mrc volume + .ply mesh — port of
apps/gen_shapes.py (ref PanoHead/gen_samples.py --shapes, shape_utils.py).

    python -m gaussian_gan_decoder_tpu_torch.apps.gen_shapes \\
        (--network_pkl network.pkl | --checkpoint results/runX/decoder_final) \\
        [--seed 0] [--shape_res 128] [--level 10] [--out shape] [--force_cpu]

The generator's density on the sampling cube (decoder/surface.py
sigma_grid, the gather grid the JAX app runs), written as <out>.mrc, then
single-stage marching tetrahedra at --level, welded into <out>.ply.
--checkpoint takes a decoder snapshot's frozen generator (its fine-tuned
copy when the snapshot holds none).

z is the JAX app's jax.random.normal(PRNGKey(seed), (1, z_dim)), drawn by
the port's numpy threefry (utils/jax_random.py), so a seed gives the JAX
app's head.
"""
from __future__ import annotations

import argparse
import sys


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network_pkl", default="", help="reference GAN .pkl")
    p.add_argument("--checkpoint", default="", help="decoder snapshot (uses its frozen G)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--truncation_psi", type=float, default=0.7)
    p.add_argument("--shape_res", type=int, default=128)
    p.add_argument("--level", type=float, default=10.0)
    p.add_argument("--out", default="shape")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def export_shape(gen, z, out: str, shape_res: int = 128, level: float = 10.0,
                 truncation_psi: float = 0.7):
    """z (1, z_dim) -> <out>.mrc and <out>.ply of gen's density; -> dict of
    the sigma grid (R, R, R), n_faces and n_dropped."""
    import torch

    from ..decoder.surface import marching_tetrahedra_faces, sigma_grid
    from ..gaussians.shape_export import save_mesh_ply, save_mrc

    with torch.no_grad():
        ws = gen.mapping(z, torch.zeros((1, gen.c_dim), device=z.device),
                         truncation_psi=truncation_psi)
        planes = gen.synthesis_planes(ws, noise_mode="const")
        sig = sigma_grid(gen, planes, shape_res=shape_res, chunk=min(2 ** 18, shape_res ** 3),
                         separable=False)
        sig_np = sig.cpu().numpy()
        save_mrc(out + ".mrc", sig_np)
        print(f"wrote {out}.mrc  (sigma range {sig_np.min():.2f}..{sig_np.max():.2f})")
        packed, n_faces, n_dropped = marching_tetrahedra_faces(
            sig, level, face_capacity=min(2 ** 21, 12 * (shape_res - 1) ** 3), two_stage=False)
        # index space -> the reference's normalised coordinates idx / R - 0.5
        verts = packed.reshape(-1, 3, 3) / shape_res - 0.5
    if n_dropped:
        print(f"WARNING: cube_capacity bound — {n_dropped} crossed cubes dropped (mesh is "
              "spatially truncated)", file=sys.stderr)
    save_mesh_ply(out + ".ply", verts.cpu().numpy(), n_faces)
    print(f"wrote {out}.ply  ({n_faces} faces)")
    return {"sigmas": sig, "n_faces": n_faces, "n_dropped": n_dropped}


def main(argv=None):
    """-> export_shape's dict."""
    args = build_argparser().parse_args(argv)
    import torch

    from ..flagship import resolve_device
    from ..utils.jax_random import seed_normal

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    if args.network_pkl:
        from ..port.torch_pickle import load_generator_pkl
        gen = load_generator_pkl(args.network_pkl, device=dev)[0]
    else:
        if not args.checkpoint:
            raise SystemExit("gen_shapes: need --network_pkl or --checkpoint")
        from ..decoder.snapshot import load_decoder
        decoder, configs = load_decoder(args.checkpoint, device=dev)
        gen = configs.get("frozen_G", decoder.G)
    gen.eval()
    z = torch.from_numpy(seed_normal(args.seed, (1, gen.z_dim))).to(dev)
    return export_shape(gen, z, args.out, args.shape_res, args.level, args.truncation_psi)


if __name__ == "__main__":
    main()
