"""Render / export from a trained decoder snapshot — port of
apps/render_decoder.py: load_decoder + render_with_decoder (ref
main/load_decoder.py:12-43) and the .ply export for splatviz / SIBR viewers
(gaussian_splatting/scene/gaussian_model.py:281).

    python -m gaussian_gan_decoder_tpu_torch.apps.render_decoder \\
        --checkpoint results/runX/decoder_final --seed 7 --out head.png \\
        --ply head.ply [--force_cpu]

The surface points come from the snapshot's frozen generator at the given
yaw, pitch and fov; the frame is blended by K3 (--backend pallas, the
default) or by the f32 tile rasterizer in plain PyTorch (--backend xla, the
JAX app's default). The image is a PNG through PIL, or <out>.npy without
PIL.
"""
from __future__ import annotations

import argparse
import math


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fov_deg", type=float, default=13.0)
    p.add_argument("--yaw", type=float, default=0.0, help="radians off frontal")
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--truncation_psi", type=float, default=1.0)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--out", default="render.png")
    p.add_argument("--ply", default="", help="optional .ply scene export")
    p.add_argument("--backend", default="pallas", choices=["xla", "pallas"])
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def main(argv=None):
    """-> {image (the path written)[, ply], render (3, H, W), z,
    camera_params, cam2world, vertices (the surface decoded)}."""
    args = build_argparser().parse_args(argv)
    import numpy as np
    import torch

    from ..decoder.camera_sampling import fov_to_intrinsics, pose_from_hv
    from ..decoder.snapshot import load_decoder, render_with_decoder
    from ..decoder.target_pipeline import TargetDraws, sample_target
    from ..flagship import resolve_device
    from ..gaussians.model import gaussian_scene_from_decoded
    from ..gaussians.ply import save_ply
    from ..utils.loggers import write_image

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    decoder, configs = load_decoder(args.checkpoint, device=dev)
    frozen = configs.get("frozen_G", decoder.G)
    tcfg = configs["target_cfg"]
    rng = torch.Generator().manual_seed(args.seed)
    z = torch.randn((1, frozen.z_dim), generator=rng).to(dev)
    pose = pose_from_hv(torch.tensor([[math.pi / 2 + args.yaw]]),
                        torch.tensor([[math.pi / 2 + args.pitch]]), radius=2.7)
    intr = fov_to_intrinsics(torch.tensor(args.fov_deg, dtype=torch.float32))
    cp = torch.cat([pose.reshape(1, 16), intr.reshape(1, 9)], dim=1).to(dev)
    # surface points from the frozen target generator, at this camera
    target = sample_target(TargetDraws.make(rng, frozen, tcfg, dev), frozen, z, cfg=tcfg,
                           camera_params=cp)
    img, decoded = render_with_decoder(
        decoder, z, cp, pose[0], target.vertices, math.radians(args.fov_deg),
        image_size=args.image_size, truncation_psi=args.truncation_psi, backend=args.backend)
    arr = np.clip(img.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
    # the written paths, and what the frame was made from
    out = {"image": write_image(arr, args.out), "render": img, "z": z, "camera_params": cp,
           "cam2world": pose[0], "vertices": target.vertices}
    print(f"wrote {out['image']}")
    if args.ply:
        save_ply(gaussian_scene_from_decoded(decoded), args.ply)
        out["ply"] = args.ply
        print(f"wrote {args.ply}")
    return out


if __name__ == "__main__":
    main()
