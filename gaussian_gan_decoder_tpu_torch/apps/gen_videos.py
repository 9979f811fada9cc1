"""Latent-interpolation orbit videos from a decoder snapshot — port of
apps/gen_videos.py (ref PanoHead/gen_videos.py:69), the real-time editing
stream: the decode-and-splat path frame by frame, not the volume renderer.

    python -m gaussian_gan_decoder_tpu_torch.apps.gen_videos \\
        --checkpoint results/runX/decoder_final [--seeds 0,1,2,3] \\
        [--frames_per_seed 30] [--backend xla|pallas] [--outdir video_frames] \\
        [--force_cpu]

Each frame interpolates the latent between the seeds with Catmull-Rom while
the camera swings in yaw, samples the surface points from the snapshot's
frozen generator (decoder/target_pipeline.py sample_target, with the
snapshot's target config: a probe table where it asks for one), then
decodes and renders them (decoder/snapshot.py render_with_decoder):
--backend pallas blends with K3, xla (the JAX app's default) with the f32
tile rasterizer in plain PyTorch. Frames are frame_NNNNN.png (PIL) or
.png.npy, and video.mp4 when imageio and ffmpeg are there.

z is drawn by torch.Generator().manual_seed(seed), and each frame's target
draws by torch.Generator().manual_seed(frame): JAX's threefry stream cannot
be reproduced without jax, so a seed gives another head than the JAX app's.
"""
from __future__ import annotations

import argparse
import math
import os
from types import SimpleNamespace


def catmull_rom(p0, p1, p2, p3, t):
    """Cubic interpolation between p1 and p2 (the reference interpolates the
    seed grid with scipy's cubic splines; Catmull-Rom is the same C1
    interpolation without scipy)."""
    t2, t3 = t * t, t * t * t
    return 0.5 * (2 * p1 + (-p0 + p2) * t + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--seeds", default="0,1,2,3")
    p.add_argument("--frames_per_seed", type=int, default=30)
    p.add_argument("--fov_deg", type=float, default=13.0)
    p.add_argument("--yaw_amplitude", type=float, default=0.6)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--outdir", default="video_frames")
    p.add_argument("--truncation_psi", type=float, default=0.7)
    p.add_argument("--backend", default="xla", choices=["xla", "pallas"])
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def seed_latents(seeds, z_dim: int):
    """(K, z_dim) CPU latents, one torch.Generator().manual_seed(s) each."""
    import torch
    return torch.stack([torch.randn((z_dim,), generator=torch.Generator().manual_seed(s))
                        for s in seeds])


def frame(decoder, frozen, target_cfg, zs, fidx: int, args):
    """Frame fidx of the video: the interpolated latent, the orbit camera,
    the snapshot's surface points and the decoded render -> namespace of
    image (3, H, W) in [0, 1], z (1, z_dim), camera_params (1, 25),
    cam2world (4, 4), vertices (P, 3)."""
    import torch

    from ..decoder.snapshot import render_with_decoder
    from ..decoder.target_pipeline import TargetDraws, TargetSamplerConfig, sample_target
    from .gen_samples import orbit_camera

    dev = next(decoder.parameters()).device
    K = zs.shape[0]
    n_total = K * args.frames_per_seed
    seg, t = divmod(fidx, args.frames_per_seed)
    t /= args.frames_per_seed
    z = catmull_rom(zs[(seg - 1) % K], zs[seg % K], zs[(seg + 1) % K], zs[(seg + 2) % K],
                    t)[None].to(dev)
    yaw = args.yaw_amplitude * math.sin(2 * math.pi * fidx / n_total)
    cp, pose = orbit_camera(math.pi / 2 + yaw, math.pi / 2, args.fov_deg)
    cp = cp.to(dev)
    tcfg = target_cfg or TargetSamplerConfig()
    target = sample_target(TargetDraws.make(torch.Generator().manual_seed(fidx), frozen, tcfg,
                                            dev),
                           frozen, z, cfg=tcfg, camera_params=cp)
    cam2world = pose[0].to(dev)
    img, _ = render_with_decoder(decoder, z, cp, cam2world, target.vertices,
                                 math.radians(args.fov_deg), image_size=args.image_size,
                                 truncation_psi=args.truncation_psi, backend=args.backend)
    return SimpleNamespace(image=img, z=z, camera_params=cp, cam2world=cam2world,
                           vertices=target.vertices)


def main(argv=None):
    """-> {frames: [paths], video: the .mp4 path or None}."""
    args = build_argparser().parse_args(argv)
    import numpy as np

    from ..decoder.snapshot import load_decoder
    from ..flagship import resolve_device
    from ..utils.loggers import write_image

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    decoder, configs = load_decoder(args.checkpoint, device=dev)
    decoder.eval()
    frozen = configs.get("frozen_G", decoder.G)
    zs = seed_latents([int(s) for s in args.seeds.split(",")], frozen.z_dim)
    os.makedirs(args.outdir, exist_ok=True)
    n_total = zs.shape[0] * args.frames_per_seed
    files = []
    for fidx in range(n_total):
        f = frame(decoder, frozen, configs.get("target_cfg"), zs, fidx, args)
        arr = np.clip(f.image.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
        files.append(write_image(arr, os.path.join(args.outdir, f"frame_{fidx:05d}.png")))
        if fidx % 10 == 0:
            print(f"frame {fidx}/{n_total}")
    return {"frames": files, "video": write_video(files, args.outdir, fps=30)}


def write_video(files, outdir: str, fps: int):
    """files (PNGs) -> <outdir>/video.mp4 through imageio (and its ffmpeg),
    as the JAX apps write it; -> its path, or None when imageio, ffmpeg or
    PNG frames are not there."""
    path = os.path.join(outdir, "video.mp4")
    try:
        import imageio

        with imageio.get_writer(path, fps=fps) as w:
            for f in files:
                w.append_data(imageio.imread(f))
    except Exception:
        print(f"wrote {len(files)} frames to {outdir} (imageio/ffmpeg unavailable)")
        return None
    print("wrote video.mp4")
    return path


if __name__ == "__main__":
    main()
