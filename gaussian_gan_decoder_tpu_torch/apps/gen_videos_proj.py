"""Orbit / sweep videos from projected latents — port of
apps/gen_videos_proj.py (ref PanoHead/gen_videos_proj_withseg.py:68-198).

    python -m gaussian_gan_decoder_tpu_torch.apps.gen_videos_proj \\
        --latents projected_w.npz[,more.npz] (--network_pkl network.pkl | \\
        --finetuned G_checkpoint) [--mode orbit|sweep] [--w_frames 120] \\
        [--image_mode image|image_raw|image_depth|image_mask] [--outdir proj_video] \\
        [--force_cpu]

Loads the keyframe latents (each file's 'w', (num_ws, w_dim) or (1, num_ws,
w_dim)), orbits (full 360 deg yaw) or sweeps (yaw / pitch sinusoids) the
camera around the generator's avg_camera_pivot, synthesizes every frame
from the FIXED ws, Catmull-Rom interpolated between keyframes (no mapping
pass), and writes frame_NNNNN.png (PIL) or .png.npy, video.mp4 when imageio
and ffmpeg are there, and the camera trajectory, trajectory.npy ((frames,
16) cam2world). --image_mode picks the synthesis output: image_depth is
negated and scaled to [-1, 1]; a one-channel output is tiled to three.

--finetuned reads a train/checkpoint.py file whose configs hold "G" (a
TriPlaneGeneratorConfig) and whose state is that generator's state dict:
checkpoint.save(path, G.state_dict(), {"G": G.config}).
"""
from __future__ import annotations

import argparse
import math
import os


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--latents", required=True,
                   help="comma list of projected_w.npz files (keyframes)")
    p.add_argument("--network_pkl", default="", help="reference GAN .pkl")
    p.add_argument("--finetuned", default="",
                   help="fine-tuned generator checkpoint (train/checkpoint.py, configs['G'])")
    p.add_argument("--mode", default="orbit", choices=["orbit", "sweep"],
                   help="orbit: full 360 yaw (ref cfg=Head); sweep: yaw/pitch sinusoid "
                        "(ref default)")
    p.add_argument("--w_frames", type=int, default=120,
                   help="frames per keyframe segment (ref 60*4)")
    p.add_argument("--image_mode", default="image",
                   choices=["image", "image_raw", "image_depth", "image_mask"])
    p.add_argument("--fov_deg", type=float, default=18.837,
                   help="ref gen_videos_proj_withseg intrinsics fov")
    p.add_argument("--outdir", default="proj_video")
    p.add_argument("--neural_rendering_resolution", type=int, default=64)
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def load_finetuned(path: str, device):
    """A generator checkpoint (configs['G'] and G's state dict) -> the
    TriPlaneGenerator with its weights on device, loaded strictly."""
    from ..models.triplane import TriPlaneGenerator
    from ..train import checkpoint
    gen = TriPlaneGenerator.from_config(checkpoint.load_configs(path)["G"], device=device)
    gen.load_state_dict(checkpoint.restore(path), strict=True)
    return gen


def render_frame(gen, ws, cp, image_mode: str, neural_rendering_resolution: int = 64):
    """ws (1, num_ws, w_dim), cp (1, 25) -> (3, H, W) in about [-1, 1]: the
    synthesis output image_mode (image_raw where the generator has no such
    output), depth negated and min-max scaled, one channel tiled to three."""
    import torch

    with torch.no_grad():
        out = gen.synthesis(ws, cp, torch.Generator().manual_seed(0),
                            neural_rendering_resolution)
    img = out[image_mode] if image_mode in out else out["image_raw"]
    if image_mode == "image_depth":
        img = -img
        img = (img - img.min()) / torch.clamp(img.max() - img.min(), min=1e-8) * 2 - 1
    if img.shape[1] == 1:
        img = img.repeat(1, 3, 1, 1)
    return img[0]


def main(argv=None):
    """-> {frames: [paths], trajectory: path, video: the .mp4 path or None}."""
    args = build_argparser().parse_args(argv)
    import numpy as np
    import torch

    from ..flagship import resolve_device
    from ..utils.loggers import write_image
    from .gen_samples import orbit_camera
    from .gen_videos import catmull_rom, write_video

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    if args.finetuned:
        gen = load_finetuned(args.finetuned, dev)
    else:
        if not args.network_pkl:
            raise SystemExit("gen_videos_proj: need --network_pkl or --finetuned")
        from ..port.torch_pickle import load_generator_pkl
        gen = load_generator_pkl(args.network_pkl, device=dev)[0]
    gen.eval()
    # keyframe latents (ref :289 np.load(latent)['w']): (num_ws, w_dim) or
    # (1, num_ws, w_dim) each
    ws_keys = np.stack([w if w.ndim == 2 else w[0]
                        for w in (np.load(p)["w"] for p in args.latents.split(","))])
    K = len(ws_keys)
    pivot = torch.tensor(gen.rk.get("avg_camera_pivot", (0, 0, 0)), dtype=torch.float32)[None]
    os.makedirs(args.outdir, exist_ok=True)
    n_total = K * args.w_frames
    files, poses = [], []
    for fidx in range(n_total):
        t = fidx / n_total
        if args.mode == "orbit":
            yaw, pitch = math.pi / 2 + 2 * math.pi * t, math.pi / 2 - 0.05
        else:
            # ref :125-128: yaw_range 1.5, pitch_range 0.25
            yaw = math.pi / 2 + 1.5 * math.sin(2 * math.pi * t)
            pitch = math.pi / 2 - 0.05 + 0.25 * math.cos(2 * math.pi * t)
        cp, pose = orbit_camera(yaw, pitch, args.fov_deg, 2.7, lookat=pivot)
        cp = cp.to(dev)
        seg, ft = divmod(fidx, args.w_frames)
        wi = catmull_rom(ws_keys[(seg - 1) % K], ws_keys[seg % K], ws_keys[(seg + 1) % K],
                         ws_keys[(seg + 2) % K], ft / args.w_frames)[None]
        img = render_frame(gen, torch.tensor(wi, dtype=torch.float32, device=dev), cp,
                           args.image_mode, args.neural_rendering_resolution)
        arr = np.clip((img.cpu().numpy().transpose(1, 2, 0) + 1) * 127.5, 0, 255).astype(np.uint8)
        files.append(write_image(arr, os.path.join(args.outdir, f"frame_{fidx:05d}.png")))
        poses.append(pose.numpy().reshape(16))
        if fidx % 20 == 0:
            print(f"frame {fidx}/{n_total}")
    # trajectory sidecar (ref :197 *_trajectory.npy)
    traj = os.path.join(args.outdir, "trajectory.npy")
    np.save(traj, np.stack(poses))
    return {"frames": files, "trajectory": traj, "video": write_video(files, args.outdir, fps=60)}


if __name__ == "__main__":
    main()
