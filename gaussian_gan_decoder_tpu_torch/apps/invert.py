"""PTI inversion: one image -> its W pivot and a fine-tuned generator — port
of apps/invert.py (the reference's projector_withseg.py::run_projection
and gen_pti_script.sh).

    python -m gaussian_gan_decoder_tpu_torch.apps.invert --target face.png \\
        (--network_pkl network.pkl | --smoke) [--label c.npy] [--num_steps 1000] \\
        [--num_steps_pti 1000] [--vgg_weights vgg16.npz] [--seed 303] \\
        [--outdir pti_out] [--force_cpu]

Projects the target to W (train/inversion.project), fine-tunes the
generator at the pivot (project_pti) and writes projected_w.npz (`w`, (1,
num_ws, w_dim)) and finetuned_generator, a train/checkpoint.py file with
the generator's state dict and configs {"G": its config}
(apps/gen_videos_proj.py --finetuned reads it). --smoke builds the JAX
app's small PanoHead generator (z / w 32, 32^2, no SR, 16^2 planes, 4 + 4
depth samples) on seeded random weights, 16^2 targets, 500 w_avg samples;
otherwise the reference .pkl loads through port/torch_pickle.py. The
camera is the label file's (25 floats) or frontal (fov 13 deg); the VGG16
is seeded random (seed 7) without --vgg_weights. Runs on the card unless
--force_cpu, and raises without one.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np

SMOKE_RK = {"triplane_size": 16, "depth_resolution": 4, "depth_resolution_importance": 4}


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network_pkl", default="", help="reference GAN .pkl to port")
    p.add_argument("--target", required=True, help="target image (png/jpg)")
    p.add_argument("--label", default="", help="25-float camera label file (.npy); frontal default")
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--num_steps_pti", type=int, default=1000)
    p.add_argument("--outdir", default="pti_out")
    p.add_argument("--vgg_weights", default="", help="torchvision-named VGG16 (.npz / .pt)")
    p.add_argument("--seed", type=int, default=303)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def smoke_generator(seed: int, device):
    """The JAX app's --smoke generator, on weights seeded from `seed`."""
    import torch

    from ..models.triplane import TriPlaneGenerator
    return TriPlaneGenerator(z_dim=32, c_dim=25, w_dim=32, img_resolution=32,
                             variant="panohead", without_sr=True, channel_base=512,
                             channel_max=32, rendering_kwargs=SMOKE_RK,
                             generator=torch.Generator().manual_seed(seed), device=device)


def frontal_label(device=None):
    """(1, 25): the frontal pose at radius 2.7, fov 13 deg (the JAX app's
    default label)."""
    import torch

    from ..decoder.camera_sampling import fov_to_intrinsics, pose_from_hv
    h = torch.full((1, 1), math.pi / 2)
    pose = pose_from_hv(h, h.clone(), 2.7)
    intr = fov_to_intrinsics(torch.tensor(13.0))
    return torch.cat([pose.reshape(1, 16), intr.reshape(1, 9)], dim=1).to(device)


def make_vgg(weights: str, device):
    """The VGG16-LPIPS embedder: the file's weights, or seeded random (7)."""
    import torch

    from ..losses.lpips import VGG16LPIPS
    from ..port.from_jax import load_vgg16_lpips_state
    vgg = VGG16LPIPS(generator=torch.Generator().manual_seed(7), device=device)
    if weights:
        load_vgg16_lpips_state(vgg, weights)
    return vgg.eval().requires_grad_(False)


def load_target(path: str, res: int):
    """The target image (3, res, res) f32 in [0, 255] (LANCZOS resize)."""
    import torch
    from PIL import Image
    img = Image.open(path).convert("RGB").resize((res, res), Image.LANCZOS)
    return torch.from_numpy(np.asarray(img, np.float32).transpose(2, 0, 1).copy())


def run(gen, target, c, vgg, cfg, outdir: str, seed: int, on_project_step=None,
        on_pti_step=None) -> dict:
    """Both stages on gen (fine-tuned in place) -> {"w", "c", "losses",
    "pti_losses", "w_path", "generator_path", "seconds"}: the outputs
    written under outdir."""
    from ..train import checkpoint
    from ..train.inversion import project, project_pti
    from ..utils import jax_random
    os.makedirs(outdir, exist_ok=True)
    t0 = time.perf_counter()
    print("stage 1: W projection...")
    w_pivot, c_adj, losses = project(gen, target, c, vgg, jax_random.PRNGKey(seed), cfg,
                                     on_step=on_project_step)
    w_path = os.path.join(outdir, "projected_w.npz")
    np.savez(w_path, w=w_pivot.cpu().numpy())
    print("wrote projected_w.npz")
    print("stage 2: generator fine-tuning (PTI)...")
    pti_losses = project_pti(gen, w_pivot, target, c_adj, vgg, jax_random.PRNGKey(seed + 1),
                             cfg, on_step=on_pti_step)
    g_path = os.path.join(outdir, "finetuned_generator")
    checkpoint.save(g_path, gen.state_dict(), configs={"G": gen.config})
    final = pti_losses[-1] if pti_losses else float("nan")
    print(f"wrote finetuned_generator (final loss {final:.4f})")
    return {"w": w_pivot, "c": c_adj, "losses": losses, "pti_losses": pti_losses,
            "w_path": w_path, "generator_path": g_path, "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    import torch

    from ..flagship import resolve_device
    from ..train.inversion import ProjectConfig

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    if args.smoke:
        gen, res = smoke_generator(args.seed, dev), 16
    else:
        if not args.network_pkl:
            raise SystemExit("invert: --network_pkl is required unless --smoke")
        from ..port.torch_pickle import load_generator_pkl
        gen, _ = load_generator_pkl(args.network_pkl, device=dev)
        res = gen.img_resolution
    target = load_target(args.target, res)
    if args.label:
        c = torch.tensor(np.load(args.label), dtype=torch.float32).reshape(1, 25).to(dev)
    else:
        c = frontal_label(dev)
    cfg = ProjectConfig(num_steps=args.num_steps, pti_steps=args.num_steps_pti,
                        w_avg_samples=500 if args.smoke else 10_000,
                        neural_rendering_resolution=16 if args.smoke else 64)
    return run(gen, target, c, make_vgg(args.vgg_weights, dev), cfg, args.outdir, args.seed)


if __name__ == "__main__":
    main()
