"""MBS: the mask-based background-swap consistency metric — port of
apps/calc_mbs.py (the reference's PanoHead/calc_mbs.py:84-187).

    python -m gaussian_gan_decoder_tpu_torch.apps.calc_mbs (--network_pkl network.pkl | \\
        --smoke) [--trunc 0.7] [--pose_cond 90] [--fov_deg 18.837] [--n_sample 64] \\
        [--batch 8] [--mask_source gan|deeplab] [--deeplab_weights deeplab.pth] \\
        [--seed 0] [--force_cpu]

Each latent renders with the same foreground w and a different background
w; the metric is the mean squared difference of the person masks of the
two renders. The mask is the generator's own image_mask (--mask_source
gan) or torchvision's deeplabv3_resnet101 person class (deeplab, with its
weights given locally; torchvision is imported only then, and its absence
raises). The reference generator forces the rendered background to -1
(training/triplane.py:184), as the port does, so the swap changes nothing:
neither package's render_planes reads the background w, the two renders
are one and MBS is 0 by construction, exactly as for the reference code.
The latents follow the JAX app's key stream (utils/jax_random.py). --smoke
builds the JAX app's small generator (seeded random weights, 32^2 raw
render). Runs on the card unless --force_cpu, and raises without one.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network_pkl", default="", help="reference GAN .pkl to port")
    p.add_argument("--trunc", type=float, default=0.7)
    p.add_argument("--pose_cond", type=float, default=90.0, help="degrees")
    p.add_argument("--fov_deg", type=float, default=18.837)
    p.add_argument("--n_sample", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--mask_source", default="gan", choices=["gan", "deeplab"])
    p.add_argument("--deeplab_weights", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--force_cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def deeplab_mask_fn(weights_path: str, device):
    """torchvision's deeplabv3_resnet101 with the given weights -> mask_fn:
    (N, 3, H, W) [0, 1] -> (N, H, W) person mask (class 15). Raises when
    torchvision is not installed."""
    import torch
    from torchvision.models.segmentation import deeplabv3_resnet101

    net = deeplabv3_resnet101(weights=None, progress=False, aux_loss=True)
    net.load_state_dict(torch.load(weights_path, map_location="cpu"))
    net = net.to(device).eval().requires_grad_(False)
    mean = torch.tensor([0.485, 0.456, 0.406], device=device).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=device).view(1, 3, 1, 1)

    @torch.no_grad()
    def mask_fn(img01):
        return (net((img01 - mean) / std)["out"].argmax(1) == 15).float()
    return mask_fn


def mbs(gen, nrr: int, n_sample: int, batch: int, trunc: float = 0.7, pose_cond: float = 90.0,
        fov_deg: float = 18.837, seed: int = 0, mask_fn=None) -> float:
    """The MBS over n_sample // batch * batch latents on the generator's
    device (NaN for none)."""
    import torch

    from ..decoder.camera_sampling import fov_to_intrinsics, pose_from_hv
    from ..utils import jax_random
    dev = next(gen.parameters()).device
    pose = pose_from_hv(torch.tensor([[pose_cond / 180.0 * math.pi]]),
                        torch.tensor([[math.pi / 2]]), 2.7)
    intr = fov_to_intrinsics(torch.tensor(fov_deg, dtype=torch.float32))
    c1 = torch.cat([pose.reshape(1, 16), intr.reshape(1, 9)], dim=1).to(dev)

    @torch.no_grad()
    def mask(z0):
        c = c1.expand(z0.shape[0], 25)
        ws0 = gen.mapping(z0, c, truncation_psi=trunc)
        out = gen.render_planes(gen.synthesis_planes(ws0, noise_mode="const"), ws0, c, None,
                                nrr, noise_mode="const")
        if mask_fn is not None:
            im = out["image"] if "image" in out else out["image_raw"]
            return mask_fn(torch.clamp((im + 1) / 2, 0, 1))
        return torch.clamp((out["image_mask"][:, 0] + 1) / 2, 0, 1)

    n = n_sample // batch * batch
    key = jax_random.PRNGKey(seed)
    mses = []
    for i in range(n // batch):
        k0, _, key = jax_random.split(jax_random.fold_in(key, i), 3)
        z0 = torch.from_numpy(jax_random.normal(k0, (batch, gen.z_dim))).to(dev)
        m0 = mask(z0)
        m1 = m0   # the background-swapped render is the same call (module doc)
        mses.append(float((m0 - m1).square().mean()))
    return float(np.mean(mses)) if mses else float("nan")


def main(argv=None) -> float:
    args = build_argparser().parse_args(argv)
    from ..flagship import resolve_device

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    mask_fn = None
    if args.mask_source == "deeplab":
        if not args.deeplab_weights:
            raise SystemExit("calc_mbs: --deeplab_weights is required for --mask_source deeplab")
        mask_fn = deeplab_mask_fn(args.deeplab_weights, dev)
    if args.smoke:
        from .invert import smoke_generator
        gen, nrr = smoke_generator(0, dev), 32
    else:
        if not args.network_pkl:
            raise SystemExit("calc_mbs: --network_pkl is required unless --smoke")
        from ..port.torch_pickle import load_generator_pkl
        gen, _ = load_generator_pkl(args.network_pkl, device=dev)
        nrr = 64
    value = mbs(gen.eval(), nrr, args.n_sample, args.batch, args.trunc, args.pose_cond,
                args.fov_deg, args.seed, mask_fn)
    n = args.n_sample // args.batch * args.batch
    print(json.dumps({"metric": "mbs", "value": value, "n_sample": n,
                      "mask_source": args.mask_source}))
    return value


if __name__ == "__main__":
    main()
