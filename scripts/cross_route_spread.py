#!/usr/bin/env python3
"""Spread of chip_smoke.py's cross-route witness over head draws, on one
NVIDIA GPU.

    python3 scripts/cross_route_spread.py [--draws 20]

chip_smoke.py's brick phase holds the brick route's rows (the int8 table,
the gather, K8) against the slab route's (K2) on the same planes, in
template order, at the limits chip_smoke.hold_cross_route derives from
both routes' sound references (the plain chain on one route's staging
against the chain with f64 sums on the other's), with a 6-bit control
that must fail them. This script builds the smoke's slab-route decoder
(flagship_decoder, "poly6" GELU) with its heads from
torch.Generator().manual_seed(k) for k in range(draws), the smoke's 500k
template (seed 0), camera and first latent, and prints for each draw the
witness's worst row-relative gap (hold_decode's measure), the derived
limit, the control's readings and whether the hold passes. It never
imports jax.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cross_route_spread: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import build_slab_volume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    dev, seed = torch.device("cuda:0"), 0
    nprng = np.random.RandomState(seed)
    template = ((nprng.rand(chip_smoke.POINTS, 3) - 0.5) * 0.4).astype(np.float32)
    pos = torch.tensor(template, device=dev)
    cp, c2w = flagship.default_camera_params(device=dev)
    cam = make_camera(chip_smoke.IMAGE, chip_smoke.FOV, c2w, device=dev)
    z = torch.tensor(nprng.randn(1, 1, 512).astype(np.float32)[0], device=dev)
    ctx = None
    gaps, limits, failed = [], [], 0
    with torch.inference_mode():
        for k in range(args.draws):
            dec = flagship.flagship_decoder(rng=torch.Generator().manual_seed(k), device=dev,
                                            gelu="poly6").eval()
            weights = dec.fold()
            if ctx is None:
                # the template's slab context: the same for every draw
                ctx = dec.make_slab_context(template, device=dev)
            planes, _ = dec.synthesize_planes(weights, z, cp)
            vol, scales = build_slab_volume(planes, dec.G.triplane_depth)
            rows_slab = ph.decode_project_slab(weights.chain, vol, scales, ctx, cam)
            del vol, scales
            label = f"witness draw {k}"
            try:
                worst, limit = chip_smoke.hold_cross_route(torch, dec, weights, planes, rows_slab,
                                                           ctx, pos, cam, label)
                ok = True
            except chip_smoke.PhaseError as e:
                print(f"{label}: FAILS: {e}")
                worst, limit, ok = float("nan"), float("nan"), False
            failed += not ok
            gaps.append(worst)
            limits.append(limit)
            print(f"{label}: worst row-relative {worst:.4e}, derived limit {limit:.4e}, "
                  f"passes {ok}")
            del dec, weights, planes, rows_slab
            torch.cuda.empty_cache()
    g, lim = np.array(gaps), np.array(limits)
    print(f"{len(lim)} draws: worst min {np.nanmin(g):.4e}, median {np.nanmedian(g):.4e}, max "
          f"{np.nanmax(g):.4e}; derived limit min {np.nanmin(lim):.4e}, median "
          f"{np.nanmedian(lim):.4e}, max {np.nanmax(lim):.4e}; {int((g > 1e-2).sum())} above "
          f"the old fixed 1e-2; {failed} draws fail the hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
