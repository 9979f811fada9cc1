#!/usr/bin/env python3
"""Spread of chip_smoke.py's five bf16 decode holds over head and plane
draws, on one NVIDIA GPU.

    python3 scripts/decode_hold_spread.py [--draws 20]

chip_smoke.py holds K2 (slab), K8 (brick), K9 ('bcast', 8 int8 corners)
on the PanoHead flagship decoder and K2's bilinear form and K9's
tri-plane form (4 bf16 corners) on the EG3D one against their plain
versions through chip_smoke.hold_chain_gap: limits derived from the plain
version's gap to the same chain with f64 sums on the plain version's own
staging, and a 6-bit control that must fail them. For each draw k this
script builds those decoders with generator and heads from
torch.Generator().manual_seed(k) (the tri-grid slab decoder with the
smoke's "poly6" GELU, the brick decoders with the same weights and "poly",
as the smoke's brick phase), the planes of a latent from
numpy RandomState(k), the smoke's 500k template (seed 0) and camera, and
runs the five holds, printing for each site and draw the kernel's worst
row-relative gap, the derived limits (the rows', conic_b's), the
control's worst and tail and whether the hold passed; then each site's
spread. It never imports jax.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SITES = ("K2 slab", "K8 brick", "K9 bcast", "EG3D K2 bilinear", "EG3D K9 tri-plane")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_hold_spread: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
        build_plane_table, build_slab_volume, sample_from_planes, sample_fused_inputs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    template = ((np.random.RandomState(0).rand(cs.POINTS, 3) - 0.5) * 0.4).astype(np.float32)
    pos = torch.tensor(template, device=dev)
    M = pos.shape[0]
    cp, c2w = flagship.default_camera_params(device=dev)
    cam = make_camera(cs.IMAGE, cs.FOV, c2w, device=dev)
    ctxs = {}
    readings = {s: [] for s in SITES}

    def hold(site, k, rows_k, rows_p, staging, real, cw):
        label = f"{site} draw {k}"
        cs.CHAIN_GAPS.clear()
        try:
            cs.hold_chain_gap(torch, rows_k, rows_p, staging, real, cw, cam, label)
            ok = True
        except cs.PhaseError as e:
            print(f"{label}: FAILS: {e}")
            ok = False
        r = dict(cs.CHAIN_GAPS[-1], ok=ok)
        readings[site].append(r)
        print(f"{label}: kernel worst {r['kernel']:.4e}, derived limit {r['limit']:.4e} "
              f"(conic_b {r.get('conic_b_limit', float('nan')):.4e}), control worst "
              f"{r['control']:.4e} tail {r['control_tail']} (tail limit {r['tail_limit']}), "
              f"passes {ok}")

    def brick_holds(k, G, dec, planes, eg3d):
        """K2 (slab; the bilinear form on EG3D) on dec, then the brick
        route's K8 (tri-grid) and K9 ('bcast') on the same weights."""
        w = dec.fold()
        cw = w.chain
        key = "eg3d" if eg3d else "trigrid"
        if key not in ctxs:
            ctxs[key] = dec.make_slab_context(template, device=dev)
        ctx = ctxs[key]
        D, box_warp = G.triplane_depth, float(G.rk["box_warp"])
        vol, scales = build_slab_volume(planes, D)
        rows_k = ph.decode_project_slab(cw, vol, scales, ctx, cam)
        rows_p = ph.decode_project_slab_plain(cw, vol, scales, ctx, cam)
        hold("EG3D K2 bilinear" if eg3d else "K2 slab", k, rows_k, rows_p,
             cs.slab_staging(torch, cw, vol, scales, ctx), ctx.valid > 0, cw)
        del vol, scales, rows_k, rows_p
        if eg3d:
            bcw = cw
        else:
            bdec = flagship.flagship_decoder(gen=G, device=dev).eval()
            bdec.load_state_dict(dec.state_dict())
            bcw = bdec.fold().chain
            table = build_plane_table(planes, D, brick_dtype=torch.int8)
            feats = sample_from_planes(G.plane_axes, planes, pos[None], box_warp, D,
                                       table=table)[0]
            staging, Mpad = ph.build_brick_staging(feats.mean(0), pos, pos)
            real = torch.arange(Mpad, device=dev) < M
            hold("K8 brick", k, ph.decode_project(bcw, staging, cam, M),
                 ph.decode_project_plain(bcw, staging, cam, M), staging, real, bcw)
            del feats, staging
        aux, Mpad = ph.build_brick_staging(pos.new_zeros((M, ph.C)), pos, pos)
        rows_in, wts, scale_rows = sample_fused_inputs(
            G.plane_axes, planes, pos[None], box_warp, D,
            table=None if eg3d else table, pad_to=Mpad)
        real = torch.arange(Mpad, device=dev) < M
        hold("EG3D K9 tri-plane" if eg3d else "K9 bcast", k,
             ph.decode_project_fused(bcw, aux, rows_in, wts, scale_rows, cam, M),
             ph.decode_project_fused_plain(bcw, aux, rows_in, wts, scale_rows, cam, M),
             cs.fused_staging(torch, bcw, aux, rows_in, wts, scale_rows), real, bcw)

    with torch.inference_mode():
        for k in range(args.draws):
            z = torch.tensor(np.random.RandomState(k).randn(1, 512).astype(np.float32),
                             device=dev)
            for eg3d in (False, True):
                rng = torch.Generator().manual_seed(k)
                if eg3d:
                    G = flagship.flagship_generator("eg3d", rng=rng, device=dev)
                    dec = flagship.flagship_decoder(gen=G, rng=rng, device=dev).eval()
                else:
                    dec = flagship.flagship_decoder(rng=rng, device=dev, gelu="poly6").eval()
                    G = dec.G
                planes, _ = dec.synthesize_planes(dec.fold(), z, cp)
                brick_holds(k, G, dec, planes, eg3d)
                del G, dec, planes
                torch.cuda.empty_cache()

    for site in SITES:
        rs = readings[site]
        kern = np.array([r["kernel"] for r in rs])
        lim = np.array([r["limit"] for r in rs])
        ctl_fail = sum(r["control"] > r["limit"] or r["control_tail"] > r["tail_limit"]
                       for r in rs)
        tails = [r["control_tail"] for r in rs]
        blim = np.array([r.get("conic_b_limit", np.nan) for r in rs])
        print(f"{site}: {len(rs)} draws; kernel worst min {kern.min():.4e}, median "
              f"{np.median(kern):.4e}, max {kern.max():.4e} ({int((kern > 1e-2).sum())} above "
              f"the old fixed 1e-2); derived limit min {lim.min():.4e}, median "
              f"{np.median(lim):.4e}, max {lim.max():.4e}; conic_b limit {np.nanmin(blim):.4e}-"
              f"{np.nanmax(blim):.4e}; control tail {min(tails)}-"
              f"{max(tails)} points, fails the limits on {ctl_fail}/{len(rs)}; "
              f"{sum(not r['ok'] for r in rs)} draws fail the hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
