#!/usr/bin/env python3
"""Spread of chip_smoke.py's five bf16 decode holds over head and plane
draws, on one NVIDIA GPU.

    python3 scripts/decode_hold_spread.py [--draws 20] [--dseq]

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
row-relative gap, the derived limits (the rows', conic_b's), the row
that sets the floor's worst and the kernel's, the kernel's gap to the
f64-sum chain there, the head rows' 0:14 readings alone, the control's
worst and tail and whether the hold passed; then each site's spread. With --dseq it runs
the decoder-options phase's three D-seq holds instead (the sequential
bf16 decoder on the real camera: K2 slab, K8 on the int8 table's
staging, K9 'bcast'), each through hold_chain_gap on its own plain
staging, and prints how far the three routes' stagings and kernel rows
differ, point by point. It never imports jax.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SITES = ("K2 slab", "K8 brick", "K9 bcast", "EG3D K2 bilinear", "EG3D K9 tri-plane")
DSEQ_SITES = ("D-seq K2 slab", "D-seq K8 table", "D-seq K9 fused")
# chip_smoke.decoder_options_phase's non-frontal camera, which D-seq maps
CAM_REAL = np.asarray([[0.9, 0.0, 0.4359, 1.18], [0.0, 1.0, 0.0, 0.0],
                       [-0.4359, 0.0, 0.9, 2.43], [0.0, 0.0, 0.0, 1.0]], np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=20)
    ap.add_argument("--dseq", action="store_true",
                    help="the decoder-options phase's three D-seq holds in place of the five")
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
    sites = DSEQ_SITES if args.dseq else SITES
    readings = {s: [] for s in sites}

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
        print(f"{label}: kernel worst {r['kernel']:.4e} (row {r['kernel_at'][0]}; there "
              f"{r['kernel_ref_at']:.4e} from the f64-sum chain), derived "
              f"limit {r['limit']:.4e} (floor {r['floor']:.4e} at row {r['floor_at'][0]}; conic_b "
              f"{r['conic_b_limit']:.4e}); head rows 0:14: kernel {r['head_kernel']:.4e}, floor "
              f"{r['head_floor']:.4e}; control worst "
              f"{r['control']:.4e} tail {r['control_tail']} (tail limit {r['tail_limit']}), "
              f"passes {ok}")
        return r

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

    def dseq_holds(k, z):
        """D-seq (sequential heads, no xyz embedding, bf16, "poly", the
        real camera at the mapping), as chip_smoke's decoder-options phase
        builds it, with generator and heads from draw k: K2 (slab), K8 on
        the int8 table's staging and K9 ('bcast'), each on its own plain
        staging."""
        from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
        G = flagship.flagship_generator(rng=torch.Generator().manual_seed(k), device=dev).eval()
        dec = GaussianDecoder(G, gelu="poly", rng=torch.Generator().manual_seed(k + 1),
                              device=dev, decoder_type="sequential", use_xyz_embedding=False,
                              heads_bf16=True, fused_lerp="bcast").eval()
        w = dec.fold()
        cw, dt = w.chain, ph.chain_dtype(w.chain)
        if "dseq" not in ctxs:
            ctxs["dseq"] = dec.make_slab_context(template, device=dev)
        ctx = ctxs["dseq"]
        point_of = torch.argsort(ctx.inv_slot)   # real slot index -> template point
        cp_real = cp.clone()
        cp_real[0, :16] = torch.tensor(CAM_REAL.reshape(-1), device=dev)
        planes, _ = dec.synthesize_planes(w, z, cp_real)
        D, box_warp = G.triplane_depth, float(G.rk["box_warp"])
        vol, scales = build_slab_volume(planes, D)
        rows_k = {"slab": ph.decode_project_slab(cw, vol, scales, ctx, cam)}
        st = {"slab": cs.slab_staging(torch, cw, vol, scales, ctx)}
        at = {"slab": hold("D-seq K2 slab", k, rows_k["slab"],
                           ph.decode_project_slab_plain(cw, vol, scales, ctx, cam), st["slab"],
                           ctx.valid > 0, cw)}
        at["slab"] = int(point_of[at["slab"]["kernel_at"][1]])
        rows_k["slab"], st["slab"] = rows_k["slab"][:, ctx.inv_slot], st["slab"][ctx.inv_slot]
        del vol, scales
        table = build_plane_table(planes, D, brick_dtype=torch.int8)
        feats = sample_from_planes(G.plane_axes, planes, pos[None], box_warp, D, table=table)[0]
        staging, Mpad = ph.build_brick_staging(feats.mean(0), dec.cond0(pos), pos, dtype=dt)
        real = torch.arange(Mpad, device=dev) < M
        rows_k["table"] = ph.decode_project(cw, staging, cam, M)
        at["table"] = hold("D-seq K8 table", k, rows_k["table"],
                           ph.decode_project_plain(cw, staging, cam, M), staging, real,
                           cw)["kernel_at"][1]
        rows_k["table"], st["table"] = rows_k["table"][:, :M], staging[:M]
        del feats, staging
        aux, _ = ph.build_brick_staging(pos.new_zeros((M, ph.C)), dec.cond0(pos), pos, dtype=dt)
        rows_in, wts, scale_rows = sample_fused_inputs(G.plane_axes, planes, pos[None], box_warp,
                                                       D, table=table, pad_to=Mpad)
        rows_k["fused"] = ph.decode_project_fused(cw, aux, rows_in, wts, scale_rows, cam, M)
        st["fused"] = cs.fused_staging(torch, cw, aux, rows_in, wts, scale_rows, "bcast")
        at["fused"] = hold("D-seq K9 fused", k, rows_k["fused"],
                           ph.decode_project_fused_plain(cw, aux, rows_in, wts, scale_rows, cam,
                                                         M),
                           st["fused"], real, cw)["kernel_at"][1]
        rows_k["fused"], st["fused"] = rows_k["fused"][:, :M], st["fused"][:M]
        # do the three routes read the same staging and give the same rows?
        every = torch.ones(M, dtype=torch.bool, device=dev)
        cols = cs._gap_cols(ph)
        for a, b in (("slab", "table"), ("slab", "fused"), ("table", "fused")):
            differ = (st[a][:, :ph.C].float() != st[b][:, :ph.C].float()).any(dim=1)
            gap = cs.point_gaps(torch, rows_k[a], rows_k[b], every, cols)
            head = cs.point_gaps(torch, rows_k[a], rows_k[b], every, cs.HEAD_COLS)
            print(f"D-seq draw {k}: {a} vs {b}: stagings differ on {int(differ.sum())}/{M} "
                  f"points; kernel rows differ on {int((gap > 0).sum())} points, worst "
                  f"{float(gap.max()):.4e} (head rows 0:14 {float(head.max()):.4e})")
        print(f"D-seq draw {k}: the kernel's worst at template point slab {at['slab']}, table "
              f"{at['table']}, fused {at['fused']}")

    with torch.inference_mode():
        for k in range(args.draws):
            if args.dseq:
                z = torch.tensor(np.random.RandomState(k).randn(1, 512).astype(np.float32),
                                 device=dev)
                dseq_holds(k, z)
                torch.cuda.empty_cache()
                continue
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

    for site in sites:
        rs = readings[site]
        kern = np.array([r["kernel"] for r in rs])
        lim = np.array([r["limit"] for r in rs])
        ctl_fail = sum(r["control"] > r["limit"] or r["control_tail"] > r["tail_limit"]
                       for r in rs)
        tails = [r["control_tail"] for r in rs]
        blim = np.array([r["conic_b_limit"] for r in rs])
        kref = np.array([r["kernel_ref_at"] for r in rs])
        rows_at = sorted({r["floor_at"][0] for r in rs})
        krows_at = sorted({r["kernel_at"][0] for r in rs})
        print(f"{site}: {len(rs)} draws; kernel worst min {kern.min():.4e}, median "
              f"{np.median(kern):.4e}, max {kern.max():.4e} ({int((kern > 1e-2).sum())} above "
              f"the old fixed 1e-2); derived limit min {lim.min():.4e}, median "
              f"{np.median(lim):.4e}, max {lim.max():.4e}; conic_b limit {blim.min():.4e}-"
              f"{blim.max():.4e}; floor's worst in rows {rows_at}, kernel's in rows {krows_at}; "
              f"at the kernel's worst it is {kref.min():.4e}-{kref.max():.4e} from the f64-sum "
              f"chain ({int((kref < 1e-4).sum())} draws under 1e-4); control tail {min(tails)}-"
              f"{max(tails)} points, fails the limits on {ctl_fail}/{len(rs)}; "
              f"{sum(not r['ok'] for r in rs)} draws fail the hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
