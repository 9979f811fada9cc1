#!/usr/bin/env python3
"""Spread of chip_smoke.py's decode_packed hold of K6's bf16 form over head
draws, on one NVIDIA GPU.

    python3 scripts/k6_bf16_hold_spread.py [--draws 20] [--repeats 2]

chip_smoke.py's decoder-options phase holds K6's bf16 form against its
plain version on the flagship decoder (seeded flagship generator, seed +
21; the heads from their own seeded stream) by each output column's
largest gap as a share of that column's largest value, at the limit
chip_smoke.hold_heads_gap derives from the plain version's gap to the
chain with f64 sums, with a 6-bit control that must fail it. This script
builds the same decoder with the heads from torch.Generator().manual_seed(k)
for k in range(draws), takes the same staging (the int8 table sample of the
planes of the phase's first latent at the 500k-point template), and prints
each draw's worst column-relative gap, the derived limit and the control's
readings, each draw repeated to show whether the kernel, the plain version
and the staging are deterministic for a given draw. It never imports jax.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k6_bf16_hold_spread: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (build_plane_table,
                                                                     sample_from_planes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    dev, seed, M = torch.device("cuda:0"), 0, 500_000
    gen = flagship.flagship_generator(rng=torch.Generator().manual_seed(seed + 21),
                                      device=dev).eval()
    template = ((np.random.RandomState(seed).rand(M, 3) - 0.5) * 0.4).astype(np.float32)
    pos = torch.tensor(template, device=dev)
    cp, _ = flagship.default_camera_params(device=dev)
    z = torch.tensor(np.random.RandomState(seed + 21).randn(1, 512).astype(np.float32),
                     device=dev)

    def digest(t):
        return hashlib.sha1(t.float().contiguous().cpu().numpy().tobytes()).hexdigest()[:10]

    gaps, limits, failed = [], [], 0
    with torch.inference_mode():
        for k in range(args.draws):
            d = flagship.flagship_decoder(gen=gen, device=dev,
                                          rng=torch.Generator().manual_seed(k)).eval()
            cw = d.fold().chain
            reads = []
            for _ in range(args.repeats):
                planes, _ = d.synthesize_planes(d.fold(), z, cp)
                table = build_plane_table(planes, 3, brick_dtype=torch.int8)
                feats = sample_from_planes(gen.plane_axes, planes, pos[None], 1.0, 3,
                                           table=table)[0]
                st, _ = ph.build_brick_staging(feats.mean(0), d.cond0(pos), pos,
                                               dtype=torch.bfloat16)
                o_k, o_p = ph.decode_heads(st, cw), ph.decode_heads_plain(st, cw)
                col = ((o_k - o_p)[:M, :14].abs().amax(dim=0)
                       / o_p[:M, :14].abs().amax(dim=0).clamp(min=1e-3))
                reads.append((float(col.max()), int(col.argmax()), digest(st), digest(o_k),
                              digest(o_p)))
            try:
                worst, limit = chip_smoke.hold_heads_gap(torch, o_k, o_p, st, cw, M,
                                                         f"heads draw {k}")
                ok = worst <= limit
            except chip_smoke.PhaseError as e:
                print(f"heads draw {k}: {e}")
                worst, limit, ok = reads[0][0], float("nan"), False
            failed += not ok
            gaps.append(reads[0][0])
            limits.append(limit)
            same = all(r[2:] == reads[0][2:] for r in reads)
            print(f"heads draw {k}: worst column-relative {reads[0][0]:.4e} (column "
                  f"{reads[0][1]}), derived limit {limit:.4e}, passes {ok}; {args.repeats} "
                  f"repeats bit-identical: {same}")
            del d
    g, lim = np.array(gaps), np.array(limits)
    print(f"{len(g)} draws: worst min {g.min():.4e}, median {np.median(g):.4e}, max "
          f"{g.max():.4e}; derived limit min {np.nanmin(lim):.4e}, max {np.nanmax(lim):.4e}; "
          f"{failed} draws fail the derived hold; {int((g > 1e-2).sum())} above the old fixed "
          f"1e-2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
