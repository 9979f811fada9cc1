#!/usr/bin/env python3
"""Where the bf16 fused decode's gap to its plain version comes from, on one
NVIDIA GPU: K9 (csrc/brick_decode.cu) with the 'dots' lerp on the stagings
that chip_smoke.py holds it on, the flagship (PanoHead tri-grid, 8 int8
corners) and the EG3D tri-plane (4 bf16 corners) fused routes, each at 500k
template points with chip_smoke.py's seeds, latent and camera.

    python3 scripts/dots_gap.py [--seed 0]

On each staging it computes the rows (heads and projection) of
  kernel   K9 'dots' (decode_project_fused);
  plain    its plain version (decode_project_fused_plain: f32 sums);
  plain64  the same chain and roundings with f64 sums (chip_smoke.chain_rows),
           a second sound reference that differs from plain only in the
           order and precision of its sums;
  ctl_h6   the plain chain with its hidden activations rounded to 6 stored
           mantissa bits, not bf16's 7 (a lower-precision control);
  ctl_f6   the plain chain on the features rounded to 6 bits (a control);
  bcast    K9 'bcast' and its plain version on the same planes (the other
           lerp's gap, on the same chain);
and prints, for each pair, the gap in chip_smoke.hold_decode's measure
(rows 0:14 and 16:26 but conic_b, each row's |d| over the reference's row
max): the worst row-relative gap and its row, the per-point quantiles, the
points above 1e-3, 3e-3, 1e-2 and 1.6e-2; the share of points at which
each head's written-back bf16 outputs differ; and, at the worst point of
kernel vs plain, each side's gap to plain64. Then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

THRESHOLDS = (1e-3, 3e-3, 1e-2, 1.6e-2)


def report(torch, label, name, a, b, real, cols):
    """One pair's gap, printed -> per-point gaps (n_real,)."""
    ref = b[cols][:, real]
    rel = (a[cols][:, real] - ref).abs() / ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)
    g, per_row = rel.amax(dim=0), rel.amax(dim=1)
    q = torch.quantile(g.double(), g.new_tensor([0.5, 0.99, 0.999, 0.9999]).double()).tolist()
    print(f"{label} {name}: worst {float(g.max()):.3e} (row {cols[int(per_row.argmax())]}), "
          f"point quantiles p50 {q[0]:.2e} p99 {q[1]:.2e} p99.9 {q[2]:.2e} p99.99 {q[3]:.2e}; "
          "points above " + ", ".join(f"{t:g}: {int((g > t).sum())}" for t in THRESHOLDS)
          + f" of {g.numel()}; per-row worst "
          + " ".join(f"{r}:{float(v):.1e}" for r, v in zip(cols, per_row)))
    return g


def flips(torch, cw, a, b, real):
    """Per head that writes back: the share of real points at which its bf16
    outputs differ between rows a and b."""
    out = []
    for name, od, sc, oc in cw.chain:
        if sc + od <= 128:
            ra = a[oc:oc + od][:, real].to(torch.bfloat16)
            rb = b[oc:oc + od][:, real].to(torch.bfloat16)
            out.append(f"{name} {float((ra != rb).any(dim=0).float().mean()):.2e}")
    return ", ".join(out)


def staging(torch, d, w, z, cp, pos):
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import sample_fused_inputs
    G, M = d.G, pos.shape[0]
    planes, _ = d.synthesize_planes(w, z, cp)
    aux, Mpad = ph.build_brick_staging(pos.new_zeros((M, ph.C)), d.cond0(pos), pos,
                                       dtype=ph.chain_dtype(w.chain))
    rows_in, wts, sr = sample_fused_inputs(G.plane_axes, planes, pos[None],
                                           float(G.rk["box_warp"]), G.triplane_depth,
                                           table=d._brick_table(planes), pad_to=Mpad)
    return aux, rows_in, wts, sr


def study(torch, label, d, pos, cam, cp, z):
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    w = d.fold()
    cw = w.chain
    M = pos.shape[0]
    with torch.inference_mode():
        aux, rows_in, wts, sr = staging(torch, d, w, z, cp, pos)
        Mpad = aux.shape[0]
        real = torch.arange(Mpad, device=pos.device) < M
        cb = ph.PROJ_ROWS["conic_b"]
        cols = [r for r in list(range(0, 14)) + list(range(16, 26)) if r != cb]
        k = ph.decode_project_fused(cw, aux, rows_in, wts, sr, cam, M, lerp="dots")
        p = ph.decode_project_fused_plain(cw, aux, rows_in, wts, sr, cam, M, lerp="dots")
        feats = ph.fused_features_plain(rows_in, wts, sr, "dots")
        st = aux.float()
        st[:, :ph.C] = cs.round_mantissa(torch, feats, 7)
        p32 = cs.chain_rows(torch, st, cw, cam, torch.float32)
        print(f"{label}: chain_rows at f32 equals the plain version on the real points: "
              f"{torch.equal(p32[:, real], p[:, real])}")
        del p32
        p64 = cs.chain_rows(torch, st, cw, cam, torch.float64)
        h6 = cs.chain_rows(torch, st, cw, cam, torch.float32, hidden_bits=6)
        st6 = st.clone()
        st6[:, :ph.C] = cs.round_mantissa(torch, feats, 6)
        f6 = cs.chain_rows(torch, st6, cw, cam, torch.float32)
        del st6
        torch.cuda.synchronize()
        g_kp = report(torch, label, "kernel vs plain", k, p, real, cols)
        report(torch, label, "plain64 vs plain", p64, p, real, cols)
        report(torch, label, "kernel vs plain64", k, p64, real, cols)
        report(torch, label, "plain vs plain64", p, p64, real, cols)
        report(torch, label, "ctl_h6 vs plain", h6, p, real, cols)
        report(torch, label, "ctl_f6 vs plain", f6, p, real, cols)
        print(f"{label} written-back outputs that differ, kernel vs plain: "
              f"{flips(torch, cw, k, p, real)}; plain64 vs plain: "
              f"{flips(torch, cw, p64, p, real)}; ctl_h6 vs plain: {flips(torch, cw, h6, p, real)}")
        i = int(real.nonzero()[int(g_kp.argmax())])
        rmax = p[cols][:, real].abs().amax(dim=1).clamp(min=1e-3)
        dk = (k[cols, i] - p[cols, i]).abs() / rmax
        d64k = (k[cols, i] - p64[cols, i]).abs() / rmax
        d64p = (p[cols, i] - p64[cols, i]).abs() / rmax
        j = int(dk.argmax())
        print(f"{label} worst point {i} (row {cols[j]}): kernel-plain {float(dk[j]):.3e}, "
              f"kernel-plain64 {float(d64k[j]):.3e}, plain-plain64 {float(d64p[j]):.3e} of the "
              f"row max; values kernel {float(k[cols[j], i]):.6g} plain {float(p[cols[j], i]):.6g} "
              f"plain64 {float(p64[cols[j], i]):.6g}; its worst over rows: kernel-plain64 "
              f"{float(d64k.max()):.3e}, plain-plain64 {float(d64p.max()):.3e}")
        kb = ph.decode_project_fused(cw, aux, rows_in, wts, sr, cam, M, lerp="bcast")
        pb = ph.decode_project_fused_plain(cw, aux, rows_in, wts, sr, cam, M, lerp="bcast")
        torch.cuda.synchronize()
        report(torch, label, "bcast kernel vs bcast plain", kb, pb, real, cols)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dots_gap: no CUDA device", file=sys.stderr)
        return 2
    from gaussian_gan_decoder_tpu_torch import flagship, kernel_lib
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_lib.library()
    dev = torch.device("cuda:0")
    cp, c2w = flagship.default_camera_params(device=dev)
    cam = make_camera(cs.IMAGE, cs.FOV, c2w, device=dev)

    # the flagship fused route as chip_smoke.py's frame-options phase builds
    # it (its latents from seed + 31)
    rng = torch.Generator().manual_seed(args.seed)
    dec = flagship.flagship_decoder(rng=rng, device=dev, gelu="poly6").eval()
    nprng = np.random.RandomState(args.seed)
    pos = torch.tensor(((nprng.rand(cs.POINTS, 3) - 0.5) * 0.4).astype(np.float32), device=dev)
    z = np.random.RandomState(args.seed + 31).randn(cs.FRAMES + 1, 1, 512)[0]
    fdec = flagship.flagship_decoder(gen=dec.G, device=dev, fused_sampling=True).eval()
    fdec.load_state_dict(dec.state_dict())
    study(torch, "flagship", fdec, pos, cam, cp,
          torch.tensor(z.astype(np.float32), device=dev))
    del dec, fdec

    # the EG3D fused route (bf16 heads) as chip_smoke.py's EG3D phase builds it
    rng = torch.Generator().manual_seed(args.seed + 9)
    dec = flagship.flagship_decoder(gen=flagship.flagship_generator("eg3d", rng=rng, device=dev),
                                    rng=rng, device=dev).eval()
    nprng = np.random.RandomState(args.seed + 9)
    pos = torch.tensor(((nprng.rand(cs.POINTS, 3) - 0.5) * 0.4).astype(np.float32), device=dev)
    zs = torch.tensor(nprng.randn(cs.EG3D_FRAMES + 2, 1, 512).astype(np.float32), device=dev)
    ddec = flagship.flagship_decoder(gen=dec.G, device=dev, fused_sampling=True).eval()
    ddec.config = dataclasses.replace(ddec.config, heads_bf16=True)
    ddec.load_state_dict(dec.state_dict())
    study(torch, "EG3D", ddec, pos, cam, cp, zs[1])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
