#!/usr/bin/env python3
"""Times the blend kernels K3, K4 and K5 of one checkout on one NVIDIA GPU,
on the blend inputs that `chip_smoke.py --dump FILE` saved (the flagship
frame's binned pairs and the warm-up train step's pairs, each with its
cotangent):

    python3 scripts/blend_time.py --inputs FILE [--root DIR] [--save OUT]
                                  [--compare OTHER] [--iters N]
                                  [--max_k K [K ...]]

Imports gaussian_gan_decoder_tpu_torch from DIR (default: this checkout),
so that one run can time another checkout's kernels (a parent commit
unpacked beside this one) on the same card and the same inputs. K3 runs on
the frame's pairs at the flagship's tile capacity 640, K4 and K5 on the
step's pairs, on the frame's and on the frame's widened until half its
pixels saturate (as chip_smoke.py widens them) at each of --max_k (default 1024: the
train step's; smaller ones cap each tile's walk, to see whether the
heaviest tile bounds a kernel). Each is timed twice, after one
warm-up, by CUDA events around N wrapper calls: queued behind a ~10 ms
device sleep, so that the device runs them back to back (the device time
of a call), and on an idle device (which reads the wrapper's host time
where that is the longer). A checkout whose K5 replays
from K4's chunk entries gets them from K4 (blend_train(..., entries=True)),
and its K4 is timed with them. --save writes K3's, K4's and K5's outputs;
--compare reads another run's and prints, for each, whether the two are
bit-identical and their largest difference. Prints the card's name and
power limit last.
"""
from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--max_k", type=int, nargs="+", default=[1024])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("blend_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend as pb

    dev = torch.device("cuda")
    inputs = {k: tuple(x.to(dev) for x in v) for k, v in torch.load(args.inputs).items()}
    # the frame's pairs 4x wider and more opaque, as chip_smoke.py widens
    # them: half the pixels saturate
    starts, attrs, dout = inputs["frame"]
    wide = attrs.clone()
    wide[2:5] /= 16.0
    wide[5] = 0.6 + 0.4 * wide[5]
    inputs["wide"] = (starts, wide, dout)
    with_entries = "ent" in inspect.signature(pb.blend_train_bwd).parameters

    def ms(fn):
        """'<queued> ms device (queued events), <idle> ms a call (events)'"""
        fn()
        torch.cuda.synchronize()
        t = []
        for queued in (True, False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(args.iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            t.append(start.elapsed_time(end) / args.iters)
        return f"{t[0]:.4f} ms device (queued events), {t[1]:.4f} ms a call (events)"

    outputs = {}
    with torch.inference_mode():
        starts, attrs, _ = inputs["frame"]
        g = int(round((starts.numel() - 1) ** 0.5))
        acc, tr = pb.blend_tiles(starts, attrs, g, g, 16, 640)
        outputs["K3 frame"] = torch.cat([acc, tr[..., None]], dim=2)
        print(f"K3 ({args.root}) frame pairs, max_k 640: "
              + ms(lambda: pb.blend_tiles(starts, attrs, g, g, 16, 640)))
        for label in ("step", "frame", "wide"):
            starts, attrs, dout = inputs[label]
            g = int(round((starts.numel() - 1) ** 0.5))
            for mk in args.max_k:
                if with_entries:
                    fwd = lambda: pb.blend_train(starts, attrs, g, g, 16, mk, entries=True)  # noqa: E731
                    out, ent = fwd()
                    bwd = lambda: pb.blend_train_bwd(starts, attrs, out, dout, g, g, 16, mk, ent)  # noqa: E731
                else:
                    fwd = lambda: pb.blend_train(starts, attrs, g, g, 16, mk)  # noqa: E731
                    out = fwd()
                    bwd = lambda: pb.blend_train_bwd(starts, attrs, out, dout, g, g, 16, mk)  # noqa: E731
                key = label if mk == 1024 else f"{label} max_k {mk}"
                outputs[f"K4 {key}"], outputs[f"K5 {key}"] = out, bwd()
                print(f"K4 ({args.root}) {label} pairs, max_k {mk}: " + ms(fwd))
                print(f"K5 ({args.root}) {label} pairs, max_k {mk}: " + ms(bwd))
    torch.cuda.synchronize()
    if args.save:
        torch.save({k: v.cpu() for k, v in outputs.items()}, args.save)
    if args.compare:
        other = torch.load(args.compare)
        for k, v in outputs.items():
            if k not in other:
                continue
            v, w = v.cpu(), other[k]
            print(f"{k} against {args.compare}: bit-identical {torch.equal(v, w)}, max|d| "
                  f"{float((v - w).abs().max()):.3e}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
