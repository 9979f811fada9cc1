#!/usr/bin/env python3
"""What the blends' design choices are worth (csrc/blend.cu: K3,
csrc/blend_train.cu: K4 and K5), on one NVIDIA GPU, and that the reach
tests change no bit of their outputs.

    python3 scripts/blend_ablation.py --inputs FILE [--iters N]

FILE is what `chip_smoke.py --dump FILE` saved: the flagship frame's binned
pairs and the warm-up train step's, each with a cotangent. Builds the two
sources as they are ("base"), without K4's and K5's row tests ("no_rows":
a warp evaluates all the tile's rows of a pair within reach), without any
reach test ("no_reach": every warp evaluates every pair at every pixel of
its rows), without K4's reach tests alone ("k4_no_reach"), with K4's scan
replaying every chunk ("k4_serial": each pixel walks all its tile's pairs
one after another, the old serial walk; its first pass still runs), K4
blending every round of a tile even after all its pixels stopped
("k4_all_rounds"), with one or four warps a K4 chunk in place of two
("k4_1warp": 8 pixels a lane, 8 warps a block; "k4_4warps": 2 pixels a
lane, rounds of 4 chunks), with K4 rounds of 4 chunks in place of 8
("k4_round4"), and with K3's threads blending 4 or 8 pixels in place of 2 ("k3_4px": 64
threads a tile, a warp 8 rows; "k3_8px": one warp a tile, 32-pair chunks),
one nvcc per variant, all started together, into
gaussian_gan_decoder_tpu_torch/_build/ablation_blend/. Then runs each
variant's K3 on the frame's pairs at the tile capacity 640, and its K4 and
K5 on the step's pairs, the frame's and the frame's widened until half
its pixels saturate (as chip_smoke.py widens them) at max_k 1024, checks
that every
variant gives the base's bits (k4_serial: K3's; its K4 folds T pair by
pair, not chunk by chunk, so its K4 and K5 differ by rounding, and their
largest difference is printed), and K4 and K5 of the base build at
training chunks of 16 and 32 pairs, and times each kernel by CUDA
events around N launches of its C entry, the variants in turns (each in
order, then in reverse), queued behind a ~10 ms device sleep so that the
device runs them back to back. Prints one line per kernel and pair set,
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SKIP = ("if (ggd::beyond_reach(", "if (false && ggd::beyond_reach(")
NO_ROWS = ("blend_train.cu", "= reach_row_pairs(", "= 0xffffffffu | reach_row_pairs(")
PIX = "constexpr int kPixPerThread = 2;"
# K4's own reach tests: a chunk's pair against the tile, and its rows
K4_SKIP = [("blend_train.cu", "(ggd::beyond_reach(make_float2(e.y, e.z), a.x, a.y, rx0, rx1,",
            "(false && ggd::beyond_reach(make_float2(e.y, e.z), a.x, a.y, rx0, rx1,")]
# variant -> [(source, text, replacement)]
VARIANTS = {"base": [],
            "no_rows": [NO_ROWS],
            "no_reach": [NO_ROWS, ("blend.cu", *SKIP), ("blend_train.cu", *SKIP)],
            "k4_no_reach": K4_SKIP + [("blend_train.cu", "near_rows = reach_row_pairs(",
                                       "near_rows = 0xffffffffu | reach_row_pairs(")],
            "k4_serial": [("blend_train.cu", "kFastT = kStop * (1.f + 1e-4f);",
                           "kFastT = 3.0e38f;")],
            "k4_all_rounds": [("blend_train.cu", "__syncthreads_or(p < kPix && T >= kStop)",
                               "__syncthreads_or(1)")],
            "k4_1warp": [("blend_train.cu", "kChunkWarps = 2;", "kChunkWarps = 1;")],
            "k4_round4": [("blend_train.cu", "kRound = 8;", "kRound = 4;")],
            "k4_4warps": [("blend_train.cu", "kRound = 8;", "kRound = 4;"),
                          ("blend_train.cu", "kChunkWarps = 2;", "kChunkWarps = 4;")],
            "k3_4px": [("blend.cu", PIX, PIX.replace("2", "4"))],
            "k3_8px": [("blend.cu", PIX, PIX.replace("2", "8")),
                       ("blend.cu", "kStage = 64;", "kStage = 32;")]}
# variants whose outputs of these kernels differ from the base's by rounding
ROUNDED = {"k4_serial": ("K4", "K5")}
CHUNKS = (16, 32)   # training chunks of the base build's K4 and K5 (K4 takes up to 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("blend_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gaussian_gan_decoder_tpu_torch import kernel_lib
    from gaussian_gan_decoder_tpu_torch.splat import pallas_blend as pb

    out_dir = kernel_lib.BUILD_DIR / "ablation_blend"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernel_lib._nvcc()
    jobs = []
    for name, edits in VARIANTS.items():
        objs = []
        for src in ("blend.cu", "blend_train.cu"):
            text = (kernel_lib.CSRC / src).read_text()
            for f, a, b in edits:
                if f != src:
                    continue
                if a not in text:
                    print(f"blend_ablation: {src} no longer has {a!r}", file=sys.stderr)
                    return 1
                text = text.replace(a, b)
            (out_dir / f"{name}_{src}").write_text(text)
            objs.append(str(out_dir / f"{name}_{src}"))
        jobs.append((name, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", str(kernel_lib.CSRC),
             "-o", str(out_dir / f"{name}.so"), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"blend_ablation: {name} does not build:\n{err}", file=sys.stderr)
            return 1
    libs = {}
    for name, _ in jobs:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, argtypes in kernel_lib._SIGNATURES.items():
            if fn.startswith("ggd_blend"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {k: tuple(x.to(dev) for x in v) for k, v in torch.load(args.inputs).items()}
    # the frame's pairs 4x wider and more opaque, as chip_smoke.py widens
    # them: half the pixels saturate
    starts, attrs, dout = inputs["frame"]
    wide = attrs.clone()
    wide[2:5] /= 16.0
    wide[5] = 0.6 + 0.4 * wide[5]
    inputs["wide"] = (starts, wide, dout)
    calls = {}   # (kernel, pairs) -> {variant: (launch, output)}
    for name, lib in libs.items():
        starts, attrs, _ = inputs["frame"]
        T, g = starts.numel() - 1, int(round((starts.numel() - 1) ** 0.5))
        out3 = torch.empty((T, 256, 4), device=dev)
        calls.setdefault(("K3", "frame"), {})[name] = (
            lambda lib=lib, s=starts, a=attrs, o=out3, g=g, T=T: lib.ggd_blend_tiles(
                s.data_ptr(), a.data_ptr(), o.data_ptr(), a.shape[1], g, T, 16, 640, 0, 0,
                stream),
            out3)
        for label in ("step", "frame", "wide"):
            starts, attrs, dout = inputs[label]
            T, g = starts.numel() - 1, int(round((starts.numel() - 1) ** 0.5))
            out = torch.empty((T, 256, 4), device=dev)
            ent = torch.empty((pb.entry_slot_count(T, attrs.shape[1]), 256, 4), device=dev)
            dattrs = torch.zeros_like(attrs)
            fwd = (lambda lib=lib, s=starts, a=attrs, o=out, e=ent, g=g, T=T:
                   lib.ggd_blend_train_fwd(s.data_ptr(), a.data_ptr(), o.data_ptr(),
                                           e.data_ptr(), a.shape[1], g, T, 16, 1024,
                                           pb.ENTRY_CHUNK, stream))
            bwd = (lambda lib=lib, s=starts, a=attrs, o=out, d=dout, e=ent, da=dattrs, g=g, T=T:
                   lib.ggd_blend_train_bwd(s.data_ptr(), a.data_ptr(), o.data_ptr(),
                                           d.data_ptr(), e.data_ptr(), da.data_ptr(), a.shape[1],
                                           g, T, 16, 1024, pb.ENTRY_CHUNK, stream))
            calls.setdefault(("K4", label), {})[name] = (fwd, out)
            calls.setdefault(("K5", label), {})[name] = (bwd, dattrs)
    # outputs, in the order the kernels depend on each other
    for key, variants in calls.items():
        for name, (launch, _) in variants.items():
            if launch() != 0:
                print(f"blend_ablation: {name} {key} did not launch", file=sys.stderr)
                return 1
    torch.cuda.synchronize()

    def ms(launch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(args.iters):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    for (kernel, label), variants in calls.items():
        base_out = variants["base"][1]
        exact = [n for n in variants if kernel not in ROUNDED.get(n, ())]
        same = all(torch.equal(base_out, variants[n][1]) for n in exact)
        rounded = {n: float((v[1] - base_out).abs().max() / base_out.abs().max())
                   for n, v in variants.items() if n not in exact}
        t = {name: 0.0 for name in variants}
        for name in list(variants) + list(variants)[::-1]:
            t[name] += ms(variants[name][0]) / 2
        print(f"{kernel} {label} pairs: " + ", ".join(f"{n} {v:.4f} ms" for n, v in t.items())
              + f"; outputs bit-identical: {same}"
              + "".join(f"; {n} max|d| {d:.1e} of the base's largest" for n, d in rounded.items()))
        if not same:
            return 1
    # the base build's K4 and K5 at other training chunks (K5's sums then
    # round in another order: the largest difference is printed)
    base = libs["base"]
    for label in ("step", "frame", "wide"):
        starts, attrs, dout = inputs[label]
        T, g = starts.numel() - 1, int(round((starts.numel() - 1) ** 0.5))
        ref = calls[("K5", label)]["base"][1]
        line = []
        for chunk in CHUNKS:
            out = torch.empty((T, 256, 4), device=dev)
            ent = torch.empty((pb.entry_slot_count(T, attrs.shape[1], chunk), 256, 4), device=dev)
            dattrs = torch.zeros_like(attrs)
            fwd = (lambda s=starts, a=attrs, o=out, e=ent, g=g, T=T, c=chunk:
                   base.ggd_blend_train_fwd(s.data_ptr(), a.data_ptr(), o.data_ptr(),
                                            e.data_ptr(), a.shape[1], g, T, 16, 1024, c, stream))
            bwd = (lambda s=starts, a=attrs, o=out, d=dout, e=ent, da=dattrs, g=g, T=T, c=chunk:
                   base.ggd_blend_train_bwd(s.data_ptr(), a.data_ptr(), o.data_ptr(),
                                            d.data_ptr(), e.data_ptr(), da.data_ptr(),
                                            a.shape[1], g, T, 16, 1024, c, stream))
            if fwd() != 0 or bwd() != 0:
                print(f"blend_ablation: chunk {chunk} did not launch", file=sys.stderr)
                return 1
            torch.cuda.synchronize()
            rel = float((dattrs - ref).abs().max() / ref.abs().max())
            line.append(f"{chunk}: K4 {ms(fwd):.4f} ms, K5 {ms(bwd):.4f} ms "
                        f"(max|d| {rel:.1e} of K5's largest)")
        print(f"training chunk, {label} pairs: " + "; ".join(line))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
