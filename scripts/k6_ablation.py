#!/usr/bin/env python3
"""Where K6 (csrc/heads_train.cu::heads_fwd_kernel, its chain in
csrc/chain_tf32.cuh) spends its time, on one NVIDIA GPU.

    python3 scripts/k6_ablation.py

Builds heads_train.cu as it is and with variants of chain_tf32.cuh that
each change one part of K6 (their outputs are wrong on purpose where a part
is switched off), one nvcc per variant, all started together, into
gaussian_gan_decoder_tpu_torch/_build/ablation6/. Then times each
variant's K6 (the weight split included) by CUDA events on the train
step's shape: 500,000 points, the exact-GELU 5-head chain of the decoder,
random inputs from seed 0. A part's cost is the base time less the time
without it; parts overlap, so the costs do not add up to the base.

Variants: base (weights split once per call into TF32 (hi, lo) pairs);
warp_split (the warps split the raw weights as they read them: half the
operand bytes, three more instructions an element; its outputs are
right); no_gelu (GELU is the identity); one_mma (one TF32 product hi*hi in
place of the three of 3xTF32: the price of f32 accuracy); no_mma (the
products load and split their operands but run no MMA); full_l1 (layer 1
multiplies all 128 rows of w1, not only the staging prefix; right too);
no_stream (only the first two ring stages are copied: every later stage
multiplies what its slot holds, so the weight stream from L2 is gone).
The variants are timed in turns, two rounds of 5 launches each. Prints
one line per variant and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
POINTS = 500_000


def variants(src: str):
    """(name, text of chain_tf32.cuh) for each variant of K6's chain."""
    mma = ("        mma_3xtf32(acc[2 * Jn], ahi, alo, v0.x, v1.x, v0.y, v1.y);\n"
           "        mma_3xtf32(acc[2 * Jn + 1], ahi, alo, v0.z, v1.z, v0.w, v1.w);\n")
    one = ("        mma_tf32(acc[2 * Jn], ahi, v0.x, v1.x);\n"
           "        mma_tf32(acc[2 * Jn + 1], ahi, v0.z, v1.z);\n")
    none = ("        acc[2 * Jn][0] += __uint_as_float(ahi[0] ^ alo[1] ^ v0.x ^ v1.y);\n"
            "        acc[2 * Jn + 1][0] += __uint_as_float(ahi[2] ^ alo[3] ^ v0.z ^ v1.w);\n")
    pairs = ("        const int n = (32 * Jn + 4 * g) ^ (q << 3);\n"
             "        const uint4 v0 = *reinterpret_cast<const uint4*>(r0 + n);\n"
             "        const uint4 v1 = *reinterpret_cast<const uint4*>(r0 + kSplitRow + n);\n")
    split = ("        const int n = (16 * Jn + 2 * g) ^ (q << 3);\n"
             "        const float2 wa = *reinterpret_cast<const float2*>(r0 + n);\n"
             "        const float2 wb = *reinterpret_cast<const float2*>(r0 + kStage + n);\n"
             "        uint4 v0, v1;\n"
             "        split_tf32(wa.x, v0.x, v0.y);\n"
             "        split_tf32(wa.y, v0.z, v0.w);\n"
             "        split_tf32(wb.x, v1.x, v1.y);\n"
             "        split_tf32(wb.y, v1.z, v1.w);\n")
    prep = ("  wsplit[(size_t)hl * 2 * kLayer + 2 * e] = __uint_as_float(hi);\n"
            "  wsplit[(size_t)hl * 2 * kLayer + 2 * e + 1] = __uint_as_float(lo);")
    raw = ("  wsplit[(size_t)hl * 2 * kLayer + e] = w[(size_t)(hl / 3) * kLayer + e];\n"
           "  (void)lo;")
    fetch = ("  const float* w = wsplit + (size_t)hl * 2 * kLayer + part * kSplitSlot;\n"
             "  if (n > 0) cp_rows<kSplitRow, kSplitRow, true, kF32Threads>(s.ring + (st & 1) * "
             "kSplitSlot, w, n);")
    fetch_raw = ("  const float* w = wsplit + (size_t)hl * 2 * kLayer + part * 64 * kStage;\n"
                 "  if (n > 0) cp_rows<kStage, kStage, true, kF32Threads>(s.ring + (st & 1) * "
                 "kSplitSlot, w, n);")
    row = "      const float* r0 = slot + (16 * (J - kJ0) + 4 * q + 2 * b) * kSplitRow;"
    gelu = "  return kGelu == 0 ? gelu_exact(x) : gelu(x, kGelu);"
    l1 = "  return min(8, (__ldg(meta + 6 + h) + 15) / 16);"
    edits = {
        "base": [],
        # the warps split the raw f32 weights as they read them: the prep
        # kernel copies w1..w3 unsplit, the ring carries half the bytes
        "warp_split": [(prep, raw), (fetch, fetch_raw),
                       (row, row.replace("kSplitRow;", "kStage;")), (pairs, split)],
        "no_gelu": [(gelu, "  return x;")],
        "one_mma": [(mma, one)],
        "no_mma": [(mma, none)],
        "full_l1": [(l1, "  return 8 + 0 * h + 0 * meta[0];")],
        "no_stream": [(fetch, fetch.replace("if (n > 0)", "if (n > 0 && st < 2)"))],
    }
    for name, subs in edits.items():
        s = src
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"variant {name}: chain_tf32.cuh no longer has {a!r}")
            s = s.replace(a, b)
        yield name, s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k6_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gaussian_gan_decoder_tpu_torch import kernel_lib
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.decoder.heads import CHAIN, DecoderHead

    out_dir = kernel_lib.BUILD_DIR / "ablation6"
    out_dir.mkdir(parents=True, exist_ok=True)
    # K6's chain is chain_tf32.cuh's: each variant is a copy of that header
    # beside heads_train.cu in a directory of its own, which the quoted
    # include finds before csrc/
    src = (kernel_lib.CSRC / "chain_tf32.cuh").read_text()
    nvcc = kernel_lib._nvcc()
    jobs = []
    for name, text in variants(src):
        vdir = out_dir / name
        vdir.mkdir(exist_ok=True)
        (vdir / "chain_tf32.cuh").write_text(text)
        cu = vdir / "heads_train.cu"
        cu.write_text((kernel_lib.CSRC / "heads_train.cu").read_text())
        jobs.append((name, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", str(kernel_lib.CSRC),
             "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"k6_ablation: {name} does not build:\n{err}", file=sys.stderr)
            return 1

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    heads, cond = {}, 3
    for name, od in CHAIN:
        heads[name] = DecoderHead(32 + cond, od, generator=g).to(dev)
        cond += od
    with torch.no_grad():
        cw = ph.pack_chain_f32(heads, CHAIN, 3, -2.5, "exact")
        rand = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
        st = ph.build_staging_f32(rand(POINTS, 32), rand(POINTS, 3) * 0.2, rand(POINTS, 3) * 0.2)
    H = cw.w1.shape[0]
    out = torch.empty((POINTS, 16), device=dev)
    wsplit = torch.empty((H, 3, 128, 128, 2), device=dev)
    ptrs = [st.data_ptr()]
    ptrs += [getattr(cw, k).data_ptr() for k in ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")]
    ptrs += [cw.meta.data_ptr(), out.data_ptr()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip()
    times = {name: 0.0 for name, _ in jobs}
    for _ in range(2):
        for name, _ in jobs:
            fn = ctypes.CDLL(str(out_dir / f"{name}.so")).ggd_heads_fwd
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                          ctypes.c_void_p]
            call = lambda: fn(*ptrs, wsplit.data_ptr(), POINTS, H, 0,  # noqa: E731
                              cw.scale_offset, torch.cuda.current_stream().cuda_stream)
            if call() != 0:
                print(f"k6_ablation: {name} did not launch", file=sys.stderr)
                return 1
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                call()
            end.record()
            torch.cuda.synchronize()
            times[name] += start.elapsed_time(end) / 10
    for name, ms in times.items():
        extra = "" if name == "base" else f"; base less this {times['base'] - ms:.3f} ms"
        print(f"K6 {name}: {ms:.3f} ms{extra}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
