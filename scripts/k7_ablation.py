#!/usr/bin/env python3
"""Where K7 (csrc/heads_train.cu::heads_bwd_kernel) spends its time, on one
NVIDIA GPU.

    python3 scripts/k7_ablation.py

Builds heads_train.cu as it is and in variants that each switch one part
of K7 off (their gradients are wrong on purpose), one nvcc per variant, all
started together, into gaussian_gan_decoder_tpu_torch/_build/ablation/.
Then times each variant's K7 (with its fixed-order reduce) by CUDA events
on the train step's shape: 500,032 points, the exact-GELU 5-head chain,
random inputs from seed 0. A part's cost is the base time less the time
without it; parts overlap, so the costs do not add up to the base.

Variants: base; no_rmw (the weight-gradient products run, their
read-modify-write of the block's partial does not, but for a rare store); no_wgrad (no weight
gradients of the three 128-wide layers at all); no_gelu (GELU and its
derivative are the identity); no_l4 (no layer-4 raw output on the CUDA
cores); no_xw_gwt (the recompute X W and the data gradient G W^T load and
split their operands but run no MMA). Prints one line per variant and
the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
POINTS = 500_032
N_PART = 132


def variants(src: str):
    wgrad = ("__device__ __forceinline__ void wgrad(const float* A, const float* G, float* pw, "
             "float* pb) {\n")
    rmw = ("#pragma unroll\n    for (int hr = 0; hr < 2; ++hr)\n#pragma unroll\n"
           "      for (int j = 0; j < 8; ++j)\n        row[hr][4 * j]")
    l4 = ("      // -- layer 4 on the CUDA cores: raw output, then dO ----------------\n"
          "      for (int e = tid; e < kBT * kOutW; e += kThreads) {")
    mma_f = "      ggd::mma_3xtf32(acc[j], ahi, alo, bh0, bh1, bl0, bl1);\n    }\n  }\n}\n\n// data"
    keep_f = "      acc[j][0] += __uint_as_float(ahi[0] ^ alo[1] ^ bh0 ^ bl1);\n    }\n  }\n}\n\n// data"
    mma_d = "      ggd::mma_3xtf32(acc[4 * half + jj], ahi, alo, bh0, bh1, bl0, bl1);"
    keep_d = "      acc[4 * half + jj][0] += __uint_as_float(ahi[0] ^ alo[1] ^ bh0 ^ bl1);"
    edits = {
        "base": [],
        "no_rmw": [(rmw, rmw.replace("        row[", "        if (acc[0][0] == 1234.5f) row[")),
                   ("      for (int j = 0; j < 8; ++j) old[hr][j] = row[hr][4 * j];",
                    "      for (int j = 0; j < 8; ++j) old[hr][j] = make_float2(0.f, 0.f);")],
        "no_wgrad": [(wgrad, wgrad + "  return;\n")],
        "no_gelu": [("a[j][e] = ggd::gelu_and_grad(z[j][e], unused);", "a[j][e] = z[j][e];"),
                    ("a[j][e] = ggd::gelu_and_grad(z[j][e], z[j][e]);", "a[j][e] = z[j][e];")],
        "no_l4": [(l4, l4.replace("      for (int e", "      if (Mpad < 0) for (int e"))],
        "no_xw_gwt": [(mma_f, keep_f), (mma_d, keep_d)],
    }
    for name, subs in edits.items():
        s = src
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"variant {name}: heads_train.cu no longer has {a!r}")
            s = s.replace(a, b)
        yield name, s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k7_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gaussian_gan_decoder_tpu_torch import kernel_lib
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads_vjp as pv
    from gaussian_gan_decoder_tpu_torch.decoder.heads import CHAIN, DecoderHead

    out_dir = kernel_lib.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (kernel_lib.CSRC / "heads_train.cu").read_text()
    nvcc = kernel_lib._nvcc()
    jobs = []
    for name, text in variants(src):
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        jobs.append((name, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", str(kernel_lib.CSRC), "-Xptxas", "-v",
             "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"k7_ablation: {name} does not build:\n{err}", file=sys.stderr)
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
        out16 = ph.decode_heads(st, cw)
        dout = rand(POINTS, 16)
    dst = torch.empty_like(st)
    parts = torch.zeros((N_PART, 5 * pv._HEAD_GRAD), device=dev)
    flat = torch.empty((5, pv._HEAD_GRAD), device=dev)
    ptrs = [st.data_ptr(), out16.data_ptr(), dout.data_ptr()]
    ptrs += [getattr(cw, k).data_ptr() for k in ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")]
    ptrs += [cw.meta.data_ptr(), dst.data_ptr(), parts.data_ptr(), flat.data_ptr()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip()
    times = {}
    for name, _ in jobs:
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).ggd_heads_bwd
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                 ctypes.c_void_p]
        call = lambda: fn(*ptrs, POINTS, N_PART, cw.scale_offset,  # noqa: E731
                          torch.cuda.current_stream().cuda_stream)
        if call() != 0:
            print(f"k7_ablation: {name} did not launch", file=sys.stderr)
            return 1
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            call()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / 3
    for name, ms in times.items():
        extra = "" if name == "base" else f"; the part costs {times['base'] - ms:.3f} ms"
        print(f"K7 {name}: {ms:.3f} ms{extra}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
