#!/usr/bin/env python3
"""Where the f32 decode kernels (csrc/decode_f32.cu: K2-f32, K8-f32, K9-f32)
spend their time beyond K6's chain, on one NVIDIA GPU; and, with --root, the
same kernels of another checkout timed in turns beside this one's.

    python3 scripts/f32_decode_ablation.py [--root DIR ...] [--no_variants] [--eg3d]

Builds the f32 decode kernels (csrc/decode_f32.cu, its body
decode_f32.cuh and the GELU kinds' decode_f32_gelu_*.cu) as they are and
in variants that each switch one phase off (their rows are wrong on
purpose), one nvcc a source, all started together, into
gaussian_gan_decoder_tpu_torch/_build/ablation_f32/, with -Xptxas -v: each
kernel's registers, spills, stack and shared memory are printed. K6
(heads_train.cu::heads_fwd_kernel) is built beside them. The variants,
copies of decode_f32.cu / decode_f32.cuh / chain_tf32.cuh:
  base           the kernels as they are;
  no_staging     the staging rows are not loaded (zero);
  no_gather      no feature gather (K2, K9): the feature columns are zero;
  no_projection  no projection kernel: rows 16:32 are not written (the
                 decode kernel writes its packed outputs as rows 0:16);
  gelu_runtime   the GELU kind chosen at run time in the chain's layer loop
                 (the parent's dispatch; the kernels take it as a template
                 argument, one instance a kind);
  chain_only     no staging load, no gather, no projection;
  items_unrolled K9's gather over a thread's two points unrolled (the
                 kernel keeps that loop rolled, half the code to fetch).
A phase's cost is the base time less the time without it; phases that
overlap do not add up to the base.

Inputs, made from --seed: D-par, the decoder of chip_smoke.py's
decoder-options phase (the PanoHead flagship generator at full width,
seeded random weights, 'parallel' heads with the xyz embedding, f32 heads,
exact GELU), the 500k template, the frontal camera: K2-f32 on its slab pack
(572,416 slots), K9-f32 'dots' and 'bcast' on its int8 brick gathers and
K8-f32 on the plane-mean staging (500,736 rows), and K6 on a staging of
each row count. --eg3d adds the EG3D forms (flagship_generator("eg3d"),
f32 "poly" heads): K2-f32 bilinear and K9-f32 tri-plane, 'bcast' and
'dots'.

--root DIR (repeatable): builds DIR's decode_f32*.cu and heads_train.cu too
(a parent commit unpacked beside this checkout; their C entries take the
same arguments) and times them in turns with this checkout's base: DIR,
this, this, DIR; each root's rows are compared with this checkout's.
--no_variants skips the variants. Every time is device time: CUDA events
around calls queued behind a device sleep, the weight split included.
Prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
POINTS = 500_000
IMAGE = 512
FOV = 0.227
ITERS = 5


def variant_edits():
    """name -> [(text in one of decode_f32.cu, decode_f32.cuh, chain_tf32.cuh,
    replacement)] of each variant."""
    stage = "    if (r < n_rows)\n      cp_async16(s.X + r * kF32Ld + c, staging"
    fused = ("      fused_point_features<kCorners, Row, kDots>(rows0, rows1, rows2, wts, "
             "scale_rows, m0 + pt,\n                                                 tid & 3, "
             "Mpad, acc);")
    slab = ("      slab_point_features<kBilinear>(vol, scale_rows, positions, idx16, inv_axes, "
            "m0 + pt,\n                                     tid & 3, D, H, W, DZ, YP, XP, "
            "box_warp, acc[k]);")
    proj = "  project_rows_kernel<<<"
    off = [(stage, stage.replace("r < n_rows", "r < 0 * n_rows")),
           (fused, "      for (int c = 0; c < 8; ++c) acc[c] = 0.f;"),
           (slab, "      for (int c = 0; c < 8; ++c) acc[k][c] = 0.f;"),
           (proj, "  if (Mpad < 0) project_rows_kernel<<<")]
    gelu = "      bias_gelu<kGelu>(act, bh + l * kStage);"
    runtime = ("      switch (sMeta[26]) {\n"
               + "".join(f"        case {k}: bias_gelu<{k}>(act, bh + l * kStage); break;\n"
                         for k in range(4))
               + "        default: bias_gelu<4>(act, bh + l * kStage);\n      }")
    items = ("#pragma unroll 1\n  for (int k = 0; k < kItems; ++k) {\n"
             "    const int pt = (tid >> 2) + k * (kF32Threads / 4);\n    if (pt < n_rows) {\n"
             "      float acc[8];")
    return {
        "base": [],
        "no_staging": off[:1],
        "no_gather": off[1:3],
        "no_projection": off[3:],
        "gelu_runtime": [(gelu, runtime)],
        "chain_only": off,
        "items_unrolled": [(items, items.replace("#pragma unroll 1\n", "#pragma unroll\n"))],
    }


EDITED = ("decode_f32.cu", "decode_f32.cuh", "chain_tf32.cuh")


def apply_edits(name, texts, subs):
    """texts: {file: text} of EDITED -> the edited copies (a variant's edit
    lands in the one file that has its text)."""
    texts = dict(texts)
    for a, b in subs:
        hits = [f for f, t in texts.items() if a in t]
        if len(hits) != 1:
            raise RuntimeError(f"variant {name}: {len(hits)} files have {a!r}")
        texts[hits[0]] = texts[hits[0]].replace(a, b)
    return texts


def nvcc_job(nvcc, src: Path, include: Path, obj: Path):
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-I", str(include), "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_report(log: str):
    """nvcc -Xptxas -v output -> {mangled entry: {regs, spill_st, spill_ld,
    stack, smem}} for every kernel (entry function) compiled."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                              spill_ld=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and entry in out:
            out[entry].update(regs=int(m.group(1)), smem=int(m.group(2) or 0))
    return out


def demangle(nvcc, names):
    tool = Path(nvcc).parent / "cu++filt"
    if not names or not tool.exists():
        return {n: n for n in names}
    res = subprocess.run([str(tool)], input="\n".join(names), capture_output=True, text=True)
    lines = res.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def build(args, kernel_lib):
    """Compile each variant's sources (decode_f32.cu with the GELU kinds'
    decode_f32_gelu_*.cu, edited copies beside them), K6 and each root's
    decode_f32*.cu and heads_train.cu, one nvcc a source, all started
    together; link each into a library and print its kernels' ptxas report.
    -> {label: [decode .so, K6 .so or None]}."""
    out_dir = kernel_lib.BUILD_DIR / "ablation_f32"
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    csrc = kernel_lib.CSRC
    nvcc = kernel_lib._nvcc()
    texts = {f: (csrc / f).read_text() for f in EDITED}
    units = {}   # label -> (sources, include dir)
    edits = {"base": []} if args.no_variants else variant_edits()
    for name, subs in edits.items():
        vdir = out_dir / name
        vdir.mkdir()
        for f, t in apply_edits(name, texts, subs).items():
            (vdir / f).write_text(t)
        srcs = []
        for src in sorted(csrc.glob("decode_f32*.cu")):
            if not (vdir / src.name).exists():
                shutil.copy(src, vdir / src.name)
            srcs.append(vdir / src.name)
        units[name] = (srcs, csrc)
    units["K6"] = ([csrc / "heads_train.cu"], csrc)
    for i, root in enumerate(args.root):
        rc = Path(root).resolve() / "gaussian_gan_decoder_tpu_torch" / "csrc"
        units[f"root{i}"] = (sorted(rc.glob("decode_f32*.cu")), rc)
        units[f"root{i} K6"] = ([rc / "heads_train.cu"], rc)
    jobs = []
    for label, (srcs, inc) in units.items():
        for j, src in enumerate(srcs):
            obj = out_dir / f"{label.replace(' ', '_')}.{j}.o"
            jobs.append((label, obj, nvcc_job(nvcc, src, inc, obj)))
    reports = {label: {} for label in units}
    for label, obj, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: {obj.name} does not build:\n{err}")
        reports[label].update(ptxas_report(err))
    libs = {}
    for label in units:
        so = out_dir / f"{label.replace(' ', '_')}.so"
        objs = [str(o) for lb, o, _ in jobs if lb == label]
        res = subprocess.run([nvcc, "-shared", "-o", str(so), *objs], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{label} does not link:\n{res.stderr}")
        if label.endswith("K6"):
            libs[label.split()[0] if " " in label else "base"][1] = so
        else:
            libs[label] = [so, None]
    names = sorted({k for r in reports.values() for k in r})
    dm = demangle(nvcc, names)
    for label, rep in reports.items():
        if label not in ("base", "K6") and not label.startswith("root"):
            continue   # the variants' kernels are the base's, edited
        for k, v in sorted(rep.items(), key=lambda kv: dm[kv[0]]):
            pretty = dm[k]
            if label.endswith("K6") and "heads_fwd_kernel<0>" not in pretty:
                continue   # K6's exact-GELU instance is the one timed
            print(f"ptxas {label}: {pretty[:110]}: {v.get('regs')} registers, "
                  f"{v.get('spill_st')} B spill stores, {v.get('spill_ld')} B spill loads, "
                  f"{v.get('stack')} B stack, {v.get('smem')} B static smem")
    return libs


def load(so: Path, kernel_lib):
    lib = ctypes.CDLL(str(so))
    for name, argtypes in kernel_lib._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def dpar_forms(torch, dev, seed, ph):
    """D-par's f32 forms and K6 at their row counts -> {form: (entry,
    pointers before wsplit, ints and floats after the output, out shape)}."""
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
        build_plane_table, build_slab_volume, sample_fused_inputs, sample_from_planes)
    gen = flagship.flagship_generator(rng=torch.Generator().manual_seed(seed + 21),
                                      device=dev).eval()
    dec = GaussianDecoder(gen, gelu="exact", rng=torch.Generator().manual_seed(seed + 22),
                          device=dev, decoder_type="parallel", use_xyz_embedding=True,
                          heads_bf16=False).eval()
    return route_forms(torch, dev, seed, ph, dec, gen.triplane_depth, "",
                       build_plane_table, build_slab_volume, sample_fused_inputs,
                       sample_from_planes)


def eg3d_forms(torch, dev, seed, ph):
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.decoder.heads import GaussianDecoder
    from gaussian_gan_decoder_tpu_torch.neuralfield.renderer import (
        build_plane_table, build_slab_volume, sample_fused_inputs, sample_from_planes)
    gen = flagship.flagship_generator("eg3d", rng=torch.Generator().manual_seed(seed + 9),
                                      device=dev).eval()
    dec = GaussianDecoder(gen, gelu="poly", rng=torch.Generator().manual_seed(seed + 10),
                          device=dev, heads_bf16=False).eval()
    return route_forms(torch, dev, seed, ph, dec, 1, "EG3D ", build_plane_table,
                       build_slab_volume, sample_fused_inputs, sample_from_planes)


def route_forms(torch, dev, seed, ph, dec, D, tag, build_plane_table, build_slab_volume,
                sample_fused_inputs, sample_from_planes):
    from gaussian_gan_decoder_tpu_torch import flagship
    from gaussian_gan_decoder_tpu_torch.gaussians.cameras import make_camera
    gen = dec.G
    template = ((np.random.RandomState(seed).rand(POINTS, 3) - 0.5) * 0.4).astype(np.float32)
    pos = torch.tensor(template, device=dev)
    cp, c2w = flagship.default_camera_params(device=dev)
    cam = make_camera(IMAGE, FOV, c2w, device=dev)
    z = torch.tensor(np.random.RandomState(seed + 21).randn(1, gen.z_dim).astype(np.float32),
                     device=dev)
    w = dec.fold()
    cw = w.chain
    box_warp = float(gen.rk["box_warp"])
    M = POINTS
    with torch.inference_mode():
        planes, _ = dec.synthesize_planes(w, z, cp)
        ctx = dec.make_slab_context(template, device=dev)
        vol, scales = build_slab_volume(planes, D)
        scale_rows = ph.slab_scale_rows(scales)
        cam_c = ph._cam_consts(cam, dev)
        aux, Mpad = ph.build_brick_staging(pos.new_zeros((M, ph.C)), dec.cond0(pos), pos,
                                           dtype=torch.float32)
        table = build_plane_table(planes, D, brick_dtype=torch.int8) if D > 1 else None
        rows_in, wts, fused_scale = sample_fused_inputs(gen.plane_axes, planes, pos[None],
                                                        box_warp, D, table=table, pad_to=Mpad)
        if D > 1:
            feats = sample_from_planes(gen.plane_axes, planes, pos[None], box_warp, D,
                                       table=table)[0]
            staging, _ = ph.build_brick_staging(feats.mean(0), dec.cond0(pos), pos,
                                                dtype=torch.float32)
    H_, gk = cw.w1.shape[0], ph._GELU_IDS[cw.gelu]
    chain = [cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4, cam_c, cw.meta]
    Dv, Hs, Ws = ctx.sizes
    n_planes, DZ, YP, XPC = vol.shape
    Ms = ctx.aux.shape[0]
    K = rows_in[0].shape[1] // ph.C
    slab = ("ggd_slab_decode_f32",
            [vol, scale_rows, ctx.positions, ctx.idx16, ctx.aux, ctx.inv_axes] + chain,
            [Ms, Dv, Hs, Ws, DZ, YP, XPC // ph.C, H_, gk, ctx.box_warp, cw.scale_offset],
            (ph.NROWS, Ms))

    def fused(dots):
        return ("ggd_fused_decode_f32", [aux, *rows_in, wts, fused_scale] + chain,
                [Mpad, M, K, dots, H_, gk, cw.scale_offset], (ph.NROWS, Mpad))

    def k6(st):
        return ("ggd_heads_fwd", [st, cw.w1, cw.b1, cw.w2, cw.b2, cw.w3, cw.b3, cw.w4, cw.b4,
                                  cw.meta], [st.shape[0], H_, gk, cw.scale_offset],
                (st.shape[0], ph.OUT_W))

    if D > 1:
        forms = {f"{tag}K2f (slab, {Ms} slots)": slab,
                 f"{tag}K9fd ('dots', {Mpad} rows)": fused(1),
                 f"{tag}K9f ('bcast', {Mpad} rows)": fused(0),
                 f"{tag}K8f ({Mpad} rows)": ("ggd_brick_decode_f32", [staging] + chain,
                                             [Mpad, M, H_, gk, cw.scale_offset],
                                             (ph.NROWS, Mpad)),
                 f"{tag}K6 ({Ms} rows)": k6(ctx.aux),
                 f"{tag}K6 ({Mpad} rows)": k6(staging)}
    else:
        forms = {f"{tag}K2f bilinear ({Ms} slots)": slab,
                 f"{tag}K9bf tri-plane 'bcast' ({Mpad} rows)": fused(0),
                 f"{tag}K9bfd tri-plane 'dots' ({Mpad} rows)": fused(1)}
    return forms, H_, gk


def arguments(form, out, wsplit, stream):
    """The C entry's arguments: the inputs' and the chain's pointers, then
    wsplit and the output (K6: the output, then wsplit), the sizes, the
    stream."""
    entry, ptrs, tail, _ = form
    p = [t.data_ptr() for t in ptrs]
    mid = [out.data_ptr(), wsplit.data_ptr()] if entry == "ggd_heads_fwd" else \
        [wsplit.data_ptr(), out.data_ptr()]
    return p + mid + list(tail) + [stream]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--no_variants", action="store_true")
    ap.add_argument("--eg3d", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("f32_decode_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gaussian_gan_decoder_tpu_torch import kernel_lib
    from gaussian_gan_decoder_tpu_torch.decoder import pallas_heads as ph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build(args, kernel_lib)
    dev = torch.device("cuda")
    forms, H_, gk = dpar_forms(torch, dev, args.seed, ph)
    if args.eg3d:
        forms.update(eg3d_forms(torch, dev, args.seed, ph)[0])
    loaded = {name: (load(so, kernel_lib), load(so6, kernel_lib) if so6 else None)
              for name, (so, so6) in libs.items()}
    wsplit = torch.empty((H_, 3, 128, 128, 2), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def caller(lib_name, form):
        entry, ptrs, tail, shape = forms[form]
        is_k6 = entry == "ggd_heads_fwd"
        lib = loaded[lib_name][1 if is_k6 else 0]
        if lib is None:
            return None, None
        out = torch.empty(shape, device=dev)
        fn = getattr(lib, entry)
        a = arguments(forms[form], out, wsplit, stream)

        def call():
            code = fn(*a)
            if code != 0:
                raise RuntimeError(f"{lib_name} {entry}: cudaError {code}")
        return call, out

    def queued(call):
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(ITERS):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / ITERS

    order = list(loaded)
    if args.root:
        # roots and this checkout's base in turns: root, this, this, root
        order = [n for n in order if n.startswith("root")] + ["base"]
        order += list(reversed(order))
        order += [n for n in loaded if n not in order]
    else:
        order += list(reversed(order))
    for form in forms:
        times, outs = {}, {}
        for name in order:
            call, out = caller(name, form)
            if call is None:
                continue
            times.setdefault(name, []).append(queued(call))
            outs[name] = out
        base = outs["base"].clone()
        cells = []
        for name, t in times.items():
            ms = sum(t) / len(t)
            cell = f"{name} {ms:.3f} ms"
            if name != "base":
                cell += f" (base less this {sum(times['base']) / len(times['base']) - ms:+.3f})"
            if name.startswith("root"):
                o = outs[name]
                rel = float(((o - base).abs().amax(dim=-1 if o.shape[0] == ph.NROWS else 0)
                             / base.abs().amax(dim=-1 if o.shape[0] == ph.NROWS else 0)
                             .clamp(min=1e-3)).max())
                cell += f", rows bit-identical to base {torch.equal(o, base)}, worst " \
                        f"row-relative {rel:.3e}"
            cells.append(cell + " [" + ", ".join(f"{x:.3f}" for x in t) + "]")
        print(f"{form}: " + "; ".join(cells))
    for i, root in enumerate(args.root):
        print(f"root{i} = {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
