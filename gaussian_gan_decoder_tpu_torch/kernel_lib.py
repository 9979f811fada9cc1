"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The kernels have a plain C interface (raw pointers, ints, the stream).
Each source is compiled by its own nvcc process, all started together, and
the objects are linked into a single .so that ctypes loads; nothing
includes PyTorch's headers, so a cold build takes seconds. The library is built at
first use, never at import, into `_build/` next to this file, under a name
keyed by a hash of the sources and the flags — an edited source never loads
a stale binary.

Dispatch rule of every kernel wrapper in the package: tensors on the CPU go
to the wrapper's plain PyTorch version; tensors on a CUDA device go to the
kernel, and a kernel that cannot be built or launched raises — there is no
fallback to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points (csrc/*.cu) -> argtypes; every one returns cudaGetLastError()
_SIGNATURES = {
    # mapping.cu
    "ggd_mapping_forward": [_P] * 9 + [_F, _P, _P] + [_I] * 5 + [_P],
    # slab_decode.cu
    "ggd_slab_decode": [_P] * 17 + [_I] * 7 + [_F, _F, _P],
    # blend.cu
    "ggd_blend_tiles": [_P, _P, _P] + [_I] * 5 + [_P],
    # blend_train.cu
    "ggd_blend_train_fwd": [_P] * 4 + [_I] * 6 + [_P],
    "ggd_blend_train_bwd": [_P] * 6 + [_I] * 6 + [_P],
    # heads_train.cu
    "ggd_heads_fwd": [_P] * 12 + [_I, _I, _I, _F, _P],
    "ggd_heads_bwd": [_P] * 15 + [_I, _I, _F, _P],
    # brick_table.cu
    "ggd_brick_table": [_P, _P] + [_I] * 6 + [_P],
    # brick_decode.cu
    "ggd_brick_decode": [_P] * 12 + [_I, _I, _F, _P],
    "ggd_fused_decode": [_P] * 17 + [_I, _I, _I, _F, _P],
}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        p = Path(CUDA_HOME) / "bin" / "nvcc"
        cand = str(p) if p.exists() else None
    if cand is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of gaussian_gan_decoder_tpu_torch "
            "are built from csrc/ on a machine with the CUDA toolkit")
    return cand


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into _build/libggd_kernels_<hash>.so (cached) and
    return its path: one nvcc per source, run in parallel, then one link.
    Prints the build seconds and ptxas' register/shared memory report when
    it compiles."""
    so = BUILD_DIR / f"libggd_kernels_{_source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{err}")
    objs = [obj for obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = BUILD_DIR / f"{tag}.so"
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s -> {so.name}", file=sys.stderr)
    print("".join(logs), file=sys.stderr)
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def use_kernel(*tensors: torch.Tensor) -> bool:
    """Dispatch on device: False for CPU tensors (plain version), True for
    CUDA tensors (kernel). Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on unsupported or mixed devices: {sorted(kinds)}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def raise_on_error(code: int, kernel: str):
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")
