"""Build and load the CUDA C++ kernels of `hi3d_tpu_torch/csrc`.

Each `csrc/*.cu` file compiles to an object in its own `nvcc` process, all
started together, and one more `nvcc` links the objects into a shared library
with a plain C interface, loaded with ctypes. The library lands in
`build/kernels/` at the repository root, named by a hash of every file under
`csrc/` (the `.cu` sources and the headers they include) and of the flags, so
a checkout builds on first use and reuses the build afterwards, and an edit
of a header rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the build this process ran


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    sources = sorted(p for p in CSRC.rglob("*") if p.is_file())
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        digest.update(p.relative_to(CSRC).as_posix().encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libhi3d_kernels_{digest.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        t0 = time.perf_counter()
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            objs.append(obj)
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]))
        codes = [p.wait() for p in procs]
        if any(codes):
            raise RuntimeError(f"nvcc failed for csrc/*.cu (exit codes {codes})")
        tmp = out.with_name(f"{tag}.so.tmp")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                       check=True)
        os.replace(tmp, out)
        for obj in objs:
            obj.unlink()
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.hi3d_flash_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, strides, f32, ptr,
    ]
    lib.hi3d_flash_attention_fwd.restype = i32
    lib.hi3d_temporal_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, strides, f32, ptr,
    ]
    lib.hi3d_temporal_attention_fwd.restype = i32
    lib.hi3d_flash_attention_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, strides,
        f32, ptr,
    ]
    lib.hi3d_flash_attention_bwd.restype = i32
    lib.hi3d_temporal_attention_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, strides, f32, ptr,
    ]
    lib.hi3d_temporal_attention_bwd.restype = i32
    lib.hi3d_block_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, strides, f32, ptr,
    ]
    lib.hi3d_block_attention_fwd.restype = i32
    lib.hi3d_block_attention_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, strides, f32,
        ptr,
    ]
    lib.hi3d_block_attention_bwd.restype = i32
    _lib = lib
    return lib


def stride_array(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
