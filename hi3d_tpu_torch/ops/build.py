"""Build and load the CUDA C++ kernels of `hi3d_tpu_torch/csrc`.

Each `csrc/*.cu` file compiles to an object in its own `nvcc` process, all
started together, and one more `nvcc` links the objects into a shared library
with a plain C interface, loaded with ctypes. The library lands in
`build/kernels/` at the repository root, named by a hash of every file under
`csrc/` (the `.cu` sources and the headers they include) and of the flags, so
a checkout builds on first use and reuses the build afterwards, and an edit
of a header rebuilds. `SIGNATURES` gives ctypes every entry point's
argtypes, and `launch` calls one on PyTorch's current stream.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)

# The argtypes of every `extern "C"` entry point of csrc/*.cu, in declaration
# order; each returns its cudaError_t as an int. ctypes would pass an argument
# of an entry point missing here as a 32-bit int, cutting its pointers, so
# tests/test_torch_build.py checks this table against the sources.
SIGNATURES = {
    "hi3d_flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _P),
    "hi3d_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _STRIDES, _F, _P),
    "hi3d_temporal_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _P),
    "hi3d_temporal_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _STRIDES, _F, _P),
    "hi3d_block_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _P),
    "hi3d_block_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _STRIDES, _F, _P),
    "hi3d_layer_norm": (_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _F, _P),
    "hi3d_group_stats": (_P, _P, _P, _L, _L, _L, _I, _I, _F, _I, _P),
    "hi3d_group_norm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                        _I, _F, _I, _P, _P),
}

# the dtype codes of csrc/norm_common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

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
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def stride_array(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])


def launch(fn, device: int, *args) -> int:
    """fn(*args, stream) for an entry point whose last argument is the
    stream: PyTorch's current stream on CUDA device `device` (an index) as
    the raw cudaStream_t, with the current device switched only when it is
    another. Returns fn's cudaError_t."""
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch._C._cuda_getDevice():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
