"""Build and load the port's CUDA kernels.

The sources are the package's own `csrc/*.cu` (+ `*.cuh`). At first use
they are compiled by nvcc for sm_90a into one shared library with a plain
C interface, cached in `diffroll_tpu_torch/_build/` under a hash of the
sources and flags, and loaded with ctypes. There is no fallback: a missing
nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "drk_gated_stack": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P,
                        _P, _I, _I, _I, _I, _I, _P],
    "drk_cond_proj": [_P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P],
    "drk_head_in": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "drk_head_out": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, 0.0 if cached


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (pathlib.Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and pathlib.Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these exact sources exists."""
    global build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libdiffroll_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_seconds = 0.0
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.drk_error_string.argtypes = [ctypes.c_int]
            lib.drk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        msg = library().drk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
