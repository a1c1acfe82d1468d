"""Build and load the port's CUDA kernels.

The sources are the package's own `csrc/*.cu` (+ `*.cuh`). At first use
they are compiled by nvcc for sm_90a (one nvcc per source, all started
together) and linked into one shared library with a plain C interface,
cached in `diffroll_tpu_torch/_build/` under a hash of the sources and
flags, and loaded with ctypes. There is no fallback: a missing
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "drk_gated_stack": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P,
                        _P, _I, _I, _I, _I, _I, _I, _P],
    "drk_gated_stack_fwd_saves": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "drk_gated_stack_bwd": [_P, _P, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    "drk_cond_proj": [_P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P],
    "drk_sample_run": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P,
                       _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
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
    nvcc, tag = _nvcc(), f"{lib_path.stem}.{os.getpid()}"
    units = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in units]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(units, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s.name, log) for s, p, log in zip(units, procs, logs) if p.returncode != 0]
    tmp = BUILD_DIR / f"{tag}.tmp"
    if not failed:
        # -ldl: the tensor-map encoder is looked up in the loaded libcuda (dlsym)
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs], "-ldl"],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", logs[-1]))
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "nvcc.log").write_text("\n".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name}: {log[-4000:]}" for name, log in failed))
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
