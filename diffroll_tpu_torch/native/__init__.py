"""First-party native (C++) host runtime, loaded via ctypes.

The device path is PyTorch/CUDA; this package accelerates the HOST side
of the framework (the port's own copy of the JAX package's `native`) — the data-path loops that dominate epoch time outside
the accelerator (SURVEY.md §2b): polyphase resampling, MIDI->roll
rasterization, and the sequential note-event decoder scan.

The library always builds locally on first use with the system C++
toolchain (`g++ -O3 -march=native -shared -fPIC`) into `_build/` — the
binary is never distributed (gitignored), so host-specific codegen is
safe. A cached binary is reused only when its build fingerprint (source
hash + compiler identity + flags) matches; a binary from a different
host or toolchain is recompiled, never dlopened. Every entry point has a
pure-numpy fallback, so missing compilers degrade gracefully.
`diffroll_tpu_torch.native.available()` reports which tier is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "src" / "native.cpp"
_BUILD = _HERE / "_build"
_LIB_PATH = _BUILD / "libdiffroll_native.so"
_FPR_PATH = _BUILD / "fingerprint.txt"
_CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _fingerprint() -> Optional[str]:
    """Hash of everything that determines the binary: source bytes,
    compiler identity (incl. host arch via -dumpmachine), and flags.
    A foreign binary (e.g. built with different ISA extensions) can
    SIGILL on dlopen/call, so an mtime check is not enough."""
    try:
        cxx_id = subprocess.run(
            ["g++", "--version"], capture_output=True, timeout=30,
        ).stdout + subprocess.run(
            ["g++", "-dumpmachine"], capture_output=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    h = hashlib.sha256()
    h.update(_SRC.read_bytes())
    h.update(cxx_id)
    h.update(" ".join(_CXX_FLAGS).encode())
    return h.hexdigest()


def _compile(fpr: str) -> bool:
    _BUILD.mkdir(exist_ok=True)
    cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(_LIB_PATH)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        _FPR_PATH.write_text(fpr)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        fpr = _fingerprint()
        if fpr is None:
            return None
        cached = (_LIB_PATH.exists() and _FPR_PATH.exists()
                  and _FPR_PATH.read_text().strip() == fpr)
        if not cached and not _compile(fpr):
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None

        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32

        lib.resample_poly_f32.argtypes = [f32p, i64, f32p, i64, i32, i32,
                                          i64, f32p, i64]
        lib.resample_poly_f32.restype = None
        lib.rasterize_f32.argtypes = [f64p, f64p, i32p, i64,
                                      ctypes.c_double, i32, i32,
                                      f32p, f32p, i64, i64]
        lib.rasterize_f32.restype = None
        lib.extract_notes.argtypes = [u8p, u8p, i64, i64, i32,
                                      i32p, i32p, i32p]
        lib.extract_notes.restype = i64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _design_filter(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, the scipy.signal.resample_poly
    default design (half_len 10*max(up,down), beta 5.0)."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    n = 2 * half_len + 1
    t = np.arange(n) - half_len
    h = f_c * np.sinc(f_c * t) * np.kaiser(n, 5.0)
    h /= h.sum()            # firwin normalizes DC gain to 1
    return (h * up).astype(np.float32)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis (native, numpy fallback)."""
    if orig_sr == target_sr:
        return x
    lib = _load()
    if lib is None:
        from ..io.wav import _resample_scipy

        return _resample_scipy(x, orig_sr, target_sr)

    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    h = _design_filter(up, down)
    half = (len(h) - 1) // 2                    # group delay, folded into C++
    shape = x.shape
    flat = np.ascontiguousarray(x.reshape(-1, shape[-1]), np.float32)
    n_in = shape[-1]
    n_out = -(-n_in * up // down)               # scipy resample_poly length
    out = np.empty((flat.shape[0], n_out), np.float32)
    for r in range(flat.shape[0]):
        row = np.ascontiguousarray(flat[r])
        lib.resample_poly_f32(
            _as(row, ctypes.c_float), len(row),
            _as(h, ctypes.c_float), len(h),
            up, down, half, _as(out[r], ctypes.c_float), n_out)
    return out.reshape(shape[:-1] + (n_out,)).astype(x.dtype)


def rasterize(
    onsets_s: np.ndarray, offsets_s: np.ndarray, pitches: np.ndarray,
    n_frames: int, hop_length: int, sample_rate: int,
    min_midi: int, max_midi: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native rasterizer; returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n_pitches = max_midi - min_midi + 1
    frame = np.empty((n_frames, n_pitches), np.float32)
    onset = np.empty((n_frames, n_pitches), np.float32)
    on = np.ascontiguousarray(onsets_s, np.float64)
    off = np.ascontiguousarray(offsets_s, np.float64)
    pit = np.ascontiguousarray(pitches, np.int32)
    lib.rasterize_f32(
        _as(on, ctypes.c_double), _as(off, ctypes.c_double),
        _as(pit, ctypes.c_int32), len(pit),
        sample_rate / hop_length, min_midi, max_midi,
        _as(frame, ctypes.c_float), _as(onset, ctypes.c_float),
        n_frames, n_pitches)
    return frame, onset


def extract_notes(
    onsets: np.ndarray, frames: np.ndarray, rule1: bool = True,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native note-event decoder over thresholded (T, P) bool rolls;
    returns (pitches, intervals) or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    on = np.ascontiguousarray(onsets, np.uint8)
    fr = np.ascontiguousarray(frames, np.uint8)
    t_len, p_len = on.shape
    cap = t_len * p_len
    out_p = np.empty(cap, np.int32)
    out_on = np.empty(cap, np.int32)
    out_off = np.empty(cap, np.int32)
    n = lib.extract_notes(
        _as(on, ctypes.c_uint8), _as(fr, ctypes.c_uint8),
        t_len, p_len, int(rule1),
        _as(out_p, ctypes.c_int32), _as(out_on, ctypes.c_int32),
        _as(out_off, ctypes.c_int32))
    pitches = out_p[:n].astype(np.int64)
    intervals = np.stack([out_on[:n], out_off[:n]], axis=1).astype(np.int64)
    return pitches, intervals
