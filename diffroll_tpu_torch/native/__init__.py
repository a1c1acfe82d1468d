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
host or toolchain is recompiled, never dlopened. Processes that reach
first use together (loader workers, data-axis ranks, test workers) build
once: a valid cache is loaded without a lock; otherwise each holds an
exclusive `flock` on `_build/.lock` from the fingerprint check until the
library is loaded, and the compiler writes a pid-tagged temporary file that
`os.replace` moves into place before the fingerprint is written. Every
entry point has a pure-numpy fallback for a host without `g++` (or a
`_build/` it cannot write); a library that was built but cannot be loaded
raises.
`diffroll_tpu_torch.native.available()` reports which tier is active.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import math
import os
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
    """Build into a pid-tagged temporary file and move it into place, then
    the fingerprint the same way: a reader never sees a half-written
    library, and a matching fingerprint always names a whole one. The
    caller holds the build lock."""
    tag = f".{os.getpid()}.tmp"
    lib_tmp = _LIB_PATH.with_name(_LIB_PATH.name + tag)
    fpr_tmp = _FPR_PATH.with_name(_FPR_PATH.name + tag)
    cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(lib_tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(lib_tmp, _LIB_PATH)
        fpr_tmp.write_text(fpr)
        os.replace(fpr_tmp, _FPR_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        lib_tmp.unlink(missing_ok=True)
        fpr_tmp.unlink(missing_ok=True)


def _open_cached(fpr: str) -> Optional[ctypes.CDLL]:
    """The cached library when its fingerprint is `fpr`, else None. The
    fingerprint is written only after its library is in place, so a match
    names a whole library: one that then fails to `dlopen` raises."""
    if not (_LIB_PATH.exists() and _FPR_PATH.exists()
            and _FPR_PATH.read_text().strip() == fpr):
        return None
    try:
        return ctypes.CDLL(str(_LIB_PATH))
    except OSError as err:
        raise RuntimeError(f"the native library {_LIB_PATH} was built for this host "
                           f"but cannot be loaded: {err}") from err


def _build_locked(fpr: str) -> Optional[ctypes.CDLL]:
    """Build under an exclusive `flock` on `_build/.lock`, held until the
    library is loaded: the first process compiles, the others wait and then
    find the cache valid. None (the numpy tier) when the directory cannot be
    written or the compile fails."""
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        lock_file = open(_BUILD / ".lock", "a")
    except OSError:
        return None
    with lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        lib = _open_cached(fpr)
        if lib is None and _compile(fpr):
            lib = _open_cached(fpr)
        return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        fpr = _fingerprint()
        # a valid cache loads without the lock, so a checkout whose `_build/`
        # cannot be written still takes the C++ tier
        lib = None if fpr is None else _open_cached(fpr)
        if lib is None and fpr is not None:
            lib = _build_locked(fpr)
        if lib is None:
            _tried = True
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
        _lib, _tried = lib, True
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
    returns (pitches, intervals) or None when unavailable. `frames` is
    broadcast to the onsets' shape, as the numpy tier's `onset_diff &= fr`
    broadcasts it (a scalar or a (P,) row holds for every step); a shape
    that does not broadcast raises. The scan reads T x P bytes of each."""
    lib = _load()
    if lib is None:
        return None
    on = np.ascontiguousarray(onsets, np.uint8)
    if on.ndim != 2:
        raise ValueError(f"onsets must be a (T, P) roll, got shape {on.shape}")
    fr = np.ascontiguousarray(np.broadcast_to(np.asarray(frames, np.uint8), on.shape))
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
