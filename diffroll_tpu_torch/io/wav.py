"""WAV decode/encode + resampling, host-side (numpy).

Replaces torchaudio.load/save + Resample in the data pipeline (reference
utils/custom_dataset.py:55-62; task/diffusion.py:413-415). Pure stdlib
`wave` handles 16/24/32-bit PCM and float32 WAVs; resampling is polyphase
via scipy (MAPS/MAESTRO ship 44.1 kHz audio, the pipeline runs at 16 kHz).
MP3 decode is delegated to an `ffmpeg` binary when present (the image has
no Python audio codecs); WAV is the supported native path.
"""

from __future__ import annotations

import math
import pathlib
import shutil
import struct
import subprocess
import tempfile
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str | pathlib.Path, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Returns (samples float32 in [-1, 1], sample_rate). (C, L) or (L,) if mono."""
    path = str(path)
    with open(path, "rb") as f:
        riff = f.read(12)
    if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        return _read_via_ffmpeg(path, mono)

    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(n)
        x = _pcm_to_float(raw, width)
    except wave.Error:
        # float32 WAV (format 3) — stdlib wave rejects it; parse chunks directly
        x, sr, ch = _read_float_wav(path)

    x = x.reshape(-1, ch).T  # (C, L)
    if mono:
        x = x.mean(axis=0)
    return x, sr


def _pcm_to_float(raw: bytes, width: int) -> np.ndarray:
    """Interleaved PCM bytes -> float32 in [-1, 1] (8/16/24/32-bit)."""
    if width == 2:
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if width == 4:
        return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32))
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        return (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    if width == 1:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"unsupported sample width {width}")


def read_wav_bytes(data: bytes, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode an in-memory audio payload (the serving hot path — avoids a
    temp-file round trip per HTTP request). RIFF/WAVE parses directly from
    the buffer; anything else (mp3 etc.) falls back to the ffmpeg file
    path via a temporary file."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        import io as _io

        try:
            with wave.open(_io.BytesIO(data), "rb") as w:
                sr = w.getframerate()
                ch = w.getnchannels()
                width = w.getsampwidth()
                raw = w.readframes(w.getnframes())
            try:
                x = _pcm_to_float(raw, width)
            except ValueError as e:
                raise wave.Error(str(e))
            x = x.reshape(-1, ch).T
            if mono:
                x = x.mean(axis=0)
            return x, sr
        except wave.Error:
            pass  # 24-bit / float32 formats: reuse the file-path parser
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".audio") as tmp:
        tmp.write(data)
        tmp.flush()
        return read_wav(tmp.name, mono=mono)


def wav_info(path: str | pathlib.Path) -> Tuple[int, int]:
    """(n_samples_per_channel, sample_rate) from the WAV header alone —
    no sample decode, so eval-segmentation indices over a large test set
    build in O(files) header reads. Falls back to a full decode for
    non-RIFF files (mp3 via ffmpeg)."""
    path = str(path)
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            x, sr = read_wav(path, mono=True)
            return x.shape[-1], sr
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[:4]
            (size,) = struct.unpack("<I", hdr[4:8])
            if cid == b"fmt ":
                body = f.read(16)
                f.seek(size - 16 + (size & 1), 1)
                fmt = struct.unpack("<HHIIHH", body)
            elif cid == b"data" and fmt is not None:
                _, ch, sr, _, block_align, bits = fmt
                ba = block_align or max(1, ch * (bits // 8))
                return size // ba, sr
            else:
                f.seek(size + (size & 1), 1)
    raise ValueError(f"{path}: no data chunk")


def resampled_length(n: int, orig_sr: int, target_sr: int) -> int:
    """Output length of the polyphase resamplers here (native + scipy
    resample_poly agree): ceil(n * up / down)."""
    if orig_sr == target_sr:
        return int(n)
    g = math.gcd(int(orig_sr), int(target_sr))
    return -(-int(n) * (target_sr // g) // (orig_sr // g))


def _read_float_wav(path: str):
    with open(path, "rb") as f:
        data = f.read()
    i = 12
    fmt = None
    while i + 8 <= len(data):
        cid = data[i : i + 4]
        (size,) = struct.unpack("<I", data[i + 4 : i + 8])
        body = data[i + 8 : i + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data" and fmt is not None:
            audio_format, ch, sr, _, _, bits = fmt
            if audio_format in (3, 0xFFFE) and bits == 32:
                x = np.frombuffer(body, "<f4").astype(np.float32)
            elif audio_format == 1 and bits == 16:
                x = np.frombuffer(body, "<i2").astype(np.float32) / 32768.0
            else:
                raise ValueError(f"unsupported WAV format {audio_format}/{bits}")
            return x, sr, ch
        i += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")


def _read_via_ffmpeg(path: str, mono: bool) -> Tuple[np.ndarray, int]:
    """Decode non-WAV audio (mp3/flac/...) through an ffmpeg binary."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"{path}: not a WAV file and no ffmpeg binary available for decode"
        )
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        subprocess.run(
            [ffmpeg, "-y", "-v", "error", "-i", path, "-f", "wav",
             "-acodec", "pcm_s16le", tmp.name],
            check=True,
        )
        return read_wav(tmp.name, mono=mono)


def write_wav(path: str | pathlib.Path, samples: np.ndarray, sample_rate: int) -> None:
    """float [-1,1] (L,) or (C,L) -> 16-bit PCM WAV."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[None]
    pcm = np.clip(x.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def write_mp3(path: str | pathlib.Path, samples: np.ndarray,
              sample_rate: int) -> pathlib.Path:
    """Encode float [-1,1] audio to MP3 through an `ffmpeg` or `lame`
    binary (the reference saves eval audio as mp3 via torchaudio,
    reference task/diffusion.py:413-415; this image ships no Python
    audio codecs). When neither encoder exists, falls back to a 16-bit
    WAV next to the requested path. Returns the path actually written."""
    path = pathlib.Path(path)
    ffmpeg = shutil.which("ffmpeg")
    lame = shutil.which("lame")
    if ffmpeg is None and lame is None:
        fallback = path.with_suffix(".wav")
        write_wav(fallback, samples, sample_rate)
        return fallback
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        write_wav(tmp.name, samples, sample_rate)
        if ffmpeg is not None:
            cmd = [ffmpeg, "-y", "-v", "error", "-i", tmp.name,
                   "-codec:a", "libmp3lame", "-b:a", "192k", str(path)]
        else:
            cmd = [lame, "--quiet", "-b", "192", tmp.name, str(path)]
        subprocess.run(cmd, check=True)
    return path


def write_audio(path: str | pathlib.Path, samples: np.ndarray,
                sample_rate: int, fmt: str = "wav") -> pathlib.Path:
    """Write audio in the requested artifact format ("wav" | "mp3");
    returns the path actually written (mp3 may fall back to wav)."""
    path = pathlib.Path(path).with_suffix(f".{fmt}")
    if fmt == "mp3":
        return write_mp3(path, samples, sample_rate)
    if fmt != "wav":
        raise ValueError(f"unsupported audio format {fmt!r}")
    write_wav(path, samples, sample_rate)
    return path


def _resample_scipy(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(x, target_sr // g, orig_sr // g, axis=-1).astype(x.dtype)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis (torchaudio.Resample
    equivalent for the data pipeline). Uses the first-party C++ polyphase
    kernel (diffroll_tpu_torch.native) when the toolchain is available; scipy
    otherwise."""
    if orig_sr == target_sr:
        return x
    from .. import native

    if native.available():
        return native.resample(x, orig_sr, target_sr)
    return _resample_scipy(x, orig_sr, target_sr)
