"""Arbitrary-length audio transcription: windowing, batched sampling and
overlap stitching (counterpart of `diffroll_tpu/tasks/transcribe.py`)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.profiling import span


def split_windows(
    audio: np.ndarray,
    seq_len: int,
    hop_length: int = 512,
    overlap_frames: int = 0,
) -> np.ndarray:
    """(L,) waveform -> (n_win, seq_len) hop-aligned windows covering L."""
    if overlap_frames < 0 or overlap_frames * hop_length >= seq_len:
        raise ValueError("overlap must be >= 0 and smaller than the window")
    stride = seq_len - overlap_frames * hop_length
    n_win = max(1, math.ceil(max(len(audio) - seq_len, 0) / stride) + 1)
    total = (n_win - 1) * stride + seq_len
    padded = np.zeros(total, dtype=np.float32)
    padded[: len(audio)] = audio
    idx = np.arange(n_win)[:, None] * stride + np.arange(seq_len)[None, :]
    return padded[idx]


def stitch_rolls(
    rolls: np.ndarray,
    overlap_frames: int,
    total_frames: int,
) -> np.ndarray:
    """(n_win, F, 88) window rolls -> (total_frames, 88) with a linear
    crossfade over the overlapped frames."""
    n_win, frames, pitches = rolls.shape
    stride = frames - overlap_frames
    out = np.zeros((max(total_frames, (n_win - 1) * stride + frames), pitches))
    weight = np.zeros(out.shape[0])

    w = np.ones(frames)
    if overlap_frames > 0:
        ramp = np.linspace(0.0, 1.0, overlap_frames + 2)[1:-1]
        w[:overlap_frames] = ramp
        w[-overlap_frames:] = ramp[::-1]
    for i in range(n_win):
        s = i * stride
        out[s: s + frames] += rolls[i] * w[:, None]
        weight[s: s + frames] += w
    out /= np.maximum(weight, 1e-8)[:, None]
    return out[:total_frames]


@torch.no_grad()
def transcribe_long(
    task,
    audio: np.ndarray,
    generator: torch.Generator,
    *,
    sample_rate: int = 16000,
    batch_size: int = 8,
    overlap_frames: int = 32,
) -> Optional[np.ndarray]:
    """Transcribe a waveform of any length -> (n_frames, 88) roll.

    Audio at another rate than the model's is resampled first. Windows run
    through `task.sample` in batches of up to `batch_size` on the model's
    device; x_T and the per-step noise come from `generator` (which must
    live on that device). Unlike the JAX package, a short last batch is
    not padded: eager PyTorch has no compiled shape to keep.

    Over the task's data axis (`task.mesh`) each batch's windows are
    striped over the ranks (x_T and the noise drawn for the whole batch on every rank), the
    rolls gathered to rank 0, which stitches them and returns the roll;
    every other rank returns None.
    """
    with span("transcribe.long"):
        mc = task.model.config
        device = task.model.device
        with span("transcribe.split"):
            if sample_rate != mc.mel.sample_rate:
                from .. import native

                audio = native.resample(np.asarray(audio, np.float32), sample_rate,
                                        mc.mel.sample_rate)
            hop = mc.mel.hop_length
            seq_len = mc.frames * hop
            total_frames = max(1, math.ceil(len(audio) / hop))
            windows = split_windows(np.asarray(audio, np.float32), seq_len, hop,
                                    overlap_frames)

        rolls = []
        for k, start in enumerate(range(0, len(windows), batch_size)):
            with span("transcribe.copy_in", f"batch={k}"):
                chunk = torch.from_numpy(windows[start: start + batch_size]).to(device)
            with span("transcribe.draw", f"batch={k}"):
                x_T = torch.randn((chunk.shape[0], mc.frames, mc.pitches),
                                  generator=generator, device=device)
            out, _ = task.sample(x_T, waveform=chunk, generator=generator)
            if out is None:  # not rank 0 of the data axis: the rolls went there
                continue
            with span("transcribe.copy_out", f"batch={k}"):
                rolls.append(out.cpu().numpy())
        if not rolls:
            return None
        with span("transcribe.stitch"):
            return stitch_rolls(np.concatenate(rolls, axis=0), overlap_frames, total_frames)
