"""Log-mel spectrogram front-end on `torch.stft`.

Counterpart of `diffroll_tpu/dsp/mel.py`, with the same numerics as
torchaudio's defaults used by the reference (config/spec/mel.yaml):

  * center=True with reflect padding of n_fft//2 samples on both sides,
  * periodic Hann window of length n_fft,
  * `normalized=True` in torchaudio's sense: the complex STFT is divided by
    sqrt(sum(win^2)) (NOT torch.stft's own `normalized`, which divides by
    sqrt(n_fft)),
  * power spectrum (power=2.0),
  * HTK mel filterbank, norm=None.

The JAX package's conv-DFT and matmul-DFT paths are TPU routes and have no
counterpart here. Layout is channels-last: (B, L) -> (B, n_frames, n_mels).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
) -> np.ndarray:
    """Triangular HTK mel filterbank, shape (n_freqs, n_mels), norm=None."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Same fields and defaults as `diffroll_tpu.dsp.mel.MelConfig`.
    `method` and `precision` select TPU execution paths there; the port
    always runs `torch.stft` and keeps them only as data."""

    sample_rate: int = 16000
    n_fft: int = 2048
    hop_length: int = 512
    n_mels: int = 229
    f_min: float = 0.0
    f_max: Optional[float] = 8000.0
    center: bool = True
    normalized: bool = True
    pad_mode: str = "reflect"
    power: float = 2.0
    win_length: Optional[int] = None
    method: str = "fft"
    precision: str = "highest"

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, n_samples: int) -> int:
        if self.center:
            return n_samples // self.hop_length + 1
        return (n_samples - self.n_fft) // self.hop_length + 1


class MelSpectrogram(nn.Module):
    """waveform (B, L) -> power mel spectrogram (B, n_frames, n_mels).

    The window and filterbank are non-persistent buffers: they follow the
    module across `.to(device)` and never enter a `state_dict`.
    """

    def __init__(self, config: MelConfig = MelConfig()):
        super().__init__()
        self.config = config
        n = config.win_length or config.n_fft
        if n != config.n_fft:
            # torchaudio centers a shorter window inside the FFT frame
            win = np.zeros(config.n_fft, dtype=np.float32)
            start = (config.n_fft - n) // 2
            win[start: start + n] = hann_window(n)
        else:
            win = hann_window(config.n_fft)
        self._win_norm = float(np.sqrt(np.sum(win.astype(np.float64) ** 2)))
        f_max = config.f_max if config.f_max is not None else config.sample_rate / 2
        fb = mel_filterbank(config.n_freqs, config.f_min, f_max,
                            config.n_mels, config.sample_rate)
        self.register_buffer("window", torch.from_numpy(win), persistent=False)
        self.register_buffer("fb", torch.from_numpy(fb), persistent=False)

    def power_spectrogram(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, n_frames, n_freqs) power spectrum."""
        cfg = self.config
        spec = torch.stft(
            waveform.float(), n_fft=cfg.n_fft, hop_length=cfg.hop_length,
            window=self.window, center=cfg.center, pad_mode=cfg.pad_mode,
            normalized=False, onesided=True, return_complex=True,
        )                                            # (B, n_freqs, n_frames)
        re, im = spec.real, spec.imag
        if cfg.normalized:
            re = re / self._win_norm
            im = im / self._win_norm
        power = re * re + im * im
        if cfg.power != 2.0:
            power = power ** (cfg.power / 2.0)
        return power.transpose(1, 2)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return self.power_spectrogram(waveform) @ self.fb


def log_mel(mel: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """log(spec + eps) as applied by every reference model."""
    return torch.log(mel + eps)
