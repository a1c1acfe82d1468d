"""Conditioning pipeline: waveform -> conditioner tensor (counterpart of
`diffroll_tpu/models/conditioning.py`), computed once per clip."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..dsp.mel import MelSpectrogram, log_mel
from ..dsp.normalize import min_max_normalize


def compute_spec(
    mel: MelSpectrogram,
    waveform: torch.Tensor,
    norm_range: Optional[Tuple[float, float]] = (0.0, 1.0),
    norm_mode: str = "imagewise",
) -> torch.Tensor:
    """waveform (B, L) -> normalized log-mel (B, n_frames, n_mels);
    norm_range=None skips the min-max step."""
    spec = log_mel(mel(waveform))
    if norm_range is not None:
        spec = min_max_normalize(spec, norm_range[0], norm_range[1], norm_mode)
    return spec


def spec_dropout_mask(batch_size: int, p: float,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Per-sample Bernoulli(p) unconditional mask (True => drop the
    conditioner): the classifier-free training dropout. Drawn from
    `generator` on its device; a caller that needs given draws hands the
    mask itself to `DiffusionTask.loss_fn`."""
    if generator is not None:
        device = generator.device
    return torch.rand(batch_size, generator=generator, device=device) < p


def apply_inpainting_mask(
    spec: torch.Tensor,
    inpainting_t: Optional[Sequence[int]] = None,
    inpainting_f: Optional[Sequence[int]] = None,
    masked_value: float = -1.0,
) -> torch.Tensor:
    """Force a time/frequency region of the (B, T, n_mels) conditioner to
    the unconditional value; returns a new tensor."""
    if inpainting_t is None and inpainting_f is None:
        return spec
    t0, t1 = (0, spec.shape[1]) if inpainting_t is None else map(int, inpainting_t)
    f0, f1 = (0, spec.shape[2]) if inpainting_f is None else map(int, inpainting_f)
    out = spec.clone()
    out[:, t0:t1, f0:f1] = masked_value
    return out


def trim_to(roll_len: int, spec: torch.Tensor) -> torch.Tensor:
    """Trim the (641-frame) centered STFT output to the roll grid."""
    return spec[:, :roll_len]
