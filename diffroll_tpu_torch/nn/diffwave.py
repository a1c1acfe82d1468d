"""The DiffWave audio vocoder net (counterpart of `diffroll_tpu/nn/diffwave.py`).

The reference vendors the original LMNT DiffWave network with its
spectrogram upsampler but never calls it: DiffRoll replaced the waveform
output with piano rolls. The JAX package rebuilds it for inventory parity,
and so does the port: a (B, L) waveform denoiser conditioned on
(B, frames, n_mels) mel spectrograms that two transposed convs upsample
256x in time.

Parameter names follow the flax scopes (`spectrogram_upsampler.
ConvTranspose_0` / `ConvTranspose_1`, `residual_layers.<i>.*`, `input_
projection`, `skip_projection`, `output_projection`, `diffusion_embedding`);
layouts are the reference's: each ConvTranspose2d is (1, 1, 3, 32) over the
(B, 1, n_mels, T) image, and `state_dict_from_jax` flips the flax kernel in
both spatial axes into it (flax's `ConvTranspose(..., 'SAME')` correlates
with its kernel unflipped).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .embedding import DiffusionEmbedding
from .init import lecun_normal
from .resblock import ResidualBlock, conv1d, pointwise


class SpectrogramUpsampler(nn.Module):
    """(B, frames, n_mels) -> (B, frames * 256, n_mels): two leaky-ReLU(0.4)
    transposed convs, 16x in time each, kernel 32 x 3 ('SAME')."""

    def __init__(self):
        super().__init__()
        self.ConvTranspose_0 = lecun_normal(
            nn.ConvTranspose2d(1, 1, (3, 32), stride=(1, 16), padding=(1, 8)))
        self.ConvTranspose_1 = lecun_normal(
            nn.ConvTranspose2d(1, 1, (3, 32), stride=(1, 16), padding=(1, 8)))

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        x = spec.transpose(1, 2)[:, None]          # (B, 1, n_mels, T)
        for conv in (self.ConvTranspose_0, self.ConvTranspose_1):
            x = F.leaky_relu(conv(x), 0.4)
        return x[:, 0].transpose(1, 2)             # (B, T * 256, n_mels)


class DiffWaveNet(nn.Module):
    """Waveform denoiser: (B, L) audio + (B,) t + (B, L / 256, n_mels) mel
    -> (B, L) predicted noise. Its residual blocks are the 1-D DiffRoll
    block conditioned on the upsampled mel (`ResidualBlock`, n_cond=n_mels,
    dilation 2^(i % dilation_cycle_length))."""

    def __init__(self, residual_channels: int = 64, residual_layers: int = 30,
                 dilation_cycle_length: int = 10, n_mels: int = 80, max_steps: int = 50):
        super().__init__()
        c = residual_channels
        self.input_projection = conv1d(1, c, 1)
        self.diffusion_embedding = DiffusionEmbedding(max_steps)
        self.spectrogram_upsampler = SpectrogramUpsampler()
        self.residual_layers = nn.ModuleList([
            ResidualBlock(c, 2 ** (i % dilation_cycle_length), 3, n_cond=n_mels)
            for i in range(residual_layers)])
        self.skip_projection = conv1d(c, c, 1)
        # zero-init head: the net predicts 0 at init
        self.output_projection = nn.Conv1d(c, 1, 1)
        nn.init.zeros_(self.output_projection.weight)
        nn.init.zeros_(self.output_projection.bias)

    def forward(self, audio: torch.Tensor, t: torch.Tensor,
                mel: Optional[torch.Tensor]) -> torch.Tensor:
        x = torch.relu(pointwise(audio[..., None], self.input_projection))   # (B, L, C)
        t_emb = self.diffusion_embedding(t)
        mel_up = self.spectrogram_upsampler(mel)[:, : x.shape[1]]
        skip_sum = None
        for block in self.residual_layers:
            x, skip = block(x, t_emb, block.cond_proj(mel_up))
            skip_sum = skip if skip_sum is None else skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = torch.relu(pointwise(x, self.skip_projection))
        return pointwise(x, self.output_projection)[..., 0]
