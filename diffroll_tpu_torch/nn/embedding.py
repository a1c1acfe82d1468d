"""Diffusion timestep embedding (counterpart of `diffroll_tpu/nn/embedding.py`):
a fixed 128-dim sin/cos table over `max_steps` with frequencies
10^(4 i / 63), then two Linear(512) + SiLU projections. Integer timesteps
index the table; fractional ones interpolate linearly between rows."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .init import dense


def build_table(max_steps: int, dim: int = 128) -> np.ndarray:
    """Sin/cos table, shape (max_steps, dim)."""
    half = dim // 2
    steps = np.arange(max_steps, dtype=np.float64)[:, None]
    freqs = 10.0 ** (np.arange(half, dtype=np.float64)[None, :] * 4.0 / (half - 1))
    angles = steps * freqs
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1).astype(np.float32)


def lookup(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Table rows for integer t; linear interpolation for fractional t."""
    if not t.is_floating_point():
        return table[t.long()]
    low = torch.floor(t).long()
    high = torch.ceil(t).long()
    frac = (t - low.to(t.dtype))[..., None].to(table.dtype)
    return table[low] + (table[high] - table[low]) * frac


class DiffusionEmbedding(nn.Module):
    """t (B,) int or float -> embedding (B, proj_dim). Parameter names
    follow the reference (`projection1`, `projection2`); the table is the
    non-persistent buffer `embedding`."""

    def __init__(self, max_steps: int, dim: int = 128, proj_dim: int = 512):
        super().__init__()
        self.register_buffer("embedding",
                             torch.from_numpy(build_table(max_steps, dim)),
                             persistent=False)
        self.projection1 = dense(dim, proj_dim)
        self.projection2 = dense(proj_dim, proj_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = lookup(self.embedding, t)
        x = F.silu(self.projection1(x))
        return F.silu(self.projection2(x))
