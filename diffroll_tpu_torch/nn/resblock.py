"""Gated dilated-convolution residual block (counterpart of the 1-D
`diffroll_tpu.nn.resblock.ResidualBlock`, condition='fixed' only).

Parameters keep the reference's names and layouts (Conv1d (O, I, K),
Linear (O, I)); the forward takes and returns channels-last tensors:
    y = dilated_conv(x + t_proj) + cond_proj
    g = sigmoid(y[..., :C]) * tanh(y[..., C:])
    residual, skip = split(output_projection(g))
    return (x + residual) / sqrt(2), skip
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

SQRT_HALF = 0.7071067811865476


def conv1d(in_ch: int, out_ch: int, kernel_size: int, **kw) -> nn.Conv1d:
    """Conv1d with the reference's kaiming-normal weight init."""
    conv = nn.Conv1d(in_ch, out_ch, kernel_size, **kw)
    nn.init.kaiming_normal_(conv.weight)
    return conv


def pointwise(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """A 1x1 Conv1d applied to a channels-last (B, T, I) tensor."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class ResidualBlock(nn.Module):
    def __init__(self, residual_channels: int, dilation: int = 1,
                 kernel_size: int = 3, conditional: bool = True,
                 n_cond: int = 229, emb_dim: int = 512):
        super().__init__()
        c = residual_channels
        self.dilation = dilation
        pad = ((kernel_size - 1) * (dilation - 1) + kernel_size - 1) // 2
        self.dilated_conv = conv1d(c, 2 * c, kernel_size, padding=pad,
                                   dilation=dilation)
        self.diffusion_projection = nn.Linear(emb_dim, c)
        if conditional:
            self.conditioner_projection = conv1d(n_cond, 2 * c, 1)
        self.output_projection = conv1d(c, 2 * c, 1)

    def cond_proj(self, cond: torch.Tensor) -> torch.Tensor:
        """(B, T, n_cond) -> (B, T, 2C)."""
        return pointwise(cond, self.conditioner_projection)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                cond_proj: Optional[torch.Tensor] = None):
        step = self.diffusion_projection(t_emb)
        y = x + step[:, None, :]
        y = self.dilated_conv(y.transpose(1, 2)).transpose(1, 2)
        if cond_proj is not None:
            y = y + cond_proj
        gate, filt = y.chunk(2, dim=-1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        residual, skip = pointwise(y, self.output_projection).chunk(2, dim=-1)
        return (x + residual) * SQRT_HALF, skip
