"""Gated dilated-convolution residual blocks (counterpart of
`diffroll_tpu.nn.resblock`): the 1-D `ResidualBlock` and the 2-D
`ResidualBlock2D`.

Parameters keep the reference's names and layouts (Conv1d (O, I, K),
Conv2d (O, I, k_88, k_T), Linear (O, I), `uncon_z` (2C, frames)). The 1-D
block takes and returns channels-last (B, T, C) tensors; the 2-D block
works on the reference's (B, C, 88, T). Both compute
    y = dilated_conv(x + t_proj) + cond_proj
    g = sigmoid(y[:C]) * tanh(y[C:])          (split over channels)
    residual, skip = split(output_projection(g))
    return (x + residual) / sqrt(2), skip

The 1-D block's `dtype` follows flax's `dtype=`: with torch.bfloat16, each of
its convs and its Linear casts input, weight and bias to bf16 by hand and
returns bf16, while the parameters stay f32 (no autocast: the net's head
must stay f32, see nn/denoiser.py). Ops between them promote as jnp does: a
bf16 sum stays bf16, a bf16 + f32 one is f32.

Under a model axis (parallel/model_axis.py) the products the 1-D block
computes functionally go through `column` and `uncon_z` through
`full_param`; on a whole net both are the plain reads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.model_axis import column, full_param
from .init import dense, he_normal

SQRT_HALF = 0.7071067811865476


def _same_padding(kernel_size: int, dilation: int) -> int:
    """The reference's padding, 'SAME' for the odd kernels every config uses."""
    return ((kernel_size - 1) * (dilation - 1) + kernel_size - 1) // 2


def conv1d(in_ch: int, out_ch: int, kernel_size: int, **kw) -> nn.Conv1d:
    """Conv1d drawn as the JAX package's `_conv_init` draws it (nn/init.py)."""
    return he_normal(nn.Conv1d(in_ch, out_ch, kernel_size, **kw))


def conv2d(in_ch: int, out_ch: int, kernel_size: int, **kw) -> nn.Conv2d:
    """Conv2d drawn as the JAX package's `_conv_init` draws it (nn/init.py)."""
    return he_normal(nn.Conv2d(in_ch, out_ch, kernel_size, **kw))


def _cast(dtype: Optional[torch.dtype], *tensors: torch.Tensor):
    """The tensors in the compute dtype (as they are where it is None)."""
    return tensors if dtype is None else tuple(t.to(dtype) for t in tensors)


def pointwise(x: torch.Tensor, conv: nn.Conv1d,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A 1x1 Conv1d applied to a channels-last (B, T, I) tensor, computed in
    `dtype` where given."""
    return column(conv, x, lambda v, w, b: F.linear(*_cast(dtype, v, w[:, :, 0], b)), -1)


class ResidualBlock(nn.Module):
    """1-D block over (B, T, C). With `trainable_z` the block learns its own
    unconditional embedding `uncon_z` (2C, z_frames), which replaces the
    projected conditioner on unconditional rows (reference ResidualBlockz)."""

    def __init__(self, residual_channels: int, dilation: int = 1,
                 kernel_size: int = 3, conditional: bool = True,
                 n_cond: int = 229, emb_dim: int = 512,
                 trainable_z: bool = False, z_frames: int = 640,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = residual_channels
        self.dtype = dtype
        self.dilated_conv = conv1d(c, 2 * c, kernel_size,
                                   padding=_same_padding(kernel_size, dilation),
                                   dilation=dilation)
        self.diffusion_projection = dense(emb_dim, c)
        self.trainable_z = conditional and trainable_z
        if conditional:
            self.conditioner_projection = conv1d(n_cond, 2 * c, 1)
            if self.trainable_z:
                # the reference leaves it uninitialised (torch.empty); the JAX
                # package draws N(0, 0.02^2), and so does the port
                self.uncon_z = nn.Parameter(0.02 * torch.randn(2 * c, z_frames))
        self.output_projection = conv1d(c, 2 * c, 1)

    def cond_proj(self, cond: torch.Tensor,
                  uncond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, n_cond) -> (B, T, 2C); with `trainable_z`, rows where
        `uncond_mask` is set take `uncon_z` (its first T frames) instead."""
        proj = pointwise(cond, self.conditioner_projection, self.dtype)
        if self.trainable_z and uncond_mask is not None:
            z = full_param(self, "uncon_z")[:, : cond.shape[1]].t()
            proj = torch.where(uncond_mask[:, None, None], z[None], proj)
        return proj

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                cond_proj: Optional[torch.Tensor] = None):
        dt = self.dtype
        lin, conv = self.diffusion_projection, self.dilated_conv
        step = column(lin, t_emb, lambda v, w, b: F.linear(*_cast(dt, v, w, b)), -1)
        y = column(conv, (x + step[:, None, :]).transpose(1, 2),
                   lambda v, w, b: F.conv1d(*_cast(dt, v, w, b), padding=conv.padding,
                                            dilation=conv.dilation), 1).transpose(1, 2)
        # the elementwise chains run in f32 and round once, at the next conv
        # or the block's outputs, as XLA keeps excess precision inside a
        # fusion (every `.float()` / `.to` is a no-op on the f32 path)
        if cond_proj is not None:
            y = y.float() + cond_proj.float()
        gate, filt = y.float().chunk(2, dim=-1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        residual, skip = pointwise(y, self.output_projection, dt).chunk(2, dim=-1)
        return ((x.float() + residual.float()) * SQRT_HALF).to(residual.dtype), skip


class ResidualBlock2D(nn.Module):
    """2-D block over (B, C, 88, T) with a (B, 1, 88, T) conditioner
    (reference ResidualBlockv2). The JAX package runs it on (B, T, 88, C)."""

    def __init__(self, residual_channels: int, dilation: int = 1,
                 kernel_size: int = 3, conditional: bool = True, emb_dim: int = 512):
        super().__init__()
        c = residual_channels
        self.dilated_conv = conv2d(c, 2 * c, kernel_size,
                                   padding=_same_padding(kernel_size, dilation),
                                   dilation=dilation)
        self.diffusion_projection = dense(emb_dim, c)
        if conditional:
            self.conditioner_projection = conv2d(1, 2 * c, 1)
        self.output_projection = conv2d(c, 2 * c, 1)

    def cond_proj(self, cond: torch.Tensor) -> torch.Tensor:
        """(B, 1, 88, T) -> (B, 2C, 88, T)."""
        return self.conditioner_projection(cond)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                cond_proj: Optional[torch.Tensor] = None):
        step = self.diffusion_projection(t_emb)
        y = self.dilated_conv(x + step[:, :, None, None])
        if cond_proj is not None:
            y = y + cond_proj
        gate, filt = y.chunk(2, dim=1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        residual, skip = self.output_projection(y).chunk(2, dim=1)
        return (x + residual) * SQRT_HALF, skip
