"""The 1-D DiffRoll denoiser (counterpart of `diffroll_tpu.nn.denoiser.DiffRollNet`),
in plain PyTorch: the reference forward the kernels are held against.

  input_projection Conv1x1(88 -> C) + ReLU
  -> N x ResidualBlock(dilation = base^(i % bound))
  -> sum(skips)/sqrt(N) -> skip_projection Conv1x1 + ReLU
  -> zero-init output_projection Conv1x1(C -> 88)

Unconditional rows (classifier-free guidance, condition='fixed') see the
conditioner replaced by -1, driven by an explicit per-sample `uncond_mask`.
`cond_projections` precomputes every layer's projected conditioner once per
clip; the per-step forward then takes them through `cond_proj=`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .embedding import DiffusionEmbedding
from .resblock import ResidualBlock, conv1d, pointwise

NOT_PORTED = {
    "trainable_spec": "ROADMAP.md Queue 1 item 19 (trainable conditioning)",
    "trainable_z": "ROADMAP.md Queue 1 item 19 (trainable conditioning)",
}


class DiffRollNet(nn.Module):
    def __init__(self, residual_channels: int = 512, residual_layers: int = 15,
                 kernel_size: int = 3, dilation_base: int = 1,
                 dilation_bound: int = 4, max_steps: int = 200,
                 out_features: int = 88, unconditional: bool = False,
                 condition: str = "fixed", n_mels: int = 229):
        super().__init__()
        if condition in NOT_PORTED:
            raise NotImplementedError(
                f"condition={condition!r} is not ported yet: {NOT_PORTED[condition]}")
        if condition != "fixed":
            raise ValueError(f"unrecognized condition {condition!r}")
        c = residual_channels
        self.unconditional = unconditional
        self.input_projection = conv1d(out_features, c, 1)
        self.diffusion_embedding = DiffusionEmbedding(max_steps)
        self.residual_layers = nn.ModuleList([
            ResidualBlock(c, dilation_base ** (i % dilation_bound), kernel_size,
                          conditional=not unconditional, n_cond=n_mels)
            for i in range(residual_layers)
        ])
        self.skip_projection = conv1d(c, c, 1)
        # zero-init head: the net predicts 0 at init
        self.output_projection = nn.Conv1d(c, out_features, 1)
        nn.init.zeros_(self.output_projection.weight)
        nn.init.zeros_(self.output_projection.bias)

    def cond_projections(self, cond: torch.Tensor,
                         uncond_mask: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, ...]:
        """(B, T, n_cond) -> per-layer projected conditioners (B, T, 2C)."""
        if self.unconditional:
            raise ValueError("unconditional net has no conditioner")
        if uncond_mask is not None:
            cond = torch.where(uncond_mask[:, None, None],
                               torch.full_like(cond, -1.0), cond)
        return tuple(block.cond_proj(cond) for block in self.residual_layers)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                uncond_mask: Optional[torch.Tensor] = None,
                cond_proj: Optional[Sequence[torch.Tensor]] = None,
                ) -> torch.Tensor:
        """x_t (B, T, 88), t (B,), cond (B, T, n_cond) or None -> (B, T, 88)."""
        conditional = not self.unconditional and (
            cond is not None or cond_proj is not None)
        if conditional and cond_proj is None:
            cond_proj = self.cond_projections(cond, uncond_mask)

        x = torch.relu(pointwise(x_t, self.input_projection))
        t_emb = self.diffusion_embedding(t)
        skip_sum = None
        for i, block in enumerate(self.residual_layers):
            x, skip = block(x, t_emb, cond_proj[i] if conditional else None)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = torch.relu(pointwise(x, self.skip_projection))
        return pointwise(x, self.output_projection)
