"""The DiffRoll denoisers (counterpart of `diffroll_tpu.nn.denoiser`), in
plain PyTorch: the 1-D `DiffRollNet`, the reference forward the kernels are
held against, and the 2-D `DiffRollNet2D`.

  input_projection Conv1x1(88 -> C) + ReLU
  -> N x ResidualBlock(dilation = base^(i % bound))
  -> sum(skips)/sqrt(N) -> skip_projection Conv1x1 + ReLU
  -> zero-init output_projection Conv1x1(C -> 88)

Classifier-free conditioning, driven by an explicit per-sample `uncond_mask`:
  * condition='fixed'         : unconditional rows see the conditioner := -1
  * condition='trainable_spec': they see the learned `trainable_parameters`
                                (n_mels, spec_frames), initialised to -1
  * condition='trainable_z'   : each block swaps its learned `uncon_z` in for
                                the projected conditioner
`cond_projections` precomputes every layer's projected conditioner once per
clip; the per-step forward then takes them through `cond_proj=`.

`DiffRollNet(dtype=torch.bfloat16)` is the counterpart of flax's `dtype=`
(`model.dtype=bfloat16`): the parameters stay f32; `input_projection`,
`skip_projection` and each block's convs and `diffusion_projection` compute
in bf16 by explicit casts (nn/resblock.py), so the residual and skip sums
are bf16; the `DiffusionEmbedding` and the net's `output_projection` stay
f32, and the net returns f32. Plain `torch.autocast` would put the head in
bf16 too, so it is not used. The 2-D net stays f32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.model_axis import full_param
from .embedding import DiffusionEmbedding
from .resblock import ResidualBlock, ResidualBlock2D, conv1d, conv2d, pointwise

CONDITIONS = ("fixed", "trainable_spec", "trainable_z")


class DiffRollNet(nn.Module):
    def __init__(self, residual_channels: int = 512, residual_layers: int = 15,
                 kernel_size: int = 3, dilation_base: int = 1,
                 dilation_bound: int = 4, max_steps: int = 200,
                 out_features: int = 88, unconditional: bool = False,
                 condition: str = "fixed", frames: int = 640,
                 spec_frames: int = 641, n_mels: int = 229,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if condition not in CONDITIONS:
            raise ValueError(f"unrecognized condition {condition!r}")
        c = residual_channels
        self.unconditional = unconditional
        self.condition = condition
        self.dtype = dtype
        self.input_projection = conv1d(out_features, c, 1)
        self.diffusion_embedding = DiffusionEmbedding(max_steps)
        self.residual_layers = nn.ModuleList([
            ResidualBlock(c, dilation_base ** (i % dilation_bound), kernel_size,
                          conditional=not unconditional, n_cond=n_mels,
                          trainable_z=condition == "trainable_z", z_frames=frames,
                          dtype=dtype)
            for i in range(residual_layers)
        ])
        self.skip_projection = conv1d(c, c, 1)
        # zero-init head: the net predicts 0 at init
        self.output_projection = nn.Conv1d(c, out_features, 1)
        nn.init.zeros_(self.output_projection.weight)
        nn.init.zeros_(self.output_projection.bias)
        if condition == "trainable_spec":
            self.trainable_parameters = nn.Parameter(torch.full((n_mels, spec_frames), -1.0))

    def cond_projections(self, cond: torch.Tensor,
                         uncond_mask: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, ...]:
        """(B, T, n_cond) -> per-layer projected conditioners (B, T, 2C),
        with the unconditional substitution of the `condition` mode."""
        if self.unconditional:
            raise ValueError("unconditional net has no conditioner")
        if uncond_mask is not None:
            if self.condition == "fixed":
                cond = torch.where(uncond_mask[:, None, None],
                                   torch.full_like(cond, -1.0), cond)
            elif self.condition == "trainable_spec":
                sub = full_param(self, "trainable_parameters")[:, : cond.shape[1]].t()
                cond = torch.where(uncond_mask[:, None, None], sub[None], cond)
        z_mask = uncond_mask if self.condition == "trainable_z" else None
        return tuple(block.cond_proj(cond, z_mask) for block in self.residual_layers)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                uncond_mask: Optional[torch.Tensor] = None,
                cond_proj: Optional[Sequence[torch.Tensor]] = None,
                layer: Optional[Callable] = None,
                ) -> torch.Tensor:
        """x_t (B, T, 88), t (B,), cond (B, T, n_cond) or None -> (B, T, 88).
        `layer(block, x, t_emb, cond_proj)`, where given, runs each block in
        its stead (sequence parallelism runs it over a halo)."""
        conditional = not self.unconditional and (
            cond is not None or cond_proj is not None)
        if conditional and cond_proj is None:
            cond_proj = self.cond_projections(cond, uncond_mask)

        x = torch.relu(pointwise(x_t, self.input_projection, self.dtype))
        t_emb = self.diffusion_embedding(t)
        skip_sum = None
        for i, block in enumerate(self.residual_layers):
            args = (x, t_emb, cond_proj[i] if conditional else None)
            x, skip = block(*args) if layer is None else layer(block, *args)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = torch.relu(pointwise(x, self.skip_projection, self.dtype))
        # the head stays f32 whatever the compute dtype
        return pointwise(x.float(), self.output_projection)


class DiffRollNet2D(nn.Module):
    """The 2-D denoiser (reference DiffRollv2 / DiffRollv2Debug): the roll is a
    one-channel (88, T) image and the conditioner another, aligned with it.
    With `project_cond` the log-mel is first projected n_mels -> 88
    (`spec_projection`); the debug variant takes the roll as it is. Its
    unconditional rows see the projected conditioner := -1."""

    def __init__(self, residual_channels: int = 16, residual_layers: int = 30,
                 kernel_size: int = 3, dilation_base: int = 1,
                 dilation_bound: int = 10, max_steps: int = 200,
                 out_features: int = 88, unconditional: bool = False,
                 project_cond: bool = True, n_mels: int = 229):
        super().__init__()
        c = residual_channels
        self.unconditional = unconditional
        self.project_cond = project_cond and not unconditional
        self.input_projection = conv2d(1, c, 1)
        self.diffusion_embedding = DiffusionEmbedding(max_steps)
        if self.project_cond:
            self.spec_projection = conv1d(n_mels, out_features, 1)
        self.residual_layers = nn.ModuleList([
            ResidualBlock2D(c, dilation_base ** (i % dilation_bound), kernel_size,
                            conditional=not unconditional)
            for i in range(residual_layers)
        ])
        self.skip_projection = conv2d(c, c, 1)
        self.output_projection = nn.Conv2d(c, 1, 1)
        nn.init.zeros_(self.output_projection.weight)
        nn.init.zeros_(self.output_projection.bias)

    def cond_projections(self, cond: torch.Tensor,
                         uncond_mask: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, ...]:
        """(B, T, n_cond) -> per-layer (B, 2C, 88, T) projections."""
        if self.unconditional:
            raise ValueError("unconditional net has no conditioner")
        if self.project_cond:
            cond = pointwise(cond, self.spec_projection)
        if uncond_mask is not None:
            cond = torch.where(uncond_mask[:, None, None], torch.full_like(cond, -1.0), cond)
        cond = cond.transpose(1, 2)[:, None]  # (B, 1, 88, T)
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

        x = torch.relu(self.input_projection(x_t.transpose(1, 2)[:, None]))
        t_emb = self.diffusion_embedding(t)
        skip_sum = None
        for i, block in enumerate(self.residual_layers):
            x, skip = block(x, t_emb, cond_proj[i] if conditional else None)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = torch.relu(self.skip_projection(x))
        return self.output_projection(x)[:, 0].transpose(1, 2)
