"""Model config and wrapper (counterpart of `diffroll_tpu/models/base.py`,
1-d variant): the denoiser net plus its log-mel front-end.

`DiffRollModel` is an `nn.Module` that owns the weights (`.net`, with the
reference's parameter names) and the mel buffers (`.mel`); `.to(device)`
moves both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..dsp.mel import MelConfig, MelSpectrogram
from ..dsp.normalize import min_max_normalize
from ..nn.denoiser import DiffRollNet
from . import conditioning

NOT_PORTED = {
    "2d": "ROADMAP.md Queue 1 item 20 (2-D variant)",
    "unet": "ROADMAP.md Queue 1 item 21 (U-Nets)",
    "spec_unet": "ROADMAP.md Queue 1 item 21 (U-Nets)",
}


@dataclasses.dataclass(frozen=True)
class DiffRollConfig:
    """Same fields and defaults as `diffroll_tpu.models.base.DiffRollConfig`;
    `dtype` is the dtype's name instead of a jnp dtype."""

    name: str = "ClassifierFreeDiffRoll"
    variant: str = "1d"
    cond_source: str = "spec"
    residual_channels: int = 512
    residual_layers: int = 15
    kernel_size: int = 3
    dilation_base: int = 2
    dilation_bound: int = 4
    condition: str = "fixed"
    unconditional: bool = False
    spec_dropout: float = 0.1
    norm_args: Tuple[float, float, str] = (0.0, 1.0, "imagewise")
    spec_norm: str = "unit"
    n_mels: int = 229
    dim_mults: Tuple[int, ...] = (1, 2, 4)
    use_convnext: bool = True
    convnext_mult: int = 2
    resnet_block_groups: int = 8
    timesteps: int = 200
    frames: int = 640
    pitches: int = 88
    mel: MelConfig = MelConfig()
    dtype: str = "float32"

    def replace(self, **kw) -> "DiffRollConfig":
        return dataclasses.replace(self, **kw)

    def dilations(self) -> Tuple[int, ...]:
        """Per-layer dilation schedule base^(i % bound)."""
        return tuple(self.dilation_base ** (i % self.dilation_bound)
                     for i in range(self.residual_layers))


class DiffRollModel(nn.Module):
    def __init__(self, config: DiffRollConfig):
        super().__init__()
        c = config
        if c.variant in NOT_PORTED:
            raise NotImplementedError(
                f"variant {c.variant!r} is not ported yet: {NOT_PORTED[c.variant]}")
        if c.variant != "1d":
            raise ValueError(f"unknown variant {c.variant!r}")
        self.config = config
        self.net = DiffRollNet(
            residual_channels=c.residual_channels,
            residual_layers=c.residual_layers,
            kernel_size=c.kernel_size,
            dilation_base=c.dilation_base,
            dilation_bound=c.dilation_bound,
            max_steps=c.timesteps,
            out_features=c.pitches,
            unconditional=c.unconditional,
            condition=c.condition,
            n_mels=c.n_mels,
        )
        self.mel = MelSpectrogram(c.mel) if c.cond_source == "spec" else None

    @property
    def device(self) -> torch.device:
        return self.net.input_projection.weight.device

    def normalize_roll(self, roll: torch.Tensor) -> torch.Tensor:
        """Min-max the (B, T, 88) roll to the `norm_args` range; mode 'none'
        passes rolls through raw."""
        lo, hi, mode = self.config.norm_args
        if mode == "none":
            return roll
        return min_max_normalize(roll, lo, hi, mode)

    def conditioner(
        self,
        waveform: Optional[torch.Tensor] = None,
        roll: Optional[torch.Tensor] = None,
        inpainting_t: Optional[Sequence[int]] = None,
        inpainting_f: Optional[Sequence[int]] = None,
    ) -> Optional[torch.Tensor]:
        """The (B, T, n_cond) conditioner, computed once per clip."""
        c = self.config
        if c.cond_source == "none" or c.unconditional:
            return None
        if c.cond_source == "roll":
            cond = roll
        else:
            if c.spec_norm == "unit":
                rng: Optional[Tuple[float, float]] = (0.0, 1.0)
                mode = c.norm_args[2]
            elif c.spec_norm == "norm_args":
                rng = (c.norm_args[0], c.norm_args[1])
                mode = c.norm_args[2]
            elif c.spec_norm == "none":
                rng, mode = None, "imagewise"
            else:
                raise ValueError(f"unknown spec_norm {c.spec_norm!r}")
            cond = conditioning.compute_spec(self.mel, waveform, rng, mode)
            cond = conditioning.trim_to(c.frames, cond)
        return conditioning.apply_inpainting_mask(cond, inpainting_t, inpainting_f)

    def apply(self, x_t, t, cond, uncond_mask=None, cond_proj=None):
        """Denoiser forward: (B, T, 88) x (B,) x (B, T, n_cond) -> (B, T, 88)."""
        return self.net(x_t, t, cond, uncond_mask, cond_proj=cond_proj)

    def cond_projections(self, cond, uncond_mask=None):
        return self.net.cond_projections(cond, uncond_mask)

    def apply_cfg(self, x_t, t, cond=None, cond_proj=None):
        """Both classifier-free-guidance branches in one forward of 2B:
        rows [0, B) conditional, rows [B, 2B) unconditional."""
        b = x_t.shape[0]
        x2 = torch.cat([x_t, x_t])
        t2 = torch.cat([t, t]) if t.ndim else t.expand(2 * b)
        if cond_proj is None:
            mask2 = torch.arange(2 * b, device=x_t.device) >= b
            out = self.net(x2, t2, torch.cat([cond, cond]), mask2)
        else:
            out = self.net(x2, t2, None, None, cond_proj=cond_proj)
        return out[:b], out[b:]

    def cfg_cond_projections(self, cond):
        b = cond.shape[0]
        mask2 = torch.arange(2 * b, device=cond.device) >= b
        return self.cond_projections(torch.cat([cond, cond]), mask2)
