"""Model config and wrapper (counterpart of `diffroll_tpu/models/base.py`):
the denoiser net of the config's variant plus its log-mel front-end.

`DiffRollModel` is an `nn.Module` that owns the weights (`.net`, with the
reference's parameter names where the reference has them) and the mel
buffers (`.mel`); `.to(device)` moves both. Variants: '1d' (`DiffRollNet`),
'2d' (`DiffRollNet2D`), 'unet' (`UnetNet`), 'spec_unet' (`SpecUnetNet`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..dsp.mel import MelConfig, MelSpectrogram
from ..dsp.normalize import min_max_normalize
from ..nn.denoiser import DiffRollNet, DiffRollNet2D
from ..nn.unet import SpecUnetNet, UnetNet
from ..utils.profiling import span
from . import conditioning


@dataclasses.dataclass(frozen=True)
class DiffRollConfig:
    """Same fields and defaults as `diffroll_tpu.models.base.DiffRollConfig`;
    `dtype` is the dtype's name instead of a jnp dtype. It is the 1-D net's
    compute dtype (`compute_dtype`); the parameters stay f32. As in the JAX
    package, the 2-D net and the U-Nets are built without it and run f32,
    and the fused routes (the kernels) are bf16 whatever it says."""

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

    def compute_dtype(self) -> Optional[torch.dtype]:
        """`dtype` as a torch dtype; None for float32 (no casts at all)."""
        if self.dtype == "float32":
            return None
        dt = getattr(torch, str(self.dtype), None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"model.dtype={self.dtype!r} is not a floating dtype's name")
        return dt

    def dilations(self) -> Tuple[int, ...]:
        """Per-layer dilation schedule base^(i % bound)."""
        return tuple(self.dilation_base ** (i % self.dilation_bound)
                     for i in range(self.residual_layers))


class DiffRollModel(nn.Module):
    def __init__(self, config: DiffRollConfig):
        super().__init__()
        c = config
        self.config = config
        if c.variant == "1d":
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
                frames=c.frames,
                spec_frames=c.mel.num_frames(c.frames * c.mel.hop_length),
                n_mels=c.n_mels,
                dtype=c.compute_dtype(),
            )
        elif c.variant == "2d":
            self.net = DiffRollNet2D(
                residual_channels=c.residual_channels,
                residual_layers=c.residual_layers,
                kernel_size=c.kernel_size,
                dilation_base=c.dilation_base,
                dilation_bound=c.dilation_bound,
                max_steps=c.timesteps,
                out_features=c.pitches,
                unconditional=c.unconditional,
                project_cond=c.cond_source == "spec",
                n_mels=c.n_mels,
            )
        elif c.variant == "unet":
            self.net = UnetNet(dim=c.residual_channels, dim_mults=c.dim_mults,
                               use_convnext=c.use_convnext, convnext_mult=c.convnext_mult,
                               resnet_block_groups=c.resnet_block_groups)
        elif c.variant == "spec_unet":
            self.net = SpecUnetNet(dim=c.residual_channels, dim_mults=c.dim_mults,
                                   convnext_mult=c.convnext_mult, n_mels=c.n_mels,
                                   pitches=c.pitches)
        else:
            raise ValueError(f"unknown variant {c.variant!r}")
        self.mel = MelSpectrogram(c.mel) if c.cond_source == "spec" else None

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

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
        with span("conditioner"):
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
        """Denoiser forward: (B, T, 88) x (B,) x (B, T, n_cond) -> (B, T, 88).
        The U-Nets take no `cond_proj`."""
        if cond_proj is None:
            return self.net(x_t, t, cond, uncond_mask)
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
