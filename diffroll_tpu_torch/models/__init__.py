"""Model registry (counterpart of `diffroll_tpu/models/__init__.py`): the
same presets as data, every one of which builds: the 1-D stacks, the 2-D
DiffRollv2 family and the U-Nets."""

from __future__ import annotations

from .base import DiffRollConfig, DiffRollModel
from .conditioning import apply_inpainting_mask, compute_spec, spec_dropout_mask, trim_to

PRESETS = {
    "ClassifierFreeDiffRoll": DiffRollConfig(
        name="ClassifierFreeDiffRoll",
        residual_channels=512, residual_layers=15, kernel_size=3,
        dilation_base=2, dilation_bound=4, condition="fixed",
        spec_dropout=0.1, norm_args=(0.0, 1.0, "imagewise"), spec_norm="unit",
    ),
    "DiffRoll": DiffRollConfig(
        name="DiffRoll",
        residual_channels=512, residual_layers=15, kernel_size=3,
        dilation_base=1, dilation_bound=4, condition="fixed",
        spec_dropout=0.0, norm_args=(0.0, 1.0, "imagewise"),
        spec_norm="norm_args", timesteps=500,
    ),
    "DiffRollBaseline": DiffRollConfig(
        name="DiffRollBaseline",
        residual_channels=512, residual_layers=15, kernel_size=7,
        dilation_base=1, dilation_bound=1, condition="fixed",
        spec_dropout=0.0, norm_args=(-1.0, 1.0, "imagewise"),
        spec_norm="norm_args",
    ),
    "DiffRollDebug": DiffRollConfig(
        name="DiffRollDebug", cond_source="roll",
        residual_channels=256, residual_layers=30, kernel_size=3,
        dilation_base=1, dilation_bound=4, n_mels=88,
        spec_dropout=0.0, norm_args=(0.0, 1.0, "imagewise"), timesteps=500,
    ),
    "DiffRollv2": DiffRollConfig(
        name="DiffRollv2", variant="2d",
        residual_channels=16, residual_layers=30, kernel_size=3,
        dilation_base=1, dilation_bound=10,
        spec_dropout=0.0, norm_args=(0.0, 1.0, "imagewise"),
        spec_norm="none", timesteps=500,
    ),
    "DiffRollv2Debug": DiffRollConfig(
        name="DiffRollv2Debug", variant="2d", cond_source="roll",
        residual_channels=32, residual_layers=30, kernel_size=3,
        dilation_base=1, dilation_bound=10,
        spec_dropout=0.0, norm_args=(0.0, 1.0, "imagewise"), timesteps=500,
    ),
    "Unet": DiffRollConfig(
        name="Unet", variant="unet", cond_source="none", unconditional=True,
        residual_channels=28, dim_mults=(1, 2, 4),
        spec_dropout=0.0, norm_args=(0.0, 1.0, "none"), timesteps=200,
    ),
    "SpecUnet": DiffRollConfig(
        name="SpecUnet", variant="spec_unet", cond_source="spec",
        residual_channels=28, dim_mults=(1, 2, 4),
        spec_dropout=0.0, norm_args=(0.0, 1.0, "none"), spec_norm="none",
        timesteps=200,
    ),
}


def build(name: str, **overrides) -> DiffRollModel:
    """Instantiate a registered model with config overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown model {name!r}; choices: {sorted(PRESETS)}")
    return DiffRollModel(PRESETS[name].replace(**overrides))


__all__ = [
    "DiffRollConfig",
    "DiffRollModel",
    "PRESETS",
    "build",
    "apply_inpainting_mask",
    "compute_spec",
    "spec_dropout_mask",
    "trim_to",
]
