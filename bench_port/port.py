"""The program under test, `diffroll_tpu_torch`, built from a configuration
file: the one place where the benchmark constructs its model and task."""

from __future__ import annotations

from typing import Dict

import torch

MODEL_KEYS = ("residual_channels", "residual_layers", "kernel_size", "dilation_base",
              "dilation_bound", "condition", "spec_dropout", "spec_norm", "n_mels",
              "timesteps", "frames", "pitches")
TASK_KEYS = ("timesteps", "beta_start", "beta_end", "loss_type", "training_mode",
             "sampling_type", "w", "frame_threshold", "lr")


def build_model(cfg: dict, device, params: Dict[str, torch.Tensor]):
    """The port's preset with every size the file states, on `device`, holding
    `params` (`weights.make(model_shapes(cfg), ...)`)."""
    from diffroll_tpu_torch.models import build

    with torch.device(device):  # the module's own initial draws, made on the card
        model = build(cfg["preset"], **_overrides(cfg))
    model = model.to(device)
    model.load_state_dict(params)
    return model


def model_shapes(cfg: dict) -> Dict[str, tuple]:
    """The model's parameter names and shapes, from a build that allocates
    nothing."""
    from diffroll_tpu_torch.models import build

    with torch.device("meta"):
        return {k: tuple(v.shape)
                for k, v in build(cfg["preset"], **_overrides(cfg)).state_dict().items()}


def _overrides(cfg: dict) -> dict:
    from diffroll_tpu_torch.dsp.mel import MelConfig

    over = {k: cfg[k] for k in MODEL_KEYS}
    over["norm_args"] = tuple(cfg["norm_args"])
    over["mel"] = MelConfig(n_mels=cfg["n_mels"], **cfg["mel"])
    return over


def build_task(cfg: dict, model, **extra):
    from diffroll_tpu_torch.tasks.diffusion import DiffusionTask, TaskConfig

    return DiffusionTask(model, TaskConfig(**{k: cfg[k] for k in TASK_KEYS}, **extra))
