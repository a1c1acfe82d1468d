"""Root experiment presets + composition (counterpart of
`diffroll_tpu/config/presets.py`): one preset per reference root yaml, as
far as it names a ported model and task. `compose(name, overrides)` resolves
a preset and applies dotted overrides; `from_argv` wires it to a CLI.

Not ported: the `baseline` preset (the baseline task) and `config=<file>.yaml`
layering. The `pianoroll` / `infer` presets compose as data; building their
U-Net raises NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..models import PRESETS as MODEL_PRESETS
from ..tasks.diffusion import TaskConfig
from .experiment import DatasetConfig, ExperimentConfig, TrainerConfig
from .overrides import apply_overrides, parse_argv


def _base(model_name: str, **model_kw) -> ExperimentConfig:
    model = MODEL_PRESETS[model_name].replace(**model_kw)
    return ExperimentConfig(model_name=model_name, model=model,
                            task=TaskConfig(timesteps=model.timesteps))


# supervised training on MAPS, ClassifierFreeDiffRoll, x_0 objective
_SPEC_ROLL = _base("ClassifierFreeDiffRoll").replace(
    task=TaskConfig(timesteps=200, training_mode="x_0", loss_type="l2", lr=5e-5,
                    sampling_type="cfdg_ddpm_x0", w=0.0, frame_threshold=0.5),
    dataset=DatasetConfig(name="MAPS"),
    trainer=TrainerConfig(max_epochs=2500, check_val_every_n_epoch=5,
                          monitor="val/diffusion_loss"),
)

# p = 1 spec dropout pretraining on MAESTRO; monitors the train loss
_UNSUP = _SPEC_ROLL.replace(
    model=_SPEC_ROLL.model.replace(spec_dropout=1.0),
    dataset=DatasetConfig(name="MAESTRO"),
    trainer=_SPEC_ROLL.trainer.replace(monitor="train/diffusion_loss"),
)

# evaluation of a checkpoint with CFG sampling w = 0.5
_TEST = _SPEC_ROLL.replace(
    task=_SPEC_ROLL.task.replace(sampling_type="cfdg_ddpm_x0", w=0.5),
)

# transcription / inpainting / generation over a folder of user audio
_SAMPLING = _SPEC_ROLL.replace(
    task=_SPEC_ROLL.task.replace(sampling_type="cfdg_ddpm_x0", w=0.5,
                                 generation_filter=0.1),
    dataset=DatasetConfig(name="Custom", audio_path="my_audio", audio_ext="mp3"),
)

# unconditional U-Net over raw rolls: epsilon objective, huber loss
_PIANOROLL = _base("Unet").replace(
    task=TaskConfig(timesteps=200, training_mode="epsilon", loss_type="huber",
                    lr=1e-5, sampling_type="ddpm"),
    dataset=DatasetConfig(name="MAESTRO"),
    trainer=TrainerConfig(max_epochs=200, monitor="val/diffusion_loss"),
)

PRESETS: Dict[str, ExperimentConfig] = {
    "spec_roll": _SPEC_ROLL,
    "unsupervised_pretrained": _UNSUP,
    "test": _TEST,
    "sampling": _SAMPLING,
    "pianoroll": _PIANOROLL,
    "infer": _PIANOROLL,
}


def compose(name: str = "spec_roll",
            overrides: Optional[Dict[str, Any]] = None) -> ExperimentConfig:
    """Resolve a preset and apply dotted overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown config {name!r}; choices: {sorted(PRESETS)}")
    cfg = PRESETS[name]
    overrides = dict(overrides or {})

    # a model swap re-composes the model group, preserving later overrides
    model_name = overrides.pop("model_name", None)
    if model_name is not None:
        cfg = cfg.replace(model_name=model_name, model=MODEL_PRESETS[model_name])

    cfg = apply_overrides(cfg, overrides)
    # keep the model's embedding table in step with the task's T
    if cfg.model.timesteps != cfg.task.timesteps:
        cfg = cfg.replace(model=cfg.model.replace(timesteps=cfg.task.timesteps))
    return cfg


def from_argv(argv: List[str], default: str,
              ) -> Tuple[ExperimentConfig, List[str], Dict[str, Any]]:
    """Build a config from CLI argv: positional tokens + key=value overrides.

    The first positional token, if it names a preset, selects it. Returns
    (config, remaining positionals, raw overrides): the raw overrides let
    the checkpoint loaders re-apply the user's explicit keys on top of a
    stored config.
    """
    positional, overrides = parse_argv(argv)
    named = bool(positional) and positional[0] in PRESETS
    cfg = compose(positional[0] if named else default, dict(overrides))
    return cfg, positional[1:] if named else positional, overrides
