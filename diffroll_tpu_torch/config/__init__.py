from .experiment import (
    DataloaderConfig, DatasetConfig, DistillConfig, ExperimentConfig, ServeConfig, TrainerConfig,
    asdict_flat)
from .overrides import apply_overrides, coerce, parse_argv
from .presets import PRESETS, compose, from_argv

__all__ = [
    "DataloaderConfig",
    "DatasetConfig",
    "DistillConfig",
    "ExperimentConfig",
    "PRESETS",
    "ServeConfig",
    "TrainerConfig",
    "apply_overrides",
    "asdict_flat",
    "coerce",
    "compose",
    "from_argv",
    "parse_argv",
]
