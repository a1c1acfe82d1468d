from .experiment import DataloaderConfig, DatasetConfig, ExperimentConfig, TrainerConfig
from .overrides import apply_overrides, coerce, parse_argv

__all__ = [
    "DataloaderConfig",
    "DatasetConfig",
    "ExperimentConfig",
    "TrainerConfig",
    "apply_overrides",
    "coerce",
    "parse_argv",
]
