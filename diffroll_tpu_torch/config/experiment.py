"""The part of the experiment config tree that transcription reads (the
port's counterpart of `diffroll_tpu/config/experiment.py`), with the
defaults of the JAX package's `sampling` preset."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models import PRESETS
from ..models.base import DiffRollConfig
from ..tasks.diffusion import TaskConfig


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    hop_length: int = 512
    sampling_rate: int = 16000
    audio_path: str = "my_audio"
    audio_ext: str = "mp3"


@dataclasses.dataclass(frozen=True)
class DataloaderConfig:
    test_batch_size: int = 8


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    output_dir: str = "outputs"
    run_name: Optional[str] = None
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model_name: str = "ClassifierFreeDiffRoll"
    model: DiffRollConfig = PRESETS["ClassifierFreeDiffRoll"]
    task: TaskConfig = TaskConfig(sampling_type="cfdg_ddpm_x0", w=0.5,
                                  generation_filter=0.1)
    dataset: DatasetConfig = DatasetConfig()
    dataloader: DataloaderConfig = DataloaderConfig()
    trainer: TrainerConfig = TrainerConfig()
    pretrained_path: Optional[str] = None
    device: str = "cuda"

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        m, t = self.model, self.task
        return (f"{self.model_name}-L{m.residual_layers}-C{m.residual_channels}"
                f"-k{m.kernel_size}-{t.sampling_type}-w{t.w}")
