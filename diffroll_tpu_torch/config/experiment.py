"""The experiment config tree (counterpart of
`diffroll_tpu/config/experiment.py`): top-level knobs plus the model / task /
dataset / dataloader / trainer groups, with the JAX package's defaults.

Left out until their slices are ported: `task_type` / `baseline` (the
baseline task), `distill`, and the trainer's `model_axis`, `data_axis`,
`rng_impl`, `adam_moments_dtype`. Left out for good: `dataloader.transfer`
(training batches always cross as float32 through pinned memory with a
non-blocking copy, `data/pipeline.to_device`) and `serve.compile_cache_dir`
(the XLA compilation cache; eager PyTorch compiles nothing per shape).
`device` is the port's own knob.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..models.base import DiffRollConfig
from ..tasks.diffusion import TaskConfig


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """One dataset group entry."""

    name: str = "MAPS"            # MAPS | MAESTRO | Custom
    root: str = "./datasets"
    data_type: str = "MUS"        # MAPS subset folder
    sequence_length: int = 327680
    seed: int = 42
    hop_length: int = 512
    min_midi: int = 21
    max_midi: int = 108
    sampling_rate: int = 16000
    download: bool = False
    preload: bool = False
    # decoded-audio LRU cache bound (bytes); None = unbounded
    max_cache_bytes: Optional[int] = 8 << 30
    # eval segmentation: None = train False, val/test True; with True an eval
    # split enumerates consecutive windows covering every recording
    overlap: Optional[bool] = None
    # frames shared by consecutive eval windows (crossfade-stitched); 0 = butted
    eval_overlap_frames: int = 32
    # Custom-folder knobs
    audio_path: str = "my_audio"
    audio_ext: str = "wav"

    def replace(self, **kw) -> "DatasetConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DataloaderConfig:
    """Per-split loader knobs."""

    train_batch_size: int = 16
    val_batch_size: int = 4
    test_batch_size: int = 8
    num_workers: int = 4
    prefetch: int = 2
    shuffle: bool = True
    drop_last: bool = True

    def replace(self, **kw) -> "DataloaderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Execution-runtime knobs."""

    max_epochs: int = 2500
    check_val_every_n_epoch: int = 5
    monitor: str = "val/diffusion_loss"
    save_top_k: int = 2
    save_last: bool = True
    output_dir: str = "outputs"
    run_name: Optional[str] = None            # default: auto from hparams
    seed: int = 0
    log_every_n_steps: int = 50
    profile: bool = False                     # torch.profiler trace of the first epoch
    # exponential moving average of the weights; None = off
    ema_decay: Optional[float] = None

    def replace(self, **kw) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-entry knobs (`python -m diffroll_tpu_torch serve`)."""

    host: str = "127.0.0.1"
    port: int = 8077
    max_batch: int = 8            # windows per sampler batch (short batches zero-padded)
    max_wait_ms: float = 25.0     # micro-batching window after the first job
    overlap_frames: int = 32      # window overlap for stitching
    max_body_mb: float = 64.0     # request-body cap (HTTP 413 above)
    # the waveform batch's host-to-device format: int16 halves the transfer,
    # is dequantised on the card and is exact for 16-bit PCM sources;
    # float32 for exact f32 inputs
    transfer: str = "int16"
    pipeline_depth: int = 2       # batches in flight (1 = serialised)

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Root config: everything a CLI entry needs."""

    model_name: str = "ClassifierFreeDiffRoll"
    model: DiffRollConfig = DiffRollConfig()
    task: TaskConfig = TaskConfig()
    dataset: DatasetConfig = DatasetConfig()
    # second dataset for the dual-loss recipe
    dataset2: Optional[DatasetConfig] = None
    dataloader: DataloaderConfig = DataloaderConfig()
    trainer: TrainerConfig = TrainerConfig()
    # checkpoint to start from
    pretrained_path: Optional[str] = None
    # dual-dataset fine-tuning recipe
    dual: bool = False
    # clips the sampling entry writes, in every mode
    num_samples: int = 16
    # the test entry's audio artifacts: "mp3" encodes through an ffmpeg /
    # lame binary where one exists and writes 16-bit wav otherwise
    audio_format: str = "mp3"
    serve: ServeConfig = ServeConfig()
    # where the entry point runs: "cuda" unless the caller asks for "cpu"
    device: str = "cuda"

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        """Informative run name encoding key hparams."""
        m, t = self.model, self.task
        return (
            f"{self.model_name}-{self.dataset.name}"
            f"-L{m.residual_layers}-C{m.residual_channels}-k{m.kernel_size}"
            f"-p{m.spec_dropout}-{t.training_mode}-{t.sampling_type}-w{t.w}"
        )


def asdict_flat(cfg: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a (nested-dataclass) config into dotted keys, for logging."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            out.update(asdict_flat(v, key + "."))
        else:
            out[key] = v
    return out
