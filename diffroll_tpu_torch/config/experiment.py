"""The experiment config tree (counterpart of
`diffroll_tpu/config/experiment.py`): top-level knobs plus the model / task /
dataset / dataloader / trainer groups, with the JAX package's defaults.

Left out for good: the trainer's `rng_impl` (it picks a `jax.random`
implementation), `dataloader.transfer` (training batches always cross as
float32 through pinned memory with a non-blocking copy,
`data/pipeline.to_device`) and
`serve.compile_cache_dir` (the XLA compilation cache; eager PyTorch compiles
nothing per shape).
`device` is the port's own knob.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

from ..models.base import DiffRollConfig
from ..tasks.baseline import BaselineConfig
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
    # the (data, model) mesh (parallel/mesh.py): model_axis ranks share each
    # parameter whose output channels divide by it (parallel/model_axis.py);
    # data_axis None = the world size of the launched group (torchrun
    # --nproc_per_node=N) // model_axis, 1 process otherwise; any other
    # value times model_axis must equal the world size, and in the training
    # entries the train batch must divide by the data axis.
    model_axis: int = 1
    data_axis: Optional[int] = None
    log_every_n_steps: int = 50
    profile: bool = False                     # torch.profiler trace of the first epoch
    # exponential moving average of the weights; None = off
    ema_decay: Optional[float] = None
    # "bfloat16": Adam's moments stored in bf16, written back with
    # stochastic rounding (train/state.BF16MomentAdam); None = f32 moments
    adam_moments_dtype: Optional[str] = None

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
class DistillConfig:
    """Progressive-distillation knobs (`python -m diffroll_tpu_torch distill`;
    semantics in train/distill.py). Same fields and defaults as the JAX
    package's."""

    start_steps: int = 65        # the first student's steps (its teacher walks
                                 # the 2n - 1 = 129-point strided grid)
    stages: int = 5              # halvings: 65 -> 33 -> 17 -> 9 -> 5
    steps_per_stage: int = 2000  # optimizer steps per stage
    lr: float = 1e-4
    w: float = 0.5               # guidance folded into the first stage
    fold_guidance: bool = True
    snr_clip: float = 1.0        # SNR loss-weight floor
    snr_cap: float = 5.0         # SNR loss-weight ceiling (min-SNR-gamma)

    def replace(self, **kw) -> "DistillConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        # a later-stage teacher is queried only at timesteps it was trained
        # on when each grid is every other point of the one before:
        # n_i == 2 n_{i+1} - 1, i.e. start_steps = 2^k + 1
        steps = self.stage_steps()
        broken = [(a, b) for a, b in zip(steps, steps[1:]) if a != 2 * b - 1]
        if broken:
            warnings.warn(
                f"distill stage grids do not nest: start_steps={self.start_steps} gives "
                f"stages {steps}, but {broken[0][1]}-step grid is not every other "
                f"point of the {broken[0][0]}-step grid. Later-stage teachers will be "
                f"queried at timesteps they were never trained on; use "
                f"start_steps = 2^k + 1 (e.g. 65, 33, 17).", stacklevel=2)

    def stage_steps(self) -> List[int]:
        """Step counts per stage, halving from start_steps: n -> (n + 1) // 2,
        while at least 2."""
        out, n = [], self.start_steps
        for _ in range(self.stages):
            out.append(n)
            n = (n + 1) // 2
            if n < 2:
                break
        return out


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Root config: everything a CLI entry needs."""

    model_name: str = "ClassifierFreeDiffRoll"
    model: DiffRollConfig = DiffRollConfig()
    # 'diffusion' -> DiffusionTask(task); 'baseline' -> BaselineTask(baseline)
    task_type: str = "diffusion"
    task: TaskConfig = TaskConfig()
    baseline: BaselineConfig = BaselineConfig()
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
    distill: DistillConfig = DistillConfig()
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
