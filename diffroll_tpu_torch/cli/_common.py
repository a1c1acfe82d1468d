"""Shared CLI plumbing (counterpart of `diffroll_tpu/cli/_common.py`):
dataset / loader / model construction, run dirs, checkpoint
load-with-override."""

from __future__ import annotations

import pathlib
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..compat.torch_ckpt import (
    config_from_hparams, read_ckpt, task_updates_from_hparams, weights_only)
from ..config import DatasetConfig, ExperimentConfig, apply_overrides
from ..data.amt import MAESTRO, MAPS
from ..data.custom import Custom
from ..data.pipeline import DataLoader
from ..models.base import DiffRollModel
from ..tasks.diffusion import DiffusionTask
from ..train.state import TrainState


def resolve_device(cfg: ExperimentConfig) -> torch.device:
    """`cfg.device` as a torch.device; exits when it names a card that is
    not there (no entry point falls back to the CPU by itself)."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device=cuda but no CUDA device is available; pass device=cpu")
    return device


def build_dataset(ds: DatasetConfig, split: str):
    """split in {'train', 'validation', 'test'}."""
    overlap = ds.overlap
    if overlap is None:
        # random train windows; eval splits enumerate consecutive windows
        # covering each recording
        overlap = split != "train"
    common = dict(
        sequence_length=ds.sequence_length, seed=ds.seed,
        hop_length=ds.hop_length, min_midi=ds.min_midi, max_midi=ds.max_midi,
        sampling_rate=ds.sampling_rate, preload=ds.preload, overlap=overlap,
        eval_overlap_frames=ds.eval_overlap_frames,
        max_cache_bytes=ds.max_cache_bytes,
    )
    if ds.name == "MAPS":
        groups = "train" if split in ("train", "validation") else "test"
        return MAPS(ds.root, groups=groups, data_type=ds.data_type,
                    download=ds.download, **common)
    if ds.name == "MAESTRO":
        return MAESTRO(ds.root, groups=split, download=ds.download, **common)
    if ds.name == "Custom":
        return Custom(ds.audio_path, ds.audio_ext,
                      max_segment_samples=ds.sequence_length,
                      sample_rate=ds.sampling_rate)
    raise KeyError(f"unknown dataset {ds.name!r}")


def build_loader(cfg: ExperimentConfig, dataset, split: str) -> DataLoader:
    dl = cfg.dataloader
    bs = {"train": dl.train_batch_size, "validation": dl.val_batch_size,
          "test": dl.test_batch_size}[split]
    return DataLoader(
        dataset, bs,
        shuffle=dl.shuffle and split == "train",
        drop_last=dl.drop_last and split == "train",
        num_workers=dl.num_workers, prefetch=dl.prefetch,
        seed=cfg.trainer.seed,
    )


def task_lr(cfg: ExperimentConfig) -> float:
    return cfg.task.lr


def make_run_dir(cfg: ExperimentConfig, kind: str) -> pathlib.Path:
    """outputs/<date>/<time>/<kind>-<run name>."""
    name = cfg.trainer.run_name or cfg.describe()
    stamp = time.strftime("%Y-%m-%d/%H-%M-%S")
    run_dir = pathlib.Path(cfg.trainer.output_dir) / stamp / f"{kind}-{name}"
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def setup_model_task(cfg: ExperimentConfig, device) -> Tuple[DiffRollModel, DiffusionTask]:
    model = DiffRollModel(cfg.model).to(device)
    return model, DiffusionTask(model, cfg.task)


def config_record(cfg: ExperimentConfig) -> Dict[str, Any]:
    return {"model_name": cfg.model_name, "model": cfg.model, "task": cfg.task}


def load_pretrained(
    cfg: ExperimentConfig,
    prefer_ema: bool = True,
    overrides: Optional[Dict[str, Any]] = None,
) -> Tuple[ExperimentConfig, DiffRollModel, DiffusionTask, TrainState]:
    """Restore a checkpoint with the reference's "reload weights, override
    hparams" semantic. The stored model config wins for architecture and the
    user's explicit `model.*` keys are re-applied on top of it (e.g.
    model.spec_dropout when switching pretrain -> fine-tune).

    For a checkpoint the port's `train` wrote, the CLI config wins for the
    task knobs, and the optimizer state and step come back too. For a
    published Lightning checkpoint, the task knobs it records apply first
    and the user's explicit `task.*` keys win; the optimizer starts fresh.
    In both, `timesteps` follows the model's embedding table. EMA weights
    are preferred when `prefer_ema` (evaluation); fine-tuning continues from
    the raw weights.
    """
    if not cfg.pretrained_path or pathlib.Path(cfg.pretrained_path).suffix != ".ckpt":
        raise SystemExit("pretrained_path=<file>.ckpt (a Lightning-style checkpoint) "
                         "is required")
    device = resolve_device(cfg)
    over = overrides or {}
    ckpt = read_ckpt(cfg.pretrained_path)
    hparams = ckpt["hyper_parameters"]
    port = hparams.get("port_config")

    model_cfg = config_from_hparams(hparams, cfg.model_name)
    model_over = {k[len("model."):]: v for k, v in over.items() if k.startswith("model.")}
    if model_over:
        model_cfg = apply_overrides(model_cfg, model_over)
    task_cfg = cfg.task
    if not port:
        updates = {k: v for k, v in task_updates_from_hparams(hparams).items()
                   if f"task.{k}" not in over}
        task_cfg = task_cfg.replace(**updates)
    cfg = cfg.replace(
        model=model_cfg, task=task_cfg.replace(timesteps=model_cfg.timesteps),
        model_name=port["model_name"] if port else cfg.model_name)

    model, task = setup_model_task(cfg, device)
    weights = ckpt.get("ema") if prefer_ema and ckpt.get("ema") is not None \
        else weights_only(ckpt["state_dict"])
    # strict: a layout or architecture mismatch raises here, naming the keys
    model.net.load_state_dict(weights)
    state = TrainState.create(model, task_lr(cfg))
    if ckpt.get("optimizer_state") is not None:
        state.optimizer.load_state_dict(ckpt["optimizer_state"])
        for group in state.optimizer.param_groups:
            group["lr"] = task_lr(cfg)
        state.step = int(ckpt.get("global_step", 0))
    return cfg, model, task, state
