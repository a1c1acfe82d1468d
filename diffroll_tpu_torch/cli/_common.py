"""Shared CLI plumbing (counterpart of `diffroll_tpu/cli/_common.py`):
dataset / loader / model construction, the mesh, run dirs, checkpoint
load-with-override."""

from __future__ import annotations

import pathlib
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..compat.torch_ckpt import (
    config_from_hparams, peek_hparams, read_ckpt, task_config_from_hparams,
    task_updates_from_hparams, weights_only)
from ..config import DatasetConfig, ExperimentConfig, apply_overrides
from ..data.amt import MAESTRO, MAPS
from ..data.custom import Custom
from ..data.pipeline import DataLoader
from ..models.base import DiffRollModel
from ..parallel.mesh import Mesh
from ..parallel.mesh import setup_mesh as _setup_mesh
from ..parallel.model_axis import shard_module
from ..tasks.baseline import BaselineTask
from ..tasks.diffusion import DiffusionTask, TaskConfig
from ..train.state import TrainState


def device_named(name: str) -> torch.device:
    """`name` as a torch.device; exits when it names a card that is not
    there (no entry point falls back to the CPU by itself)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device=cuda but no CUDA device is available; pass device=cpu")
    return device


def resolve_device(cfg: ExperimentConfig) -> torch.device:
    """`cfg.device` as a torch.device (`device_named`)."""
    return device_named(cfg.device)


def setup_mesh(cfg: ExperimentConfig,
               train: bool = False) -> Tuple[Optional[Mesh], torch.device]:
    """The (data, model) mesh (parallel/mesh.py; None outside a launched
    group) and this process's device: the rank's card under a mesh on CUDA.
    A training entry (`train`) has its train batch checked against the data
    axis; the others ignore it."""
    device = resolve_device(cfg)
    mesh = _setup_mesh(cfg, device, train)
    return mesh, (device if mesh is None else mesh.device)


def is_main(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes files: the only one, or rank 0."""
    return mesh is None or mesh.is_main


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


def build_loader(cfg: ExperimentConfig, dataset, split: str,
                 mesh: Optional[Mesh] = None) -> DataLoader:
    """The split's loader; with `mesh` each rank reads its data stripe of
    every global batch (`process_index` = its data index, `process_count` =
    the data axis's size), and the train split drops a short last batch,
    whose stripes could not all step."""
    dl = cfg.dataloader
    bs = {"train": dl.train_batch_size, "validation": dl.val_batch_size,
          "test": dl.test_batch_size}[split]
    return DataLoader(
        dataset, bs,
        shuffle=dl.shuffle and split == "train",
        drop_last=(dl.drop_last or mesh is not None) and split == "train",
        num_workers=dl.num_workers, prefetch=dl.prefetch,
        seed=cfg.trainer.seed,
        process_index=0 if mesh is None else mesh.data_index,
        process_count=1 if mesh is None else mesh.data,
    )


def task_lr(cfg: ExperimentConfig) -> float:
    return cfg.baseline.lr if cfg.task_type == "baseline" else cfg.task.lr


def task_threshold(cfg: ExperimentConfig) -> float:
    """The eval binarisation threshold (the baseline task has its own, 0.6)."""
    return (cfg.baseline.frame_threshold if cfg.task_type == "baseline"
            else cfg.task.frame_threshold)


def stored_task_config(path: str) -> Optional[TaskConfig]:
    """The task config a checkpoint that the port's `train` wrote records
    (its `port_config`), read without loading any tensor; None for a
    published Lightning checkpoint, whose recorded sampler `load_pretrained`
    has already adopted."""
    hparams = peek_hparams(path)
    return task_config_from_hparams(hparams) if hparams.get("port_config") else None


def make_run_dir(cfg: ExperimentConfig, kind: str) -> pathlib.Path:
    """outputs/<date>/<time>/<kind>-<run name>."""
    name = cfg.trainer.run_name or cfg.describe()
    stamp = time.strftime("%Y-%m-%d/%H-%M-%S")
    run_dir = pathlib.Path(cfg.trainer.output_dir) / stamp / f"{kind}-{name}"
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def setup_model_task(cfg: ExperimentConfig, device,
                     mesh: Optional[Mesh] = None) -> Tuple[DiffRollModel, Any]:
    """The model on `device` and its task: a `DiffusionTask` (drawing the
    global batch's draws under `mesh`), or a `BaselineTask` for
    task_type=baseline."""
    model = DiffRollModel(cfg.model).to(device)
    if cfg.task_type == "baseline":
        return model, BaselineTask(model, cfg.baseline, mesh=mesh)
    return model, DiffusionTask(model, cfg.task, mesh=mesh)


def new_train_state(cfg: ExperimentConfig, model: DiffRollModel) -> TrainState:
    """A fresh optimizer at the task's lr (`trainer.adam_moments_dtype`)."""
    return TrainState.create(model, task_lr(cfg), cfg.trainer.adam_moments_dtype,
                             seed=cfg.trainer.seed)


def shard_model(model: DiffRollModel, mesh: Optional[Mesh], optimizer=None) -> None:
    """Under a model axis (`train`, `distill`, `serve`), keep this rank's
    chunk of every parameter the JAX rule shards, with its slice of the
    optimizer's state; nothing otherwise."""
    if mesh is not None and mesh.model > 1:
        shard_module(model.net, mesh, optimizer)


def config_record(cfg: ExperimentConfig) -> Dict[str, Any]:
    return {"model_name": cfg.model_name, "model": cfg.model, "task": cfg.task,
            "task_type": cfg.task_type, "baseline": cfg.baseline}


def load_pretrained(
    cfg: ExperimentConfig,
    prefer_ema: bool = True,
    overrides: Optional[Dict[str, Any]] = None,
    device: Optional[torch.device] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[ExperimentConfig, DiffRollModel, Any, TrainState]:
    """Restore a checkpoint with the reference's "reload weights, override
    hparams" semantic. The stored model config wins for architecture and the
    user's explicit `model.*` keys are re-applied on top of it (e.g.
    model.spec_dropout when switching pretrain -> fine-tune).

    For a checkpoint the port's `train` wrote, the CLI config wins for the
    task knobs, and the optimizer state and step come back too. For a
    published Lightning checkpoint, the task knobs it records apply first
    and the user's explicit `task.*` keys win; the optimizer starts fresh.
    A checkpoint the port wrote also brings back its `task_type`.
    In both, `timesteps` follows the model's embedding table. EMA weights
    are preferred when `prefer_ema` (evaluation); fine-tuning continues from
    the raw weights. With `trainer.adam_moments_dtype` set the optimizer
    starts fresh (the stored moments are another dtype's), as in the JAX
    package. `device` defaults to `cfg.device`'s; `mesh` goes to the task.
    """
    if not cfg.pretrained_path or pathlib.Path(cfg.pretrained_path).suffix != ".ckpt":
        raise SystemExit("pretrained_path=<file>.ckpt (a Lightning-style checkpoint) "
                         "is required")
    device = resolve_device(cfg) if device is None else device
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
        model_name=port["model_name"] if port else cfg.model_name,
        task_type=port.get("task_type", cfg.task_type) if port else cfg.task_type)

    model, task = setup_model_task(cfg, device, mesh)
    weights = ckpt.get("ema") if prefer_ema and ckpt.get("ema") is not None \
        else weights_only(ckpt["state_dict"])
    # strict: a layout or architecture mismatch raises here, naming the keys
    model.net.load_state_dict(weights)
    state = new_train_state(cfg, model)
    if ckpt.get("optimizer_state") is not None:
        if not cfg.trainer.adam_moments_dtype:
            state.optimizer.load_state_dict(ckpt["optimizer_state"])
            for group in state.optimizer.param_groups:
                group["lr"] = task_lr(cfg)
        state.step = int(ckpt.get("global_step", 0))
    return cfg, model, task, state
