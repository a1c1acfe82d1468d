"""The fit loop: epochs, validation, monitored checkpointing, logging
(counterpart of `diffroll_tpu/train/loop.py`, for one device).

One eager train step (see `step.py`) driven by a host loop, validation every
`check_val_every_n_epoch` epochs, a monitored best-checkpoint policy
(`monitor` / `save_top_k` / `save_last`), JSONL metrics, an optional EMA of
the weights, and an optional torch.profiler trace of the first epoch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..config.experiment import TrainerConfig
from ..data.pipeline import to_device
from ..utils.logging import MetricLogger
from ..utils.profiling import StepTimer, trace_if
from .checkpoint import Checkpointer
from .state import TrainState
from .step import make_eval_step, make_train_step


def _batch_size(batch: Any) -> int:
    first = batch[0] if isinstance(batch, (tuple, list)) else batch
    return int(first["frame"].shape[0])


def _mean_losses(records) -> Dict[str, float]:
    if not records:
        return {}
    return {k: float(np.mean([float(r[k]) for r in records])) for k in records[0]}


def _resolve_monitor(monitor: str, train_losses: Dict[str, Any],
                     val_losses: Dict[str, float]) -> Optional[float]:
    """Look the checkpoint monitor up by its prefix: 'train/x' reads the
    last train-step losses even when a val loader exists (the
    unsupervised-pretrain recipe monitors train/diffusion_loss), anything
    else reads the epoch's mean val losses."""
    if monitor.startswith("train/"):
        key = monitor.removeprefix("train/")
        return float(train_losses[key]) if key in train_losses else None
    return val_losses.get(monitor.removeprefix("val/"), None)


def ema_update(ema: Dict[str, torch.Tensor], net: torch.nn.Module, decay: float) -> None:
    """e := e * decay + p * (1 - decay), in place, for every parameter."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            ema[name].mul_(decay).add_(p.detach(), alpha=1.0 - decay)


def fit(
    task,
    state: TrainState,
    train_loader: Iterable,
    trainer: TrainerConfig = TrainerConfig(),
    val_loader: Optional[Iterable] = None,
    checkpointer: Optional[Checkpointer] = None,
    logger: Optional[MetricLogger] = None,
    config_record: Optional[Dict[str, Any]] = None,
    val_hook=None,
) -> TrainState:
    """Train to `trainer.max_epochs` on the model's device. Returns the
    final state (the same object, updated in place).

    `val_hook(state, batch) -> dict` may add extra metrics on the first
    validation batch of each eval epoch.
    """
    step_fn = make_train_step(task.loss_fn)
    eval_fn = make_eval_step(task.loss_fn)
    device = state.model.device
    generator = torch.Generator(device=device).manual_seed(trainer.seed)

    # EMA of the weights (TrainerConfig.ema_decay): tracked beside the state,
    # saved as a checkpoint extra, preferred at eval time when present
    ema = None
    if trainer.ema_decay:
        ema = {name: p.detach().clone() for name, p in state.model.net.named_parameters()}

    def ckpt_extras():
        return {"ema": ema} if ema is not None else None

    best = math.inf
    timer = StepTimer()
    losses: Dict[str, Any] = {}

    for epoch in range(trainer.max_epochs):
        with trace_if(trainer.profile and epoch == 0,
                      str(logger.run_dir / "profile") if logger else "profile"):
            for batch in train_loader:
                batch = to_device(batch, device)
                losses = step_fn(state, batch, generator)
                if ema is not None:
                    ema_update(ema, state.model.net, float(trainer.ema_decay))
                timer.tick(_batch_size(batch))
                if logger and state.step % trainer.log_every_n_steps == 0:
                    scalars = {f"train/{k}": v for k, v in losses.items()}
                    scalars.update(timer.rates())
                    scalars["epoch"] = epoch
                    logger.log_scalars(state.step, scalars)

        if (epoch + 1) % trainer.check_val_every_n_epoch:
            continue
        val_losses: Dict[str, float] = {}
        if val_loader is not None:
            records = []
            extra: Dict[str, float] = {}
            state.model.eval()
            for i, batch in enumerate(val_loader):
                batch = to_device(batch, device)
                records.append(eval_fn(batch, generator))
                if i == 0 and val_hook is not None:
                    extra = val_hook(state, batch) or {}
            val_losses = _mean_losses(records)
            if logger and val_losses:
                scalars = {f"val/{k}": v for k, v in val_losses.items()}
                scalars.update(extra)
                logger.log_scalars(state.step, scalars)
        monitored = _resolve_monitor(trainer.monitor, losses, val_losses)
        if monitored is None and logger is not None and (losses or val_losses):
            logger.log_scalars(state.step, {"warn/monitor_unresolved": 1.0})

        if checkpointer is not None:
            if trainer.save_last:
                checkpointer.save_last(state, config_record, extras=ckpt_extras())
            if monitored is not None and monitored < best:
                best = monitored
                checkpointer.save(state.step, state, config_record, extras=ckpt_extras())

    if checkpointer is not None:
        checkpointer.save_last(state, config_record, extras=ckpt_extras())
    return state
