"""The fit loop: epochs, validation, monitored checkpointing, logging
(counterpart of `diffroll_tpu/train/loop.py`).

One eager train step (see `step.py`) driven by a host loop, validation every
`check_val_every_n_epoch` epochs, a monitored best-checkpoint policy
(`monitor` / `save_top_k` / `save_last`), JSONL metrics, an optional EMA of
the weights, and an optional torch.profiler trace of the first epoch.

Over the data axis (`mesh`): every rank starts from rank 0's weights, its
generator seeded alike, and steps on its stripe of each global batch with
the gradients averaged; the validation losses are reduced over the ranks,
so every rank sees the global ones; the EMA is kept on every rank (the
weights are the same bits everywhere). The caller passes the logger and
the checkpointer on rank 0 only, so only rank 0 writes. Under a model axis
each rank steps and keeps the EMA of its chunks (cut from rank 0's whole
weights by `shard_module`), every rank gathers the whole state for each
checkpoint (`whole_state`) and rank 0 writes it, and the hook runs on every
rank (it gathers the whole weights).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..config.experiment import TrainerConfig
from ..data.pipeline import to_device
from ..utils.logging import MetricLogger
from ..utils.profiling import StepTimer, span, trace_if
from ..parallel.model_axis import is_sharded
from .checkpoint import Checkpointer, whole_state
from .state import TrainState
from .step import make_eval_step, make_train_step


_END = object()   # the train loader's end


def _batch_size(batch: Any, mesh=None) -> int:
    """The rows of the (global) batch."""
    first = batch[0] if isinstance(batch, (tuple, list)) else batch
    rows = int(first["frame"].shape[0])
    return rows if mesh is None else mesh.global_rows(batch, rows)


def _mean_losses(records) -> Dict[str, float]:
    if not records:
        return {}
    return {k: float(np.mean([float(r[k]) for r in records])) for k in records[0]}


def _mean_losses_over(mesh, records, rows) -> Dict[str, float]:
    """The mean over validation batches of each global batch's loss, from
    every rank's losses on its stripe (weighted by the stripe's rows: a
    short last batch's stripes differ), in one all-reduce."""
    if not records:
        return {}
    keys = list(records[0])
    dev = records[0][keys[0]].device
    table = torch.tensor([[float(r[k]) * n for k in keys] + [n]
                          for r, n in zip(records, rows)], dtype=torch.float64)
    table = mesh.all_reduce_sum(table.to(dev)).cpu()
    per_batch = table[:, :-1] / table[:, -1:]
    return {k: float(per_batch[:, j].mean()) for j, k in enumerate(keys)}


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
    mesh=None,
) -> TrainState:
    """Train to `trainer.max_epochs` on the model's device. Returns the
    final state (the same object, updated in place; `state.ema` holds the
    EMA weights when `trainer.ema_decay` is set).

    `val_hook(state, batch) -> dict` may add extra metrics on the first
    validation batch of each eval epoch.
    """
    step_fn = make_train_step(task.loss_fn, mesh)
    eval_fn = make_eval_step(task.loss_fn)
    device = state.model.device
    generator = torch.Generator(device=device).manual_seed(trainer.seed)
    # a sharded net's chunks were cut from rank 0's whole weights already
    sharded = is_sharded(state.model.net)
    if mesh is not None and not sharded:
        mesh.broadcast_module(state.model.net)

    # EMA of the weights (TrainerConfig.ema_decay): tracked beside the state,
    # saved as a checkpoint extra, preferred at eval time when present
    ema = None
    if trainer.ema_decay:
        ema = {name: p.detach().clone() for name, p in state.model.net.named_parameters()}
    state.ema = ema

    def ckpt_extras():
        return {"ema": ema} if ema is not None else None

    # a sharded net's checkpoints are gathered by every rank, written by rank 0
    saves = checkpointer is not None or sharded

    def save(step=None):
        whole = whole_state(state, ckpt_extras()) if sharded else None
        if checkpointer is None:
            return
        if step is None:
            checkpointer.save_last(state, config_record, extras=ckpt_extras(), whole=whole)
        else:
            checkpointer.save(step, state, config_record, extras=ckpt_extras(), whole=whole)

    best = math.inf
    timer = StepTimer()
    losses: Dict[str, Any] = {}

    for epoch in range(trainer.max_epochs):
        with trace_if(trainer.profile and epoch == 0 and (mesh is None or mesh.is_main),
                      str(logger.run_dir / "profile") if logger else "profile"):
            batches = iter(train_loader)
            while True:
                with span("train.data"):
                    batch = next(batches, _END)
                    if batch is not _END:
                        batch = to_device(batch, device)
                if batch is _END:
                    break
                losses = step_fn(state, batch, generator)
                if ema is not None:
                    ema_update(ema, state.model.net, float(trainer.ema_decay))
                timer.tick(_batch_size(batch, mesh))
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
            rows = []
            for i, batch in enumerate(val_loader):
                batch = to_device(batch, device)
                records.append(eval_fn(batch, generator))
                first = batch[0] if isinstance(batch, (tuple, list)) else batch
                rows.append(int(first["frame"].shape[0]))
                if i == 0 and val_hook is not None:
                    extra = val_hook(state, batch) or {}
            val_losses = (_mean_losses(records) if mesh is None
                          else _mean_losses_over(mesh, records, rows))
            if logger and val_losses:
                scalars = {f"val/{k}": v for k, v in val_losses.items()}
                scalars.update(extra)
                logger.log_scalars(state.step, scalars)
        monitored = _resolve_monitor(trainer.monitor, losses, val_losses)
        if monitored is None and logger is not None and (losses or val_losses):
            logger.log_scalars(state.step, {"warn/monitor_unresolved": 1.0})

        if saves:
            if trainer.save_last:
                save()
            if monitored is not None and monitored < best:
                best = monitored
                save(state.step)

    if saves:
        save()
    return state
