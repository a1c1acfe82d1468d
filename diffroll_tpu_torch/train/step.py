"""The training step (counterpart of `diffroll_tpu/train/step.py`), on one
device or over the data axis (parallel/mesh.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..utils.profiling import span
from .state import TrainState

# loss_fn(batch, generator, train) -> (total, (losses, tensors))
LossFn = Callable[..., Any]


def make_train_step(loss_fn: LossFn, mesh=None):
    """`(state, batch, generator) -> losses`: zero_grad, loss, backward, Adam
    step, in place on `state`. The losses come back detached and stay on the
    device, so a step forces no host synchronisation.

    With `mesh` the gradients and the losses are averaged over the data
    group after `backward` (`Mesh.average_gradients`), whatever route the
    loss took (the modules under autograd, or K3 + K4 through
    `GatedStackFn`), so every rank applies the same update: the global
    batch's; under a model axis each rank's to its chunks."""

    def step(state: TrainState, batch: Any, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with span("train.step"):
            state.model.train()
            with span("train.zero_grad"):
                state.optimizer.zero_grad(set_to_none=True)
            with span("train.loss"):
                total, (losses, _) = loss_fn(batch, generator, True)
            with span("train.backward"):
                total.backward()
            losses = {k: v.detach() for k, v in losses.items()}
            if mesh is not None:
                with span("train.allreduce"):
                    losses = mesh.average_gradients(state.model.net.parameters(), losses)
            with span("train.optimizer"):
                state.optimizer.step()
            state.step += 1
            return losses

    return step


def make_eval_step(loss_fn: LossFn):
    """`(batch, generator) -> losses` without gradients."""

    @torch.no_grad()
    def step(batch: Any, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        _, (losses, _) = loss_fn(batch, generator, False)
        return losses

    return step
