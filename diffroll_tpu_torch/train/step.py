"""The training step for one device (counterpart of
`diffroll_tpu/train/step.py`; the mesh-sharded step is not ported)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .state import TrainState

# loss_fn(batch, generator, train) -> (total, (losses, tensors))
LossFn = Callable[..., Any]


def make_train_step(loss_fn: LossFn):
    """`(state, batch, generator) -> losses`: zero_grad, loss, backward, Adam
    step, in place on `state`. The losses come back detached and stay on the
    device, so a step forces no host synchronisation."""

    def step(state: TrainState, batch: Any, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        total, (losses, _) = loss_fn(batch, generator, True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_eval_step(loss_fn: LossFn):
    """`(batch, generator) -> losses` without gradients."""

    @torch.no_grad()
    def step(batch: Any, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        _, (losses, _) = loss_fn(batch, generator, False)
        return losses

    return step
