"""Train state: the model (which owns the weights), the optimizer and the
step counter (counterpart of `diffroll_tpu/train/state.py`).

The optimizer is `torch.optim.Adam(lr)` with default betas and eps and no
weight decay: the reference's own setting, which the JAX package's
`make_optimizer` and `fused_adam_apply` reproduce. The JAX package's bf16
moments with stochastic rounding (`adam_moments_dtype`) are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.base import DiffRollModel


def make_optimizer(model: DiffRollModel, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


@dataclasses.dataclass
class TrainState:
    step: int
    model: DiffRollModel
    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, model: DiffRollModel, lr: float) -> "TrainState":
        return cls(step=0, model=model, optimizer=make_optimizer(model, lr))
