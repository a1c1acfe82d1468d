"""Training losses (counterpart of `diffroll_tpu/tasks/losses.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def p_losses(label: torch.Tensor, prediction: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Mean loss between label and prediction; 'l1' | 'l2' | 'huber'
    (smooth L1 with beta = 1)."""
    if loss_type == "l1":
        return torch.mean(torch.abs(label - prediction))
    if loss_type == "l2":
        return torch.mean((label - prediction) ** 2)
    if loss_type == "huber":
        return F.smooth_l1_loss(prediction, label, beta=1.0)
    raise NotImplementedError(f"loss_type {loss_type!r}")
