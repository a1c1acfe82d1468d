"""Forward (noising) process and x0 recovery (counterpart of
`diffroll_tpu/diffusion/forward.py`): the closed forms of DDPM eq. 4,
broadcast over arbitrary trailing dimensions."""

from __future__ import annotations

import torch

from .schedule import Schedule


def _bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] (t: (B,)) on t's device, shaped (B, 1, 1, ...) to broadcast
    against a rank-`ndim` batch tensor."""
    coef = table.to(t.device)[t]
    return coef.reshape(coef.shape + (1,) * (ndim - 1))


def q_sample(x_start: torch.Tensor, t: torch.Tensor, schedule: Schedule,
             noise: torch.Tensor) -> torch.Tensor:
    """x_t ~ q(x_t | x_0). x_start (B, ...) clean rolls; t (B,) int
    timesteps; noise of x_start's shape."""
    a = _bcast(schedule.sqrt_alphas_cumprod, t, x_start.ndim)
    s = _bcast(schedule.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
    return a * x_start + s * noise


def extract_x0(x_t: torch.Tensor, epsilon: torch.Tensor, t: torch.Tensor,
               schedule: Schedule) -> torch.Tensor:
    """x0 from x_t and the predicted noise (the inverse of `q_sample`)."""
    a = _bcast(schedule.sqrt_alphas_cumprod, t, x_t.ndim)
    s = _bcast(schedule.sqrt_one_minus_alphas_cumprod, t, x_t.ndim)
    return (x_t - s * epsilon) / a
