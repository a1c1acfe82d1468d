"""Progressive-distillation math (counterpart of
`diffroll_tpu/diffusion/distill.py`): the targets that make one student
DDIM step land where two teacher steps do.

Progressive distillation (Salimans & Ho, arXiv 2202.00512) halves a
deterministic sampler's step count per stage: a student learns to make ONE
strided DDIM step t -> tp from x_t reproduce the teacher's TWO steps
t -> tm -> tp. Guided distillation (Meng et al., arXiv 2210.03142) folds
classifier-free guidance into the first stage, so every student needs one
forward per step. The training loop is in train/distill.py.

Every function takes per-example (B,) long timesteps, so one batch mixes
transitions, as diffusion training mixes timesteps. `tp == -1` marks the
final transition, which emits x0 / sac[0]. None reads a value back to the
host, so with the schedule's tables on the card a step never waits for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .loop import timestep_subsequence
from .schedule import Schedule


def distill_grids(timesteps: int, student_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(student grid, teacher midpoints) for one stage: descending int32
    arrays of n and n - 1 points, every other point of ONE strided
    subsequence of 2n - 1 points. So the student grid is the sampling grid of
    `sampling_steps=n`, and a later stage's teacher is queried only at
    timesteps it was trained on."""
    if student_steps < 2:
        raise ValueError("student_steps must be >= 2")
    teacher = timestep_subsequence(timesteps, 2 * student_steps - 1)
    if len(teacher) != 2 * student_steps - 1:
        raise ValueError(
            f"cannot build a {2 * student_steps - 1}-point teacher grid "
            f"inside {timesteps} timesteps; lower student_steps")
    return teacher[::2].astype(np.int32), teacher[1::2].astype(np.int32)


def _gather(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] on t's device, shaped (B, 1, ...) against a rank-`ndim` batch."""
    coef = table.to(t.device)[t]
    return coef.reshape(coef.shape + (1,) * (ndim - 1))


def _done(tp: torch.Tensor, ndim: int) -> torch.Tensor:
    return (tp < 0).reshape(tp.shape + (1,) * (ndim - 1))


def _step_coeffs(schedule: Schedule, t: torch.Tensor, tp: torch.Tensor, ndim: int):
    """(sac[t], sac[tp], s1m[tp] / s1m[t]), with tp clamped to 0 for the
    tables (the tp == -1 rows take the other branch)."""
    sac, s1m = schedule.sqrt_alphas_cumprod, schedule.sqrt_one_minus_alphas_cumprod
    tpc = tp.clamp(min=0)
    return (_gather(sac, t, ndim), _gather(sac, tpc, ndim),
            _gather(s1m, tpc, ndim) / _gather(s1m, t, ndim))


def ddim_x0_vec(schedule: Schedule, x: torch.Tensor, t: torch.Tensor, tp: torch.Tensor,
                x0: torch.Tensor) -> torch.Tensor:
    """The deterministic DDIM x0-step with per-example timesteps (the
    vectorised `samplers.ddim_x0_step`); tp == -1 emits x0 / sac[0]."""
    a_t, a_p, b = _step_coeffs(schedule, t, tp, x.ndim)
    mean_t = a_p * x0 + b * (x - a_t * x0)
    return torch.where(_done(tp, x.ndim), x0 / schedule.sqrt_alphas_cumprod[0], mean_t)


def ddim_x0_target(schedule: Schedule, x_t: torch.Tensor, t: torch.Tensor, tp: torch.Tensor,
                   x_tp: torch.Tensor) -> torch.Tensor:
    """The x0 a student must predict at (x_t, t) for its one step t -> tp to
    land on `x_tp`: the step x_tp = (a_p - b a_t) x0 + b x_t inverted (its x0
    coefficient is positive for tp < t). For tp == -1 the target is
    x_tp * sac[0]."""
    a_t, a_p, b = _step_coeffs(schedule, t, tp, x_t.ndim)
    target = (x_tp - b * x_t) / (a_p - b * a_t)
    return torch.where(_done(tp, x_t.ndim), x_tp * schedule.sqrt_alphas_cumprod[0], target)


def truncated_snr_weight(schedule: Schedule, t: torch.Tensor, ndim: int, clip: float = 1.0,
                         cap: Optional[float] = 5.0) -> torch.Tensor:
    """The loss weight clamp(SNR(t), clip, cap), shaped (B, 1, ...): the
    truncated SNR of Salimans & Ho §4, capped above (min-SNR-gamma, Hang et
    al. arXiv 2303.09556, gamma = 5) because SNR(0) ~ 1e4 on the linear
    schedule magnifies low-t drift into loss spikes. cap=None leaves it
    unbounded."""
    snr = (_gather(schedule.sqrt_alphas_cumprod, t, ndim)
           / _gather(schedule.sqrt_one_minus_alphas_cumprod, t, ndim)) ** 2
    w = snr.clamp(min=clip)
    return w if cap is None else w.clamp(max=cap)
