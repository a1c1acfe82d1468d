"""Reverse-diffusion sampler steps (counterpart of
`diffroll_tpu/diffusion/samplers.py`).

Each step is `(schedule, x_t, t, prediction, noise, t_prev) -> x_{t_prev}`
with Python-int timesteps: `t_prev` is the next index visited (-1 marks the
final step, which follows the reference's t==0 branches). Stochastic steps
take their Gaussian draw as a tensor instead of a PRNG key, so two
implementations can be held to the same draws. Stochastic steps use the
generalized DDIM sigma
    sigma^2 = (1-acum[tp])/(1-acum[t]) * (1-acum[t]/acum[tp]),
which equals the DDPM posterior variance for tp == t-1.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .schedule import Schedule


def cfg_mix(pred_cond: torch.Tensor, pred_uncond: torch.Tensor, w: float) -> torch.Tensor:
    """Classifier-free guidance: (1+w)*cond - w*uncond."""
    return (1.0 + w) * pred_cond - w * pred_uncond


def _coeffs(schedule: Schedule, t: int, t_prev: Optional[int]):
    """(sac[t], s1m[t], sac[tp], s1m[tp], sigma, done) as floats."""
    if t_prev is None:
        t_prev = t - 1
    tp = max(t_prev, 0)
    sac = schedule.sqrt_alphas_cumprod
    s1m = schedule.sqrt_one_minus_alphas_cumprod
    sac_t, s1m_t = float(sac[t]), float(s1m[t])
    sac_p, s1m_p = float(sac[tp]), float(s1m[tp])
    alpha_ratio = (sac_t / sac_p) ** 2
    sigma = (s1m_p / s1m_t) * math.sqrt(max(1.0 - alpha_ratio, 0.0))
    return sac_t, s1m_t, sac_p, s1m_p, sigma, t_prev < 0


def _need(noise: Optional[torch.Tensor]) -> torch.Tensor:
    if noise is None:
        raise ValueError("a stochastic sampler step needs its noise tensor")
    return noise


def ddpm_step(schedule, x, t, eps, noise, t_prev=None):
    """Ancestral DDPM step from an epsilon prediction."""
    sac_t, s1m_t, sac_p, _, sigma, done = _coeffs(schedule, t, t_prev)
    if done:  # the reference's t==0 branch: deterministic posterior mean
        return float(schedule.sqrt_recip_alphas[t]) * (
            x - float(schedule.betas[t]) * eps / s1m_t)
    x0 = (x - s1m_t * eps) / sac_t
    c_eps = math.sqrt(max(1.0 - sac_p ** 2 - sigma ** 2, 0.0))
    return sac_p * x0 + c_eps * eps + sigma * _need(noise)


def ddpm_x0_step(schedule, x, t, x0, noise, t_prev=None):
    """Ancestral DDPM step from an x0 prediction (the flagship update)."""
    sac_t, s1m_t, sac_p, _, sigma, done = _coeffs(schedule, t, t_prev)
    if done:
        return x0 / float(schedule.sqrt_alphas_cumprod[0])
    c_dir = math.sqrt(max(1.0 - sac_p ** 2 - sigma ** 2, 0.0))
    return sac_p * x0 + c_dir * (x - sac_t * x0) / s1m_t + sigma * _need(noise)


def ddim_x0_step(schedule, x, t, x0, noise=None, t_prev=None):
    """Deterministic DDIM step from an x0 prediction."""
    sac_t, s1m_t, sac_p, _, _, done = _coeffs(schedule, t, t_prev)
    if done:
        return x0 / float(schedule.sqrt_alphas_cumprod[0])
    return sac_p * x0 + math.sqrt(1.0 - sac_p ** 2) * (x - sac_t * x0) / s1m_t


def ddim_step(schedule, x, t, eps, noise=None, t_prev=None):
    """Deterministic DDIM step from an epsilon prediction."""
    sac_t, s1m_t, sac_p, s1m_p, _, done = _coeffs(schedule, t, t_prev)
    x0 = (x - s1m_t * eps) / sac_t
    if done:
        return x0
    return sac_p * x0 + s1m_p * eps


def ddim2ddpm_step(schedule, x, t, eps, noise, t_prev=None):
    """DDIM-form update with the DDPM sigma."""
    sac_t, s1m_t, sac_p, _, sigma, done = _coeffs(schedule, t, t_prev)
    x0 = (x - s1m_t * eps) / sac_t
    if done:
        return x0
    c_eps = math.sqrt(max(1.0 - sac_p ** 2 - sigma ** 2, 0.0))
    return sac_p * x0 + c_eps * eps + sigma * _need(noise)


# keyed by the reference's `task.sampling.type` strings:
# name -> (step fn, parameterisation, guided, stochastic)
SAMPLER_TABLE = {
    "ddpm":                (ddpm_step,      "epsilon", False,  True),
    "ddpm_x0":             (ddpm_x0_step,   "x_0",     False,  True),
    "ddim":                (ddim_step,      "epsilon", False,  False),
    "ddim_x0":             (ddim_x0_step,   "x_0",     False,  False),
    "ddim2ddpm":           (ddim2ddpm_step, "epsilon", False,  True),
    "cfdg_ddpm_x0":        (ddpm_x0_step,   "x_0",     True,   True),
    "cfdg_ddim_x0":        (ddim_x0_step,   "x_0",     True,   False),
    "generation_ddpm_x0":  (ddpm_x0_step,   "x_0",     False,  True),
    "inpainting_ddpm_x0":  (ddpm_x0_step,   "x_0",     True,   True),
}
