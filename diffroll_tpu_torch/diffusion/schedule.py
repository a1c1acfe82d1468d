"""Diffusion noise schedules and their coefficient tables (counterpart of
`diffroll_tpu/diffusion/schedule.py`). Tables are float32 CPU tensors of T
scalars; the samplers read them as Python floats."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def linear_beta_schedule(beta_start: float, beta_end: float, timesteps: int) -> torch.Tensor:
    return torch.linspace(beta_start, beta_end, timesteps, dtype=torch.float32)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> torch.Tensor:
    """Cosine schedule from Nichol & Dhariwal."""
    x = torch.linspace(0.0, timesteps, timesteps + 1, dtype=torch.float32)
    alphas_cumprod = torch.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return torch.clamp(betas, 0.0001, 0.9999)


def quadratic_beta_schedule(
    timesteps: int, beta_start: float = 0.0001, beta_end: float = 0.02
) -> torch.Tensor:
    return torch.linspace(beta_start ** 0.5, beta_end ** 0.5, timesteps,
                          dtype=torch.float32) ** 2


def sigmoid_beta_schedule(
    timesteps: int, beta_start: float = 0.0001, beta_end: float = 0.02
) -> torch.Tensor:
    betas = torch.linspace(-6.0, 6.0, timesteps, dtype=torch.float32)
    return torch.sigmoid(betas) * (beta_end - beta_start) + beta_start


class Schedule(NamedTuple):
    """Precomputed DDPM coefficient tables, one scalar per timestep."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor

    @property
    def timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(betas: torch.Tensor) -> Schedule:
    betas = torch.as_tensor(betas, dtype=torch.float32)
    alphas = 1.0 - betas
    alphas_cumprod = torch.cumprod(alphas, dim=0)
    alphas_cumprod_prev = torch.cat([torch.ones(1), alphas_cumprod[:-1]])
    return Schedule(
        betas=betas,
        alphas=alphas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_recip_alphas=torch.sqrt(1.0 / alphas),
        sqrt_alphas_cumprod=torch.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=torch.sqrt(1.0 - alphas_cumprod),
        posterior_variance=betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod),
    )


def linear_schedule(beta_start: float, beta_end: float, timesteps: int) -> Schedule:
    return make_schedule(linear_beta_schedule(beta_start, beta_end, timesteps))
