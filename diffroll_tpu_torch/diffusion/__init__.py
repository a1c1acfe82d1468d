from . import samplers
from .loop import sample_loop, timestep_subsequence
from .schedule import (
    Schedule,
    cosine_beta_schedule,
    linear_beta_schedule,
    linear_schedule,
    make_schedule,
    quadratic_beta_schedule,
    sigmoid_beta_schedule,
)

__all__ = [
    "Schedule",
    "cosine_beta_schedule",
    "linear_beta_schedule",
    "linear_schedule",
    "make_schedule",
    "quadratic_beta_schedule",
    "sigmoid_beta_schedule",
    "sample_loop",
    "samplers",
    "timestep_subsequence",
]
