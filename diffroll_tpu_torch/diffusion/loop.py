"""The reverse-diffusion loop (counterpart of `diffroll_tpu/diffusion/loop.py`).

PyTorch runs eagerly, so the scan becomes a Python loop. Randomness is
explicit: the per-step noise comes in as one (n, B, T, 88) tensor (tests
hand both packages the same draws), or is drawn per step from a
`torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

# step_fn(x, t, t_prev, noise) -> x_{t_prev}; t_prev == -1 marks the final
# step. `noise` is None when the loop was given no noise source.
StepFn = Callable[[torch.Tensor, int, int, Optional[torch.Tensor]], torch.Tensor]


def timestep_subsequence(timesteps: int, steps: Optional[int]) -> np.ndarray:
    """Descending timestep indices: all of T-1..0, or `steps` evenly spaced
    values including both T-1 and 0."""
    if steps is None or steps >= timesteps:
        return np.arange(timesteps - 1, -1, -1, dtype=np.int32)
    if steps < 1:
        raise ValueError("steps must be >= 1")
    ts = np.unique(np.round(np.linspace(0, timesteps - 1, steps)).astype(np.int32))
    return ts[::-1]


def previous_timesteps(ts: np.ndarray) -> np.ndarray:
    """The next index each step visits; -1 after the last."""
    return np.concatenate([ts[1:], [-1]]).astype(np.int32)


def sample_loop(
    step_fn: StepFn,
    x_T: torch.Tensor,
    timesteps: int,
    noise: Union[torch.Tensor, torch.Generator, None],
    steps: Optional[int] = None,
    record_every: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the reverse process over t = T-1 .. 0 (or a strided subsequence).

    `noise`: an (n, *x_T.shape) tensor of per-step draws, a generator on
    x_T's device to draw them from, or None for deterministic samplers.
    Returns (x_0, trajectory subsampled every `record_every` steps, aligned
    to include the final state, or None).
    """
    ts = timestep_subsequence(timesteps, steps)
    ts_prev = previous_timesteps(ts)
    n = len(ts)
    if isinstance(noise, torch.Tensor) and noise.shape[0] != n:
        raise ValueError(f"noise has {noise.shape[0]} steps, the loop visits {n}")
    x = x_T
    traj = []
    for i in range(n):
        if isinstance(noise, torch.Generator):
            n_i = torch.randn(x.shape, generator=noise, device=x.device,
                              dtype=x.dtype)
        elif noise is not None:
            n_i = noise[i]
        else:
            n_i = None
        x = step_fn(x, int(ts[i]), int(ts_prev[i]), n_i)
        if record_every is not None:
            traj.append(x)
    if record_every is None:
        return x, None
    start = (n - 1) % record_every
    return x, torch.stack(traj[start::record_every])
