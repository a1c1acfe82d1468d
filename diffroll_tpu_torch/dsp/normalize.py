"""Batchwise min-max normalization (counterpart of
`diffroll_tpu/dsp/normalize.py`): per-sample scaling to [lo, hi], either
'imagewise' (over all non-batch elements) or 'framewise' (over `axis`);
constant inputs map to `lo`."""

from __future__ import annotations

import torch


def min_max_normalize(
    x: torch.Tensor,
    lo: float,
    hi: float,
    mode: str = "imagewise",
    axis: int = -1,
) -> torch.Tensor:
    if mode == "imagewise":
        dims = tuple(range(1, x.ndim))
        x_min = torch.amin(x, dim=dims, keepdim=True)
        x_max = torch.amax(x, dim=dims, keepdim=True)
    elif mode == "framewise":
        x_min = torch.amin(x, dim=axis, keepdim=True)
        x_max = torch.amax(x, dim=axis, keepdim=True)
    else:
        raise ValueError(f"unknown normalization mode: {mode!r}")

    denom = x_max - x_min
    scaled = (x - x_min) / denom * (hi - lo) + lo
    # constant input => denom == 0 => NaN; map to lo
    return torch.where(denom > 0, scaled, torch.full_like(x, lo))
