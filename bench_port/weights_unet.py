"""The weights of a U-Net configuration, made from `--seed` on the device.

`weights.make` draws every parameter over the shapes of a build that
allocates nothing: kernels N(0, 1/fan_in), every one-dimensional parameter as
a bias, N(0, 0.05^2). A GroupNorm's scale drawn so would be about 0.05 with a
random sign, and would shrink every activation it normalises twentyfold; so
each GroupNorm `weight` is then drawn again as 1 + N(0, 0.05^2), from one
more generator of the same seed. The same tensors go to the program and to
the reference.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import inputs, port, weights

NORM_STREAM = 1


def norm_weights(cfg: dict) -> List[str]:
    """The state-dict names of the model's GroupNorm scales, from a build that
    allocates nothing."""
    from diffroll_tpu_torch.models import build

    with torch.device("meta"):
        model = build(cfg["preset"], **port._overrides(cfg))
    return [f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, torch.nn.GroupNorm)]


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on `device`."""
    out = weights.make(port.model_shapes(cfg), seed, device)
    names = norm_weights(cfg)
    gen = torch.Generator(device=device).manual_seed(inputs.torch_seed(seed, NORM_STREAM))
    flat = torch.randn(sum(out[n].numel() for n in names), generator=gen, device=device)
    at = 0
    for n in names:
        k = out[n].numel()
        out[n] = 1.0 + weights.BIAS_STD * flat[at: at + k].view_as(out[n])
        at += k
    return out
