"""The model's weights, made from `--seed` on the device.

One normal draw from a `torch.Generator` on the device fills every
parameter at once, in the model's own f32 type; each tensor is then scaled
so that activations keep their size through the stack: a kernel by
1 / sqrt(fan_in) (LeCun), a bias by 0.05. The output head is drawn like any
other layer, so the prediction is not the zero of a fresh model. The same
tensors go to the program (`load_state_dict`) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BIAS_STD = 0.05


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on `device`, from one draw of `seed`."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        std = BIAS_STD if len(shape) == 1 else 1.0 / math.sqrt(math.prod(shape[1:]))
        out[name] = flat[at: at + n].view(shape).mul_(std)
        at += n
    return out
