"""Dense (Linear) layers drawn as the JAX package draws them.

The JAX package builds its dense layers with Flax's `nn.Dense`, whose
kernels are LeCun-normal: variance 1 / fan_in, a normal truncated at two
standard deviations and rescaled to that variance. PyTorch's `nn.Linear`,
the reference's, draws kaiming-uniform kernels, a third of that variance. In
the DiffRoll nets the dense layers are the timestep pathway (the diffusion
embedding's MLP and each block's `diffusion_projection`); from PyTorch's
draw the port's p=0.1 twins inpainted a third worse inside a band than the
JAX package's (PERF.md section 6). Biases and conv kernels keep the
reference's draws: drawn as Flax draws them (zero biases, truncated conv
kernels) they moved neither that band nor the learning check beyond its
spread over seeds.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated at +-2


def dense(in_features: int, out_features: int) -> nn.Linear:
    """A Linear layer whose kernel is Flax's `lecun_normal` draw; its bias is
    PyTorch's."""
    layer = nn.Linear(in_features, out_features)
    std = math.sqrt(1.0 / in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    return layer
