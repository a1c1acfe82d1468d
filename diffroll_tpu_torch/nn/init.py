"""The JAX package's initial weight distributions, drawn by the port's layers.

The JAX package builds its layers with Flax's initialisers: every bias
zero; dense kernels, and the U-Nets' and the spectrogram upsampler's conv
and transposed-conv kernels, LeCun-normal (variance 1 / fan_in); the
DiffRoll and DiffWave conv kernels he-normal (variance 2 / fan_in,
`diffroll_tpu/nn/resblock.py` `_conv_init`); both normals truncated at two
standard deviations and rescaled to that variance. The output heads start
at zero in both packages. PyTorch's own defaults, which the reference uses
(uniform biases, kaiming-uniform dense kernels, untruncated kaiming-normal
conv kernels), trained p=0.1 twins that inpainted a third worse inside a
band than the JAX package's (PERF.md section 6).

Each layer makes PyTorch's default draw first and these draws overwrite
it, so the random stream a seed gives is the one the port's recorded
readings were trained from.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated at +-2


def _fan_in(layer: nn.Module) -> int:
    """Flax's fan-in of the layer's kernel: its input features times its
    receptive field (a transposed conv's weight is (in, out, *k))."""
    w = layer.weight
    if isinstance(layer, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
        return w.shape[0] * math.prod(w.shape[2:])
    return w[0].numel()


@torch.no_grad()
def _flax_init(layer: nn.Module, scale: float) -> nn.Module:
    std = math.sqrt(scale / _fan_in(layer)) / _TRUNC_STD
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer


def he_normal(layer: nn.Module) -> nn.Module:
    """`layer` with Flax's `he_normal` kernel (variance 2 / fan_in) and a
    zero bias."""
    return _flax_init(layer, 2.0)


def lecun_normal(layer: nn.Module) -> nn.Module:
    """`layer` with Flax's `lecun_normal` kernel (variance 1 / fan_in, its
    default for `nn.Dense`, `nn.Conv` and `nn.ConvTranspose`) and a zero
    bias."""
    return _flax_init(layer, 1.0)


def dense(in_features: int, out_features: int) -> nn.Linear:
    """A Linear layer drawn as Flax draws `nn.Dense`."""
    return lecun_normal(nn.Linear(in_features, out_features))
