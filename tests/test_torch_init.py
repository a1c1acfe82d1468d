"""The port's nets start from the JAX package's initial weight distributions
(`diffroll_tpu_torch/nn/init.py`): every bias zero, dense kernels
LeCun-normal, the DiffRoll and DiffWave conv kernels he-normal, the U-Nets'
and the upsamplers' conv kernels LeCun-normal, each normal truncated at two
standard deviations, the output heads zero.

The 1-D and 2-D DiffRoll nets are held against the JAX package's own
`model.init`, parameter by parameter (carried over with
`state_dict_from_jax`): the same zeros, and for every kernel of 256 values
or more the spread within 10% and no value past the truncation bound. The
U-Nets and DiffWave, whose JAX init takes long to compile, are held against
Flax's rule for each layer."""

import math

import jax
import numpy as np
import pytest
import torch
from torch import nn

from diffroll_tpu import models as jmodels
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.compat import state_dict_from_jax
from diffroll_tpu_torch.nn import DiffWaveNet

# a unit normal truncated at +-2 and rescaled to unit variance reaches 2 / 0.8796
BOUND = 2.0 / 0.87962566103423978


def _check(name, got, want_std, zero):
    got = got.detach().numpy()
    if zero:
        assert not got.any(), f"{name} starts at zero in the JAX package"
        return
    if got.size >= 256:  # a spread and a largest value a sample this size pins down
        std = float(got.std())
        assert abs(std / want_std - 1.0) < 0.1, (name, std, want_std)
        assert float(np.abs(got).max()) <= BOUND * want_std * 1.1, name


@pytest.mark.parametrize("preset", ["ClassifierFreeDiffRoll", "DiffRollv2"])
def test_diffroll_nets_start_as_the_jax_package_does(preset):
    size = dict(residual_channels=32, residual_layers=2, frames=32, timesteps=10)
    params = jmodels.build(preset, **size).init(jax.random.key(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, params))
    torch.manual_seed(0)
    got = dict(tmodels.build(preset, **size).net.named_parameters())
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        ref = ref.numpy()
        _check(name, got[name], float(ref.std()), zero=not ref.any())


def _flax_rule(net: nn.Module, conv_scale: float):
    """(name, parameter, the std Flax draws it with, whether it starts at 0)
    for every kernel and bias of `net`'s dense, conv and transposed-conv
    layers: dense and transposed-conv kernels LeCun, conv kernels with
    variance `conv_scale` / fan_in."""
    for mname, m in net.named_modules():
        if not isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            continue
        transposed = isinstance(m, nn.ConvTranspose2d)
        w = m.weight
        fan_in = w.shape[0] * math.prod(w.shape[2:]) if transposed else w[0].numel()
        scale = conv_scale if isinstance(m, (nn.Conv1d, nn.Conv2d)) else 1.0
        head = mname == "output_projection"   # zero-initialised in both packages
        yield f"{mname}.weight", w, math.sqrt(scale / fan_in), head
        if m.bias is not None:
            yield f"{mname}.bias", m.bias, 0.0, True


@pytest.mark.parametrize("preset", ["Unet", "SpecUnet", "DiffWave"])
def test_other_nets_start_from_flax_distributions(preset):
    torch.manual_seed(0)
    if preset == "DiffWave":
        net, conv_scale = DiffWaveNet(residual_channels=16, residual_layers=2), 2.0
    else:
        net, conv_scale = tmodels.build(preset, residual_channels=16).net, 1.0
    checked = list(_flax_rule(net, conv_scale))
    assert len(checked) > 10
    for name, param, std, zero in checked:
        _check(name, param, std, zero)
