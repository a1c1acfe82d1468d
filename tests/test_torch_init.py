"""The port's dense (Linear) kernels are drawn as the JAX package draws them
(`diffroll_tpu_torch/nn/init.py`): Flax's LeCun-normal, variance 1 / fan_in,
truncated at two standard deviations. PyTorch's kaiming-uniform draw has a
third of that variance.

The 1-D and 2-D DiffRoll nets are held against the JAX package's own
`model.init`, dense kernel by dense kernel (carried over with
`state_dict_from_jax`): the spread within 10% and no value past the
truncation bound. The U-Nets and DiffWave, whose JAX init takes long to
compile, are held against Flax's rule."""

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


def _check(name, got, want_std):
    got = got.detach().numpy()
    std = float(got.std())
    assert abs(std / want_std - 1.0) < 0.1, (name, std, want_std)
    assert float(np.abs(got).max()) <= BOUND * want_std * 1.1, name


def _dense(net: nn.Module):
    return [(f"{n}.weight", m.weight) for n, m in net.named_modules()
            if isinstance(m, nn.Linear)]


@pytest.mark.parametrize("preset", ["ClassifierFreeDiffRoll", "DiffRollv2"])
def test_diffroll_dense_kernels_start_as_the_jax_package_draws_them(preset):
    size = dict(residual_channels=32, residual_layers=2, frames=32, timesteps=10)
    params = jmodels.build(preset, **size).init(jax.random.key(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, params))
    torch.manual_seed(0)
    dense = _dense(tmodels.build(preset, **size).net)
    assert len(dense) == 2 + size["residual_layers"]   # the embedding's MLP, each block's
    for name, weight in dense:
        _check(name, weight, float(want[name].numpy().std()))


@pytest.mark.parametrize("preset", ["Unet", "SpecUnet", "DiffWave"])
def test_other_dense_kernels_start_from_flax_lecun_normal(preset):
    torch.manual_seed(0)
    net = (DiffWaveNet(residual_channels=16, residual_layers=2) if preset == "DiffWave"
           else tmodels.build(preset, residual_channels=16).net)
    dense = _dense(net)
    assert len(dense) >= 4
    for name, weight in dense:
        _check(name, weight, math.sqrt(1.0 / weight.shape[1]))
