"""The port's DiffWave net (`nn/diffwave.py`) against the JAX package's
`diffroll_tpu.nn.diffwave.DiffWaveNet` on the CPU: the same params (through
`state_dict_from_jax`, the upsampler's transposed kernels flipped), audio, t
and mel; f32 gates atol 1e-4, rtol 1e-3. Sizes: C=8, 3 layers, dilation
cycle 2, 12 mels, 4 mel frames (1,024 samples)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu.nn.diffwave import DiffWaveNet as JDiffWave
from diffroll_tpu.nn.diffwave import SpectrogramUpsampler as JUpsampler
from diffroll_tpu_torch.compat import state_dict_from_jax
from diffroll_tpu_torch.nn import DiffWaveNet
from diffroll_tpu_torch.nn.diffwave import SpectrogramUpsampler
from test_torch_variants import jax_params

torch.set_num_threads(1)
ATOL, RTOL = 1e-4, 1e-3
KW = dict(residual_channels=8, residual_layers=3, dilation_cycle_length=2, n_mels=12,
          max_steps=10)
B, FRAMES, L = 2, 4, 1024


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L)).astype(np.float32),
            np.array([3, 7], np.int32),
            rng.standard_normal((B, FRAMES, KW["n_mels"])).astype(np.float32))


def test_upsampler_matches_flax():
    """Both transposed convs, on random kernels and biases: the flip of the
    flax kernel and the 'SAME' padding (16x per conv, 256x in all)."""
    rng = np.random.default_rng(3)
    spec = rng.standard_normal((B, FRAMES, 12)).astype(np.float32)
    jm = JUpsampler()
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(spec))
    params = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s.shape), jnp.float32),
                          shapes)
    want = np.asarray(jm.apply(params, jnp.asarray(spec)))
    up = SpectrogramUpsampler()
    up.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = up(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape == (B, FRAMES * 256, 12)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_forward_matches_jax():
    audio, t, mel = _inputs(1)
    jm = JDiffWave(**KW)
    params = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(audio), jnp.asarray(t),
                            jnp.asarray(mel))
    params = jax_params(type("M", (), {"init": lambda self, key: params})())
    want = np.asarray(jm.apply(params, jnp.asarray(audio), jnp.asarray(t), jnp.asarray(mel)))
    net = DiffWaveNet(**KW)
    sd = state_dict_from_jax(params)
    assert sorted(sd) == sorted(net.state_dict())
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(torch.from_numpy(audio), torch.from_numpy(t).long(),
                  torch.from_numpy(mel)).numpy()
    assert got.shape == (B, L) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_zero_init_output(seed):
    """The zero-initialised head predicts exactly 0, as the JAX net does."""
    torch.manual_seed(seed)
    audio, t, mel = _inputs(seed)
    with torch.no_grad():
        out = DiffWaveNet(**KW)(torch.from_numpy(audio), torch.from_numpy(t).long(),
                                torch.from_numpy(mel))
    assert out.shape == (B, L) and torch.equal(out, torch.zeros(B, L))
