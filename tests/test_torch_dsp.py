"""The port's log-mel front-end (torch.stft) and min-max normalisation
against the JAX package's `fft` mel path, on the same seeded waveforms.
Tolerance atol 1e-4, rtol 1e-3: both sides are float32 FFTs with their own
summation orders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffroll_tpu import models as jmodels
from diffroll_tpu.dsp.mel import MelConfig as JMelConfig
from diffroll_tpu.dsp.mel import MelSpectrogram as JMel
from diffroll_tpu.dsp.mel import log_mel as j_log_mel
from diffroll_tpu.dsp.normalize import min_max_normalize as j_norm
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.dsp.mel import MelConfig as TMelConfig
from diffroll_tpu_torch.dsp.mel import MelSpectrogram as TMel
from diffroll_tpu_torch.dsp.mel import hann_window, log_mel as t_log_mel, mel_filterbank
from diffroll_tpu_torch.dsp.normalize import min_max_normalize as t_norm

torch.set_num_threads(1)
ATOL, RTOL = 1e-4, 1e-3
SR, HOP = 16000, 512


def _waves(seed: int, frames: int = 24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = frames * HOP
    t = np.arange(n) / SR
    tone = 0.3 * np.sin(2 * np.pi * 261.63 * t) + 0.2 * np.sin(2 * np.pi * 659.25 * t)
    return np.stack([0.1 * rng.standard_normal(n), tone]).astype(np.float32)


def test_filterbank_and_window_match_numpy_math():
    from diffroll_tpu.dsp import mel as jm

    np.testing.assert_array_equal(mel_filterbank(1025, 0.0, 8000.0, 229, SR),
                                  jm.mel_filterbank(1025, 0.0, 8000.0, 229, SR))
    np.testing.assert_array_equal(hann_window(2048), jm.hann_window(2048))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg_kw", [{}, {"win_length": 1024}, {"f_max": None}],
                         ids=["default", "short_window", "full_band"])
def test_log_mel_matches_jax_fft_path(seed, cfg_kw):
    wav = _waves(seed)
    j = np.asarray(j_log_mel(JMel(JMelConfig(method="fft", **cfg_kw))(jnp.asarray(wav))))
    t = t_log_mel(TMel(TMelConfig(**cfg_kw))(torch.from_numpy(wav))).numpy()
    assert t.shape == j.shape == (2, 25, 229)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["imagewise", "framewise"])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0)])
def test_min_max_normalize_matches(mode, lo, hi):
    x = np.random.default_rng(3).standard_normal((3, 16, 12)).astype(np.float32)
    x[1] = 2.5                  # constant sample -> lo (imagewise)
    x[2, 4] = -0.5              # constant frame -> lo (framewise)
    j = np.asarray(j_norm(jnp.asarray(x), lo, hi, mode))
    t = t_norm(torch.from_numpy(x), lo, hi, mode).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        t_norm(torch.from_numpy(x), lo, hi, "bogus")


@pytest.mark.parametrize("inpaint", [None, ((4, 12), None), (None, (100, 229))],
                         ids=["none", "time", "freq"])
def test_conditioner_matches(inpaint):
    """waveform -> log-mel -> min-max [0, 1] -> trim to the roll grid ->
    inpainting mask, through both packages' model.conditioner."""
    frames = 24
    wav = _waves(5, frames)
    kw = dict(residual_channels=16, residual_layers=2, frames=frames, timesteps=10)
    it, f = inpaint or (None, None)
    j = np.asarray(jmodels.build("ClassifierFreeDiffRoll", **kw).conditioner(
        waveform=jnp.asarray(wav), inpainting_t=it, inpainting_f=f))
    t = tmodels.build("ClassifierFreeDiffRoll", **kw).conditioner(
        waveform=torch.from_numpy(wav), inpainting_t=it, inpainting_f=f).numpy()
    assert t.shape == j.shape == (2, frames, 229)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)
