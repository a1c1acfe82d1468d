"""The plain reference against the port's plain CPU path at a tiny width: the
front end, the denoiser, the sampler, the long-audio windowing and
crossfade, the note decoder, and the training loss with its gradients. The
test imports the port; the reference does not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import inputs, port, weights
from bench_port.reference import diffroll as ref
from bench_port.trace import Trace, kernel_base

from .conftest import tiny_config

CONFIGS = ["ClassifierFreeDiffRoll", "DiffRoll"]


def _model(name: str, seed: int = 7):
    cfg = tiny_config(name)
    params = weights.make(port.model_shapes(cfg), seed, torch.device("cpu"))
    return cfg, params, port.build_model(cfg, torch.device("cpu"), params).eval()


def _wave(cfg, batch: int, seed: int = 3) -> torch.Tensor:
    n = cfg["frames"] * cfg["mel"]["hop_length"]
    return torch.from_numpy(np.stack([inputs.chord_audio(n / 16000, 16000, seed + i)
                                      for i in range(batch)]))


@pytest.mark.parametrize("name", CONFIGS)
def test_conditioner(name):
    cfg, _, model = _model(name)
    wave = _wave(cfg, 2)
    torch.testing.assert_close(ref.conditioner(wave, cfg), model.conditioner(waveform=wave),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_denoiser(name):
    cfg, params, model = _model(name)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, cfg["frames"], 88, generator=g)
    t = torch.tensor([0, 2, cfg["timesteps"] - 1])
    cond = torch.rand(3, cfg["frames"], cfg["n_mels"], generator=g)
    net = ref.Denoiser(params, cfg)
    with torch.no_grad():
        torch.testing.assert_close(net(x, t, net.cond_terms(cond)), model.apply(x, t, cond),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_sampler_on_the_same_draws(name):
    cfg, params, model = _model(name)
    task = port.build_task(cfg, model)
    wave = _wave(cfg, 2)
    g = torch.Generator().manual_seed(11)
    x_T = torch.randn(2, cfg["frames"], 88, generator=g)
    noise = torch.randn(cfg["timesteps"], 2, cfg["frames"], 88, generator=g)
    got, _ = task.sample(x_T, waveform=wave, noise=noise)
    with torch.no_grad():
        want = ref.sample(ref.Denoiser(params, cfg), cfg, x_T, noise, ref.conditioner(wave, cfg))
    torch.testing.assert_close(want, got, atol=1e-4, rtol=1e-4)


def test_windows_and_stitch():
    from diffroll_tpu_torch.tasks.transcribe import split_windows, stitch_rolls

    audio = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    for seq, stride in ((32768, 32768 - 8 * 512), (32768, 32768)):
        overlap = (seq - stride) // 512
        assert np.array_equal(ref.windows(audio, seq, stride),
                              split_windows(audio, seq, 512, overlap))
        rolls = np.random.default_rng(1).random((5, 64, 88))
        np.testing.assert_allclose(ref.stitch(rolls, overlap, 290),
                                   stitch_rolls(rolls, overlap, 290), atol=1e-12)


def test_note_decoder():
    from diffroll_tpu_torch.eval.notes import extract_notes

    roll = np.random.default_rng(2).random((400, 88))
    keys, spans = extract_notes(roll, roll, 0.5, 0.5)
    theirs = {(int(k), int(a), int(b)) for k, (a, b) in zip(keys, spans)}
    assert {tuple(r) for r in ref.notes(roll, 0.5)} == theirs
    assert ref.notes(np.zeros((10, 88)), 0.5).shape == (0, 3)


@pytest.mark.parametrize("name", CONFIGS)
def test_training_loss_and_gradients(name):
    cfg, params, model = _model(name)
    task = port.build_task(cfg, model, fused_train=True)
    g = torch.Generator().manual_seed(13)
    b = 3
    frame = (torch.rand(b, cfg["frames"], 88, generator=g) < 0.1).float()
    audio = 0.1 * torch.randn(b, cfg["frames"] * 512, generator=g)
    t = torch.randint(0, cfg["timesteps"], (b,), generator=g)
    noise = torch.randn(b, cfg["frames"], 88, generator=g)
    mask = torch.zeros(b, dtype=torch.bool)
    model.train()
    loss, _ = task.loss_fn({"frame": frame, "audio": audio}, None, True, t=t, noise=noise,
                           uncond_mask=mask)
    loss.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = ref.train_loss(ref.Denoiser(leaves, cfg), cfg, audio, frame, t, noise)
    grads = torch.autograd.grad(want, list(leaves.values()))
    torch.testing.assert_close(loss, want, atol=1e-6, rtol=1e-5)
    named = {f"net.{k}": p.grad for k, p in model.net.named_parameters()}
    for k, gr in zip(leaves, grads):
        torch.testing.assert_close(named[k], gr, atol=1e-6, rtol=1e-4)


def test_fp8_control_differs_and_rounds_its_gradients():
    x = torch.linspace(-3, 3, 1000, requires_grad=True)
    y = ref._Fp8.apply(x)
    assert 0 < float((y - x).detach().abs().max()) < 0.2
    g = torch.linspace(0.1, 1.0, 1000)
    y.backward(g)
    rel = ((x.grad - g) / g).abs()
    assert 0 < float(rel.max()) <= 0.125   # e5m2 keeps two mantissa bits


def test_adam_update_matches_torch():
    p = torch.randn(10, requires_grad=True)
    opt = torch.optim.Adam([p], lr=1e-3)
    mine, state = {"p": p.detach().clone()}, {}
    for step in range(1, 4):
        g = torch.randn(10, generator=torch.Generator().manual_seed(step))
        p.grad = g.clone()
        opt.step()
        ref.adam_update(mine, {"p": g}, state, step, 1e-3)
    torch.testing.assert_close(mine["p"], p.detach(), atol=1e-7, rtol=1e-6)


def test_trace_reader_on_a_made_trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.stretch", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "void gate_kernel<true>(CUtensorMap)",
           "ts": 10, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "out_kernel(OutArgs)", "ts": 35, "dur": 15},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 50, "dur": 30}]
    tr = Trace(ev)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.seconds_by_base() == pytest.approx(
        {"gate_kernel": 30e-6, "out_kernel": 15e-6, "Memcpy DtoH": 10e-6})
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("void gate_kernel")
    assert dict(bd["idle_gaps"])["aten::copy_"] == pytest.approx(30e-6)
    assert kernel_base("void nt_kernel<DgEpi>(CUtensorMap, NtArgs, DgEpi)") == "nt_kernel"
