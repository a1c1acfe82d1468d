"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no jax, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(`--noconftest` skips tests/conftest.py, which sets up the JAX package's
CPU mesh.) Every test skips without a CUDA card. The plain versions run in
full f32: TF32 is off for matmul and cuDNN while a test runs. Gate: the bf16
kernels' max|d| / max|ref| < 0.05 (tests/test_ops.py,
tests/test_sampler_kernel.py).
"""

import importlib

import pytest
import torch

from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.ops.sampler_kernel import fused_sample
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig

# the module (the package re-exports a function of the same name)
tgs = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")

BF16_GATE = 0.05
STEPS = 12


@pytest.fixture
def cuda_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_kernels_gpu.py on one)")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 64, 3, True), (3, 100, 128, 4, True),
                                   (2, 64, 64, 3, False), (2, 640, 512, 15, True)],
                         ids=["small", "ragged_rows", "nocond", "flagship"])
def test_stack_kernel_matches_plain(cuda_f32, shape):
    dev = cuda_f32
    b, t, c, layers, with_cond = shape
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=c, residual_layers=layers,
                       frames=t).to(dev)
    w = tgs.stack_weights(tm.net)
    x = torch.randn(b, t, c, device=dev)
    tb = 0.1 * torch.randn(layers, b, c, device=dev)
    cond = torch.rand(b, t, 229, device=dev) if with_cond else None
    dil = tm.config.dilations()
    before = tgs.gated_stack.launches
    with torch.no_grad():
        out = tgs.gated_stack(x, tb, cond, w, dil, kweights=tgs.kernel_weights(w))
        ref = tgs.gated_stack_ref(x, tb, cond, w, dil)
    torch.cuda.synchronize()
    assert tgs.gated_stack.launches == before + 1
    assert _rel(out, ref) < BF16_GATE
    with pytest.raises(ValueError, match="kweights"):  # no silent per-call rebuild
        tgs.gated_stack(x, tb, cond, w, dil)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["megakernel", "step_loop"])
@pytest.mark.parametrize("name,steps,w", [("cfdg_ddpm_x0", None, 0.5), ("ddpm_x0", None, 0.0),
                                          ("cfdg_ddim_x0", 5, 0.5), ("ddpm", None, 0.0)],
                         ids=["guided", "unguided", "deterministic", "epsilon"])
def test_sampler_kernels_match_plain(cuda_f32, name, steps, w, route):
    """The whole reverse process at B=2 (two windows, four CFG streams):
    the sampler kernel (`use_megakernel` on) or the step loop with K1 per
    step, against the plain module path in f32."""
    dev = cuda_f32
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=64, residual_layers=3,
                       frames=64, timesteps=STEPS).to(dev)
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    x_T = torch.randn(2, 64, 88, device=dev)
    wav = 0.1 * torch.randn(2, 64 * 512, device=dev)
    n = STEPS if steps is None else steps
    noise = torch.randn(n, 2, 64, 88, device=dev)
    base = TaskConfig(timesteps=STEPS, sampling_type=name, w=w, sampling_steps=steps)
    before = (fused_sample.launches, tgs.gated_stack.launches)
    out = DiffusionTask(tm, base.replace(use_megakernel=route == "megakernel")).sample(
        x_T, waveform=wav, noise=noise)[0]
    launched = (fused_sample.launches - before[0], tgs.gated_stack.launches - before[1])
    assert launched == ((1, n) if route == "megakernel" else (0, n))
    plain = DiffusionTask(tm, base.replace(use_fused=False, use_megakernel=False)).sample(
        x_T, waveform=wav, noise=noise)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and _rel(out, plain) < BF16_GATE
