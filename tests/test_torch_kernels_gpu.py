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
from diffroll_tpu_torch.diffusion.loop import previous_timesteps, timestep_subsequence
from diffroll_tpu_torch.ops.fused_forward import _embed
from diffroll_tpu_torch.ops.sampler_kernel import (
    fused_sample, fused_sample_ref, head_weights, sampler_tables)
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig

# the module (the package re-exports a function of the same name)
tgs = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")
tgt = importlib.import_module("diffroll_tpu_torch.ops.gated_stack_train")
tgg = importlib.import_module("diffroll_tpu_torch.ops.gated_stack_grad")

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
                                   (2, 64, 64, 3, False), (2, 640, 512, 15, True),
                                   (2, 200, 64, 4, True), (3, 8, 64, 4, True),
                                   (1, 130, 128, 5, False)],
                         ids=["small", "ragged_rows", "nocond", "flagship",
                              "last_tile_crosses_T", "dilation_reaches_T", "two_rows_in_last_tile"])
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
@pytest.mark.parametrize("shape", [(3, 100, 128, 4, True), (2, 640, 512, 15, True)],
                         ids=["ragged_rows", "flagship"])
def test_stack_kernel_same_bits_every_run(cuda_f32, shape):
    """No atomics and a fixed tile order: two runs on the same inputs agree bit for bit."""
    dev = cuda_f32
    b, t, c, layers, _ = shape
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=c, residual_layers=layers,
                       frames=t).to(dev)
    w = tgs.stack_weights(tm.net)
    kw = tgs.kernel_weights(w)
    x = torch.randn(b, t, c, device=dev)
    tb = 0.1 * torch.randn(layers, b, c, device=dev)
    cond = torch.rand(b, t, 229, device=dev)
    dil = tm.config.dilations()
    with torch.no_grad():
        first = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
        torch.randn(1 << 22, device=dev)  # other work on the stream in between
        second = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _process_case(dev, guided, frames=64, c=64, layers=3, bsz=2):
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=c, residual_layers=layers,
                       frames=frames, timesteps=STEPS).to(dev)
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    task = DiffusionTask(tm, TaskConfig(timesteps=STEPS, w=0.5))
    w = tgs.stack_weights(tm.net)
    ts = timestep_subsequence(STEPS, None)
    name = "cfdg_ddpm_x0" if guided else "ddpm_x0"
    tables = torch.from_numpy(sampler_tables(task.schedule, name, ts,
                                             previous_timesteps(ts))).to(dev)
    with torch.no_grad():
        t_emb = _embed(torch.from_numpy(ts.astype("int64")).to(dev), tm.net.diffusion_embedding)
        t_bias = torch.einsum("ne,lec->nlc", t_emb, w.wt) + w.bt[None]
    x_T = torch.randn(bsz, frames, 88, device=dev)
    noise = torch.randn(STEPS, bsz, frames, 88, device=dev)
    cond = torch.rand(bsz, frames, 229, device=dev)
    return (x_T, noise, t_bias, tables, w, head_weights(tm.net), cond, tm.config.dilations(),
            guided, 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("stochastic", [True, False], ids=["noise", "no_noise"])
@pytest.mark.parametrize("guided", [True, False], ids=["guided", "unguided"])
def test_fused_sample_single_entry(cuda_f32, guided, stochastic):
    """`fused_sample` called directly, n=12: one call into the library runs
    every step (12 stack passes counted by the C entry), with and without
    noise, against the plain process on the kernels' own weight values; and
    a second run gives the same bits."""
    args = list(_process_case(cuda_f32, guided))
    if not stochastic:
        args[1] = None
    w = args[4]
    wq = w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})
    kw = tgs.kernel_weights(w)
    before = (fused_sample.launches, tgs.gated_stack.launches)
    with torch.no_grad():
        out = fused_sample(*args, stochastic, kweights=kw)
        launched = (fused_sample.launches - before[0], tgs.gated_stack.launches - before[1])
        again = fused_sample(*args, stochastic, kweights=kw)
        ref = fused_sample_ref(*args[:4], wq, *args[5:], stochastic)
    torch.cuda.synchronize()
    assert launched == (1, STEPS)
    assert torch.isfinite(out).all() and _rel(out, ref) < BF16_GATE
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="kweights"):
        fused_sample(*args, stochastic)


@pytest.mark.gpu
def test_fused_sample_ragged_frames(cuda_f32):
    """A clip whose frames do not fill the stack's 128-frame tile and a batch
    whose rows do not fill the heads' 64-row tiles."""
    args = _process_case(cuda_f32, True, frames=100, c=128, layers=4, bsz=3)
    w = args[4]
    wq = w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})
    with torch.no_grad():
        out = fused_sample(*args, True, kweights=tgs.kernel_weights(w))
        ref = fused_sample_ref(*args[:4], wq, *args[5:], True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and _rel(out, ref) < BF16_GATE


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


def _train_case(dev, shape):
    b, t, c, layers, with_cond = shape
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=c, residual_layers=layers,
                       frames=t).to(dev)
    w = tgs.stack_weights(tm.net)
    kw = tgs.kernel_weights(w)
    # the plain versions run on the kernels' own weight values
    wq = w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})
    x = torch.randn(b, t, c, device=dev)
    tb = 0.1 * torch.randn(layers, b, c, device=dev)
    cond = torch.rand(b, t, 229, device=dev) if with_cond else None
    cot = torch.randn(b, t, c, device=dev)
    return tm.config.dilations(), w, wq, kw, x, tb, cond, cot


TRAIN_SHAPES = [(2, 64, 128, 3, True), (3, 100, 128, 4, True), (1, 640, 512, 15, True),
                (2, 8, 128, 4, True), (2, 64, 128, 3, False)]
TRAIN_IDS = ["small", "ragged_T", "flagship_b1", "taps_leave_clip", "nocond"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_fwd_saves_kernel_matches_plain(cuda_f32, shape):
    """K3: skip, xs and a against the plain forward-with-saves, and the skip
    output bit-for-bit against K1 (the saves add stores, no arithmetic)."""
    dil, w, wq, kw, x, tb, cond, _ = _train_case(cuda_f32, shape)
    before = tgt.fwd_saves.launches
    with torch.no_grad():
        skip, xs, a = tgt.fwd_saves(x, tb, cond, w, dil, kweights=kw)
        skip_r, xs_r, a_r = tgt.fwd_saves_ref(x, tb, cond, wq, dil)
        k1 = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
    torch.cuda.synchronize()
    assert tgt.fwd_saves.launches == before + 1
    assert xs.dtype == a.dtype == torch.bfloat16
    assert torch.equal(skip, k1)
    for out, ref in ((skip, skip_r), (xs.float(), xs_r), (a.float(), a_r)):
        assert _rel(out, ref) < BF16_GATE
    with pytest.raises(ValueError, match="kweights"):
        tgt.fwd_saves(x, tb, cond, w, dil)


# K4 alone: five sequences of 200 frames (a second row tile of 72 frames, a
# fourth 64-frame box of 8, weight gradients in five one-sequence splits), and
# a dilation of 8 on sequences of 4 frames (every off-centre tap box is zero)
BWD_SHAPES = TRAIN_SHAPES + [(5, 200, 128, 4, True), (3, 4, 128, 4, False)]
BWD_IDS = TRAIN_IDS + ["odd_sequences_ragged_boxes", "dilation_past_T_nocond"]


@pytest.mark.gpu
@pytest.mark.parametrize("need_dcond", [True, False], ids=["dcond", "nodcond"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=BWD_IDS)
def test_bwd_kernel_matches_plain(cuda_f32, shape, need_dcond):
    """K4 against the plain backward from the same (kernel-made) saves."""
    dil, w, wq, kw, x, tb, cond, cot = _train_case(cuda_f32, shape)
    with torch.no_grad():
        _, xs, a = tgt.fwd_saves(x, tb, cond, w, dil, kweights=kw)
        before = tgt.bwd.launches
        out = tgt.bwd(dil, (tb, cond, w, xs, a), cot, need_dcond, kweights=kw)
        again = tgt.bwd(dil, (tb, cond, w, xs, a), cot, need_dcond, kweights=kw)
        ref = tgt.bwd_ref(dil, (tb, cond, wq, xs, a), cot, need_dcond)
    torch.cuda.synchronize()
    assert tgt.bwd.launches == before + 2
    assert (out[2] is None) == (cond is None or not need_dcond)

    def leaves(o):
        dx, dtb, dcond, dw = o
        named = {"dx": dx, "dtb": dtb, "dcond": dcond}
        named.update({f"d{k}": v for k, v in dw._asdict().items()})
        return {k: v for k, v in named.items() if v is not None}

    got, want, rerun = leaves(out), leaves(ref), leaves(again)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert _rel(got[name], want[name]) < BF16_GATE, name
        assert torch.equal(got[name], rerun[name]), name  # fixed summation order


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 100, 128, 4, True), (1, 640, 512, 15, True)],
                         ids=["ragged_T", "flagship_b1"])
def test_bwd_kernel_same_bits_every_run(cuda_f32, shape):
    """No atomics, partial sums added in a fixed order: two sweeps on the same
    saves, with other work on the stream in between, agree bit for bit in
    every leaf."""
    dil, w, _, kw, x, tb, cond, cot = _train_case(cuda_f32, shape)
    with torch.no_grad():
        _, xs, a = tgt.fwd_saves(x, tb, cond, w, dil, kweights=kw)
        first = tgt.bwd(dil, (tb, cond, w, xs, a), cot, True, kweights=kw)
        torch.randn(1 << 22, device=cuda_f32)
        second = tgt.bwd(dil, (tb, cond, w, xs, a), cot, True, kweights=kw)
    torch.cuda.synchronize()
    for one, two in zip((*first[:3], *first[3][:6]), (*second[:3], *second[3][:6])):
        assert torch.equal(one, two)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda", "cuda_fwd"])
def test_gated_stack_fn_routes(cuda_f32, impl):
    """GatedStackFn on CUDA tensors: the kernel routes launch their kernels
    and agree with the plain route's gradients."""
    dil, w, wq, _, x, tb, cond, cot = _train_case(cuda_f32, (2, 64, 128, 3, True))

    def grads(weights, route):
        leaves = [t.clone().requires_grad_() for t in (x, tb, *weights[:6])]
        ws = tgs.GatedStackWeights(*leaves[2:], None, None)
        out = tgg.gated_stack_trainable(leaves[0], leaves[1], cond, ws, dil, route, False)
        return torch.autograd.grad((out * cot).sum(), leaves)

    before = (tgt.fwd_saves.launches, tgt.bwd.launches)
    got = grads(w, impl)
    launched = (tgt.fwd_saves.launches - before[0], tgt.bwd.launches - before[1])
    assert launched == ((1, 1) if impl == "cuda" else (1, 0))
    for g, r in zip(got, grads(wq, "plain")):
        assert _rel(g, r) < BF16_GATE
