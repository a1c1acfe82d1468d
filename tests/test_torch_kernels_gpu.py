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
from diffroll_tpu_torch.ops.sampler_kernel import fused_sample, fused_sample_ref
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
from diffroll_tpu_torch.tasks.transcribe import transcribe_long

# the module (the package re-exports a function of the same name)
tgs = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")
tgt = importlib.import_module("diffroll_tpu_torch.ops.gated_stack_train")
tgg = importlib.import_module("diffroll_tpu_torch.ops.gated_stack_grad")
tgn = importlib.import_module("diffroll_tpu_torch.ops.group_norm")

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
                                   (1, 130, 128, 5, False), (8, 640, 512, 15, True),
                                   (140, 100, 128, 4, True), (300, 8, 64, 4, True)],
                         ids=["small", "ragged_rows", "nocond", "flagship",
                              "last_tile_crosses_T", "dilation_reaches_T", "two_rows_in_last_tile",
                              "flagship_b8", "ragged_rows_ping_pong",
                              "dilation_reaches_T_ping_pong"])
def test_stack_kernel_matches_plain(cuda_f32, shape):
    """K1 against its plain version; the `_ping_pong` shapes give 280 and 300
    tiles, so blocks walk two or three tiles and hand the tensor cores from
    one consumer warpgroup to the other (ragged 100-frame tiles, taps that
    leave the 8-frame clip)."""
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
@pytest.mark.parametrize("shape", [(3, 100, 128, 4, True), (2, 640, 512, 15, True),
                                   (8, 640, 512, 15, True), (16, 640, 512, 15, True),
                                   (140, 100, 128, 4, True)],
                         ids=["ragged_rows", "flagship", "flagship_s8", "flagship_s16",
                              "ragged_rows_ping_pong"])
def test_stack_kernel_same_bits_every_run(cuda_f32, shape):
    """No atomics and a fixed tile order: two runs on the same inputs agree bit
    for bit, with a block holding one tile (80 tiles at S=2), two or three
    (320 at S=8) and four or five (640 at S=16) on the card's 132 SMs."""
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
    name = "cfdg_ddpm_x0" if guided else "ddpm_x0"
    so = DiffusionTask(tm, TaskConfig(timesteps=STEPS, sampling_type=name,
                                      w=0.5)).sampler_operands()
    x_T = torch.randn(bsz, frames, 88, device=dev)
    noise = torch.randn(STEPS, bsz, frames, 88, device=dev)
    cond = torch.rand(bsz, frames, 229, device=dev)
    return (x_T, noise, so.t_bias, so.tables, so.operands.weights, so.operands.head, cond,
            tm.config.dilations(), guided, 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("stochastic", [True, False], ids=["noise", "no_noise"])
@pytest.mark.parametrize("guided", [True, False], ids=["guided", "unguided"])
def test_fused_sample_single_entry(cuda_f32, guided, stochastic):
    """`fused_sample` called directly, n=12: one call into the library runs
    every step (12 stack passes counted), with and without noise, against
    the plain process on the kernels' own weight values; and a second run
    gives the same bits."""
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
@pytest.mark.parametrize("shape", TRAIN_SHAPES + [(16, 640, 512, 15, True)],
                         ids=TRAIN_IDS + ["flagship_b16"])
def test_fwd_saves_kernel_matches_plain(cuda_f32, shape):
    """K3: skip, xs and a against the plain forward-with-saves, and the skip
    output bit-for-bit against K1 (the saves add stores, no arithmetic); at
    B=16, 640 tiles on the ping-pong schedule."""
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
def test_gated_stack_fn_routes(cuda_f32):
    """GatedStackFn on CUDA tensors: the kernel route launches K3 and K4 and
    agrees with the plain route's gradients."""
    dil, w, wq, _, x, tb, cond, cot = _train_case(cuda_f32, (2, 64, 128, 3, True))

    def grads(weights, route):
        leaves = [t.clone().requires_grad_() for t in (x, tb, *weights[:6])]
        ws = tgs.GatedStackWeights(*leaves[2:], None, None)
        out = tgg.gated_stack_trainable(leaves[0], leaves[1], cond, ws, dil, route, False)
        return torch.autograd.grad((out * cot).sum(), leaves)

    before = (tgt.fwd_saves.launches, tgt.bwd.launches)
    got = grads(w, "cuda")
    launched = (tgt.fwd_saves.launches - before[0], tgt.bwd.launches - before[1])
    assert launched == (1, 1)
    for g, r in zip(got, grads(wq, "plain")):
        assert _rel(g, r) < BF16_GATE


@pytest.mark.gpu
def test_stack_kernel_on_generation_rows(cuda_f32):
    """K1 as generation runs it: 8 unguided sequences of the flagship whose
    conditioner is spec := -1 everywhere."""
    dev = cuda_f32
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll").to(dev)
    w = tgs.stack_weights(tm.net)
    x = torch.randn(8, 640, 512, device=dev)
    tb = 0.1 * torch.randn(15, 8, 512, device=dev)
    cond = torch.full((8, 640, 229), -1.0, device=dev)
    dil = tm.config.dilations()
    with torch.no_grad():
        out = tgs.gated_stack(x, tb, cond, w, dil, kweights=tgs.kernel_weights(w))
        ref = tgs.gated_stack_ref(x, tb, cond, w, dil)
    torch.cuda.synchronize()
    assert _rel(out, ref) < BF16_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("name,steps", [("cfdg_ddpm_x0", None), ("generation_ddpm_x0", None),
                                        ("cfdg_ddim_x0", 5)],
                         ids=["guided", "generation", "deterministic"])
def test_fused_sample_flagship_batch8(cuda_f32, name, steps):
    """K2 at the flagship's widths and B=8 (the test and serving batch:
    10,240 rows a stream), guided (S=2), unguided generation (S=1, spec := -1)
    and deterministic (no noise): against the plain process on the kernels'
    own weight values, the same bits on a second run, and the task's route
    gives the kernel's result; then the step loop (K1 per step) against the
    same plain trajectory."""
    dev = cuda_f32
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", timesteps=STEPS).to(dev)
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    cfg = TaskConfig(timesteps=STEPS, sampling_type=name, sampling_steps=steps, w=0.5)
    task = DiffusionTask(tm, cfg)
    generation = name.startswith("generation")
    x_T = torch.randn(8, 640, 88, device=dev)
    wav = None if generation else 0.1 * torch.randn(8, 640 * 512, device=dev)
    with torch.no_grad():
        so = task.sampler_operands()
        w, head, kw = so.operands.weights, so.operands.head, so.operands.kernel
        tables, t_bias, stochastic = so.tables, so.t_bias, so.stochastic
        noise = torch.randn(tables.shape[0], 8, 640, 88, device=dev) if stochastic else None
        cond = (torch.full((8, 640, 229), -1.0, device=dev) if generation
                else tm.conditioner(waveform=wav))
        args = (x_T, noise, t_bias, tables, w, head, cond, tm.config.dilations(),
                not generation, 0.5, stochastic)
        wq = w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})
        before = (fused_sample.launches, tgs.gated_stack.launches)
        out = fused_sample(*args, kweights=kw)
        again = fused_sample(*args, kweights=kw)
        ref = fused_sample_ref(x_T, noise, t_bias, tables, wq, *args[5:])
    via_task = task.sample(x_T, waveform=wav, noise=noise)[0]
    n = tables.shape[0]
    loop = DiffusionTask(tm, cfg.replace(use_megakernel=False)).sample(
        x_T, waveform=wav, noise=noise)[0]
    launched = (fused_sample.launches - before[0], tgs.gated_stack.launches - before[1])
    torch.cuda.synchronize()
    assert stochastic == (name != "cfdg_ddim_x0")
    assert launched == (3, 4 * n)  # three reverse processes, then the loop's n passes
    assert torch.isfinite(out).all() and _rel(out, ref) < BF16_GATE
    assert torch.equal(out, again) and torch.equal(via_task, out)
    assert _rel(loop, ref) < BF16_GATE


@pytest.mark.gpu
def test_transcribe_long_on_the_card_at_batch8(cuda_f32):
    """Eight windows of one recording through `transcribe_long` in one batch
    of 8 (K2 at B=8) against the step loop on the same draws."""
    dev = cuda_f32
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=128, residual_layers=4,
                       timesteps=STEPS).to(dev)
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    audio = (0.1 * torch.randn(8 * 640 * 512 - 7 * 32 * 512)).numpy()
    rolls = []
    for mk in (True, False):
        task = DiffusionTask(tm, TaskConfig(timesteps=STEPS, w=0.5, use_megakernel=mk))
        before = fused_sample.launches
        rolls.append(transcribe_long(task, audio, torch.Generator(device=dev).manual_seed(1),
                                     batch_size=8, overlap_frames=32))
        assert fused_sample.launches - before == (1 if mk else 0)
    assert rolls[0].shape == (8 * 640 - 7 * 32, 88)
    ref = torch.from_numpy(rolls[1])
    assert _rel(torch.from_numpy(rolls[0]), ref) < BF16_GATE


# ---- the other 1-d presets that `supports_fused` admits, at their own widths:
# DiffRoll (512 x 15, every dilation 1, T = 500: K2's tables and t_bias have
# 500 rows) and DiffRollDebug (256 x 30, every dilation 1, T = 500, the 88-lane
# roll conditioner padded to 256)
PRESETS_1D = ["DiffRoll", "DiffRollDebug"]


def _preset_case(dev, name, b=2):
    torch.manual_seed(0)
    tm = tmodels.build(name).to(dev)
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    mc = tm.config
    assert set(mc.dilations()) == {1} and mc.timesteps == 500
    w = tgs.stack_weights(tm.net)
    kw = tgs.kernel_weights(w)
    wq = w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})
    c = mc.residual_channels
    x = torch.randn(b, mc.frames, c, device=dev)
    tb = 0.1 * torch.randn(mc.residual_layers, b, c, device=dev)
    # a spectrogram in [0, 1], or for the debug model a piano roll
    cond = (torch.rand(b, mc.frames, mc.n_mels, device=dev) if mc.cond_source == "spec"
            else (torch.rand(b, mc.frames, mc.n_mels, device=dev) > 0.9).float())
    cot = torch.randn(b, mc.frames, c, device=dev)
    return tm, w, wq, kw, x, tb, cond, cot


@pytest.mark.gpu
@pytest.mark.parametrize("name", PRESETS_1D)
def test_presets_stack_kernel(cuda_f32, name):
    """K1 at the preset's widths against its plain version, and the same bits
    on a second run."""
    tm, w, wq, kw, x, tb, cond, _ = _preset_case(cuda_f32, name)
    dil = tm.config.dilations()
    assert kw.mp == 256  # 229 or 88 lanes, zero-padded
    with torch.no_grad():
        out = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
        again = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
        ref = tgs.gated_stack_ref(x, tb, cond, wq, dil)
    torch.cuda.synchronize()
    assert _rel(out, ref) < BF16_GATE and torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["cfdg_ddpm_x0", "ddim_x0"], ids=["guided", "unguided"])
@pytest.mark.parametrize("name", PRESETS_1D)
def test_presets_fused_sample(cuda_f32, name, sampler):
    """K2 over all 500 steps (guided with noise; unguided without, as a
    distilled student samples) against the plain process on the kernels'
    weight values, the same bits on a second run."""
    dev = cuda_f32
    tm, w, wq, kw, _, _, cond, _ = _preset_case(dev, name, b=1)
    task = DiffusionTask(tm, TaskConfig(timesteps=500, sampling_type=sampler, w=0.5))
    with torch.no_grad():
        so = task.sampler_operands()
        w, head, kw = so.operands.weights, so.operands.head, so.operands.kernel
        tables, t_bias, stochastic = so.tables, so.t_bias, so.stochastic
        assert tables.shape == (500, 3) and t_bias.shape[0] == 500
        assert stochastic == (sampler == "cfdg_ddpm_x0")
        x_T = torch.randn(1, tm.config.frames, 88, device=dev)
        noise = torch.randn(500, 1, tm.config.frames, 88, device=dev) if stochastic else None
        args = (x_T, noise, t_bias, tables, w, head, cond, tm.config.dilations(),
                sampler == "cfdg_ddpm_x0", 0.5, stochastic)
        before = fused_sample.launches
        out = fused_sample(*args, kweights=kw)
        again = fused_sample(*args, kweights=kw)
        ref = fused_sample_ref(x_T, noise, t_bias, tables, wq, *args[5:])
    torch.cuda.synchronize()
    assert fused_sample.launches == before + 2
    assert torch.isfinite(out).all() and _rel(out, ref) < BF16_GATE
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("name", PRESETS_1D)
def test_presets_training_kernels(cuda_f32, name):
    """K3 (skip, xs, a; skip bit for bit K1's) and K4 (every leaf, with and
    without dcond) at the preset's widths, each against its plain version and
    the same bits on a second run."""
    tm, w, wq, kw, x, tb, cond, cot = _preset_case(cuda_f32, name)
    dil = tm.config.dilations()
    with torch.no_grad():
        skip, xs, a = tgt.fwd_saves(x, tb, cond, w, dil, kweights=kw)
        skip_r, xs_r, a_r = tgt.fwd_saves_ref(x, tb, cond, wq, dil)
        k1 = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
    torch.cuda.synchronize()
    assert torch.equal(skip, k1)
    for out, ref in ((skip, skip_r), (xs.float(), xs_r), (a.float(), a_r)):
        assert _rel(out, ref) < BF16_GATE

    def leaves(o):
        dx, dtb, dcond, dw = o
        named = {"dx": dx, "dtb": dtb, "dcond": dcond}
        named.update({f"d{k}": v for k, v in dw._asdict().items()})
        return {k: v for k, v in named.items() if v is not None}

    for need_dcond in (True, False):
        with torch.no_grad():
            got = leaves(tgt.bwd(dil, (tb, cond, w, xs, a), cot, need_dcond, kweights=kw))
            rerun = leaves(tgt.bwd(dil, (tb, cond, w, xs, a), cot, need_dcond, kweights=kw))
            want = leaves(tgt.bwd_ref(dil, (tb, cond, wq, xs, a), cot, need_dcond))
        torch.cuda.synchronize()
        assert got.keys() == want.keys() and ("dcond" in got) == need_dcond
        for leaf in want:
            assert _rel(got[leaf], want[leaf]) < BF16_GATE, (need_dcond, leaf)
            assert torch.equal(got[leaf], rerun[leaf]), (need_dcond, leaf)


# ---- the learning check's twin (diffroll_tpu_torch/quality/synthetic_end_to_end.py):
# 128 channels x 8 layers, dilations 1-2-4-8, 128-frame sequences (one row tile
# a sequence, the dilation halo at both ends of the same tile), T=100, B=8 (16
# sequences when guided)
TWIN = dict(residual_channels=128, residual_layers=8, frames=128, timesteps=100)


def _twin_case(dev, b):
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", **TWIN).to(dev)
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    w = tgs.stack_weights(tm.net)
    kw = tgs.kernel_weights(w)
    wq = w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})
    x = torch.randn(b, 128, 128, device=dev)
    tb = 0.1 * torch.randn(8, b, 128, device=dev)
    cond = torch.rand(b, 128, 229, device=dev)
    cot = torch.randn(b, 128, 128, device=dev)
    return tm, w, wq, kw, x, tb, cond, cot


@pytest.mark.gpu
def test_twin_stack_kernel(cuda_f32):
    """K1 at the twin's widths over the 16 sequences of a guided B=8 step."""
    tm, w, wq, kw, x, tb, cond, _ = _twin_case(cuda_f32, 16)
    dil = tm.config.dilations()
    assert dil == (1, 2, 4, 8, 1, 2, 4, 8) and kw.mp == 256
    with torch.no_grad():
        out = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
        again = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
        ref = tgs.gated_stack_ref(x, tb, cond, wq, dil)
    torch.cuda.synchronize()
    assert _rel(out, ref) < BF16_GATE and torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("name,steps", [("cfdg_ddpm_x0", None), ("cfdg_ddim_x0", 25)],
                         ids=["guided_100", "ddim_25"])
def test_twin_fused_sample_batch8(cuda_f32, name, steps):
    """K2 at the twin's widths and B=8 (the learning check's scoring batch):
    against the plain process on the kernels' weight values, the same bits on
    a second run, the task's route; then the step loop against the same
    plain trajectory."""
    dev = cuda_f32
    tm = _twin_case(dev, 1)[0]
    cfg = TaskConfig(timesteps=100, sampling_type=name, sampling_steps=steps, w=0.5)
    task = DiffusionTask(tm, cfg)
    x_T = torch.randn(8, 128, 88, device=dev)
    wav = 0.1 * torch.randn(8, 128 * 512, device=dev)
    with torch.no_grad():
        so = task.sampler_operands()
        w, head, kw = so.operands.weights, so.operands.head, so.operands.kernel
        tables, t_bias, stochastic = so.tables, so.t_bias, so.stochastic
        noise = torch.randn(tables.shape[0], 8, 128, 88, device=dev) if stochastic else None
        args = (x_T, noise, t_bias, tables, w, head, tm.conditioner(waveform=wav),
                tm.config.dilations(), True, 0.5, stochastic)
        wq = w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})
        before = fused_sample.launches
        out = fused_sample(*args, kweights=kw)
        again = fused_sample(*args, kweights=kw)
        ref = fused_sample_ref(x_T, noise, t_bias, tables, wq, *args[5:])
    via_task = task.sample(x_T, waveform=wav, noise=noise)[0]
    loop = DiffusionTask(tm, cfg.replace(use_megakernel=False)).sample(
        x_T, waveform=wav, noise=noise)[0]
    torch.cuda.synchronize()
    assert fused_sample.launches == before + 3
    assert tables.shape[0] == (100 if steps is None else steps)
    assert torch.isfinite(out).all() and _rel(out, ref) < BF16_GATE
    assert torch.equal(out, again) and torch.equal(via_task, out)
    assert _rel(loop, ref) < BF16_GATE


@pytest.mark.gpu
def test_twin_training_kernels(cuda_f32):
    """K3 (skip bit for bit K1's) and K4 (every leaf, with and without dcond)
    at the twin's widths and the training batch B=8, against their plain
    versions, and the same bits on a second run."""
    tm, w, wq, kw, x, tb, cond, cot = _twin_case(cuda_f32, 8)
    dil = tm.config.dilations()
    with torch.no_grad():
        skip, xs, a = tgt.fwd_saves(x, tb, cond, w, dil, kweights=kw)
        skip_r, xs_r, a_r = tgt.fwd_saves_ref(x, tb, cond, wq, dil)
        k1 = tgs.gated_stack(x, tb, cond, w, dil, kweights=kw)
    torch.cuda.synchronize()
    assert torch.equal(skip, k1)
    for out, ref in ((skip, skip_r), (xs.float(), xs_r), (a.float(), a_r)):
        assert _rel(out, ref) < BF16_GATE

    def leaves(o):
        dx, dtb, dcond, dw = o
        named = {"dx": dx, "dtb": dtb, "dcond": dcond}
        named.update({f"d{k}": v for k, v in dw._asdict().items()})
        return {k: v for k, v in named.items() if v is not None}

    for need_dcond in (True, False):
        with torch.no_grad():
            got = leaves(tgt.bwd(dil, (tb, cond, w, xs, a), cot, need_dcond, kweights=kw))
            rerun = leaves(tgt.bwd(dil, (tb, cond, w, xs, a), cot, need_dcond, kweights=kw))
            want = leaves(tgt.bwd_ref(dil, (tb, cond, wq, xs, a), cot, need_dcond))
        torch.cuda.synchronize()
        assert got.keys() == want.keys() and ("dcond" in got) == need_dcond
        for leaf in want:
            assert _rel(got[leaf], want[leaf]) < BF16_GATE, (need_dcond, leaf)
            assert torch.equal(got[leaf], rerun[leaf]), (need_dcond, leaf)


@pytest.mark.gpu
def test_twin_training_loss_matches_autograd(cuda_f32):
    """One training loss of the twin at B=8 through K3 + K4 against autograd
    through the modules on the same bf16-rounded stack weights and draws:
    the loss within 1e-2, every gradient within the bf16 gate."""
    dev = cuda_f32
    tm = _twin_case(dev, 1)[0]
    rounded = tmodels.build("ClassifierFreeDiffRoll", **TWIN).to(dev)
    rounded.net.load_state_dict(tm.net.state_dict())
    with torch.no_grad():
        for layer in rounded.net.residual_layers:
            for conv in (layer.dilated_conv, layer.conditioner_projection,
                         layer.output_projection):
                conv.weight.copy_(conv.weight.to(torch.bfloat16).float())
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"frame": (torch.rand(8, 128, 88, device=dev, generator=gen) > 0.95).float(),
             "audio": 0.1 * torch.randn(8, 128 * 512, device=dev, generator=gen)}
    draws = dict(t=torch.randint(0, 100, (8,), device=dev, generator=gen),
                 noise=torch.randn(8, 128, 88, device=dev, generator=gen),
                 uncond_mask=torch.arange(8, device=dev) == 3)
    losses, grads = {}, {}
    before = (tgt.fwd_saves.launches, tgt.bwd.launches)
    for key, model, fused in (("fused", tm, True), ("autograd", rounded, False)):
        task = DiffusionTask(model, TaskConfig(timesteps=100, fused_train=fused))
        total, _ = task.loss_fn(batch, None, True, **draws)
        total.backward()
        losses[key] = float(total.detach())
        grads[key] = {n: p.grad for n, p in model.net.named_parameters()}
    torch.cuda.synchronize()
    assert (tgt.fwd_saves.launches - before[0], tgt.bwd.launches - before[1]) == (1, 1)
    assert abs(losses["fused"] - losses["autograd"]) < 1e-2 * abs(losses["autograd"])
    for name, g in grads["autograd"].items():
        assert _rel(grads["fused"][name], g) < BF16_GATE, name


# ---- the U-Nets' GroupNorm (ops/group_norm.py, csrc/group_norm.cu): every
# distinct (C, H, W) of SpecUnet's 63 forward norms (one group) and the 8-group
# norms of UnetNet(dim=32, use_convnext=False), at the cell's batch of 16, and a
# ragged one whose planes take the 4-byte path
GN_SHAPES = [(18, 640, 88, 1), (28, 320, 44, 1), (28, 640, 88, 1), (56, 160, 22, 1),
             (56, 320, 44, 1), (56, 640, 88, 1), (112, 160, 22, 1), (112, 320, 44, 1),
             (168, 320, 44, 1), (224, 160, 22, 1), (336, 160, 22, 1), (32, 320, 44, 8),
             (32, 640, 88, 8), (64, 160, 22, 8), (64, 320, 44, 8), (128, 160, 22, 8),
             (24, 7, 11, 8)]
GN_GATE = 1e-5


def _gn_case(dev, c, h, w, b=16, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.5 + 2.0 * torch.randn(b, c, h, w, device=dev, generator=gen)
    weight = 1.0 + 0.05 * torch.randn(c, device=dev, generator=gen)
    bias = 0.1 * torch.randn(c, device=dev, generator=gen)
    dy = torch.randn(b, c, h, w, device=dev, generator=gen)
    return x, weight, bias, dy


def _gn_grads(x, weight, bias, dy, groups, fn):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, weight, bias)]
    y = fn(leaves[0], groups, leaves[1], leaves[2], 1e-6)
    y.backward(dy.to(y.dtype))
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("c,h,w,groups", GN_SHAPES,
                         ids=[f"{c}x{h}x{w}_g{g}" for c, h, w, g in GN_SHAPES])
def test_group_norm_kernels_match_f64(cuda_f32, c, h, w, groups):
    """y, dx, dgamma and dbeta through the kernels against F.group_norm in
    f64, each within 1e-5 of the reference's largest value, and the same bits
    on a second run."""
    x, weight, bias, dy = _gn_case(cuda_f32, c, h, w)
    before = tgn.group_norm.launches
    got = _gn_grads(x, weight, bias, dy, groups, tgn.group_norm)
    again = _gn_grads(x, weight, bias, dy, groups, tgn.group_norm)
    want = _gn_grads(x.double(), weight.double(), bias.double(), dy, groups,
                     torch.nn.functional.group_norm)
    torch.cuda.synchronize()
    assert tgn.group_norm.launches - before == 2
    for name, out, ref, rerun in zip(("y", "dx", "dgamma", "dbeta"), got, want, again):
        assert out.dtype == torch.float32 and _rel(out.double(), ref) < GN_GATE, name
        assert torch.equal(out, rerun), name


@pytest.mark.gpu
def test_group_norm_kernels_take_a_transposed_input(cuda_f32):
    """A transposed input and gradient go through the kernels (on a
    contiguous copy) and match F.group_norm in f64; a call the kernels cannot
    take raises instead of falling back."""
    x, weight, bias, dy = _gn_case(cuda_f32, 28, 88, 320)
    xt, dyt = x.transpose(2, 3), dy.transpose(2, 3)
    assert not xt.is_contiguous()
    before = tgn.group_norm.launches
    got = _gn_grads(xt, weight, bias, dyt, 1, tgn.group_norm)
    want = _gn_grads(xt.double(), weight.double(), bias.double(), dyt, 1,
                     torch.nn.functional.group_norm)
    torch.cuda.synchronize()
    assert tgn.group_norm.launches - before == 1
    for name, out, ref in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        assert _rel(out.double(), ref) < GN_GATE, name
    with pytest.raises(ValueError):
        tgn.group_norm(x.double(), 1, weight.double(), bias.double(), 1e-6)


@pytest.mark.gpu
def test_spec_unet_training_step_launches_every_norm(cuda_f32):
    """One SpecUnet training step at the published B=16: all 63 forward norms
    on the kernels, a finite loss and gradients."""
    from diffroll_tpu_torch.train import TrainState, make_train_step

    dev = cuda_f32
    torch.manual_seed(0)
    tm = tmodels.build("SpecUnet").to(dev)
    task = DiffusionTask(tm, TaskConfig(timesteps=200))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"frame": (torch.rand(16, 640, 88, device=dev, generator=gen) < 0.08).float(),
             "audio": 0.1 * torch.randn(16, 640 * 512, device=dev, generator=gen)}
    state = TrainState.create(tm, 5e-5)
    step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train))
    before = tgn.group_norm.launches
    losses = step(state, batch, gen)
    torch.cuda.synchronize()
    assert tgn.group_norm.launches - before == 63
    assert torch.isfinite(losses["diffusion_loss"])
    assert all(torch.isfinite(p).all() for p in tm.parameters())


# ---- the U-Nets' depthwise 7x7 convs (ops/depthwise_conv.py,
# csrc/depthwise_conv.cu): every distinct (C, H, W) of SpecUnet's 24 forward
# depthwise convs and UnetNet's, at the cell's batch of 16; then ragged rows and
# columns on the 4-byte path, a width cut into column tiles, and one column
tdw = importlib.import_module("diffroll_tpu_torch.ops.depthwise_conv")
DW_SHAPES = [(16, 18, 640, 88), (16, 28, 320, 44), (16, 28, 640, 88), (16, 56, 160, 22),
             (16, 56, 320, 44), (16, 112, 160, 22), (16, 112, 320, 44), (16, 168, 320, 44),
             (16, 224, 160, 22), (16, 336, 160, 22), (3, 5, 37, 13), (2, 3, 9, 300),
             (2, 2, 50, 1)]
DW_GATE = 1e-5


def _dw_case(dev, n, c, h, w, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.5 + torch.randn(n, c, h, w, device=dev, generator=gen)
    weight = torch.randn(c, 1, 7, 7, device=dev, generator=gen) / 7
    bias = 0.1 * torch.randn(c, device=dev, generator=gen)
    dy = torch.randn(n, c, h, w, device=dev, generator=gen)
    return x, weight, bias, dy


def _dw_grads(x, weight, bias, dy, fn):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, weight, bias)]
    y = fn(leaves[0], leaves[1], leaves[2])
    y.backward(dy.to(y.dtype))
    return [y.detach()] + [t.grad for t in leaves]


def _dw_aten(x, weight, bias):
    return torch.nn.functional.conv2d(x, weight, bias, 1, 3, 1, x.shape[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,w", DW_SHAPES, ids=[f"{n}x{c}x{h}x{w}" for n, c, h, w in DW_SHAPES])
def test_depthwise_conv_kernels_match_f64(cuda_f32, n, c, h, w):
    """y, dx, dw and db through the kernels against F.conv2d in f64, each
    within 1e-5 of the reference's largest value, and the same bits on a
    second run (the weight gradient has no atomics)."""
    x, weight, bias, dy = _dw_case(cuda_f32, n, c, h, w)
    before = tdw.depthwise_conv.launches
    got = _dw_grads(x, weight, bias, dy, tdw.depthwise_conv)
    again = _dw_grads(x, weight, bias, dy, tdw.depthwise_conv)
    want = _dw_grads(x.double(), weight.double(), bias.double(), dy, _dw_aten)
    torch.cuda.synchronize()
    assert tdw.depthwise_conv.launches - before == 2
    for name, out, ref, rerun in zip(("y", "dx", "dw", "db"), got, want, again):
        assert out.dtype == torch.float32 and _rel(out.double(), ref) < DW_GATE, name
        assert torch.equal(out, rerun), name


@pytest.mark.gpu
def test_depthwise_conv_kernels_take_a_transposed_input(cuda_f32):
    """A transposed input and gradient go through the kernels (on a
    contiguous copy) and match F.conv2d in f64; a call the kernels cannot
    take raises instead of falling back."""
    x, weight, bias, dy = _dw_case(cuda_f32, 4, 28, 88, 320)
    xt, dyt = x.transpose(2, 3), dy.transpose(2, 3)
    assert not xt.is_contiguous()
    before = tdw.depthwise_conv.launches
    got = _dw_grads(xt, weight, bias, dyt, tdw.depthwise_conv)
    want = _dw_grads(xt.double(), weight.double(), bias.double(), dyt, _dw_aten)
    torch.cuda.synchronize()
    assert tdw.depthwise_conv.launches - before == 1
    for name, out, ref in zip(("y", "dx", "dw", "db"), got, want):
        assert _rel(out.double(), ref) < DW_GATE, name
    with pytest.raises(ValueError):
        tdw.depthwise_conv(x.double(), weight.double(), bias.double())


@pytest.mark.gpu
def test_spec_unet_training_step_launches_every_depthwise_conv(cuda_f32):
    """One SpecUnet training step at the published B=16: all 24 forward
    depthwise convs on the kernels, a finite loss and gradients."""
    from diffroll_tpu_torch.train import TrainState, make_train_step

    dev = cuda_f32
    torch.manual_seed(0)
    tm = tmodels.build("SpecUnet").to(dev)
    task = DiffusionTask(tm, TaskConfig(timesteps=200))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"frame": (torch.rand(16, 640, 88, device=dev, generator=gen) < 0.08).float(),
             "audio": 0.1 * torch.randn(16, 640 * 512, device=dev, generator=gen)}
    state = TrainState.create(tm, 5e-5)
    step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train))
    before = tdw.depthwise_conv.launches
    losses = step(state, batch, gen)
    torch.cuda.synchronize()
    assert tdw.depthwise_conv.launches - before == 24
    assert torch.isfinite(losses["diffusion_loss"])
    assert all(torch.isfinite(p).all() for p in tm.parameters())


@pytest.mark.gpu
def test_unet_step_matches_its_aten_route(cuda_f32, monkeypatch):
    """UnetNet's forward and every parameter's gradient with the depthwise
    convs on the kernels against the same net with them on F.conv2d, each
    within 1e-5 of the aten route's largest value."""
    from diffroll_tpu_torch.nn import unet

    dev = cuda_f32
    torch.manual_seed(0)
    net = unet.UnetNet().to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(4, 640, 88, device=dev, generator=gen)
    t = torch.randint(0, 200, (4,), device=dev, generator=gen)

    def run():
        net.zero_grad()
        out = net(x, t)
        out.square().mean().backward()
        return out.detach(), {k: p.grad.clone() for k, p in net.named_parameters()}

    kernels = tdw.depthwise_conv
    before = kernels.launches
    got = run()
    assert kernels.launches - before == 13
    monkeypatch.setattr(unet.dw_ops, "depthwise_conv",
                        lambda x, w, b, stride, padding, dilation: _dw_aten(x, w, b))
    want = run()
    assert kernels.launches - before == 13
    assert _rel(got[0], want[0]) < DW_GATE
    for name, g in want[1].items():
        assert _rel(got[1][name], g) < DW_GATE, name


@pytest.mark.gpu
def test_spec_unet_guided_step_reads_the_stream_once(cuda_f32):
    """SpecUnet's guided step at the published widths and B=8 (16 rows): the
    spectrogram stream once (`cfg_cond_projections`) plus the x stream alone
    equals the whole forward on both branches; the stream's 24 norms and 11
    depthwise convs run once, the x stream's 37 and 13 every step."""
    dev = cuda_f32
    torch.manual_seed(0)
    tm = tmodels.build("SpecUnet").to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(8, 640, 88, device=dev, generator=gen)
    t = torch.full((8,), 57, device=dev, dtype=torch.long)
    with torch.no_grad():
        cond = tm.conditioner(waveform=0.1 * torch.randn(8, 640 * 512, device=dev,
                                                          generator=gen))
        counters = (tgn.group_norm, tdw.depthwise_conv)
        before = [c.launches for c in counters]
        proj = tm.cfg_cond_projections(cond)
        stream = [c.launches - b for c, b in zip(counters, before)]
        got = torch.cat(tm.apply_cfg(x, t, cond_proj=proj))
        step = [c.launches - b - s for c, b, s in zip(counters, before, stream)]
        want = torch.cat(tm.apply_cfg(x, t, cond))
    torch.cuda.synchronize()
    assert (stream, step) == ([24, 11], [37, 13])
    assert want.abs().max() > 0.1 and _rel(got, want) < 1e-5
