"""`model.dtype=bfloat16` in the port against the JAX package's
`dtype="bfloat16"` net on the CPU, on the same weights (through
`state_dict_from_jax`), inputs and draws:

  * the 1-D net's forward and every parameter gradient of a loss through it,
    for condition 'fixed', 'trainable_spec', 'trainable_z' and an
    unconditional net, with a mixed `uncond_mask`: the forward max|d| /
    max|ref| < 0.05 (the bf16 gate of tests/test_ops.py) and the loss within
    1e-2. Each gradient is held to the JAX bf16 net's and to the JAX f32
    net's on the same weights (the exact answer), both max|d| / max|ref|.
    On a random target the bf16 gradients of this random net sit far from
    the exact ones in both packages alike (input_projection 0.07-0.18 at
    C=16, no nearer at C=32-128), and the two bf16 gradients of a leaf
    differ by up to 0.08 (XLA's CPU backward rounds every bf16 elementwise
    op, e.g. the sigmoid's `y (1 - y)`), so a per-leaf 0.05 between the two
    does not hold there. The gate per leaf: the port's distance to the JAX
    bf16 gradient, and to the exact one, each below the JAX bf16 gradient's
    own distance to the exact one plus 0.05; and every leaf of the port's
    bf16 gradient differs from the port's f32 gradient on the same weights
    by more than 1e-4 (the f32 packages agree to ~1e-6), which an f32
    compute would not;
  * the task's training loss and every gradient through the log-mel front
    end, for each mode, per leaf < 0.05 against JAX's bf16 net, and every
    leaf > 1e-4 from the port's f32 one (the JAX mel pinned to its fft
    path: a bf16 JAX model would otherwise pick the conv DFT, while the
    port keeps `torch.stft` in f32). These draws give a well-conditioned
    gradient (every leaf of either bf16 package within 0.035 of the exact
    one); on others, where some leaf's gradient cancels more, both
    packages' bf16 gradients sit up to 0.3 from the exact one and from
    each other, and the net test's gate above is the one that holds;
  * the compute really is bf16: every product flax computes in `dtype` takes
    bf16 operands, every other one f32; each block returns bf16, the parameters and
    the net's output stay f32, and a bf16 model's checkpoint loads into an
    f32 one; `model.dtype=float32` computes exactly as the plain chain;
  * the counterpart of tests/test_convergence.py::test_bf16_training_converges:
    the debug-conditioned bf16 model learns to copy its conditioner (final
    loss < 0.3 x first, frame F1 > 0.7).

Sizes: C=16, 3 layers, 16 frames, 10 timesteps (the convergence check: C=32,
32 frames, 20 timesteps, as the JAX test).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffroll_tpu import models as jmodels
from diffroll_tpu.dsp.mel import MelConfig as JMelConfig
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu.tasks import TaskConfig as JTaskConfig
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.compat import grads_from_jax, state_dict_from_jax
from diffroll_tpu_torch.eval.evaluate import evaluate_rolls
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig
from diffroll_tpu_torch.train import TrainState, make_train_step
from test_torch_variants import jax_params

torch.set_num_threads(1)
GATE = 0.05
DIFFERS = 1e-4   # a bf16 gradient leaf's least distance from the f32 one
C, L, T, B, STEPS = 16, 3, 16, 4, 10
MODES = {"fixed": {}, "trainable_spec": {"condition": "trainable_spec"},
         "trainable_z": {"condition": "trainable_z"}, "unconditional": {"unconditional": True}}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-5))


@functools.lru_cache(maxsize=None)
def _pair(mode):
    kw = dict(residual_channels=C, residual_layers=L, frames=T, timesteps=STEPS,
              spec_dropout=0.5, **MODES[mode])
    jm = jmodels.build("ClassifierFreeDiffRoll", dtype="bfloat16",
                       mel=JMelConfig(precision="default"), **kw)
    params = jax_params(jm)
    tm = tmodels.build("ClassifierFreeDiffRoll", dtype="bfloat16", **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    t32 = tmodels.build("ClassifierFreeDiffRoll", **kw)
    t32.net.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm, jmodels.build("ClassifierFreeDiffRoll", **kw), t32


def _port_grads(model, loss_of):
    """{leaf: gradient} of `loss_of(model)` (a scalar) through the port."""
    model.net.zero_grad(set_to_none=True)
    loss_of(model).backward()
    return {n: p.grad for n, p in model.net.named_parameters()}


def _inputs(seed, conditional=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 88)).astype(np.float32)
    t = rng.integers(0, STEPS, size=B).astype(np.int32)
    cond = rng.random((B, T, 229)).astype(np.float32) if conditional else None
    mask = np.array([False, True, False, True]) if conditional else None
    target = rng.standard_normal((B, T, 88)).astype(np.float32)
    return x, t, cond, mask, target


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bf16_net_forward_and_grads_match_jax(mode):
    jm, params, tm, jm32, t32 = _pair(mode)
    x, t, cond, mask, target = _inputs(1, mode != "unconditional")
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731

    def jloss(p, net):
        out = net.apply(p, j(x), j(t), j(cond), j(mask))
        return jnp.mean((out - j(target)) ** 2), out

    (jl, jout), jgrads = jax.value_and_grad(lambda p: jloss(p, jm.net), has_aux=True)(params)
    exact = grads_from_jax(jax.tree.map(
        np.asarray, jax.grad(lambda p: jloss(p, jm32.net)[0])(params)))
    assert jout.dtype == jnp.float32
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    tm.net.zero_grad(set_to_none=True)
    out = tm.net(tt(x), tt(t).long(), tt(cond), tt(mask))
    loss = torch.mean((out - tt(target)) ** 2)
    loss.backward()
    assert out.dtype == torch.float32
    assert float(np.abs(np.asarray(jout)).max()) > 0.1
    assert rel(out.detach(), jout) < GATE
    assert abs(float(loss) - float(jl)) / float(jl) < 1e-2
    want = grads_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tm.net.named_parameters()}
    assert sorted(want) == sorted(got)
    for name, ref in want.items():
        assert got[name] is not None and got[name].dtype == torch.float32, name
        assert float(ref.abs().max()) > 0, name
        jax_err = rel(ref, exact[name])
        assert rel(got[name], ref) < jax_err + GATE, (name, rel(got[name], ref), jax_err)
        assert rel(got[name], exact[name]) < jax_err + GATE, (name, jax_err)
    f32 = _port_grads(t32, lambda m: torch.mean(
        (m.net(tt(x), tt(t).long(), tt(cond), tt(mask)) - tt(target)) ** 2))
    for name, g in f32.items():
        assert rel(g, exact[name]) < 1e-4, name
        assert rel(got[name], g) > DIFFERS, (name, rel(got[name], g))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bf16_task_loss_and_grads_match_jax(mode):
    """The whole training loss: mel, spec dropout on two of four rows, x_0."""
    jm, params, tm, _, t32 = _pair(mode)
    rng = np.random.default_rng(2)
    batch = {"frame": (rng.random((B, T, 88)) > 0.9).astype(np.float32),
             "audio": rng.standard_normal((B, T * 512)).astype(np.float32)}
    key = jax.random.key(3)
    cfg = dict(timesteps=STEPS, training_mode="x_0")
    (jl, _), jgrads = jax.value_and_grad(
        lambda p: JTask(jm, JTaskConfig(**cfg)).loss_fn(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, key, True),
        has_aux=True)(params)
    t_key, n_key, d_key = jax.random.split(key, 3)
    t = torch.from_numpy(np.array(jax.random.randint(t_key, (B,), 0, STEPS)))
    noise = torch.from_numpy(np.array(jax.random.normal(n_key, (B, T, 88), jnp.float32)))
    from diffroll_tpu.models.conditioning import spec_dropout_mask
    mask = torch.from_numpy(np.array(spec_dropout_mask(d_key, B, 0.5)))
    losses = []

    def loss_of(model):
        tl, _ = TTask(model, TTaskConfig(**cfg)).loss_fn(
            {k: torch.from_numpy(v) for k, v in batch.items()}, None, True,
            t=t, noise=noise, uncond_mask=mask)
        losses.append(float(tl.detach()))
        return tl

    got, f32 = _port_grads(tm, loss_of), _port_grads(t32, loss_of)
    assert abs(losses[0] - float(jl)) / float(jl) < 1e-2
    want = grads_from_jax(jax.tree.map(np.asarray, jgrads))
    assert sorted(want) == sorted(got)
    for name, g in got.items():
        assert rel(g, want[name]) < GATE, (name, rel(g, want[name]))
        assert rel(g, f32[name]) > DIFFERS, (name, rel(g, f32[name]))


def test_bf16_compute_with_f32_parameters(tmp_path):
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=C, residual_layers=L,
                       frames=T, timesteps=STEPS, dtype="bfloat16")
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    assert tm.net.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.net.parameters())
    x, t, cond, _, _ = _inputs(3)
    block = tm.net.residual_layers[0]
    h = torch.randn(B, T, C)
    t_emb = tm.net.diffusion_embedding(torch.from_numpy(t).long())
    assert t_emb.dtype == torch.float32  # the embedding stays f32
    proj = block.cond_proj(torch.from_numpy(cond))
    res, skip = block(h, t_emb, proj)
    assert proj.dtype == res.dtype == skip.dtype == torch.bfloat16
    out = tm.net(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond))
    assert out.dtype == torch.float32
    # a bf16 model's weights are f32 and load into an f32 model
    f32 = tmodels.build("ClassifierFreeDiffRoll", residual_channels=C, residual_layers=L,
                        frames=T, timesteps=STEPS)
    torch.save(tm.net.state_dict(), tmp_path / "w.pt")
    f32.net.load_state_dict(torch.load(tmp_path / "w.pt"))
    assert all(torch.equal(a, b) for a, b in zip(f32.net.parameters(), tm.net.parameters()))
    with torch.no_grad():
        ref = f32.net(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond))
        assert rel(out.detach(), ref) < GATE and not torch.equal(out, ref)
    with pytest.raises(ValueError, match="floating dtype"):
        tmodels.build("ClassifierFreeDiffRoll", residual_channels=C, residual_layers=L,
                      dtype="int8")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bf16_casts_at_every_flax_dtype_site(mode, monkeypatch):
    """Every product the flax net computes in `dtype` takes bf16 operands in
    the port (input_projection, each block's diffusion_projection, dilated
    conv, conditioner_projection and output_projection, skip_projection),
    and every other one f32 (the embedding's MLP, the head): one site
    ignoring `model.dtype` fails here, which no numeric gate can tell."""
    calls = []
    for fn in ("linear", "conv1d"):
        inner = getattr(F, fn)

        def record(inp, weight, *a, _inner=inner, **kw):
            calls.append((tuple(weight.shape), inp.dtype, weight.dtype))
            return _inner(inp, weight, *a, **kw)

        monkeypatch.setattr(F, fn, record)
    _, _, tm, _, _ = _pair(mode)
    x, t, cond, mask, _ = _inputs(5, mode != "unconditional")
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        out = tm.net(tt(x), tt(t).long(), tt(cond), tt(mask))
    assert out.dtype == torch.float32
    bf16_sites = {(C, 88), (C, 512), (2 * C, C, 3), (2 * C, C), (C, C)}
    if mode != "unconditional":
        bf16_sites.add((2 * C, 229))
    n_bf16 = 2 + L * (4 if mode != "unconditional" else 3)
    assert sum(shape in bf16_sites for shape, _, _ in calls) == n_bf16
    assert (88, C) in {shape for shape, _, _ in calls}   # the head ran
    for shape, in_dt, w_dt in calls:
        want = torch.bfloat16 if shape in bf16_sites else torch.float32
        assert in_dt == w_dt == want, (shape, in_dt, w_dt)


def _plain_chain(net, x, t, cond):
    """The f32 forward as written before the compute dtype existed."""
    def pw(h, conv):
        return F.linear(h, conv.weight[:, :, 0], conv.bias)

    h = torch.relu(pw(x, net.input_projection))
    t_emb = net.diffusion_embedding(t)
    skips = None
    for blk in net.residual_layers:
        y = h + blk.diffusion_projection(t_emb)[:, None, :]
        y = blk.dilated_conv(y.transpose(1, 2)).transpose(1, 2) + pw(cond, blk.conditioner_projection)
        g, f = y.chunk(2, dim=-1)
        r, s = pw(torch.sigmoid(g) * torch.tanh(f), blk.output_projection).chunk(2, dim=-1)
        h = (h + r) * 0.7071067811865476
        skips = s if skips is None else skips + s
    h = torch.relu(pw(skips / math.sqrt(len(net.residual_layers)), net.skip_projection))
    return pw(h, net.output_projection)


def test_float32_is_the_plain_chain_bit_for_bit():
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=C, residual_layers=L,
                       frames=T, timesteps=STEPS, dtype="float32")
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    assert tm.net.dtype is None
    x, t, cond, _, _ = _inputs(4)
    args = (torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond))
    with torch.no_grad():
        assert torch.equal(tm.net(*args), _plain_chain(tm.net, *args))


FRAMES, CC, LAYERS, TC = 32, 32, 3, 20


def _random_rolls(key, n):
    """Sparse piano-roll-like binary labels with short held notes (as
    tests/test_convergence.py draws them)."""
    rng = np.random.RandomState(key)
    rolls = np.zeros((n, FRAMES, 88), np.float32)
    for i in range(n):
        for _ in range(6):
            p = rng.randint(0, 88)
            t0 = rng.randint(0, FRAMES - 6)
            rolls[i, t0: t0 + rng.randint(2, 6), p] = 1.0
    return rolls


def test_bf16_training_converges():
    torch.manual_seed(0)
    model = tmodels.build("ClassifierFreeDiffRoll", residual_channels=CC, residual_layers=LAYERS,
                          frames=FRAMES, timesteps=TC, cond_source="roll", n_mels=88,
                          spec_dropout=0.0, dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in model.net.parameters())
    task = TTask(model, TTaskConfig(timesteps=TC, training_mode="x_0", loss_type="l2", lr=2e-3,
                                    sampling_type="ddpm_x0", debug=True))
    state = TrainState.create(model, 2e-3)
    step = make_train_step(task.loss_fn)
    rolls = _random_rolls(7, 8)
    batch = {"frame": torch.from_numpy(rolls), "audio": torch.zeros(8, 16)}
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(state, batch, gen)["diffusion_loss"]) for _ in range(200)]
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])
    model.eval()
    x_T = torch.randn(8, FRAMES, 88, generator=gen)
    pred, _ = task.sample(x_T, roll_cond=torch.from_numpy(rolls), generator=gen)
    m = evaluate_rolls(pred.numpy(), rolls, frame_threshold=0.5)
    assert m["frame_f1"] > 0.7, m
