"""The port's training path against the JAX package on the CPU, on the same
weights (through `state_dict_from_jax`), the same batch and the same draws:

  * `q_sample` / `extract_x0` / `p_losses` (atol 1e-6);
  * `DiffusionTask.loss_fn` and every parameter gradient, for `fused_train`
    off and on, the three training modes and the dual-dataset branch. The
    timesteps, noise and spec-dropout mask are the ones the JAX `loss_fn`
    draws from its key (recomputed here with the same `jax.random.split`) and
    handed to the port explicitly. Loss within 1e-5; gradients
    max|d| / max|ref| < 2e-3, the gate of tests/test_ops_grad.py;
  * `torch.optim.Adam` against `fused_adam_apply` on the same gradients (atol
    1e-6), the second step from a state carried over with
    `adam_state_from_optax`, and one whole train step at the task's lr;
  * the EMA update against the JAX fit loop's lambda.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.diffusion import forward as jforward
from diffroll_tpu.diffusion.schedule import linear_schedule as j_linear_schedule
from diffroll_tpu.models.conditioning import spec_dropout_mask as j_spec_dropout_mask
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu.tasks import TaskConfig as JTaskConfig
from diffroll_tpu.tasks.losses import p_losses as j_p_losses
from diffroll_tpu.train.state import fused_adam_apply
from diffroll_tpu.train.state import make_optimizer as j_make_optimizer
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.compat import (
    adam_state_from_optax, grads_from_jax, load_adam_state, state_dict_from_jax)
from diffroll_tpu_torch.diffusion import forward as tforward
from diffroll_tpu_torch.diffusion.schedule import linear_schedule as t_linear_schedule
from diffroll_tpu_torch.models import spec_dropout_mask
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig
from diffroll_tpu_torch.tasks.losses import p_losses as t_p_losses
from diffroll_tpu_torch.train import TrainState, make_train_step
from diffroll_tpu_torch.train.loop import ema_update

torch.set_num_threads(1)
C, L, T, B, STEPS = 16, 3, 32, 4, 10
LOSS_TOL, GRAD_GATE = 1e-5, 2e-3
DUAL_KEYS = ("diffusion_loss", "unconditional_diffusion_loss")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-5))


# ------------------------------------------------------------ small pieces

@pytest.mark.parametrize("shape", [(B, T, 88), (B, 5)], ids=["roll", "flat"])
def test_q_sample_and_extract_x0_match(shape):
    rng = np.random.default_rng(0)
    x0 = rng.random(shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    t = rng.integers(0, STEPS, size=(shape[0],))
    js, ts = j_linear_schedule(1e-4, 0.02, STEPS), t_linear_schedule(1e-4, 0.02, STEPS)
    jx = jforward.q_sample(jnp.asarray(x0), jnp.asarray(t), js, jnp.asarray(noise))
    tx = tforward.q_sample(torch.from_numpy(x0), torch.from_numpy(t), ts,
                           torch.from_numpy(noise))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    je = jforward.extract_x0(jx, jnp.asarray(noise), jnp.asarray(t), js)
    te = tforward.extract_x0(tx, torch.from_numpy(noise), torch.from_numpy(t), ts)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6, rtol=1e-6)
    # extract_x0 inverts q_sample
    np.testing.assert_allclose(te.numpy(), x0, atol=1e-5)


@pytest.mark.parametrize("loss_type", ["l1", "l2", "huber"])
def test_p_losses_match(loss_type):
    rng = np.random.default_rng(1)
    # spread wide enough that huber's quadratic and linear branches both occur
    a = (2.0 * rng.standard_normal((B, T, 88))).astype(np.float32)
    b = (2.0 * rng.standard_normal((B, T, 88))).astype(np.float32)
    j = j_p_losses(jnp.asarray(a), jnp.asarray(b), loss_type)
    t = t_p_losses(torch.from_numpy(a), torch.from_numpy(b), loss_type)
    np.testing.assert_allclose(float(t), float(j), atol=1e-6, rtol=1e-6)


def test_p_losses_unknown_type_raises():
    with pytest.raises(NotImplementedError):
        t_p_losses(torch.zeros(2), torch.zeros(2), "l3")


def test_spec_dropout_mask_draws():
    g = torch.Generator().manual_seed(0)
    m = spec_dropout_mask(4096, 0.25, g)
    assert m.dtype == torch.bool and m.shape == (4096,)
    assert abs(float(m.float().mean()) - 0.25) < 0.03
    again = spec_dropout_mask(4096, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(m, again)
    assert not spec_dropout_mask(64, 0.0, g).any() and spec_dropout_mask(64, 1.0, g).all()


# ------------------------------------------------------------ loss and grads

def _pair(spec_dropout=0.5, layers=L):
    kw = dict(residual_channels=C, residual_layers=layers, frames=T, timesteps=STEPS,
              spec_dropout=spec_dropout)
    jm = jmodels.build("ClassifierFreeDiffRoll", **kw)
    params = jm.init(jax.random.key(0))
    # the head is zero-initialised, which would zero every other gradient
    head = params["params"]["output_projection"]
    head["kernel"] = 0.1 * jax.random.normal(jax.random.key(9), head["kernel"].shape)
    tm = tmodels.build("ClassifierFreeDiffRoll", **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"frame": (rng.random((B, T, 88)) > 0.9).astype(np.float32),
            "audio": rng.standard_normal((B, T * 512)).astype(np.float32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_draws(key, p):
    """The t, noise and dropout mask `DiffusionTask.loss_fn` draws from `key`."""
    t_key, n_key, d_key = jax.random.split(key, 3)
    t = jax.random.randint(t_key, (B,), 0, STEPS)
    noise = jax.random.normal(n_key, (B, T, 88), jnp.float32)
    mask = j_spec_dropout_mask(d_key, B, p)
    return (torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise)),
            torch.from_numpy(np.array(mask)))


def _compare(jm, params, tm, jcfg, tcfg, jbatch, tbatch, key):
    jtask, ttask = JTask(jm, jcfg), TTask(tm, tcfg)
    (jtotal, (jlosses, _)), jgrads = jax.value_and_grad(
        lambda p: jtask.loss_fn(p, jbatch, key, True), has_aux=True)(params)
    t, noise, mask = _jax_draws(key, jm.config.spec_dropout)
    assert 0 < int(mask.sum()) < B  # both kinds of row in the batch
    tm.train()
    tm.net.zero_grad(set_to_none=True)
    ttotal, (tlosses, tensors) = ttask.loss_fn(tbatch, None, True, t=t, noise=noise,
                                               uncond_mask=mask)
    ttotal.backward()
    assert abs(float(ttotal.detach()) - float(jtotal)) < LOSS_TOL
    assert sorted(tlosses) == sorted(jlosses)
    for k in jlosses:
        assert abs(float(tlosses[k]) - float(jlosses[k])) < LOSS_TOL, k
    want = grads_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tm.net.named_parameters()}
    assert sorted(want) == sorted(got)
    for name, ref in want.items():
        assert got[name] is not None, name
        assert got[name].shape == ref.shape, name
        assert float(ref.abs().max()) > 0, name
        assert _rel(got[name], ref) < GRAD_GATE, name
    return tensors


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
@pytest.mark.parametrize("mode", ["x_0", "epsilon", "ex_0"])
def test_loss_and_grads_match_jax(pair, mode, fused):
    jm, params, tm = pair
    b = _batch(1)
    kw = dict(timesteps=STEPS, training_mode=mode, fused_train=fused)
    tensors = _compare(jm, params, tm, JTaskConfig(**kw), TTaskConfig(**kw), _jb(b), _tb(b),
                       jax.random.key(3))
    assert tensors["pred_roll"].shape == (B, T, 88) and tensors["spec"].shape == (B, T, 229)


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_dual_branch_matches_jax(pair, fused):
    jm, params, tm = pair
    b1, b2 = _batch(1), _batch(10)
    kw = dict(timesteps=STEPS, training_mode="x_0", fused_train=fused, loss_keys=DUAL_KEYS)
    tensors = _compare(jm, params, tm, JTaskConfig(**kw), TTaskConfig(**kw),
                       [_jb(b1), _jb(b2)], [_tb(b1), _tb(b2)], jax.random.key(3))
    assert "pred_roll2" in tensors


@pytest.mark.parametrize("loss_type", ["l1", "huber"])
def test_other_loss_types_match_jax(pair, loss_type):
    jm, params, tm = pair
    b = _batch(2)
    kw = dict(timesteps=STEPS, training_mode="x_0", loss_type=loss_type, fused_train=True)
    _compare(jm, params, tm, JTaskConfig(**kw), TTaskConfig(**kw), _jb(b), _tb(b),
             jax.random.key(5))


def test_loss_fn_draws_from_the_generator(pair):
    _, _, tm = pair
    task = TTask(tm, TTaskConfig(timesteps=STEPS, training_mode="x_0"))
    b = _tb(_batch(3))
    a1 = task.loss_fn(b, torch.Generator().manual_seed(7), True)[0]
    a2 = task.loss_fn(b, torch.Generator().manual_seed(7), True)[0]
    a3 = task.loss_fn(b, torch.Generator().manual_seed(8), True)[0]
    assert float(a1) == float(a2) and float(a1) != float(a3)
    # evaluation applies no spec dropout: a given mask is ignored
    ev = dict(t=torch.zeros(B, dtype=torch.long), noise=torch.zeros(B, T, 88))
    with torch.no_grad():
        e1 = task.loss_fn(b, None, False, **ev)[0]
        e2 = task.loss_fn(b, None, False, uncond_mask=torch.ones(B, dtype=torch.bool), **ev)[0]
    assert float(e1) == float(e2)


def test_unknown_training_mode_raises(pair):
    _, _, tm = pair
    task = TTask(tm, TTaskConfig(timesteps=STEPS, training_mode="v"))
    with pytest.raises(ValueError, match="training mode"):
        task.loss_fn(_tb(_batch(3)), torch.Generator().manual_seed(0), True)


# ------------------------------------------------------------ optimizer, EMA

def _set_grads(net, grads):
    for name, p in net.named_parameters():
        p.grad = grads[name].clone()


def test_adam_steps_match_fused_adam_apply():
    """`torch.optim.Adam` against `fused_adam_apply` on the same gradients:
    the first step from a fresh state, the second from the optax state carried
    across with `adam_state_from_optax` into a new optimizer."""
    jm, params, tm = _pair(layers=2)
    lr = 1e-3
    tx = j_make_optimizer(lr)
    opt_state = tx.init(params)
    rng = np.random.default_rng(6)
    for step in (1, 2):
        jgrads = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), params)
        state = TrainState.create(tm, lr)
        if step == 2:
            adam = opt_state[0]
            load_adam_state(state.optimizer, tm.net, adam_state_from_optax(
                jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
                int(adam.count)))
        _set_grads(tm.net, grads_from_jax(jax.tree.map(np.asarray, jgrads)))
        state.optimizer.step()
        params, opt_state = fused_adam_apply(tx, params, jgrads, opt_state)
        want = state_dict_from_jax(jax.tree.map(np.asarray, params))
        for name, p in tm.net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"step {step} {name}")
    mu = state_dict_from_jax(jax.tree.map(np.asarray, opt_state[0].mu))
    nu = state_dict_from_jax(jax.tree.map(np.asarray, opt_state[0].nu))
    for name, p in tm.net.named_parameters():
        st = state.optimizer.state[p]
        assert float(st["step"]) == 2.0
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name].numpy(), atol=1e-6)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name].numpy(), atol=1e-6)


def test_train_step_matches_jax_step():
    """One whole step (loss, backward, Adam at the task's default lr) against
    `jax.grad` + `fused_adam_apply` on the same draws: params atol 1e-6."""
    jm, params, tm = _pair(layers=2)
    cfg = dict(timesteps=STEPS, training_mode="x_0")
    jtask, ttask = JTask(jm, JTaskConfig(**cfg)), TTask(tm, TTaskConfig(**cfg))
    lr = ttask.config.lr
    assert lr == jtask.config.lr == 5e-5
    b, key = _batch(4), jax.random.key(11)
    before = {n: p.detach().clone() for n, p in tm.net.named_parameters()}
    jgrads = jax.grad(lambda p: jtask.loss_fn(p, _jb(b), key, True)[0])(params)
    tx = j_make_optimizer(lr)
    params, _ = fused_adam_apply(tx, params, jgrads, tx.init(params))
    t, noise, mask = _jax_draws(key, jm.config.spec_dropout)

    def loss_fn(batch, generator, train):
        return ttask.loss_fn(batch, generator, train, t=t, noise=noise, uncond_mask=mask)

    state = TrainState.create(tm, lr)
    losses = make_train_step(loss_fn)(state, _tb(b), None)
    assert state.step == 1 and np.isfinite(float(losses["diffusion_loss"]))
    assert not losses["diffusion_loss"].requires_grad
    want = state_dict_from_jax(jax.tree.map(np.asarray, params))
    for name, p in tm.net.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_ema_update_matches_jax_lambda():
    jm, params, tm = _pair(layers=2)
    d = 0.9
    ema_j = jax.tree.map(jnp.copy, params)
    ema_t = {n: p.detach().clone() for n, p in tm.net.named_parameters()}
    rng = np.random.default_rng(5)
    for _ in range(3):
        params = jax.tree.map(
            lambda a: a + jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), params)
        tm.net.load_state_dict(state_dict_from_jax(params))
        ema_j = jax.tree.map(lambda a, b: a * d + b * (1.0 - d), ema_j, params)
        ema_update(ema_t, tm.net, d)
    want = state_dict_from_jax(jax.tree.map(np.asarray, ema_j))
    for name, ref in want.items():
        np.testing.assert_allclose(ema_t[name].numpy(), ref.numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=name)
