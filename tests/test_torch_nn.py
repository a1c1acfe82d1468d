"""The port's network (embedding, residual block, DiffRollNet, the model
wrapper) against the JAX package's flax modules on the same weights,
carried across by `state_dict_from_jax`, and the Lightning fixture through
both packages' loaders. float32 on both sides: atol 1e-4, rtol 1e-3 (the
JAX package's own f32 gate, tests/test_ops.py)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.compat import convert_state_dict, load_torch_checkpoint
from diffroll_tpu.nn.resblock import ResidualBlock as JBlock
from diffroll_tpu.ops.fused_forward import _embed as j_embed
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.compat import load_lightning, state_dict_from_jax

torch.set_num_threads(1)
ATOL, RTOL = 1e-4, 1e-3
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "lightning_small.ckpt"
KW = dict(residual_channels=16, residual_layers=4, frames=32, timesteps=12)


def _randomize_head(params, seed=9, std=0.1):
    p = params["params"]["output_projection"]
    p["kernel"] = std * jax.random.normal(jax.random.key(seed), p["kernel"].shape)
    return params


def _pair(name="ClassifierFreeDiffRoll", seed=0, **kw):
    """A JAX model + params and the port model holding the same weights."""
    jm = jmodels.build(name, **kw)
    params = _randomize_head(jm.init(jax.random.key(seed)))
    tm = tmodels.build(name, **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair(**KW)


def _inputs(seed, b=2, t=32, m=229):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, 88)).astype(np.float32),
            rng.integers(0, 12, size=b).astype(np.int32),
            rng.random((b, t, m)).astype(np.float32))


def test_state_dict_from_jax_inverts_convert_state_dict(pair):
    jm, params, tm = pair
    sd = state_dict_from_jax(params)
    assert set(sd) == set(tm.net.state_dict())
    back = convert_state_dict(sd)
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("t", [np.array([0, 5, 11]), np.array([0.0, 2.25, 10.5], np.float32)],
                         ids=["int", "fractional"])
def test_embedding_matches(pair, t):
    jm, params, tm = pair
    j = np.asarray(j_embed(jnp.asarray(t), params["params"]["diffusion_embedding"], 12))
    with torch.no_grad():
        out = tm.net.diffusion_embedding(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("layer", [0, 1, 3])
def test_residual_block_matches(pair, layer):
    jm, params, tm = pair
    rng = np.random.default_rng(layer)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    t_emb = rng.standard_normal((2, 512)).astype(np.float32)
    cond = rng.random((2, 32, 229)).astype(np.float32)
    d = jm.config.dilations()[layer]
    blk = JBlock(residual_channels=16, dilation=d, kernel_size=3)
    bp = {"params": params["params"][f"residual_layers_{layer}"]}
    j_proj = blk.apply(bp, jnp.asarray(cond), method="cond_proj")
    jx, js = blk.apply(bp, jnp.asarray(x), jnp.asarray(t_emb), j_proj)
    tb = tm.net.residual_layers[layer]
    with torch.no_grad():
        t_proj = tb.cond_proj(torch.from_numpy(cond))
        tx, ts = tb(torch.from_numpy(x), torch.from_numpy(t_emb), t_proj)
    np.testing.assert_allclose(t_proj.numpy(), np.asarray(j_proj), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mask", [None, [False, True]], ids=["cond", "mixed_uncond"])
def test_net_forward_matches(pair, mask):
    jm, params, tm = pair
    x, t, cond = _inputs(1)
    jmask = None if mask is None else jnp.asarray(mask)
    j = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jmask))
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                       None if mask is None else torch.tensor(mask)).numpy()
    assert np.abs(j).max() > 0.1  # the randomized head makes the output non-trivial
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=RTOL)


def test_apply_cfg_and_cond_projections_match(pair):
    jm, params, tm = pair
    x, t, cond = _inputs(2)
    jc, ju = jm.apply_cfg(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    jproj = jm.cfg_cond_projections(params, jnp.asarray(cond))
    with torch.no_grad():
        tc, tu = tm.apply_cfg(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
        tproj = tm.cfg_cond_projections(torch.from_numpy(cond))
        tc2, tu2 = tm.apply_cfg(torch.from_numpy(x), torch.from_numpy(t), cond_proj=tproj)
    for a, b in [(tc, jc), (tu, ju), (tc2, jc), (tu2, ju)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
    for a, b in zip(tproj, jproj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)


def test_unconditional_net_matches():
    jm, params, tm = _pair("DiffRoll", residual_channels=16, residual_layers=3, frames=32,
                           timesteps=10, unconditional=True)
    x, t, _ = _inputs(3)
    j = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t % 10), None))
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(t % 10), None).numpy()
    assert tm.conditioner(waveform=torch.zeros(2, 32 * 512)) is None
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=RTOL)


def test_full_width_forward_matches():
    """The flagship's published widths: 512 channels x 15 layers, T=640, B=1."""
    jm, params, tm = _pair()
    x, t, cond = _inputs(4, b=1, t=640)
    t = np.array([137], np.int32)
    j = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond)))
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(cond)).numpy()
    assert out.shape == (1, 640, 88) and np.abs(j).max() > 0.1
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=RTOL)


def test_lightning_fixture_loads_and_matches():
    """The committed Lightning-style fixture (omegaconf/Lightning pickles,
    schedule and mel buffers) loads through the port's `load_lightning`
    with `load_state_dict` and drives the same forward as the JAX loader."""
    tm, task_updates = load_lightning(str(FIXTURE))
    jcfg, jparams = load_torch_checkpoint(str(FIXTURE))
    c = tm.config
    assert (c.residual_channels, c.residual_layers, c.kernel_size, c.dilation_bound,
            c.n_mels, c.timesteps) == (jcfg.residual_channels, jcfg.residual_layers,
                                       jcfg.kernel_size, jcfg.dilation_bound,
                                       jcfg.n_mels, jcfg.timesteps)
    assert task_updates["sampling_type"] == "cfdg_ddpm_x0" and task_updates["w"] == 0.5
    assert task_updates["frame_threshold"] == 0.65
    x, t, cond = _inputs(5, t=16, m=c.n_mels)
    t = t % c.timesteps
    j = np.asarray(jmodels.DiffRollModel(jcfg).apply(
        jparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond)))
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=RTOL)
