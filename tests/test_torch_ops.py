"""The gated-stack op (K1) and the fused forward: the port's plain f32
version against the JAX package's XLA oracle (atol 1e-4, rtol 1e-3) and
its Pallas kernel in interpret mode (bf16: max|d| / max|ref| < 0.05, the
gate of tests/test_ops.py), on the same weights and inputs. The CUDA kernel
against the plain version is in tests/test_torch_kernels_gpu.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.ops import fused_forward as j_fused_forward
from diffroll_tpu.ops.gated_stack import gated_stack_pallas, gated_stack_xla
from diffroll_tpu.ops.gated_stack import stack_weights as j_stack_weights
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.compat import state_dict_from_jax
from diffroll_tpu_torch.ops import fused_forward as t_fused_forward
from diffroll_tpu_torch.ops.fused_forward import FusedOperands, head_weights

# the module (the package re-exports a function of the same name)
tgs = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")

torch.set_num_threads(1)
ATOL, RTOL = 1e-4, 1e-3
BF16_GATE = 0.05
C, L, T, B = 16, 4, 32, 2


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _pair(unconditional=False, c=C, layers=L, frames=T, seed=0):
    name = "DiffRoll" if unconditional else "ClassifierFreeDiffRoll"
    kw = dict(residual_channels=c, residual_layers=layers, frames=frames, timesteps=12)
    if unconditional:
        kw["unconditional"] = True
    jm = jmodels.build(name, **kw)
    params = jm.init(jax.random.key(seed))
    head = params["params"]["output_projection"]
    head["kernel"] = 0.1 * jax.random.normal(jax.random.key(9), head["kernel"].shape)
    tm = tmodels.build(name, **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    tm.net.requires_grad_(False)  # these tests read the weights, never their gradients
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _stack_inputs(seed, b=B, t=T, c=C, layers=L):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            (0.1 * rng.standard_normal((layers, b, c))).astype(np.float32),
            rng.random((b, t, 229)).astype(np.float32))


def test_stack_weights_match(pair):
    """The stacked weights (the prepared operands': `stack_weights`' with the
    diffusion projections filled in) are the JAX package's."""
    jm, params, tm = pair
    jw = j_stack_weights(params, L)
    tw = FusedOperands.of(tm.net).weights
    for name in jw._fields:
        np.testing.assert_array_equal(getattr(tw, name).numpy(), np.asarray(getattr(jw, name)),
                                      err_msg=name)


@pytest.mark.parametrize("unconditional", [False, True], ids=["cond", "uncond"])
def test_fused_operands_are_the_direct_builds(unconditional):
    """`FusedOperands.of` holds, bit for bit, what `stack_weights` and
    `head_weights` build from the same net, read without autograd, plus the
    diffusion projections; off the card it holds no kernel operands.
    `stack_weights` itself stays under autograd (the training route)."""
    name = "DiffRoll" if unconditional else "ClassifierFreeDiffRoll"
    kw = dict(residual_channels=C, residual_layers=L, frames=T, timesteps=12)
    if unconditional:
        kw["unconditional"] = True
    torch.manual_seed(0)
    net = tmodels.build(name, **kw).net
    ops = FusedOperands.of(net)
    w, head = tgs.stack_weights(net), head_weights(net)
    assert ops.kernel is None and w.wt is None and w.bt is None and w.wd.requires_grad
    assert (ops.weights.wc is None) == (w.wc is None) == unconditional
    for field in ("wd", "wc", "wo", "b", "bc", "bo"):
        got, want = getattr(ops.weights, field), getattr(w, field)
        if want is not None:
            assert torch.equal(got, want) and not got.requires_grad, field
    layers = list(net.residual_layers)
    assert torch.equal(ops.weights.wt,
                       torch.stack([l.diffusion_projection.weight.t() for l in layers]))
    assert torch.equal(ops.weights.bt, torch.stack([l.diffusion_projection.bias for l in layers]))
    assert all(torch.equal(got, want) for got, want in zip(ops.head, head))


@pytest.mark.parametrize("with_cond", [True, False], ids=["cond", "nocond"])
def test_stack_plain_matches_xla(pair, with_cond):
    jm, params, tm = pair
    x, tb, cond = _stack_inputs(1)
    dil = jm.config.dilations()
    j = gated_stack_xla(jnp.asarray(x), jnp.asarray(tb),
                        jnp.asarray(cond) if with_cond else None,
                        j_stack_weights(params, L), dil)
    t = tgs.gated_stack_ref(torch.from_numpy(x), torch.from_numpy(tb),
                            torch.from_numpy(cond) if with_cond else None,
                            tgs.stack_weights(tm.net), dil)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("frames", [32, 8], ids=["T32", "T8_wide_taps"])
def test_stack_plain_matches_pallas_interpret(frames):
    """bf16 Pallas kernel vs the port's f32 plain version. T=8 with
    dilation 8 puts every shifted tap of the last layer outside the clip."""
    jm, params, tm = _pair(frames=frames)
    x, tb, cond = _stack_inputs(2, t=frames)
    dil = jm.config.dilations()
    j = gated_stack_pallas(jnp.asarray(x), jnp.asarray(tb), jnp.asarray(cond),
                           j_stack_weights(params, L), dil, interpret=True)
    t = tgs.gated_stack_ref(torch.from_numpy(x), torch.from_numpy(tb),
                            torch.from_numpy(cond), tgs.stack_weights(tm.net), dil)
    assert _rel(t.numpy(), j) < BF16_GATE


def test_wrapper_runs_plain_version_on_cpu(pair):
    """A CPU tensor goes to the plain version; no kernel launch is counted."""
    jm, params, tm = pair
    x, tb, cond = (torch.from_numpy(a) for a in _stack_inputs(3))
    w = tgs.stack_weights(tm.net)
    before = tgs.gated_stack.launches
    out = tgs.gated_stack(x, tb, cond, w, jm.config.dilations())
    ref = tgs.gated_stack_ref(x, tb, cond, w, jm.config.dilations())
    assert torch.equal(out, ref) and tgs.gated_stack.launches == before


def test_kernel_weights_layout(pair):
    jm, params, tm = pair
    w = tgs.stack_weights(tm.net)
    kw = tgs.kernel_weights(w)
    assert kw.wcat.dtype == torch.bfloat16 and kw.wcat.shape == (L, 3 * C + 256, 2 * C)
    torch.testing.assert_close(kw.wcat[:, :3 * C].float(),
                               w.wd.reshape(L, 3 * C, 2 * C).bfloat16().float())
    torch.testing.assert_close(kw.wcat[:, 3 * C:].float(), w.wc.bfloat16().float())
    assert torch.all(kw.wcat[:, 3 * C + 229:] == 0)  # padded conditioner rows stay zero
    torch.testing.assert_close(kw.b_eff, w.b + w.bc)
    with pytest.raises(ValueError, match="multiple"):
        tgs.check_kernel_shapes(kw, C, L, torch.device("cpu"))  # C=16 is no multiple of 64


@pytest.mark.parametrize("unconditional", [False, True], ids=["cond", "uncond"])
@pytest.mark.parametrize("t_kind", ["int", "float"])
def test_fused_forward_matches(unconditional, t_kind):
    """The port's fused forward (plain stack on CPU) against the JAX fused
    forward (XLA stack) and the port's own module forward."""
    jm, params, tm = _pair(unconditional=unconditional)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, 88)).astype(np.float32)
    t = np.array([3, 11], np.int32) if t_kind == "int" else np.array([2.5, 7.25], np.float32)
    cond = None if unconditional else rng.random((B, T, 229)).astype(np.float32)
    dil = jm.config.dilations()
    j = j_fused_forward(params, jnp.asarray(x), jnp.asarray(t),
                        None if cond is None else jnp.asarray(cond), n_layers=L,
                        dilations=dil, max_steps=12, use_pallas=False)
    tcond = None if cond is None else torch.from_numpy(cond)
    with torch.no_grad():
        out = t_fused_forward(tm.net, torch.from_numpy(x), torch.from_numpy(t), tcond,
                              dilations=dil)
        mod = tm.apply(torch.from_numpy(x), torch.from_numpy(t), tcond)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), mod.numpy(), atol=ATOL, rtol=RTOL)
