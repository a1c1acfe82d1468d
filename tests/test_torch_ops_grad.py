"""The trainable gated stack of the port (ops/gated_stack_grad.py,
ops/gated_stack_train.py) against the JAX package, on the same numpy inputs:

  * the plain forward-with-saves and the plain backward vs `_fwd_saves_xla`
    / `_bwd_xla` (f32: atol 1e-4, rtol 1e-3);
  * `GatedStackFn` (plain route) vs `torch.autograd` of `gated_stack_ref`
    (max|d| / max|ref| < 1e-4, the gate of tests/test_ops_grad.py), and
    `torch.autograd.gradcheck` of it in float64;
  * the plain versions vs the Pallas training kernels in interpret mode
    (bf16 saves: rel < 0.05);
  * shifts that leave the clip (T=8, dilation 8).
The CUDA kernels against the plain versions are in
tests/test_torch_kernels_gpu.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu.ops.gated_stack import GatedStackWeights as JWeights
from diffroll_tpu.ops.gated_stack_grad import _bwd_xla, _fwd_saves_xla
from diffroll_tpu.ops.gated_stack_train import gated_stack_bwd_pallas, gated_stack_fwd_pallas
from diffroll_tpu_torch.ops.gated_stack_grad import IMPLS, GatedStackFn, gated_stack_trainable
from diffroll_tpu_torch.ops.gated_stack_train import bwd, bwd_ref, fwd_saves, fwd_saves_ref

tgs = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")

torch.set_num_threads(1)
ATOL, RTOL = 1e-4, 1e-3
L, K, C, M0, B, T = 4, 3, 16, 10, 4, 32
DIL = (1, 2, 4, 1)
W_FIELDS = ("wd", "wc", "wo", "b", "bc", "bo")


def _setup(conditional=True, seed=0, t_len=T, layers=L, dtype=np.float32, mp=128):
    """(x, t_bias, cond, weights dict, cotangent) as numpy arrays."""
    rng = np.random.RandomState(seed)

    def arr(*s):
        return (rng.randn(*s) * 0.3).astype(dtype)

    w = dict(wd=arr(layers, K, C, 2 * C), wc=arr(layers, mp, 2 * C) if conditional else None,
             wo=arr(layers, C, 2 * C), b=arr(layers, 2 * C),
             bc=arr(layers, 2 * C) if conditional else None, bo=arr(layers, 2 * C))
    return (arr(B, t_len, C), arr(layers, B, C),
            arr(B, t_len, M0) if conditional else None, w, arr(B, t_len, C))


def _jw(w):
    n = w["wd"].shape[0]
    conv = {k: None if v is None else jnp.asarray(v) for k, v in w.items()}
    return JWeights(**conv, wt=jnp.zeros((n, 8, C), jnp.float32), bt=jnp.zeros((n, C), jnp.float32))


def _tw(w, requires_grad=False):
    conv = {k: None if v is None else torch.from_numpy(v).requires_grad_(requires_grad)
            for k, v in w.items()}
    return tgs.GatedStackWeights(**conv, wt=None, bt=None)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _leaves(dx, dtb, dcond, dw):
    """Name -> array of every gradient a backward returns."""
    out = {"dx": dx, "dt_bias": dtb}
    if dcond is not None:
        out["dcond"] = dcond
    for f in W_FIELDS:
        v = getattr(dw, f)
        if v is not None:
            out["d" + f] = v
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


@pytest.mark.parametrize("conditional", [True, False], ids=["cond", "nocond"])
def test_fwd_saves_ref_matches_xla(conditional):
    x, tb, cond, w, _ = _setup(conditional)
    js = _fwd_saves_xla(_j(x), _j(tb), _j(cond), _jw(w), DIL)
    ts = fwd_saves_ref(_t(x), _t(tb), _t(cond), _tw(w), DIL)
    for name, j, t in zip(("skip", "xs", "a"), js, ts):
        assert tuple(t.shape) == tuple(j.shape), name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL, err_msg=name)
    # the saved layer inputs are x itself, before the time bias
    np.testing.assert_array_equal(ts[1][0].numpy(), x)


@pytest.mark.parametrize("need_dcond", [True, False], ids=["dcond", "nodcond"])
@pytest.mark.parametrize("conditional", [True, False], ids=["cond", "nocond"])
def test_bwd_ref_matches_xla(conditional, need_dcond):
    x, tb, cond, w, cot = _setup(conditional, seed=1)
    _, xs, a = _fwd_saves_xla(_j(x), _j(tb), _j(cond), _jw(w), DIL)
    jg = _bwd_xla(DIL, (x.shape, _j(tb), _j(cond), _jw(w), xs, a), _j(cot), need_dcond)
    saves = (_t(tb), _t(cond), _tw(w), _t(np.array(xs)), _t(np.array(a)))
    tg = bwd_ref(DIL, saves, _t(cot), need_dcond)
    assert (tg[2] is not None) == (conditional and need_dcond)
    assert (jg[2] is not None) == (conditional and need_dcond)
    jl, tl = _leaves(*jg), _leaves(*tg)
    assert sorted(jl) == sorted(tl)
    for name in jl:
        np.testing.assert_allclose(tl[name], jl[name], atol=ATOL, rtol=RTOL, err_msg=name)


def _autograd_pair(conditional, impl="plain", need_dcond=True, seed=2):
    """Gradients of sum(stack * cot) through `gated_stack_ref` under autograd
    and through `GatedStackFn`."""
    x, tb, cond, w, cot = _setup(conditional, seed=seed)
    out = []
    for fn in ("ref", "fn"):
        tx, ttb = _t(x).requires_grad_(), _t(tb).requires_grad_()
        tc = _t(cond).requires_grad_() if conditional else None
        tw = _tw(w, requires_grad=True)
        if fn == "ref":
            skip = tgs.gated_stack_ref(tx, ttb, tc, tw, DIL)
        else:
            skip = gated_stack_trainable(tx, ttb, tc, tw, DIL, impl, need_dcond)
        (skip * _t(cot)).sum().backward()
        grads = {"dx": tx.grad, "dt_bias": ttb.grad, "dcond": None if tc is None else tc.grad}
        grads.update({"d" + f: getattr(tw, f).grad for f in W_FIELDS
                      if getattr(tw, f) is not None})
        out.append((skip.detach(), grads))
    return out


@pytest.mark.parametrize("conditional", [True, False], ids=["cond", "nocond"])
def test_fn_matches_autograd_of_plain_stack(conditional):
    (skip_r, gr), (skip_f, gf) = _autograd_pair(conditional)
    assert _rel(skip_f, skip_r) < 1e-5
    for name, ref in gr.items():
        if ref is None:
            continue
        assert gf[name] is not None, name
        assert _rel(gf[name], ref) < 1e-4, name


def test_need_dcond_false_gives_no_cond_gradient():
    (_, gr), (_, gf) = _autograd_pair(True, need_dcond=False)
    assert gf["dcond"] is None
    for name, ref in gr.items():
        if name != "dcond":
            assert _rel(gf[name], ref) < 1e-4, name


@pytest.mark.parametrize("impl", [i for i in IMPLS if i != "plain"])
def test_kernel_impls_run_plain_versions_on_cpu_tensors(impl):
    """On CPU tensors the kernel routes go through the wrappers, which run
    the plain versions there and launch nothing."""
    n3, n4 = fwd_saves.launches, bwd.launches
    (_, gr), (_, gf) = _autograd_pair(True, impl=impl)
    for name, ref in gr.items():
        assert _rel(gf[name], ref) < 1e-4, name
    assert (fwd_saves.launches, bwd.launches) == (n3, n4)


def test_unknown_impl_raises():
    x, tb, cond, w, _ = _setup(True)
    with pytest.raises(ValueError, match="impl"):
        gated_stack_trainable(_t(x), _t(tb), _t(cond), _tw(w), DIL, "pallas")


@pytest.mark.parametrize("need_dcond", [True, False], ids=["dcond", "nodcond"])
def test_gradcheck_float64(need_dcond):
    """The plain backward is the derivative of the plain forward (float64,
    tiny size, finite differences)."""
    x, tb, cond, w, _ = _setup(True, seed=3, t_len=6, layers=2, dtype=np.float64, mp=M0)
    bsz = 2
    tw = _tw(w, requires_grad=True)
    tx, ttb = _t(x[:bsz]).requires_grad_(), _t(tb[:, :bsz]).requires_grad_()
    tc = _t(cond[:bsz]).requires_grad_(need_dcond)

    def fn(x_, tb_, c_, *ws):
        return GatedStackFn.apply((1, 2), "plain", need_dcond, x_, tb_, c_, *ws)

    assert torch.autograd.gradcheck(
        fn, (tx, ttb, tc, tw.wd, tw.wc, tw.wo, tw.b, tw.bc, tw.bo), eps=1e-6, atol=1e-5,
        rtol=1e-4)


@pytest.mark.parametrize("conditional", [True, False], ids=["cond", "nocond"])
def test_plain_matches_pallas_interpret(conditional):
    """The port's plain versions vs the Pallas training kernels in interpret
    mode. The kernels keep bf16 operands and bf16 saves, hence rel < 0.05."""
    x, tb, cond, w, cot = _setup(conditional, seed=4)
    skip_p, xs_p, a_p = gated_stack_fwd_pallas(_j(x), _j(tb), _j(cond), _jw(w), DIL,
                                               interpret=True)
    skip_t, xs_t, a_t = fwd_saves_ref(_t(x), _t(tb), _t(cond), _tw(w), DIL)
    assert _rel(skip_t, skip_p) < 0.05
    assert _rel(xs_t, np.asarray(xs_p.astype(jnp.float32))) < 0.05
    assert _rel(a_t, np.asarray(a_p.astype(jnp.float32))) < 0.05

    gp = gated_stack_bwd_pallas(DIL, (x.shape, _j(tb), _j(cond), _jw(w), xs_p, a_p), _j(cot),
                                interpret=True)
    gt = bwd_ref(DIL, (_t(tb), _t(cond), _tw(w), xs_t, a_t), _t(cot), True)
    pl_leaves, t_leaves = _leaves(*gp), _leaves(*gt)
    for name, ref in pl_leaves.items():
        assert _rel(t_leaves[name], ref) < 0.05, name


def test_shifts_leave_the_clip():
    """T=8 with dilation 8: the outer taps read (and, transposed, write)
    only zeros outside [0, T) of each sequence."""
    dil = (8, 1, 8, 2)
    x, tb, cond, w, cot = _setup(True, seed=5, t_len=8)
    js = _fwd_saves_xla(_j(x), _j(tb), _j(cond), _jw(w), dil)
    ts = fwd_saves_ref(_t(x), _t(tb), _t(cond), _tw(w), dil)
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)
    jg = _bwd_xla(dil, (x.shape, _j(tb), _j(cond), _jw(w), js[1], js[2]), _j(cot), True)
    tg = bwd_ref(dil, (_t(tb), _t(cond), _tw(w), ts[1], ts[2]), _t(cot), True)
    jl, tl = _leaves(*jg), _leaves(*tg)
    for name in jl:
        np.testing.assert_allclose(tl[name], jl[name], atol=ATOL, rtol=RTOL, err_msg=name)
    # with dilation 8 at T=8 only the centre tap of those layers sees data
    assert np.abs(jl["dwd"][0, 0]).max() == 0.0 and np.abs(tl["dwd"][0, 0]).max() == 0.0
    assert np.abs(tl["dwd"][0, 1]).max() > 0.0
