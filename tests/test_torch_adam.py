"""bf16 Adam moments (`trainer.adam_moments_dtype=bfloat16`,
`train/state.BF16MomentAdam`) against the JAX package's
`fused_adam_apply(moments_dtype='bfloat16')`, the counterparts of
tests/test_parallel_train.py's stochastic-rounding and packed-moment tests:

  * stochastic rounding is exact on bf16-representable values and unbiased
    between neighbours (25% round-up a quarter of the way, the mean within
    2^-11), on both signs;
  * 10 steps with bf16 moments track f32 Adam (atol 5e-4, JAX's tolerance);
  * against JAX's packed update on the same gradients over 5 steps: the
    parameters within 5e-4, and each moment max|d| / max|ref| < 0.02 (each
    step's rounding moves a moment by up to one bf16 ulp, 2^-7 relative, in
    either package, with bits that differ: JAX's `jax.random` cannot be
    replayed, so a tolerance, not bits);
  * the `train` entry with `trainer.adam_moments_dtype=bfloat16`: bf16
    moments in the state and in the checkpoint, which round-trips through
    `Checkpointer` and `load_state_dict` as bf16; `pretrained_path` with the
    field set starts a fresh optimizer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu.train.state import fused_adam_apply
from diffroll_tpu.train.state import make_optimizer as j_make_optimizer
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.compat import read_ckpt
from diffroll_tpu_torch.train import Checkpointer
from diffroll_tpu_torch.train.state import BF16MomentAdam, stochastic_round_bf16
from test_torch_train_cli import TINY, _write_tree

torch.set_num_threads(1)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_stochastic_round_exact_and_unbiased(sign):
    exact = sign * torch.tensor([1.0, 2.5, 0.0, 0.15625, 2.0 ** 127])
    for i in range(4):
        out = stochastic_round_bf16(exact, torch.Generator().manual_seed(i))
        assert out.dtype == torch.bfloat16 and torch.equal(out.float(), exact.bfloat16().float())
    assert torch.equal(stochastic_round_bf16(exact, None).float(), exact.bfloat16().float())
    # a quarter of the way from 1.0 to the next bf16 (ulp 2^-7): ~25% round away
    x = torch.full((20000,), sign * (1.0 + 0.25 * 2.0 ** -7))
    out = stochastic_round_bf16(x, torch.Generator().manual_seed(42)).float()
    frac_up = float((out.abs() > 1.0).float().mean())
    assert 0.22 < frac_up < 0.28, frac_up
    assert abs(float(out.mean()) - float(x[0])) < 2.0 ** -11


def _params(rng):
    return {"a": rng.randn(33, 9).astype(np.float32), "w": rng.randn(16).astype(np.float32)}


def _torch_opt(params, lr, moments):
    ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
    if moments:
        return ps, BF16MomentAdam(ps, lr, seed=0)
    return ps, torch.optim.Adam(ps, lr=lr)


def _step(ps, opt, grads):
    for p, g in zip(ps, grads):
        p.grad = torch.from_numpy(g)
    opt.step()


def test_bf16_moments_track_f32_adam():
    rng = np.random.RandomState(1)
    params = _params(rng)
    p16, opt16 = _torch_opt(params, 1e-3, True)
    p32, opt32 = _torch_opt(params, 1e-3, False)
    for _ in range(10):
        grads = [rng.randn(*v.shape).astype(np.float32) for v in params.values()]
        _step(p16, opt16, grads)
        _step(p32, opt32, grads)
    st = opt16.state[p16[0]]
    assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in p16)
    for a, b in zip(p16, p32):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=5e-4)


def test_bf16_moments_against_jax_packed_update():
    rng = np.random.RandomState(2)
    params = _params(rng)
    tx = j_make_optimizer(1e-3, moments_dtype="bfloat16")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = tx.init(jp)
    ps, opt = _torch_opt(params, 1e-3, True)
    for _ in range(5):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        jp, jopt = fused_adam_apply(tx, jp, {k: jnp.asarray(g) for k, g in grads.items()}, jopt)
        _step(ps, opt, list(grads.values()))
    assert jopt[0].mu["a"].dtype == jnp.bfloat16
    for (k, jv), p in zip(jp.items(), ps):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jv), atol=5e-4)
        st = opt.state[p]
        for mine, theirs in ((st["exp_avg"], jopt[0].mu[k]), (st["exp_avg_sq"], jopt[0].nu[k])):
            theirs = np.asarray(theirs.astype(jnp.float32))
            d = np.abs(mine.float().numpy() - theirs).max()
            assert d / np.abs(theirs).max() < 0.02, k


def test_train_cli_with_bf16_moments_and_checkpoint_round_trip(tmp_path):
    tree = _write_tree(tmp_path / "maps")
    state = train_cli.main(
        ["spec_roll", f"dataset.root={tree}", f"trainer.output_dir={tmp_path / 'out'}",
         "trainer.max_epochs=2", "trainer.adam_moments_dtype=bfloat16", *TINY])
    assert state.step == 6 and isinstance(state.optimizer, BF16MomentAdam)
    moments = [st["exp_avg"] for st in state.optimizer.state.values()]
    assert moments and all(m.dtype == torch.bfloat16 for m in moments)
    (run_dir,) = (tmp_path / "out").glob("*/*/train-*")
    losses = [float(l.split('"train/diffusion_loss": ')[1].split(",")[0])
              for l in (run_dir / "metrics.jsonl").read_text().splitlines()
              if "train/diffusion_loss" in l]
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    # the checkpoint keeps the bf16 moments, and they load back as bf16
    last = run_dir / "checkpoints" / "last.ckpt"
    sd = Checkpointer(run_dir / "checkpoints").load("last")["optimizer_state"]
    assert all(st["exp_avg_sq"].dtype == torch.bfloat16 for st in sd["state"].values())
    fresh = BF16MomentAdam(state.model.net.parameters(), 5e-5)
    fresh.load_state_dict(sd)
    for p in state.model.net.parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            got, want = fresh.state[p][k], state.optimizer.state[p][k]
            assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # from pretrained_path with the moments set: a fresh optimizer, the step kept
    args = [a for a in TINY if not a.startswith("model.")]
    again = train_cli.main(
        ["spec_roll", f"dataset.root={tree}", f"trainer.output_dir={tmp_path / 'ft'}",
         f"pretrained_path={last}", "trainer.max_epochs=1",
         "trainer.adam_moments_dtype=bfloat16", *args])
    assert again.step == 6 + 3
    assert all(float(st["step"]) == 3 for st in again.optimizer.state.values())
    assert read_ckpt(str(last))["global_step"] == 6
    with pytest.raises(ValueError, match="only 'bfloat16'"):
        train_cli.main(["spec_roll", f"dataset.root={tree}", "trainer.adam_moments_dtype=float16",
                        f"trainer.output_dir={tmp_path / 'bad'}", *TINY])
