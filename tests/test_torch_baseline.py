"""The port's discriminative baseline against the JAX package's
`BaselineTask` on the CPU, on the same weights (`state_dict_from_jax`) and
the same dummy inputs (the uniform "gaussian" x_t and the timesteps that the
JAX task draws from its key, recomputed here and handed to the port):

  * the loss (unnormalised roll) within 1e-5 and every parameter gradient
    max|d| / max|ref| < 2e-3, for each time_mode and x_t mode;
  * the one-shot `predict` at the f32 gates (atol 1e-4, rtol 1e-3);
  * the evaluation walk (`sample`, one forward a step) on JAX's per-step
    draws, rel < 1e-3;
  * `train baseline`: the preset, the stored task_type, the 0.6 threshold,
    `test_metrics.json`, and `test` on the checkpoint it wrote.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.tasks.baseline import BaselineConfig as JBaselineConfig
from diffroll_tpu.tasks.baseline import BaselineTask as JBaselineTask
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import _common as tcommon
from diffroll_tpu_torch.cli import test as test_cli
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.compat import grads_from_jax, read_ckpt, state_dict_from_jax
from diffroll_tpu_torch.config import compose
from diffroll_tpu_torch.tasks import BaselineConfig as TBaselineConfig
from diffroll_tpu_torch.tasks import BaselineTask as TBaselineTask
from test_torch_test_cli import _write_split  # the synthetic MAPS splits

torch.set_num_threads(1)
# the model's embedding table has 100 rows: time_mode='random' draws t from
# [0, 100), as the reference (T = 200) does; the walk runs STEPS steps
C, L, FRAMES, B, T, STEPS = 8, 2, 16, 3, 100, 10
LOSS_TOL, GRAD_GATE = 1e-5, 2e-3
MODES = [("constant_maxT", "gaussian"), ("constant", "zeros"), ("random", "gaussian")]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-5))


@pytest.fixture(scope="module")
def pair():
    kw = dict(residual_channels=C, residual_layers=L, frames=FRAMES, timesteps=T)
    jm = jmodels.build("DiffRollBaseline", **kw)
    params = jm.init(jax.random.key(0))
    head = params["params"]["output_projection"]
    head["kernel"] = 0.1 * jax.random.normal(jax.random.key(9), head["kernel"].shape)
    tm = tmodels.build("DiffRollBaseline", **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    assert tm.config.kernel_size == 7 and set(tm.config.dilations()) == {1}
    return jm, params, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"frame": (rng.random((B, FRAMES, 88)) > 0.9).astype(np.float32),
            "audio": rng.standard_normal((B, FRAMES * 512)).astype(np.float32)}


def _tasks(jm, tm, **kw):
    return JBaselineTask(jm, JBaselineConfig(**kw)), TBaselineTask(tm, TBaselineConfig(**kw))


def _jax_dummies(key, cfg):
    """The (x_t, t) `BaselineTask._dummy_inputs` draws from `key`."""
    if cfg.time_mode == "constant":
        t = jnp.ones((B,), jnp.int32)
    elif cfg.time_mode == "constant_maxT":
        t = jnp.full((B,), cfg.timesteps - 1, jnp.int32)
    else:
        t = jax.random.randint(key, (B,), 0, 100)
    shape = (B, FRAMES, 88)
    x_t = (jnp.zeros(shape) if cfg.x_t == "zeros"
           else jax.random.uniform(jax.random.fold_in(key, 1), shape, jnp.float32))
    return torch.from_numpy(np.array(x_t)), torch.from_numpy(np.array(t)).long()


@pytest.mark.parametrize("time_mode,x_t", MODES)
def test_loss_and_grads_match_jax(pair, time_mode, x_t):
    jm, params, tm = pair
    jtask, ttask = _tasks(jm, tm, timesteps=T, time_mode=time_mode, x_t=x_t)
    b, key = _batch(), jax.random.key(2)
    (jloss, (jlosses, _)), jgrads = jax.value_and_grad(
        lambda p: jtask.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()}, key),
        has_aux=True)(params)
    dx, dt = _jax_dummies(key, jtask.config)
    if x_t == "gaussian":  # the reference's quirk: uniform draws in [0, 1)
        assert float(dx.min()) >= 0.0 and float(dx.max()) < 1.0
    tm.net.zero_grad(set_to_none=True)
    loss, (losses, tensors) = ttask.loss_fn({k: torch.from_numpy(v) for k, v in b.items()},
                                            None, True, x_t=dx, t=dt)
    loss.backward()
    assert sorted(losses) == sorted(jlosses) == ["amt_loss"]
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_TOL
    # the roll is regressed as it is, not normalised to the model's (-1, 1)
    manual = torch.mean((tensors["pred_roll"].detach() - torch.from_numpy(b["frame"])) ** 2)
    assert abs(float(manual) - float(loss.detach())) < 1e-7
    want = grads_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in tm.net.named_parameters():
        ref = want[name]
        if float(ref.abs().max()) == 0:  # no gradient reaches it in either package
            assert p.grad is None or float(p.grad.abs().max()) == 0, name
            continue
        assert _rel(p.grad, ref) < GRAD_GATE, name


@pytest.mark.parametrize("time_mode,x_t", MODES)
def test_predict_matches_jax(pair, time_mode, x_t):
    jm, params, tm = pair
    jtask, ttask = _tasks(jm, tm, timesteps=T, time_mode=time_mode, x_t=x_t)
    b, key = _batch(1), jax.random.key(4)
    want = jtask.predict(params, {k: jnp.asarray(v) for k, v in b.items()}, key)
    dx, dt = _jax_dummies(key, jtask.config)
    with torch.no_grad():
        got = ttask.predict({k: torch.from_numpy(v) for k, v in b.items()}, x_t=dx, t=dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)
    # its own draws: the same shapes, and the same numbers from the same seed
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        one = ttask.predict(tb, torch.Generator().manual_seed(5))
        two = ttask.predict(tb, torch.Generator().manual_seed(5))
    assert one.shape == (B, FRAMES, 88) and torch.equal(one, two)


def test_sample_walk_matches_jax(pair):
    jm, params, tm = pair
    jtask, ttask = _tasks(jm, tm, timesteps=STEPS)
    b, key = _batch(2), jax.random.key(6)
    x_T = np.random.default_rng(7).standard_normal((B, FRAMES, 88)).astype(np.float32)
    want, _ = jtask.sample(params, jnp.asarray(x_T), key, waveform=jnp.asarray(b["audio"]))
    # sample_loop's per-step keys; ddpm_x0_step draws normal(k, x.shape)
    noise = torch.from_numpy(np.stack([np.array(jax.random.normal(k, x_T.shape, jnp.float32))
                                       for k in jax.random.split(key, STEPS)]))
    got, traj = ttask.sample(torch.from_numpy(x_T), waveform=torch.from_numpy(b["audio"]),
                             noise=noise, record_every=5)
    assert _rel(got, np.asarray(want)) < 1e-3
    assert traj.shape == (2, B, FRAMES, 88) and torch.equal(traj[-1], got)
    with pytest.raises(ValueError, match="noise"):
        ttask.sample(torch.from_numpy(x_T), waveform=torch.from_numpy(b["audio"]))


def test_unknown_modes_raise(pair):
    _, _, tm = pair
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for bad in (dict(time_mode="sometimes"), dict(x_t="laplace")):
        with pytest.raises(ValueError, match="is not recognized"):
            TBaselineTask(tm, TBaselineConfig(**bad)).loss_fn(b, torch.Generator())


def test_baseline_preset_and_threshold():
    cfg = compose("baseline")
    assert cfg.task_type == "baseline" and cfg.model_name == "DiffRollBaseline"
    assert cfg.trainer.monitor == "val/amt_loss"
    assert tcommon.task_threshold(cfg) == 0.6 and tcommon.task_lr(cfg) == cfg.baseline.lr
    assert tcommon.task_threshold(compose("spec_roll")) == 0.5
    model, task = tcommon.setup_model_task(
        compose("baseline", {"model.residual_channels": "8", "model.residual_layers": "2"}),
        "cpu")
    assert isinstance(task, TBaselineTask) and task.model is model


def test_train_baseline_then_test(tmp_path):
    root = tmp_path / "maps"
    _write_split(root, "AkPnBcht", 4, 2.0, seed=0)
    _write_split(root, "ENSTDkCl", 2, 1.5, seed=1)
    out = tmp_path / "out"
    args = ["model.residual_channels=8", "model.residual_layers=2", "model.frames=16",
            "dataset.sequence_length=8192", "task.timesteps=10", "baseline.timesteps=10",
            "dataloader.train_batch_size=2", "dataloader.val_batch_size=2",
            "dataloader.num_workers=1", "device=cpu", "audio_format=wav",
            f"dataset.root={root}"]
    state = train_cli.main(["baseline", f"trainer.output_dir={out}", "trainer.max_epochs=1",
                            "trainer.check_val_every_n_epoch=1", "trainer.log_every_n_steps=1",
                            *args])
    assert state.step == 2
    (run_dir,) = out.glob("*/*/train-*")
    records = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert any("train/amt_loss" in r for r in records)
    assert any("val/amt_loss" in r for r in records)
    metrics = json.loads((run_dir / "test_metrics.json").read_text())
    assert metrics["n_clips"] == 2 and 0.0 <= metrics["frame_f1"] <= 1.0
    last = run_dir / "checkpoints" / "last.ckpt"
    port = read_ckpt(str(last))["hyper_parameters"]["port_config"]
    assert port["task_type"] == "baseline" and port["baseline"]["frame_threshold"] == 0.6
    assert port["model"]["kernel_size"] == 7
    # `test` on that checkpoint adopts the baseline task from it
    seen = {}
    real = test_cli.run_test

    def spy(cfg, model, task, **kw):
        seen.update(task=task, threshold=tcommon.task_threshold(cfg))
        return real(cfg, model, task, **kw)

    test_cli.run_test = spy
    try:
        m2 = test_cli.main([f"pretrained_path={last}", f"trainer.output_dir={out}", *args])
    finally:
        test_cli.run_test = real
    assert isinstance(seen["task"], TBaselineTask) and seen["threshold"] == 0.6
    assert m2["n_clips"] == 2
