"""The port's progressive distillation against the JAX package on the CPU, on
the same weights (JAX params carried over with `state_dict_from_jax`), the
same batch and the same draws (the transitions i and the noise that the JAX
loss draws from its key, recomputed here with the same `jax.random.split`
and handed to the port):

  * the grids, exactly; `DistillConfig.stage_steps` and the nesting warning;
  * `ddim_x0_vec`, `ddim_x0_target` and `truncated_snr_weight` at atol 1e-6,
    the final `tp == -1` rows included;
  * the frozen teacher's fused route (the gated stack's plain version on the
    CPU) against `model.apply_cfg` / `model.apply`: atol 1e-4, rtol 1e-3;
  * the distill loss, guided and unguided, by both routes: loss within 1e-5,
    every parameter gradient max|d| / max|ref| < 2e-3;
  * one Adam step of a stage against `distill_stage`: atol 1e-6;
  * a 20-step stage lowers the loss; a two-stage chain prepares the second
    stage's teacher from the first stage's student;
  * the `distill` entry between `train` and `test` / `serve`.

The tiny model is the one of tests/test_distill.py: C=8, L=2, 16 frames,
T=100, the zero-init output head randomised (a teacher predicting x0 == 0
composes exactly across DDIM steps, which makes every target zero).
"""

import copy
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.config.experiment import DistillConfig as JDistillConfig
from diffroll_tpu.diffusion import distill as jdistill
from diffroll_tpu.diffusion.samplers import cfg_mix as j_cfg_mix
from diffroll_tpu.diffusion.schedule import linear_schedule as j_linear_schedule
from diffroll_tpu.train.distill import distill_stage as j_distill_stage
from diffroll_tpu.train.distill import make_distill_loss as j_make_distill_loss
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import distill as distill_cli
from diffroll_tpu_torch.cli import serve as serve_cli
from diffroll_tpu_torch.cli import test as test_cli
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.compat import grads_from_jax, read_ckpt, state_dict_from_jax
from diffroll_tpu_torch.config import DistillConfig as TDistillConfig
from diffroll_tpu_torch.config import compose
from diffroll_tpu_torch.diffusion import distill as tdistill
from diffroll_tpu_torch.diffusion.schedule import Schedule
from diffroll_tpu_torch.ops.fused_forward import FusedOperands
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig
from diffroll_tpu_torch.train import TrainState, make_train_step
from diffroll_tpu_torch.train import distill as tdistill_train
from test_torch_test_cli import _write_split  # the synthetic MAPS splits

torch.set_num_threads(1)
T, C, L, FRAMES, B = 100, 8, 2, 16, 4
MATH_TOL, LOSS_TOL, GRAD_GATE = 1e-6, 1e-5, 2e-3
J_SCHED = j_linear_schedule(1e-4, 0.02, T)
# the JAX tables as the port's Schedule: the functions are compared on one
# schedule (the two frameworks' own tables differ by f32 round-off, which
# tests/test_torch_config.py::test_beta_schedules_match bounds)
T_SCHED = Schedule(*[torch.from_numpy(np.array(v)) for v in J_SCHED])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-5))


# ------------------------------------------------------------ grids and config

@pytest.mark.parametrize("n", [33, 17, 9, 5, 3, 2])
def test_grids_match(n):
    js, jm = jdistill.distill_grids(T, n)
    ts, tm = tdistill.distill_grids(T, n)
    for j, t in ((js, ts), (jm, tm)):
        assert t.dtype == np.int32 and j.dtype == t.dtype
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("timesteps,n", [(T, 1), (10, 8)], ids=["too_few", "no_room"])
def test_grids_raise_where_jax_raises(timesteps, n):
    with pytest.raises(ValueError) as jerr:
        jdistill.distill_grids(timesteps, n)
    with pytest.raises(ValueError) as terr:
        tdistill.distill_grids(timesteps, n)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("start,stages,nests", [(65, 5, True), (33, 5, True), (9, 2, True),
                                                (2, 3, True), (64, 4, False), (10, 3, False)])
def test_stage_steps_and_nesting_warning(start, stages, nests):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = JDistillConfig(start_steps=start, stages=stages)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = TDistillConfig(start_steps=start, stages=stages)
    assert t.stage_steps() == j.stage_steps()
    assert len(tw) == len(jw) == (0 if nests else 1)
    if not nests:
        assert str(tw[0].message) == str(jw[0].message)


def test_distill_overrides_coerce():
    cfg = compose("spec_roll", {"distill.start_steps": "9", "distill.stages": "2",
                                "distill.snr_cap": "2.5", "distill.fold_guidance": "false"})
    assert cfg.distill == TDistillConfig(start_steps=9, stages=2, snr_cap=2.5,
                                         fold_guidance=False)
    assert cfg.distill.stage_steps() == [9, 5]


# ------------------------------------------------------------ the math

def _math_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 8, 5)).astype(np.float32)
    y = rng.standard_normal((6, 8, 5)).astype(np.float32)
    t = np.array([99, 87, 50, 12, 0, 0], np.int64)
    tp = np.array([74, 62, 25, 0, -1, -1], np.int64)
    return x, y, t, tp


@pytest.mark.parametrize("fn", ["ddim_x0_vec", "ddim_x0_target"])
def test_ddim_functions_match(fn):
    x, y, t, tp = _math_inputs()
    want = getattr(jdistill, fn)(J_SCHED, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                                 jnp.asarray(tp, jnp.int32), jnp.asarray(y))
    got = getattr(tdistill, fn)(T_SCHED, torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(tp), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MATH_TOL, rtol=0)
    # the tp == -1 rows take the final-step branch
    sac0 = float(T_SCHED.sqrt_alphas_cumprod[0])
    done = y[4:] / sac0 if fn == "ddim_x0_vec" else y[4:] * sac0
    np.testing.assert_allclose(got[4:].numpy(), done, rtol=1e-6)


def test_one_student_step_lands_on_the_target():
    x, y, t, tp = (torch.from_numpy(v) for v in _math_inputs(1))
    target = tdistill.ddim_x0_target(T_SCHED, x, t, tp, y)
    np.testing.assert_allclose(tdistill.ddim_x0_vec(T_SCHED, x, t, tp, target).numpy(),
                               y.numpy(), atol=1e-4)


@pytest.mark.parametrize("cap", [5.0, None])
def test_truncated_snr_weight_matches(cap):
    t = np.array([0, 1, 5, 20, 50, 99], np.int64)
    want = jdistill.truncated_snr_weight(J_SCHED, jnp.asarray(t, jnp.int32), 3, 1.0, cap)
    got = tdistill.truncated_snr_weight(T_SCHED, torch.from_numpy(t), 3, 1.0, cap)
    assert got.shape == (6, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MATH_TOL, rtol=1e-6)
    assert float(got.max()) == (5.0 if cap else float(got[0]))
    assert float(got[-1]) == 1.0  # floored at t = T - 1


# ------------------------------------------------------------ teacher, loss, step

def _pair():
    kw = dict(residual_channels=C, residual_layers=L, frames=FRAMES, timesteps=T)
    jm = jmodels.build("ClassifierFreeDiffRoll", **kw)
    params = jm.init(jax.random.key(0))
    head = params["params"]["output_projection"]
    head["kernel"] = 0.1 * jax.random.normal(jax.random.key(9), head["kernel"].shape)
    tm = tmodels.build("ClassifierFreeDiffRoll", **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"frame": (rng.random((B, FRAMES, 88)) > 0.9).astype(np.float32),
            "audio": rng.standard_normal((B, FRAMES * 512)).astype(np.float32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_draws(key, n):
    """The i and noise `make_distill_loss` draws from `key`."""
    i_key, n_key = jax.random.split(key)
    i = jax.random.randint(i_key, (B,), 0, n)
    noise = jax.random.normal(n_key, (B, FRAMES, 88), jnp.float32)
    return torch.from_numpy(np.array(i)).long(), torch.from_numpy(np.array(noise))


def _key_with_last(n):
    """The first key whose draws hold the last transition and another."""
    for seed in range(100):
        i = np.array(_jax_draws(jax.random.key(seed), n)[0])
        if (i == n - 1).any() and (i < n - 1).any():
            return jax.random.key(seed)
    raise AssertionError("no such key")


def _student_task(tm, **cfg):
    """A student (a copy of the teacher) and its task on the JAX schedule."""
    student = copy.deepcopy(tm).requires_grad_(True)
    task = TTask(student, TTaskConfig(timesteps=T, **cfg))
    task.schedule = T_SCHED
    return student, task


@pytest.mark.parametrize("guided", [True, False], ids=["guided", "unguided"])
def test_teacher_fused_route_matches_apply(pair, guided):
    jm, params, tm = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, FRAMES, 88)).astype(np.float32)
    cond = rng.random((B, FRAMES, 229)).astype(np.float32)
    t = np.array([99, 60, 12, 0], np.int64)
    teacher = tdistill_train.TeacherForward(tm, guided, 0.5, fused=True)
    assert teacher.operands.kernel is None  # no kernel operands for a CPU model
    got = teacher(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    jx, jt, jc = jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(cond)
    if guided:
        want = j_cfg_mix(*jm.apply_cfg(params, jx, jt, cond=jc), 0.5)
    else:
        want = jm.apply(params, jx, jt, jc, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)
    assert not got.requires_grad


@pytest.mark.parametrize("route", ["modules", "fused"])
@pytest.mark.parametrize("guided", [True, False], ids=["guided", "unguided"])
def test_distill_loss_and_grads_match_jax(pair, guided, route):
    """`route`: the teacher through the modules (`use_fused=false`) and the
    student by autograd, or both through the fused stack (the teacher's
    prepared operands, the student's `GatedStackFn`; plain versions here)."""
    jm, params, tm = pair
    n = 5
    grid, mid = jdistill.distill_grids(T, n)
    b, key = _batch(), _key_with_last(n)
    jloss_fn = j_make_distill_loss(jm, J_SCHED, params, grid, mid, guided=guided, w=0.5)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, _jb(b), key), has_aux=True)(params)
    i, noise = _jax_draws(key, n)
    fused = route == "fused"
    student, task = _student_task(tm, use_fused=fused, fused_train=fused)
    loss_fn = tdistill_train.make_distill_loss(task, tm, grid, mid, guided=guided, w=0.5)
    assert loss_fn.teacher.fused == fused
    loss, (losses, tensors) = loss_fn(_tb(b), None, True, i=i, noise=noise)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_TOL
    assert float(losses["distill_loss"].detach()) == float(loss.detach())
    assert tensors["pred_roll"].shape == (B, FRAMES, 88)
    want = grads_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in student.net.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        assert got[name] is not None and float(ref.abs().max()) > 0, name
        assert _rel(got[name], ref) < GRAD_GATE, name
    # the teacher is frozen: no gradient reaches it
    assert all(p.grad is None for p in tm.net.parameters())


def test_loss_on_the_last_transition(pair):
    """Every row on the final transition (t = 0 -> done): x_tm := x_t, the
    teacher's second step alone gives the target x0_b / sac[0] * sac[0], so a
    student equal to its teacher has (almost) no loss."""
    _, _, tm = pair
    n = 5
    grid, mid = tdistill.distill_grids(T, n)
    _, task = _student_task(tm)
    loss_fn = tdistill_train.make_distill_loss(task, tm, grid, mid, guided=False, w=0.0)
    i = torch.full((B,), n - 1, dtype=torch.long)
    with torch.no_grad():
        loss = float(loss_fn(_tb(_batch(5)), torch.Generator().manual_seed(6), True, i=i)[0])
        mixed = float(loss_fn(_tb(_batch(5)), torch.Generator().manual_seed(6), True,
                              i=torch.tensor([0, 1, 2, n - 1]))[0])
    assert loss < 1e-10 < mixed


def test_one_adam_step_of_a_stage_matches_jax(pair):
    """The first step of a guided stage: JAX's `distill_stage` (n_steps=1)
    against the port's pieces on JAX's draws, atol 1e-6; then the port's
    `distill_stage` against the same pieces on its own generator's draws,
    exactly.

    Adam's first step is lr * g / (|g| + eps): for a gradient within a few
    eps (1e-8) of zero it multiplies a difference in g by up to lr / eps =
    1e4, so two gradients that agree to 1e-10 (far inside the 2e-3 gate of
    the gradient test) can move a weight 1e-6 apart. The 1e-6 gate holds
    where both gradients are at least 10 eps; every other element must stay
    within the step's own bound, 2 lr, and they are fewer than 1%."""
    jm, params, tm = pair
    n, lr = 9, 1e-4
    b = _batch()

    def jbatches():
        while True:
            yield _jb(b)

    jstudent, _ = j_distill_stage(jm, J_SCHED, params, jbatches(), T, student_steps=n,
                                  n_steps=1, lr=lr, guided=True, w=0.5)
    key = jax.random.key(np.int64(n) * 7919 + 13)
    _, k = jax.random.split(key)
    i, noise = _jax_draws(k, n)
    grid, mid = tdistill.distill_grids(T, n)

    def one_step(draws, sched=None):
        student, task = _student_task(tm)
        if sched is not None:
            task.schedule = sched
        loss_fn = tdistill_train.make_distill_loss(task, tm, grid, mid, guided=True, w=0.5)
        state = TrainState.create(student, lr)
        gen = torch.Generator().manual_seed(n * 7919 + 13)
        make_train_step(lambda bt, g, train: loss_fn(bt, g, train, **draws))(state, _tb(b), gen)
        return student

    manual = one_step({"i": i, "noise": noise})
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstudent))
    jgrads = grads_from_jax(jax.tree.map(np.asarray, jax.grad(lambda p: j_make_distill_loss(
        jm, J_SCHED, params, grid, mid, guided=True, w=0.5)(p, _jb(b), k)[0])(params)))
    excluded = total = 0
    for name, p in manual.net.named_parameters():
        assert not torch.equal(p.detach(), tm.net.state_dict()[name]), name
        d = (p.detach() - want[name]).abs()
        conditioned = torch.minimum(p.grad.abs(), jgrads[name].abs()) >= 10 * 1e-8
        assert float(torch.where(conditioned, d, 0.0).max()) <= 1e-6, name
        assert float(d.max()) <= 2 * lr, name
        excluded += int((~conditioned).sum())
        total += d.numel()
    assert excluded < 0.01 * total, (excluded, total)

    def tbatches():
        while True:
            yield _tb(b)

    staged, _ = tdistill_train.distill_stage(tm, TTaskConfig(timesteps=T), tbatches(), n,
                                             n_steps=1, lr=lr, guided=True, w=0.5)
    own = one_step({}, sched=TTask(tm, TTaskConfig(timesteps=T)).schedule)
    for (name, p), q in zip(staged.net.named_parameters(), own.net.parameters()):
        assert torch.equal(p, q), name
    assert staged is not tm and all(p.requires_grad for p in staged.net.parameters())


def _eval_loss(student, teacher, n, guided):
    """The distill loss of `student` on fixed draws (all n transitions)."""
    _, task = _student_task(teacher)
    task.model = student
    grid, mid = tdistill.distill_grids(T, n)
    loss_fn = tdistill_train.make_distill_loss(task, teacher, grid, mid, guided=guided, w=0.5)
    gen = torch.Generator().manual_seed(123)
    with torch.no_grad():
        return float(np.mean([float(loss_fn(_tb(_batch()), gen, True)[0]) for _ in range(4)]))


def test_stage_lowers_the_loss(pair):
    """A guided stage of 150 steps, as tests/test_distill.py runs the JAX
    one, halves the loss on fixed draws (on this model 20 steps do not: the
    first tens of steps leave it near where it started)."""
    _, _, tm = pair
    b = _tb(_batch())

    def batches():
        while True:
            yield b

    logged = []
    student, last = tdistill_train.distill_stage(
        tm, TTaskConfig(timesteps=T), batches(), 9, n_steps=150, lr=1e-3, guided=True, w=0.5,
        log=lambda it, v: logged.append((it, v)))
    assert [it for it, _ in logged] == [0, 100, 149] and logged[-1][1] == last
    assert np.isfinite(last)
    before, after = _eval_loss(tm, tm, 9, True), _eval_loss(student, tm, 9, True)
    assert after < 0.5 * before, (before, after)


def test_chain_prepares_each_teacher_from_the_last_student(pair, monkeypatch):
    """Stage 2's teacher is stage 1's student: its prepared operands are
    that student's, and stage 2 gives exactly what a stage run alone from that
    student gives. A cache of the first teacher's operands fails both."""
    _, _, tm = pair
    b = _tb(_batch())

    def batches():
        while True:
            yield b

    prepared = []
    real = tdistill_train.TeacherForward

    def spy(model, guided, w, fused):
        prepared.append((model, guided, real(model, guided, w, fused)))
        return prepared[-1][2]

    monkeypatch.setattr(tdistill_train, "TeacherForward", spy)
    cfg = TTaskConfig(timesteps=T)
    out = tdistill_train.progressive_distill(
        tm, cfg, batches(), TDistillConfig(start_steps=9, stages=2, steps_per_stage=3, lr=1e-3))
    assert sorted(out) == [5, 9]
    assert [(m, g) for m, g, _ in prepared] == [(tm, True), (out[9], False)]
    first, second = prepared[0][2].operands.weights, prepared[1][2].operands.weights
    assert not torch.equal(first.wd, second.wd)  # stage 1 moved the weights
    for got, want in zip(second, FusedOperands.of(out[9].net).weights):
        assert torch.equal(got, want)
    alone, _ = tdistill_train.distill_stage(out[9], cfg, batches(), 5, n_steps=3, lr=1e-3)
    for p, q in zip(out[5].net.parameters(), alone.net.parameters()):
        assert torch.equal(p, q)


# ------------------------------------------------------------ the entry

TINY = ["model.residual_channels=16", "model.residual_layers=2", "model.frames=16",
        "dataset.sequence_length=8192", "task.timesteps=10", "dataloader.train_batch_size=2",
        "dataloader.val_batch_size=2", "dataloader.num_workers=1", "device=cpu",
        "audio_format=wav"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("maps")
    _write_split(root, "AkPnBcht", 4, 2.0, seed=0)
    _write_split(root, "ENSTDkCl", 2, 1.5, seed=1)
    out = tmp_path_factory.mktemp("train")
    train_cli.main(["spec_roll", f"dataset.root={root}", f"trainer.output_dir={out}",
                    "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1", *TINY])
    (ckpt,) = out.glob("*/*/train-*/checkpoints/last.ckpt")
    return root, ckpt


def test_distill_entry_then_test_and_serve(trained, tmp_path, monkeypatch):
    root, ckpt = trained
    args = [f"dataset.root={root}", f"trainer.output_dir={tmp_path}", *TINY]
    summary = distill_cli.main([f"pretrained_path={ckpt}", "distill.start_steps=2",
                                "distill.stages=1", "distill.steps_per_stage=3",
                                "task.fused_train=true", *args])
    assert summary["stages"] == [2]
    stage = pathlib.Path(summary["run_dir"]) / "distilled_2steps" / "checkpoints" / "last.ckpt"
    port = read_ckpt(str(stage))["hyper_parameters"]["port_config"]
    assert (port["task"]["sampling_type"], port["task"]["sampling_steps"],
            port["task"]["w"]) == ("ddim_x0", 2, 0.0)
    assert port["task_type"] == "diffusion" and port["model"]["residual_channels"] == 16

    metrics = test_cli.main([f"pretrained_path={stage}", "task.sampling_type=ddim_x0",
                             "task.sampling_steps=2", "task.w=0", *args])
    assert metrics["n_clips"] == 2 and 0.0 <= metrics["frame_f1"] <= 1.0

    # serve adopts the sampler the student's checkpoint records
    import diffroll_tpu_torch.serve as serve_pkg

    seen = {}

    def fake_serve_forever(service, host="127.0.0.1", port=8077, info=None, ready=None):
        seen.update(sampler=service.task.config.sampling_type,
                    steps=service.task.config.sampling_steps,
                    transfer=service.transfer_dtype, depth=service.pipeline_depth)

    monkeypatch.setattr(serve_pkg, "serve_forever", fake_serve_forever)
    serve_cli.main([f"pretrained_path={stage}", "device=cpu", "serve.max_batch=2",
                    "serve.overlap_frames=4"])
    assert seen == {"sampler": "ddim_x0", "steps": 2, "transfer": "int16", "depth": 2}


def test_distill_entry_refuses_an_empty_epoch(trained, tmp_path):
    root, ckpt = trained
    with pytest.raises(RuntimeError, match="yielded no batches"):
        distill_cli.main([f"pretrained_path={ckpt}", f"dataset.root={root}",
                          f"trainer.output_dir={tmp_path}", "distill.start_steps=2",
                          "distill.stages=1", "distill.steps_per_stage=1", *TINY,
                          "dataloader.train_batch_size=64"])


def test_distill_verb_is_dispatched(capsys):
    from diffroll_tpu_torch.__main__ import _dispatch

    assert _dispatch(["--help"]) == 0
    assert "distill" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            _dispatch(["distill", "pretrained_path=x.ckpt", "device=cuda"])
