"""The model axis, the service over a mesh and sequence parallelism
(parallel/model_axis.py, serve/service.py, parallel/context.py) on the CPU:
ranks in a gloo group, each a process of its own (tests/torch_dp_workers.py),
joined with a timeout; the JAX side and the single-process runs in this
process, on the conftest's virtual CPU devices.

  * the sharded set and each chunk's shape, for every model preset, against
    JAX's `param_sharding(make_mesh(data=1, model=2))` mapped through
    `state_dict_from_jax`: identical;
  * one step at data=1, model=2 and at data=2, model=2 (4 ranks) on the
    modules route (column-parallel) and the fused one (plain K3 / K4),
    against JAX's mesh step on the same mesh (the parameters atol 1e-4 /
    rtol 1e-3, the gradients max|d| / max|ref| < 2e-3) and the port's
    single-process step (gradients < 2e-3, losses within 1e-5); the bf16
    modules with bf16 moments against the single-process bf16 step (the
    gates of tests/test_torch_bf16.py: gradients < 0.05, loss 1e-2);
  * `train` at model_axis=2 against one process (weights and EMA atol
    1e-5), its checkpoint loaded by one process (weights and Adam's moments
    atol 1e-6), a single-process checkpoint loaded at model_axis=2 and
    written back (the same); `distill` and `train baseline` (atol 1e-5);
  * `test` and `transcribe` at data=2, model=2 against one process
    (METRICS_TOL; the roll atol 1e-5);
  * the service at data=2 (plain K2): `max_batch=7` becomes 6, two requests
    through `transcribe` and one through rank 0's HTTP front against a
    one-process service's rolls (atol 1e-5);
  * `sequence_parallel_forward` on 2 ranks, conditional and not, against
    `diffroll_tpu.parallel.context.sequence_parallel_forward` on a 2-device
    JAX mesh (atol 1e-4, rtol 1e-3); `sample_sequence_parallel` against the
    port's dense sampler on JAX's draws (rel < 1e-3); the undersized-shard
    refusal.

Sizes: C=16, 3 layers, 10 timesteps, 32 frames, a global batch of 4 (the
step); 16 frames and a batch of 2 (the entries).
"""

import json
import os
import pathlib
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.parallel.context import sequence_parallel_forward as j_sp_forward
from diffroll_tpu.parallel.mesh import make_mesh, param_sharding as j_param_sharding
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu.tasks import TaskConfig as JTaskConfig
from diffroll_tpu.train.state import TrainState as JTrainState
from diffroll_tpu.train.state import make_optimizer as j_make_optimizer
from diffroll_tpu.train.step import make_train_step as j_make_train_step
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import distill as distill_cli
from diffroll_tpu_torch.cli import serve as serve_cli
from diffroll_tpu_torch.cli import test as test_cli
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.cli import transcribe as transcribe_cli
from diffroll_tpu_torch.compat import (
    grads_from_jax, param_sharding, read_ckpt, state_dict_from_jax)
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig
from diffroll_tpu_torch.train import TrainState, make_train_step
from test_torch_parallel import JOIN_TIMEOUT_S, _free_port, _jax_draws, rel
from test_torch_test_cli import FIXTURE, METRICS_TOL, _write_split
from test_torch_train import _pair
from test_torch_variants import jax_params

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL, GRAD_GATE, LOSS_TOL = 1e-4, 1e-3, 2e-3, 1e-5
BF16_GATE, BF16_LOSS = 0.05, 1e-2      # tests/test_torch_bf16.py's gates
B, T, STEPS = 4, 32, 10                # T: the frames of test_torch_train._pair
SMALL = ["model.frames=16", "dataset.sequence_length=8192", "dataloader.num_workers=1",
         "device=cpu"]


# ------------------------------------------------------------ the rule

PRESETS = {
    "ClassifierFreeDiffRoll": {}, "DiffRoll": {}, "DiffRollBaseline": {}, "DiffRollDebug": {},
    "trainable_spec": {"condition": "trainable_spec"},
    "trainable_z": {"condition": "trainable_z"},
    "DiffRollv2": {}, "DiffRollv2Debug": {}, "Unet": {}, "SpecUnet": {},
}


def _preset(key):
    name = key if key in tmodels.PRESETS else "ClassifierFreeDiffRoll"
    kw = dict(PRESETS[key], frames=16, timesteps=STEPS)
    if name not in ("Unet", "SpecUnet"):
        kw.update(residual_channels=16, residual_layers=3)
    return name, kw


def _jax_chunks(params, model):
    """JAX's rule on `params`: each leaf's chunk on model rank 0 (the whole
    leaf where it is replicated), in the port's names and layouts."""
    mesh = make_mesh(data=1, model=model, devices=jax.devices()[:model])
    specs = j_param_sharding(mesh, params)

    def chunk(p, s):
        if tuple(s.spec)[-1:] == ("model",):
            return np.asarray(p)[..., : p.shape[-1] // model]
        return np.asarray(p)

    return state_dict_from_jax(jax.tree.map(chunk, params, specs))


@pytest.mark.parametrize("key", sorted(PRESETS))
def test_sharded_set_matches_jax_rule(key):
    name, kw = _preset(key)
    params = jax.tree.map(np.asarray, jax_params(jmodels.build(name, **kw)))
    whole = state_dict_from_jax(params)
    chunks = _jax_chunks(params, 2)
    want = {n for n in whole if chunks[n].shape != whole[n].shape}
    net = tmodels.build(name, **kw).net
    rule = param_sharding(net, 2)
    assert want and set(rule) == want
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert sorted(shapes) == sorted(whole)
    for n, dim in rule.items():
        got = list(shapes[n])
        got[dim] //= 2
        assert tuple(got) == tuple(chunks[n].shape), n


def test_diffwave_sharded_set_matches_jax_rule():
    from diffroll_tpu.nn.diffwave import DiffWaveNet as JDiffWave
    from diffroll_tpu_torch.nn import DiffWaveNet

    kw = dict(residual_channels=8, residual_layers=2, dilation_cycle_length=2, n_mels=8,
              max_steps=10)
    jm = JDiffWave(**kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 512)),
                                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 8))))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    whole = state_dict_from_jax(params)
    chunks = _jax_chunks(params, 2)
    want = {n for n in whole if chunks[n].shape != whole[n].shape}
    assert set(param_sharding(DiffWaveNet(**kw), 2)) == want


# ------------------------------------------------------------ the ranks

def _run_ranks(tmp, world, spec):
    spec = {"port": _free_port(), "world": world, "out": str(tmp), **spec}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")])}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dp_workers.py"),
                               str(r), str(tmp / "spec.json")], env=env, cwd=tmp,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the ranks did not finish in {JOIN_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _step_inputs(tmp):
    jm, params, _ = _pair()
    rng = np.random.default_rng(5)
    batch = {"frame": (rng.random((B, T, 88)) > 0.9).astype(np.float32),
             "audio": rng.standard_normal((B, T * 512)).astype(np.float32)}
    key = jax.random.key(7)
    inputs = {"kw": dict(residual_channels=16, residual_layers=3, frames=T, timesteps=STEPS,
                         spec_dropout=0.5),
              "state_dict": state_dict_from_jax(params), "batch": batch,
              "draws": _jax_draws(key, 0.5), "lr": 5e-5}
    torch.save(inputs, tmp / "step_inputs.pt")
    return inputs, (jm, params, key)


STEP_PRESETS = {   # the presets whose own modules are swapped column-parallel
    "DiffRollv2": dict(residual_channels=16, residual_layers=3, dilation_base=2,
                       dilation_bound=3, spec_dropout=0.5),
    "Unet": dict(residual_channels=16),
}


def _preset_inputs(tmp):
    """One step's inputs for each of STEP_PRESETS, and its JAX side."""
    out = {}
    for i, (name, extra) in enumerate(sorted(STEP_PRESETS.items())):
        kw = dict(extra, frames=T, timesteps=STEPS)
        jm = jmodels.build(name, **kw)
        params = jax_params(jm)
        rng = np.random.default_rng(30 + i)
        batch = {"frame": (rng.random((B, T, 88)) > 0.8).astype(np.float32),
                 "audio": (0.1 * rng.standard_normal((B, T * 512))).astype(np.float32)}
        key = jax.random.key(40 + i)
        inputs = {"name": name, "kw": kw, "task": {}, "state_dict": state_dict_from_jax(params),
                  "batch": batch, "draws": _jax_draws(key, jm.config.spec_dropout), "lr": 5e-5}
        out[name] = (inputs, (jm, params, key))
    torch.save({k: v[0] for k, v in out.items()}, tmp / "preset_inputs.pt")
    return out


def _wav(path, seconds, seed):
    x = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(int(16000 * seconds)) / 16000)
    x = x + 0.05 * np.random.default_rng(seed).standard_normal(x.shape)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _entry_args(root, out, audio, ckpt=None):
    """The entries' arguments, the same for the mesh and for one process
    (the mesh's axes are added by the caller)."""
    train = ["spec_roll", "model.residual_channels=16", "model.residual_layers=3",
             "task.timesteps=10", "dataloader.train_batch_size=2", "dataloader.val_batch_size=7",
             "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
             "trainer.log_every_n_steps=1", "trainer.ema_decay=0.9",
             "task.fused_train=true", f"trainer.output_dir={out / 'train'}", *SMALL,
             f"dataset.root={root}"]
    resume = [f"pretrained_path={ckpt}", "trainer.max_epochs=0",
              f"trainer.output_dir={out / 'resume'}", *SMALL, f"dataset.root={root}"]
    distill = [f"pretrained_path={FIXTURE}", "distill.start_steps=3", "distill.stages=1",
               "distill.steps_per_stage=2", "dataloader.train_batch_size=2",
               "task.fused_train=true", f"trainer.output_dir={out / 'distill'}", *SMALL,
               f"dataset.root={root}"]
    baseline = ["baseline", "model.residual_channels=8", "model.residual_layers=2",
                "baseline.timesteps=10", "dataloader.train_batch_size=2",
                "dataloader.val_batch_size=7", "trainer.max_epochs=1",
                "trainer.check_val_every_n_epoch=1", f"trainer.output_dir={out / 'baseline'}",
                *SMALL, f"dataset.root={root}"]
    test = [f"pretrained_path={FIXTURE}", f"trainer.output_dir={out / 'test'}", *SMALL,
            f"dataset.root={root}"]
    trans = [f"pretrained_path={FIXTURE}", f"dataset.audio_path={audio}", "dataset.audio_ext=wav",
             "task.w=0.5", "overlap_frames=4", "dataloader.test_batch_size=3", "device=cpu",
             f"trainer.output_dir={out / 'transcribe'}"]
    return {"train_args": train, "resume_args": resume, "distill_args": distill,
            "baseline_args": baseline, "test_args": test, "transcribe_args": trans}


def _axes(args, data, model):
    return args + [f"trainer.data_axis={data}", f"trainer.model_axis={model}"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    root = tmp / "maps"
    _write_split(root, "AkPnBcht", 6, 2.0, seed=0)
    _write_split(root, "ENSTDkCl", 3, 1.5, seed=1)
    audio = tmp / "audio"
    audio.mkdir()
    _wav(audio / "tone.wav", 1.7, 0)
    return tmp, root, audio


@pytest.fixture(scope="module")
def single(corpus):
    """The single-process runs of the entries."""
    tmp, root, audio = corpus
    args = _entry_args(root, tmp / "single_out", audio)
    state = train_cli.main(args["train_args"])
    (run,) = (tmp / "single_out" / "train").glob("*/*/train-*")
    return {"train": state, "ckpt": run / "checkpoints" / "last.ckpt",
            "distill": distill_cli.main(args["distill_args"]),
            "baseline": train_cli.main(args["baseline_args"]),
            "test": test_cli.main(args["test_args"]),
            "transcribe": transcribe_cli.main(args["transcribe_args"])}


SERVE = [f"pretrained_path={FIXTURE}", "model.frames=16", "device=cpu", "serve.max_batch=7",
         "serve.max_wait_ms=300", "serve.overlap_frames=4", "serve.transfer=int16",
         "task.sampling_steps=5", "task.use_megakernel=true"]


@pytest.fixture(scope="module")
def serve_inputs(corpus):
    """Two requests' audio and a wav file for the service over a mesh."""
    tmp = corpus[0]
    rng = np.random.default_rng(11)
    audio = {k: np.clip(0.2 * rng.standard_normal(int(16000 * s)), -1, 1).astype(np.float32)
             for k, s in (("a", 1.3), ("b", 0.6))}
    np.savez(tmp / "serve_audio.npz", **audio)
    _wav(tmp / "serve.wav", 0.9, 3)
    return {"audio": audio, "spec": {"serve_audio": str(tmp / "serve_audio.npz"),
                                     "serve_wav": str(tmp / "serve.wav")}}


@pytest.fixture(scope="module")
def mp2(corpus, single, serve_inputs):
    """Two ranks: the steps at data=1, model=2, the entries at model_axis=2,
    the service at data=2, sequence parallelism at data=2."""
    tmp, root, audio = corpus
    inputs, jax_side = _step_inputs(tmp)
    presets = _preset_inputs(tmp)
    args = _entry_args(root, tmp / "mp_out", audio, single["ckpt"])
    args = {k: _axes(v, 1, 2) for k, v in args.items() if k in (
        "train_args", "resume_args", "distill_args", "baseline_args")}
    sp_inputs, sp_jax = _sp_inputs(tmp)
    spec = {"scenarios": ["mp_step", "mp_presets", "mp_cli", "serve", "sp"],
            "mesh": {"data": 1, "model": 2}, "step_inputs": str(tmp / "step_inputs.pt"),
            "preset_inputs": str(tmp / "preset_inputs.pt"), **args,
            "serve_args": _axes(SERVE, 2, 1), **serve_inputs["spec"],
            "http_port": _free_port(), "sp_inputs": str(tmp / "sp_inputs.pt")}
    out = tmp / "ranks2"
    out.mkdir()
    res = _run_ranks(out, 2, spec)
    return {"res": res, "inputs": inputs, "jax": jax_side, "presets": presets, "tmp": tmp,
            "sp": (sp_inputs, sp_jax)}


@pytest.fixture(scope="module")
def mp4(corpus, serve_inputs):
    """Four ranks, data=2 x model=2: the step, test, transcribe and the
    service."""
    tmp, root, audio = corpus
    sub = tmp / "ranks4"
    sub.mkdir()
    inputs, jax_side = _step_inputs(sub)
    args = _entry_args(root, tmp / "mp4_out", audio)
    spec = {"scenarios": ["mp_step", "mp_eval", "serve"], "mesh": {"data": 2, "model": 2},
            "step_inputs": str(sub / "step_inputs.pt"),
            "test_args": _axes(args["test_args"], 2, 2),
            "transcribe_args": _axes(args["transcribe_args"], 2, 2),
            "serve_args": _axes(SERVE, 2, 2), **serve_inputs["spec"],
            "http_port": _free_port()}
    return {"res": _run_ranks(sub, 4, spec), "inputs": inputs, "jax": jax_side, "tmp": tmp}


# ------------------------------------------------------------ the step

def _jax_step(jm, params, key, batch, data, model, fused=False, task=None):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtask = JTask(jm, JTaskConfig(timesteps=STEPS, fused_train=fused, **(task or {})))
    tx = j_make_optimizer(5e-5)
    mesh = make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    state = JTrainState.create(params, tx)
    step = j_make_train_step(jtask.loss_fn, tx, mesh=mesh, state_example=state,
                             donate_state=False)
    new_state, losses = step(state, batch, key)
    grads = jax.jit(jax.grad(lambda p, b, k: jtask.loss_fn(p, b, k, True)[0]))(params, batch, key)
    return (float(losses["diffusion_loss"]), grads_from_jax(jax.tree.map(np.asarray, grads)),
            state_dict_from_jax(jax.tree.map(np.asarray, new_state.params)))


def _single_step(inputs, route):
    kw = dict(inputs["kw"], **({"dtype": "bfloat16"} if route == "bf16" else {}))
    model = tmodels.build(inputs.get("name", "ClassifierFreeDiffRoll"), **kw)
    model.net.load_state_dict(inputs["state_dict"])
    task = TTask(model, TTaskConfig(timesteps=STEPS, fused_train=route == "fused",
                                    **inputs.get("task", {})))
    state = TrainState.create(model, inputs["lr"], "bfloat16" if route == "bf16" else None)
    step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train, **inputs["draws"]))
    losses = step(state, {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}, None)
    return float(losses["diffusion_loss"]), model.net


def _check_step(res, jax_out, single, model):
    """Each rank's results of one step (`res`) against JAX's mesh step
    (`jax_out`) and the port's single-process step (`single`)."""
    loss, jgrads, jparams = jax_out
    got = res[0]
    assert abs(got["loss"] - loss) < LOSS_TOL
    for name, want in jgrads.items():
        assert float(want.abs().max()) > 0, name
        assert rel(got["grads"][name], want) < GRAD_GATE, name
        np.testing.assert_allclose(got["params"][name].numpy(), jparams[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
        for r in res[1:]:   # every rank holds the same whole update
            assert torch.equal(got["params"][name], r["params"][name]), name
    sloss, net = single
    assert abs(got["loss"] - sloss) < LOSS_TOL
    for name, p in net.named_parameters():
        assert rel(got["grads"][name], p.grad) < GRAD_GATE, name
        np.testing.assert_allclose(got["params"][name].numpy(), p.detach().numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    # each rank holds its chunk: the sharded leaves split, the bytes shrink
    rule = param_sharding(net, model)
    for r in res:
        for name, shape in r["chunks"].items():
            whole = list(net.get_parameter(name).shape)
            if name in rule:
                whole[rule[name]] //= model
            assert shape == tuple(whole), name
    assert got["param_bytes"] < sum(p.numel() * 4 for p in net.parameters())


def _check_flagship_step(run, fused, data, model):
    route = "fused" if fused else "modules"
    jm, params, key = run["jax"]
    _check_step([r["mp_step"][route] for r in run["res"]],
                _jax_step(jm, params, key, run["inputs"]["batch"], data, model, fused),
                _single_step(run["inputs"], route), model)


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_model_axis_step_matches_jax_and_one_process(mp2, fused):
    assert (mp2["res"][0]["mp_step"]["data"], mp2["res"][0]["mp_step"]["model"]) == (1, 2)
    _check_flagship_step(mp2, fused, 1, 2)


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_data_and_model_axes_step_matches_jax_and_one_process(mp4, fused):
    res = [r["mp_step"] for r in mp4["res"]]
    assert [(r["rank"], r["data"], r["model"]) for r in res] == [(i, 2, 2) for i in range(4)]
    _check_flagship_step(mp4, fused, 2, 2)


@pytest.mark.parametrize("key", sorted(STEP_PRESETS))
def test_model_axis_step_of_2d_net_and_unet(mp2, key):
    """The 2-D DiffRoll net and the U-Net call their Conv2d / GroupNorm
    modules directly: the column-parallel subclasses at model_axis=2, the
    U-Net's depthwise (grouped) convs among them."""
    inputs, (jm, params, jkey) = mp2["presets"][key]
    _check_step([r["mp_presets"][key] for r in mp2["res"]],
                _jax_step(jm, params, jkey, inputs["batch"], 1, 2, task=inputs["task"]),
                _single_step(inputs, "modules"), 2)


def test_model_axis_bf16_step_matches_one_process(mp2):
    got = mp2["res"][0]["mp_step"]["bf16"]
    sloss, net = _single_step(mp2["inputs"], "bf16")
    assert abs(got["loss"] - sloss) / abs(sloss) < BF16_LOSS
    for name, p in net.named_parameters():
        assert rel(got["grads"][name], p.grad) < BF16_GATE, name
    # the moments are bf16 chunks: 2 bytes an element of this rank's share
    assert got["moment_bytes"] == 2 * 2 * sum(np.prod(s) for s in got["chunks"].values())


# ------------------------------------------------------------ the entries

def test_model_axis_train_matches_one_process(mp2, single):
    r0, r1 = (r["mp_cli"]["train"] for r in mp2["res"])
    state = single["train"]
    assert r0["step"] == r1["step"] == state.step == 3
    for n, p in state.model.net.named_parameters():
        assert torch.equal(r0["params"][n], r1["params"][n]), n
        np.testing.assert_allclose(r0["params"][n].numpy(), p.detach().numpy(), atol=1e-5,
                                   err_msg=n)
        np.testing.assert_allclose(r0["ema"][n].numpy(), state.ema[n].numpy(), atol=1e-5,
                                   err_msg=n)
    runs = list((mp2["tmp"] / "mp_out" / "train").glob("*/*/train-*"))
    assert len(runs) == 1 and (runs[0] / "test_metrics.json").exists()


def test_model_axis_checkpoint_loads_in_one_process_and_back(mp2, single):
    """The model_axis=2 checkpoint holds whole weights and moments (those
    the ranks hold, gathered); a single-process checkpoint loaded at
    model_axis=2 and written back is the same checkpoint."""
    (run,) = (mp2["tmp"] / "mp_out" / "train").glob("*/*/train-*")
    ck = read_ckpt(str(run / "checkpoints" / "last.ckpt"))
    r0 = mp2["res"][0]["mp_cli"]["train"]
    for n, v in r0["params"].items():
        np.testing.assert_allclose(ck["state_dict"][n].numpy(), v.numpy(), atol=1e-6, err_msg=n)
        np.testing.assert_allclose(ck["ema"][n].numpy(), r0["ema"][n].numpy(), atol=1e-6)
    one = read_ckpt(str(single["ckpt"]))
    model = tmodels.build("ClassifierFreeDiffRoll", residual_channels=16, residual_layers=3,
                          frames=16, timesteps=STEPS)
    model.net.load_state_dict(ck["state_dict"])   # loads in one process
    opt = TrainState.create(model, 5e-5).optimizer
    opt.load_state_dict(ck["optimizer_state"])
    for k in ("exp_avg", "exp_avg_sq"):   # the moments: the single run's, atol 1e-6
        for i, st in one["optimizer_state"]["state"].items():
            np.testing.assert_allclose(ck["optimizer_state"]["state"][i][k].numpy(),
                                       st[k].numpy(), atol=1e-6)
    (back,) = (mp2["tmp"] / "mp_out" / "resume").glob("*/*/train-*")
    again = read_ckpt(str(back / "checkpoints" / "last.ckpt"))
    assert again["global_step"] == one["global_step"] == 3
    for n, v in one["state_dict"].items():
        np.testing.assert_allclose(again["state_dict"][n].numpy(), v.numpy(), atol=1e-6)
    for i, st in one["optimizer_state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(again["optimizer_state"]["state"][i][k].numpy(),
                                       st[k].numpy(), atol=1e-6)


def test_model_axis_distill_and_baseline_match_one_process(mp2, single):
    d0, d1 = (r["mp_cli"]["distill"] for r in mp2["res"])
    assert d0["stages"] == d1["stages"] == [3]
    name = pathlib.Path("distilled_3steps") / "checkpoints" / "last.ckpt"
    got = read_ckpt(str(pathlib.Path(d0["run_dir"]) / name))["state_dict"]
    want = read_ckpt(str(pathlib.Path(single["distill"]["run_dir"]) / name))["state_dict"]
    for n, v in want.items():
        np.testing.assert_allclose(got[n].numpy(), v.numpy(), atol=1e-5, err_msg=n)
    b0 = mp2["res"][0]["mp_cli"]["baseline"]
    state = single["baseline"]
    assert b0["step"] == state.step == 3
    for n, p in state.model.net.named_parameters():
        np.testing.assert_allclose(b0["params"][n].numpy(), p.detach().numpy(), atol=1e-5,
                                   err_msg=n)


def test_test_and_transcribe_over_both_axes(mp4, single):
    metrics = [r["mp_eval"]["test"] for r in mp4["res"]]
    assert all(m == metrics[0] for m in metrics)
    want = single["test"]
    assert metrics[0]["n_clips"] == want["n_clips"] == 3
    for k, v in want.items():
        assert abs(metrics[0][k] - v) <= METRICS_TOL, k
    dirs = [r["mp_eval"]["transcribe"] for r in mp4["res"]]
    assert dirs[0] is not None and dirs[1:] == [None] * 3
    got = np.load(next(pathlib.Path(dirs[0]).glob("*.npz")))["roll"]
    ref = np.load(next(pathlib.Path(single["transcribe"]).glob("*.npz")))["roll"]
    assert got.shape == ref.shape and np.abs(got - ref).max() < 1e-5


# ------------------------------------------------------------ the service

@pytest.fixture(scope="module")
def one_service(serve_inputs):
    """A one-process service's rolls of the two requests and the wav."""
    from diffroll_tpu_torch.io.wav import read_wav_bytes

    service, _, _ = serve_cli.make_service(SERVE + ["serve.max_batch=6"])
    try:
        rolls = [service.transcribe(serve_inputs["audio"][k]) for k in ("a", "b")]
        audio, sr = read_wav_bytes(pathlib.Path(serve_inputs["spec"]["serve_wav"]).read_bytes(),
                                   mono=True)
        roll = service.transcribe(audio, sample_rate=sr)
        return {"rolls": rolls, "frames": roll.shape[0], "notes": service.notes(roll)}
    finally:
        service.close()


def _check_service(res, want):
    s0 = res[0]["serve"]
    assert [r["serve"]["max_batch"] for r in res] == [6] * len(res)   # 7, rounded to 2 x 3
    # rank 0 counts the two requests' and the wav's batches; the others
    # follow the warm-up's batch too
    assert [r["serve"]["batches"] for r in res] == [3] + [4] * (len(res) - 1)
    for got, roll in zip(s0["rolls"], want["rolls"]):
        assert got.shape == roll.shape and np.abs(got - roll).max() < 1e-5
    assert s0["http"]["frames"] == want["frames"]
    assert s0["http"]["notes"] == want["notes"]


def test_service_over_the_data_axis_matches_one_process(mp2, one_service):
    _check_service(mp2["res"], one_service)


def test_service_over_both_axes_matches_one_process(mp4, one_service):
    """data=2 x model=2: each rank holds its chunk of the weights, K2 reads
    them gathered once; the batches stripe by data index."""
    _check_service(mp4["res"], one_service)


# ------------------------------------------------------------ sequence parallelism

SP_T, SP_L = 32, 3


def _sp_inputs(tmp):
    kw = dict(residual_channels=16, residual_layers=SP_L, dilation_base=2, dilation_bound=3,
              frames=SP_T, timesteps=STEPS)
    jm = jmodels.build("ClassifierFreeDiffRoll", **kw)
    params = jax_params(jm)
    rng = np.random.default_rng(21)
    n = STEPS
    inputs = {"kw": kw, "state_dict": state_dict_from_jax(params),
              "x": torch.from_numpy(rng.standard_normal((2, SP_T, 88)).astype(np.float32)),
              "t": torch.tensor([3, 7]),
              "cond": torch.from_numpy(rng.random((2, SP_T, 229)).astype(np.float32)),
              "x_T": torch.from_numpy(np.array(jax.random.normal(jax.random.key(5),
                                                                 (1, SP_T, 88)))),
              "wav": torch.from_numpy(rng.standard_normal((1, SP_T * 512)).astype(np.float32)),
              "noise": torch.from_numpy(np.array(jax.random.normal(jax.random.key(6),
                                                                   (n, 1, SP_T, 88))))}
    torch.save(inputs, tmp / "sp_inputs.pt")
    return inputs, (jm, params)


def test_sequence_parallel_forward_matches_jax(mp2):
    inputs, (jm, params) = mp2["sp"]
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    kw = dict(n_layers=SP_L, dilations=jm.config.dilations(), max_steps=STEPS)
    for key, cond in (("cond", inputs["cond"]), ("uncond", None)):
        want = j_sp_forward(mesh, params, jnp.asarray(inputs["x"].numpy()),
                            jnp.asarray(inputs["t"].numpy()),
                            None if cond is None else jnp.asarray(cond.numpy()), **kw)
        for r in mp2["res"]:
            assert r["sp"]["data"] == 2
            np.testing.assert_allclose(r["sp"][key].numpy(), np.asarray(want), atol=1e-4,
                                       rtol=1e-3, err_msg=key)


def test_sample_sequence_parallel_matches_dense_sampler(mp2):
    inputs, _ = mp2["sp"]
    model = tmodels.build("ClassifierFreeDiffRoll", **inputs["kw"])
    model.net.load_state_dict(inputs["state_dict"])
    task = TTask(model, TTaskConfig(timesteps=STEPS, w=0.5, sampling_type="cfdg_ddpm_x0"))
    want, _ = task.sample(inputs["x_T"], waveform=inputs["wav"], noise=inputs["noise"])
    for r in mp2["res"]:
        assert rel(r["sp"]["sample"], want) < 1e-3


def test_sequence_parallel_refuses_undersized_shards(mp2):
    for r in mp2["res"]:
        assert r["sp"]["refusal"] is not None and "halo" in r["sp"]["refusal"]
