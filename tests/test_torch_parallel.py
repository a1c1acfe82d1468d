"""The data axis (parallel/mesh.py) on the CPU: two ranks in a gloo group,
each a process of its own (tests/torch_dp_workers.py), joined with a
timeout; the JAX side and the single-process runs in this process.

  * one data-parallel step on the same weights and global draws (each rank
    its stripe of the batch and of the draws), on the modules route and the
    fused one, against JAX's mesh step (`make_mesh(data=2)` on the conftest's
    virtual CPU devices): the parameters atol 1e-4, rtol 1e-3, the gradients
    max|d| / max|ref| < 2e-3 (the f32 gates); against the port's single-
    process step on the whole batch: gradients < 2e-3, losses within 1e-5;
    both ranks end with the same bits;
  * the `train` entry on 2 ranks against 1 process, same arguments: the
    same weights and EMA within atol 1e-5 (the draws are the global batch's,
    striped), the same bits on both ranks, and one run directory, rank 0's;
    the validation split (288 windows in batches of 7) ends in a batch of
    one row, so rank 1's last stripe is empty, and the global validation
    loss is one process's within 1e-5; the same for `train baseline`;
  * `test` on 2 ranks (K2's plain version at B/2 a rank, the rolls gathered
    to rank 0) against 1 process: n_clips and every metric equal within 1e-9
    (METRICS_TOL of tests/test_torch_test_cli.py), on every rank;
  * `transcribe` and `distill` on 2 ranks: rank 0 alone writes; its roll
    and its student against the single-process ones (atol 1e-5);
  * the loader's stripes, and the refusals: data_axis != world size, a
    train batch that does not divide, a model_axis that does not divide the
    world or is below 1, data_axis x model_axis != world size, and more
    than one process asked for outside a launched group.

Sizes: C=16, 3 layers, 10 timesteps; 32 frames and a global batch of 4 (the step),
16 frames and 2 (the entries).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu.models.conditioning import spec_dropout_mask as j_spec_dropout_mask
from diffroll_tpu.parallel.mesh import batch_sharding, make_mesh, param_sharding
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu.tasks import TaskConfig as JTaskConfig
from diffroll_tpu.train.state import TrainState as JTrainState
from diffroll_tpu.train.state import make_optimizer as j_make_optimizer
from diffroll_tpu.train.step import make_train_step as j_make_train_step
from diffroll_tpu_torch import config as tconfig
from diffroll_tpu_torch.cli import distill as distill_cli
from diffroll_tpu_torch.cli import test as test_cli
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.cli import transcribe as transcribe_cli
from diffroll_tpu_torch.compat import grads_from_jax, read_ckpt, state_dict_from_jax
from diffroll_tpu_torch.data.pipeline import DataLoader
from diffroll_tpu_torch.parallel import setup_mesh
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig
from diffroll_tpu_torch.train import TrainState, make_train_step
from test_torch_test_cli import FIXTURE, METRICS_TOL, _write_split
from test_torch_train import _pair

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL, GRAD_GATE, LOSS_TOL = 1e-4, 1e-3, 2e-3, 1e-5
B, T, STEPS, WORLD = 4, 32, 10, 2   # T: the frames of test_torch_train._pair
JOIN_TIMEOUT_S = 300


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-5))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry_args(root, out, audio):
    """The arguments of the entries, the same for 2 ranks and for 1."""
    small = ["model.frames=16", "dataset.sequence_length=8192", "dataloader.num_workers=1",
             "device=cpu", f"dataset.root={root}"]
    train = ["spec_roll", "model.residual_channels=16", "model.residual_layers=3",
             "task.timesteps=10", "dataloader.train_batch_size=2", "dataloader.val_batch_size=7",
             "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
             "trainer.log_every_n_steps=1", "trainer.ema_decay=0.9",
             "task.fused_train=true", f"trainer.output_dir={out / 'train'}", *small]
    test = [f"pretrained_path={FIXTURE}", f"trainer.output_dir={out / 'test'}", *small]
    trans = [f"pretrained_path={FIXTURE}", f"dataset.audio_path={audio}", "dataset.audio_ext=wav",
             "task.w=0.5", "overlap_frames=4", "dataloader.test_batch_size=3", "device=cpu",
             f"trainer.output_dir={out / 'transcribe'}"]
    distill = [f"pretrained_path={FIXTURE}", "distill.start_steps=3", "distill.stages=1",
               "distill.steps_per_stage=2", "dataloader.train_batch_size=2",
               "task.fused_train=true", f"trainer.output_dir={out / 'distill'}", *small]
    baseline = ["baseline", "model.residual_channels=8", "model.residual_layers=2",
                "baseline.timesteps=10", "dataloader.train_batch_size=2",
                "dataloader.val_batch_size=7", "trainer.max_epochs=1",
                "trainer.check_val_every_n_epoch=1", f"trainer.output_dir={out / 'baseline'}",
                *small]
    return {"train_args": train, "test_args": test, "transcribe_args": trans,
            "distill_args": distill, "baseline_args": baseline}


def _jax_draws(key, p):
    t_key, n_key, d_key = jax.random.split(key, 3)
    return {"t": torch.from_numpy(np.array(jax.random.randint(t_key, (B,), 0, STEPS))),
            "noise": torch.from_numpy(np.array(jax.random.normal(n_key, (B, T, 88)))),
            "uncond_mask": torch.from_numpy(np.array(j_spec_dropout_mask(d_key, B, p)))}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both ranks' results, the inputs they had, and the tree they read."""
    tmp = tmp_path_factory.mktemp("dp")
    root = tmp / "maps"
    _write_split(root, "AkPnBcht", 6, 2.0, seed=0)
    _write_split(root, "ENSTDkCl", 3, 1.5, seed=1)
    audio = tmp / "audio"
    audio.mkdir()
    import wave
    x = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(int(16000 * 1.7)) / 16000)
    with wave.open(str(audio / "tone.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    jm, params, tm = _pair()
    rng = np.random.default_rng(5)
    batch = {"frame": (rng.random((B, T, 88)) > 0.9).astype(np.float32),
             "audio": rng.standard_normal((B, T * 512)).astype(np.float32)}
    key = jax.random.key(7)
    inputs = {"kw": dict(residual_channels=16, residual_layers=3, frames=T, timesteps=STEPS,
                         spec_dropout=0.5),
              "state_dict": state_dict_from_jax(params), "batch": batch,
              "draws": _jax_draws(key, 0.5), "lr": 5e-5}
    torch.save(inputs, tmp / "step_inputs.pt")
    spec = {"port": _free_port(), "world": WORLD, "out": str(tmp),
            "scenarios": ["step", "cli", "errors"], "step_inputs": str(tmp / "step_inputs.pt"),
            **_entry_args(root, tmp / "dp_out", audio)}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")])}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dp_workers.py"),
                               str(r), str(tmp / "spec.json")], env=env, cwd=tmp,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
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
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"res": res, "tmp": tmp, "root": root, "audio": audio, "jax": (jm, params, key),
            "inputs": inputs}


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_dp_step_matches_jax_mesh_step(dp, fused):
    jm, params, key = dp["jax"]
    batch = {k: jnp.asarray(v) for k, v in dp["inputs"]["batch"].items()}
    jtask = JTask(jm, JTaskConfig(timesteps=STEPS, fused_train=fused))
    tx = j_make_optimizer(5e-5)
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    state = JTrainState.create(params, tx)
    step = j_make_train_step(jtask.loss_fn, tx, mesh=mesh, state_example=state,
                             donate_state=False)
    new_state, losses = step(state, batch, key)
    grad_fn = jax.jit(jax.grad(lambda p, b, k: jtask.loss_fn(p, b, k, True)[0]),
                      in_shardings=(param_sharding(mesh, params), batch_sharding(mesh), None))
    jgrads = grads_from_jax(jax.tree.map(np.asarray, grad_fn(params, batch, key)))
    jparams = state_dict_from_jax(jax.tree.map(np.asarray, new_state.params))
    r0, r1 = (r["step"] for r in dp["res"])
    assert (r0["rank"], r1["rank"], r0["size"], r0["backend"]) == (0, 1, WORLD, "gloo")
    got = r0[fused]
    assert abs(got["loss"] - float(losses["diffusion_loss"])) < LOSS_TOL
    for name, want in jgrads.items():
        assert float(want.abs().max()) > 0, name
        assert rel(got["grads"][name], want) < GRAD_GATE, name
        np.testing.assert_allclose(got["params"][name].numpy(), jparams[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
        # every rank applied the same update
        assert torch.equal(got["params"][name], r1[fused]["params"][name]), name
        assert torch.equal(got["grads"][name], r1[fused]["grads"][name]), name


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_dp_step_matches_single_process_step(dp, fused):
    inp = dp["inputs"]
    from diffroll_tpu_torch import models as tmodels
    model = tmodels.build("ClassifierFreeDiffRoll", **inp["kw"])
    model.net.load_state_dict(inp["state_dict"])
    task = TTask(model, TTaskConfig(timesteps=STEPS, fused_train=fused))
    state = TrainState.create(model, inp["lr"])
    step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train, **inp["draws"]))
    losses = step(state, {k: torch.from_numpy(v) for k, v in inp["batch"].items()}, None)
    got = dp["res"][0]["step"][fused]
    assert abs(got["loss"] - float(losses["diffusion_loss"])) < LOSS_TOL
    for name, p in model.net.named_parameters():
        assert rel(got["grads"][name], p.grad) < GRAD_GATE, name
        np.testing.assert_allclose(got["params"][name].numpy(), p.detach().numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def _single(dp, name):
    """The single-process run of an entry, with the same arguments but its
    own output directory."""
    args = _entry_args(dp["root"], dp["tmp"] / "single_out", dp["audio"])[f"{name}_args"]
    return {"train": train_cli.main, "test": test_cli.main, "transcribe": transcribe_cli.main,
            "distill": distill_cli.main, "baseline": train_cli.main}[name](args)


def test_dp_train_matches_single_process_and_only_rank0_writes(dp):
    r0, r1 = (r["cli"]["train"] for r in dp["res"])
    runs = list((dp["tmp"] / "dp_out" / "train").glob("*/*/train-*"))
    assert len(runs) == 1  # rank 0's
    run = runs[0]
    assert (run / "checkpoints" / "last.ckpt").exists() and (run / "test_metrics.json").exists()
    assert r0["step"] == r1["step"] == 3  # 6 clips, global batches of 2
    for n in r0["params"]:
        assert torch.equal(r0["params"][n], r1["params"][n]), n
        assert torch.equal(r0["ema"][n], r1["ema"][n]), n
    state = _single(dp, "train")
    assert state.step == 3
    for n, p in state.model.net.named_parameters():
        np.testing.assert_allclose(r0["params"][n].numpy(), p.detach().numpy(), atol=1e-5,
                                   err_msg=n)
        np.testing.assert_allclose(r0["ema"][n].numpy(), state.ema[n].numpy(), atol=1e-5,
                                   err_msg=n)
    # the logged validation loss is the global one
    recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
    (single_run,) = (dp["tmp"] / "single_out" / "train").glob("*/*/train-*")
    srecs = [json.loads(l) for l in (single_run / "metrics.jsonl").read_text().splitlines()]
    val = [r["val/diffusion_loss"] for r in recs if "val/diffusion_loss" in r]
    sval = [r["val/diffusion_loss"] for r in srecs if "val/diffusion_loss" in r]
    assert len(val) == len(sval) == 1 and abs(val[0] - sval[0]) < LOSS_TOL
    dp_test = json.loads((run / "test_metrics.json").read_text())
    single_test = json.loads((single_run / "test_metrics.json").read_text())
    assert dp_test["n_clips"] == single_test["n_clips"] == 3


def test_dp_baseline_matches_single_process(dp):
    """The baseline task's dummy inputs and its walk's noise are striped too."""
    r0, r1 = (r["cli"]["baseline"] for r in dp["res"])
    state = _single(dp, "baseline")
    assert r0["step"] == state.step == 3
    for n, p in state.model.net.named_parameters():
        assert torch.equal(r0["params"][n], r1["params"][n]), n
        np.testing.assert_allclose(r0["params"][n].numpy(), p.detach().numpy(), atol=1e-5,
                                   err_msg=n)
    (run,) = (dp["tmp"] / "dp_out" / "baseline").glob("*/*/train-*")
    (single_run,) = (dp["tmp"] / "single_out" / "baseline").glob("*/*/train-*")
    got, want = (json.loads((r / "test_metrics.json").read_text()) for r in (run, single_run))
    assert got["n_clips"] == want["n_clips"] == 3
    assert all(abs(got[k] - want[k]) <= METRICS_TOL for k in want)


def test_sharded_test_equals_unsharded(dp):
    m0, m1 = (r["cli"]["test"] for r in dp["res"])
    single = _single(dp, "test")
    assert m0 == m1  # every rank returns rank 0's metrics
    assert m0["n_clips"] == single["n_clips"] == 3
    assert sorted(m0) == sorted(single)
    for k, v in single.items():
        assert abs(m0[k] - v) <= METRICS_TOL, k
    assert len(list((dp["tmp"] / "dp_out" / "test").glob("*/*/test-*"))) == 1


def test_sharded_transcribe_and_distill(dp):
    t0, t1 = (r["cli"]["transcribe"] for r in dp["res"])
    assert t1 is None and t0 is not None
    single = pathlib.Path(_single(dp, "transcribe"))
    got = np.load(next(pathlib.Path(t0).glob("*.npz")))["roll"]
    want = np.load(next(single.glob("*.npz")))["roll"]
    assert got.shape == want.shape and np.abs(got - want).max() < 1e-5
    assert len(list((dp["tmp"] / "dp_out" / "transcribe").glob("*/*/transcribe-*"))) == 1
    d0, d1 = (r["cli"]["distill"] for r in dp["res"])
    assert d0["stages"] == d1["stages"] == [3]
    dp_ckpt = read_ckpt(str(pathlib.Path(d0["run_dir"]) / "distilled_3steps" / "checkpoints"
                            / "last.ckpt"))
    single_d = _single(dp, "distill")
    want_ckpt = read_ckpt(str(pathlib.Path(single_d["run_dir"]) / "distilled_3steps"
                              / "checkpoints" / "last.ckpt"))
    for n, v in want_ckpt["state_dict"].items():
        np.testing.assert_allclose(dp_ckpt["state_dict"][n].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=n)
    assert len(list((dp["tmp"] / "dp_out" / "distill").glob("*/*/distill-*"))) == 1


def test_mesh_refusals(dp):
    for msgs in (r["errors"] for r in dp["res"]):
        assert "ValueError" in msgs["data_axis"] and "group has 2 ranks" in msgs["data_axis"]
        assert "ValueError" in msgs["batch"] and "does not divide" in msgs["batch"]
        assert msgs["batch_not_training"] == 2
        assert msgs["model_axis"].startswith("ValueError")
        assert "does not divide the process group's 2 ranks" in msgs["model_axis"]
        assert "ValueError" in msgs["model_axis_zero"] and ">= 1" in msgs["model_axis_zero"]
        assert "ValueError" in msgs["mesh_size"] and "group has 2 ranks" in msgs["mesh_size"]
    # outside a launched group: no mesh at world size 1, a refusal above it
    assert setup_mesh(tconfig.compose("spec_roll"), torch.device("cpu")) is None
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        setup_mesh(tconfig.compose("spec_roll", {"trainer.data_axis": "2"}), torch.device("cpu"))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=4"):
        setup_mesh(tconfig.compose("spec_roll", {"trainer.model_axis": "4"}), torch.device("cpu"))


class _Items:
    """Ten items whose value is their index."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"frame": np.full((2,), i, np.float32)}


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True)])
def test_loader_stripes(shuffle, drop_last):
    """Rank r's batch k is rows r::size of the single-process batch k."""
    one = list(DataLoader(_Items(), 4, shuffle=shuffle, drop_last=drop_last, num_workers=1))
    for size in (2, 3):
        stripes = [list(DataLoader(_Items(), 4, shuffle=shuffle, drop_last=drop_last,
                                   num_workers=1, process_index=r, process_count=size))
                   for r in range(size)]
        assert all(len(s) == len(one) for s in stripes)
        for k, full in enumerate(one):
            for r in range(size):
                got = stripes[r][k]
                assert got["global_rows"] == len(full["frame"])
                np.testing.assert_array_equal(got["frame"], full["frame"][r::size])
    # the short last batch (2 rows) over 3 ranks: rank 2's stripe is empty
    tail = list(DataLoader(_Items(), 4, num_workers=1, process_index=2, process_count=3))[-1]
    assert tail["frame"].shape == (0, 2) and tail["global_rows"] == 2
    with pytest.raises(ValueError):
        DataLoader(_Items(), 4, process_index=2, process_count=2)
