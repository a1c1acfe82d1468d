"""The port's evaluation entries on the CPU: `run_test` against the JAX
package's on the same tiny synthetic MAPS test split and the same sampled
rolls (per-recording reassembly, the overlap clamp, the cross-fade stitch,
several thresholds), the `test` CLI on the Lightning fixture, the test-split
evaluation that `train` now runs after `fit` (on the EMA weights), `sweep`,
the stored-sampler note, and a refused missing card for every new verb."""

import json
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
from diffroll_tpu.cli import _common as jcommon
from diffroll_tpu.cli import test as jtest_cli
from diffroll_tpu.config import from_argv as j_from_argv
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import _common as tcommon
from diffroll_tpu_torch.cli import sample as sample_cli
from diffroll_tpu_torch.cli import serve as serve_cli
from diffroll_tpu_torch.cli import sweep as sweep_cli
from diffroll_tpu_torch.cli import test as test_cli
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.compat import peek_hparams, read_ckpt, state_dict_from_jax
from diffroll_tpu_torch.config import from_argv as t_from_argv
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from torch_native_tiers import native_tiers_pinned  # noqa: F401

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "lightning_small.ckpt"
SR, HOP, FRAMES = 16000, 512, 16
METRICS_TOL = 1e-9
# the fixture's windows: 16 frames of 512 samples
SMALL = ["model.frames=16", "dataset.sequence_length=8192", "dataloader.num_workers=1",
         "device=cpu"]


def _write_split(root: pathlib.Path, subset: str, clips: int, seconds: float, seed: int):
    """`clips` 16 kHz recordings with MAPS .txt labels under
    <root>/MAPS/<subset>/MUS/ (ENSTDk* subsets are MAPS's test split)."""
    d = root / "MAPS" / subset / "MUS"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(clips):
        x = np.clip(0.1 * rng.standard_normal(int(SR * seconds)), -1, 1)
        with wave.open(str(d / f"{subset}_{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((x * 32767).astype("<i2").tobytes())
        rows = ["OnsetTime\tOffsetTime\tMidiPitch"]
        for _ in range(6):
            on = rng.uniform(0, seconds - 0.4)
            rows.append(f"{on:.3f}\t{on + 0.3:.3f}\t{int(rng.integers(40, 80))}")
        (d / f"{subset}_{i}.txt").write_text("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A train split (4 clips of 2 s) and a test split (3 recordings of
    1.5 s: 47 frames, so several 16-frame windows each)."""
    root = tmp_path_factory.mktemp("maps")
    _write_split(root, "AkPnBcht", 4, 2.0, seed=0)
    _write_split(root, "ENSTDkCl", 3, 1.5, seed=1)
    return root


def fake_rolls(audio: np.ndarray) -> np.ndarray:
    """A deterministic function of a batch's waveforms standing in for the
    sampler in both packages: (B, FRAMES * HOP) -> (B, FRAMES, 88)."""
    a = np.abs(np.asarray(audio, np.float32)).reshape(audio.shape[0], FRAMES, HOP)
    return (8.0 * a[:, :, :88]).astype(np.float32)


@pytest.mark.parametrize("overlap", [0, 4, 20], ids=["butted", "overlap4", "clamped"])
def test_run_test_matches_jax(tree, overlap, monkeypatch):
    args = [f"dataset.root={tree}", "model.residual_channels=16", "model.residual_layers=2",
            "model.frames=16", "dataset.sequence_length=8192", "task.timesteps=10",
            f"dataset.eval_overlap_frames={overlap}", "dataloader.num_workers=1",
            "dataloader.test_batch_size=4"]
    thresholds = [0.3, 0.5]

    jcfg, _, _ = j_from_argv(args, "test")
    jm = jmodels.DiffRollModel(jcfg.model)
    params = jm.init(jax.random.key(0))
    jtask = JTask(jm, jcfg.task)
    jtask.sample = lambda params, x_T, key, waveform=None, **kw: (
        jax.pure_callback(fake_rolls, jax.ShapeDtypeStruct(x_T.shape, jnp.float32), waveform),
        None)
    monkeypatch.setattr(jcommon, "setup_mesh", lambda cfg: None)  # one device
    want = jtest_cli.run_test(jcfg, jm, jtask, type("State", (), {"params": params}),
                              thresholds=thresholds)

    tcfg, _, _ = t_from_argv(args + ["device=cpu"], "test")
    tm = tmodels.DiffRollModel(tcfg.model)
    tm.net.load_state_dict(state_dict_from_jax(params))  # the JAX model's weights
    ttask = TTask(tm, tcfg.task)
    ttask.sample = lambda x_T, waveform=None, **kw: (
        torch.from_numpy(fake_rolls(waveform.cpu().numpy())), None)
    got = test_cli.run_test(tcfg, tm, ttask, thresholds=thresholds)

    assert got.keys() == want.keys() == set(thresholds)
    for thr in thresholds:
        assert got[thr].keys() == want[thr].keys()
        for k, v in want[thr].items():
            assert abs(got[thr][k] - v) <= METRICS_TOL, (thr, k, got[thr][k], v)
        assert got[thr]["n_clips"] == 3
        assert got[thr]["eval_overlap_frames"] == min(overlap, FRAMES - 1)
    assert got[0.3]["frame_f1"] > 0 and got[0.3]["frame_f1"] != got[0.5]["frame_f1"]


def test_test_cli_on_the_fixture(tree, tmp_path, capsys):
    metrics = test_cli.main([f"pretrained_path={FIXTURE}", f"dataset.root={tree}",
                             f"trainer.output_dir={tmp_path}", "audio_format=wav", *SMALL])
    (run_dir,) = tmp_path.glob("*/*/test-*")
    assert json.loads((run_dir / "test_metrics.json").read_text()) == metrics
    assert metrics["n_clips"] == 3 and metrics["eval_overlap_frames"] == 15
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == metrics
    rolls = np.load(run_dir / "batch0_rolls.npz")
    assert rolls["pred"].shape == rolls["label"].shape == (8, FRAMES, 88)
    assert np.isfinite(rolls["pred"]).all()
    for j in range(2):
        assert (run_dir / f"batch0_clip{j}.mid").exists()
        assert (run_dir / f"batch0_audio{j}.wav").exists()
    # a published checkpoint records no port config: nothing to compare
    assert tcommon.stored_task_config(str(FIXTURE)) is None


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """One epoch with an EMA and a recorded 5-step sampler; the post-fit
    evaluation is watched through the model it is handed."""
    out = tmp_path_factory.mktemp("train")
    seen = {}
    real = train_cli.run_test

    def spy(cfg, model, task, **kw):
        seen["weights"] = {k: v.clone() for k, v in model.net.state_dict().items()}
        seen["metrics"] = real(cfg, model, task, **kw)
        return seen["metrics"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_cli, "run_test", spy)
        state = train_cli.main(
            ["spec_roll", f"dataset.root={tree}", f"trainer.output_dir={out}",
             "trainer.max_epochs=1", "trainer.ema_decay=0.5", "model.residual_channels=16",
             "model.residual_layers=2", "task.timesteps=10", "task.sampling_steps=5",
             "dataloader.train_batch_size=2", "dataloader.val_batch_size=2",
             "trainer.check_val_every_n_epoch=1", "trainer.log_every_n_steps=1", *SMALL])
    (run_dir,) = out.glob("*/*/train-*")
    return state, run_dir, seen


def test_train_scores_the_test_split_on_the_ema_weights(trained):
    state, run_dir, seen = trained
    metrics = json.loads((run_dir / "test_metrics.json").read_text())
    assert metrics == seen["metrics"] and metrics["n_clips"] == 3
    ckpt = read_ckpt(str(run_dir / "checkpoints" / "last.ckpt"))
    raw = state.model.net.state_dict()
    for name, ema in ckpt["ema"].items():
        assert torch.equal(seen["weights"][name], ema), name
    # the EMA lags the raw weights, which the returned state keeps
    assert any(not torch.equal(seen["weights"][n], raw[n]) for n in ckpt["ema"])
    assert all(torch.equal(raw[n], ckpt["state_dict"][n]) for n in ckpt["ema"])


def test_stored_sampler_note(trained, tree, tmp_path, capsys):
    _, run_dir, _ = trained
    last = str(run_dir / "checkpoints" / "last.ckpt")
    stored = tcommon.stored_task_config(last)
    assert stored.sampling_type == "cfdg_ddpm_x0" and stored.sampling_steps == 5
    assert peek_hparams(last) == read_ckpt(last)["hyper_parameters"]
    args = [f"pretrained_path={last}", f"dataset.root={tree}",
            f"trainer.output_dir={tmp_path}", "audio_format=wav", *SMALL]
    test_cli.main(args)
    err = capsys.readouterr().err
    assert "note: evaluating with sampler ('cfdg_ddpm_x0', None)" in err
    assert "recorded ('cfdg_ddpm_x0', 5)" in err
    test_cli.main(args + ["task.sampling_steps=5"])  # pinned: no note
    assert "note:" not in capsys.readouterr().err


def test_peek_reads_no_tensor(trained, monkeypatch):
    _, run_dir, _ = trained
    from diffroll_tpu_torch.train import Checkpointer

    want = read_ckpt(str(run_dir / "checkpoints" / "last.ckpt"))["hyper_parameters"]

    def no_load(*a, **k):
        raise AssertionError("torch.load was called")

    monkeypatch.setattr(torch, "load", no_load)
    assert peek_hparams(str(run_dir / "checkpoints" / "last.ckpt")) == want
    rec = Checkpointer(run_dir / "checkpoints").peek_config("last")
    assert rec["task"].sampling_steps == 5 and rec["model"].residual_channels == 16


def test_sweep_writes_the_grid(tree, tmp_path):
    rows = sweep_cli.main([f"pretrained_path={FIXTURE}", f"dataset.root={tree}",
                           f"trainer.output_dir={tmp_path}", "w_grid=[0,0.5]",
                           "threshold_grid=[0.3,0.5]", *SMALL])
    (run_dir,) = tmp_path.glob("*/*/sweep-*")
    table = json.loads((run_dir / "sweep.json").read_text())
    assert table == rows and len(rows) == 4
    assert [(r["w"], r["frame_threshold"]) for r in rows] == [
        (0.0, 0.3), (0.0, 0.5), (0.5, 0.3), (0.5, 0.5)]
    assert all(r["n_clips"] == 3 and np.isfinite(r["note_f1"]) for r in rows)


@pytest.mark.parametrize("verb", ["test", "sample", "sweep", "serve"])
def test_new_verbs_refuse_a_missing_card(verb):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    main = {"test": test_cli.main, "sample": sample_cli.main, "sweep": sweep_cli.main,
            "serve": serve_cli.main}[verb]
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([f"pretrained_path={FIXTURE}", "device=cuda"])


def test_module_entry_tests_in_a_subprocess(tree, tmp_path):
    """`python -m diffroll_tpu_torch test ...` with jax and the JAX package
    blocked: the verb needs neither."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['diffroll_tpu'] = None\n"
            "from diffroll_tpu_torch.__main__ import _dispatch\n"
            "sys.exit(_dispatch(sys.argv[1:]))\n")
    out = subprocess.run(
        [sys.executable, "-c", code, "test", f"pretrained_path={FIXTURE}",
         f"dataset.root={tree}", f"trainer.output_dir={tmp_path}", "audio_format=wav",
         "dataset.eval_overlap_frames=0", *SMALL],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["n_clips"] == 3 and metrics["eval_overlap_frames"] == 0


def test_p_sweep_trains_and_tests_each_point(tree, tmp_path):
    rows = sweep_cli.main(
        ["spec_roll", "p_grid=[0,0.5]", f"dataset.root={tree}", f"trainer.output_dir={tmp_path}",
         "trainer.max_epochs=1", "model.residual_channels=8", "model.residual_layers=2",
         "task.timesteps=4", "dataloader.train_batch_size=2", "dataloader.val_batch_size=2",
         "trainer.check_val_every_n_epoch=1", *SMALL])
    table = json.loads((tmp_path / "p_sweep" / "p_sweep.json").read_text())
    assert table == rows and [r["spec_dropout"] for r in rows] == [0.0, 0.5]
    assert all(r["n_clips"] == 3 for r in rows)
    for p in ("p0", "p0.5"):
        (ckpt,) = (tmp_path / "p_sweep" / p).glob("*/*/train-*/checkpoints/last.ckpt")
        assert read_ckpt(str(ckpt))["hyper_parameters"]["spec_dropout"] == float(p[1:])
