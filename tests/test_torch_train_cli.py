"""The port's `train` entry on the CPU, on a tiny synthetic MAPS tree written
here: metrics, checkpoints and their policy, reloading a checkpoint for
fine-tuning and for `transcribe`, the dual-dataset recipe, and the pieces of
the fit loop (monitor lookup, logger, step timer, checkpointer)."""

import json
import pathlib
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from diffroll_tpu.train.loop import _resolve_monitor as j_resolve_monitor
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.cli import transcribe as transcribe_cli
from diffroll_tpu_torch.cli._common import config_record
from diffroll_tpu_torch.compat import load_lightning, read_ckpt
from diffroll_tpu_torch.config import compose
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
from diffroll_tpu_torch.train import Checkpointer, TrainState
from diffroll_tpu_torch.train.loop import _resolve_monitor
from diffroll_tpu_torch.utils import MetricLogger, StepTimer

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
TINY = ["model.residual_channels=16", "model.residual_layers=3", "model.frames=16",
        "dataset.sequence_length=8192", "task.timesteps=10", "dataloader.train_batch_size=2",
        "dataloader.val_batch_size=2", "dataloader.num_workers=1", "device=cpu",
        "trainer.check_val_every_n_epoch=1", "trainer.log_every_n_steps=1"]


def _write_tree(root: pathlib.Path, clips: int = 6) -> pathlib.Path:
    """A MAPS-layout corpus: 16 kHz mono wavs with MAPS .txt labels."""
    d = root / "MAPS" / "AkPnBcht" / "MUS"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(clips):
        x = np.clip(0.1 * rng.standard_normal(SR * 2), -1, 1)
        with wave.open(str(d / f"c{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((x * 32767).astype("<i2").tobytes())
        rows = ["OnsetTime\tOffsetTime\tMidiPitch"]
        for _ in range(5):
            on = rng.uniform(0, 1.5)
            rows.append(f"{on:.3f}\t{on + 0.3:.3f}\t{int(rng.integers(40, 80))}")
        (d / f"c{i}.txt").write_text("\n".join(rows) + "\n")
    return root


def _records(run_dir):
    return [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("maps"))


@pytest.fixture(scope="module")
def run(tree, tmp_path_factory):
    """One 2-epoch run with validation, an EMA and a top-1 checkpoint policy."""
    out = tmp_path_factory.mktemp("out")
    state = train_cli.main(
        ["spec_roll", f"dataset.root={tree}", f"trainer.output_dir={out}",
         "trainer.max_epochs=2", "trainer.ema_decay=0.9", "trainer.save_top_k=1",
         "task.fused_train=true", *TINY])
    (run_dir,) = out.glob("*/*/train-*")
    return state, run_dir


def test_train_writes_metrics_and_config(run):
    state, run_dir = run
    assert state.step == 6  # 6 clips, batches of 2, 2 epochs
    recs = _records(run_dir)
    train = [r for r in recs if "train/diffusion_loss" in r]
    val = [r for r in recs if "val/diffusion_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4, 5, 6]
    assert [r["step"] for r in val] == [3, 6]
    assert all(np.isfinite(r["train/diffusion_loss"]) for r in train)
    assert {r["epoch"] for r in train} == {0.0, 1.0}
    assert any("perf/steps_per_sec" in r for r in train)
    cfg = json.loads((run_dir / "config.json").read_text())
    assert cfg["model.residual_channels"] == "16" and cfg["task.fused_train"] == "True"
    assert cfg["dataset.name"] == "MAPS"


def test_train_checkpoints_and_top_k(run):
    state, run_dir = run
    files = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    assert "last.ckpt" in files
    monitored = [f for f in files if f.startswith("step_")]
    assert len(monitored) == 1  # save_top_k=1: older monitored checkpoints are pruned
    ckpt = read_ckpt(str(run_dir / "checkpoints" / "last.ckpt"))
    assert ckpt["global_step"] == 6
    names = {n for n, _ in state.model.net.named_parameters()}
    assert names <= set(ckpt["state_dict"]) and set(ckpt["ema"]) == names
    hp = ckpt["hyper_parameters"]
    assert hp["residual_channels"] == 16 and hp["training"]["mode"] == "x_0"
    assert hp["port_config"]["task"]["fused_train"] is True
    opt = ckpt["optimizer_state"]
    assert opt["param_groups"][0]["lr"] == 5e-5 and len(opt["state"]) == len(names)
    # the EMA lags the raw weights
    w = dict(state.model.net.named_parameters())
    assert any(not torch.equal(ckpt["ema"][n], w[n].detach()) for n in names)


def test_checkpointer_reads_what_train_wrote(run):
    state, run_dir = run
    ck = Checkpointer(run_dir / "checkpoints", max_to_keep=1)
    assert ck.latest_step() in (3, 6)
    assert ck.resolve("last").name == "last.ckpt"
    rec = ck.peek_config("last")
    assert rec["model_name"] == "ClassifierFreeDiffRoll"
    assert rec["model"] == state.model.config
    assert rec["task"].timesteps == 10 and rec["task"].fused_train is True
    ema = ck.load_extra("ema", "last")
    assert set(ema) == {n for n, _ in state.model.net.named_parameters()}
    assert ck.load_extra("nope", "last") is None
    assert Checkpointer(run_dir / "empty").load_extra("ema") is None
    with pytest.raises(FileNotFoundError):
        Checkpointer(run_dir / "empty").resolve()


def test_load_lightning_reads_the_checkpoint(run):
    state, run_dir = run
    model, updates = load_lightning(str(run_dir / "checkpoints" / "last.ckpt"), device="cpu")
    assert model.config == state.model.config
    assert updates["training_mode"] == "x_0" and updates["timesteps"] == 10
    for (n, a), (_, b) in zip(model.net.named_parameters(), state.model.net.named_parameters()):
        assert torch.equal(a, b), n
    task = DiffusionTask(model, TaskConfig(timesteps=10, w=0.5))
    audio = torch.zeros(1, 16 * 512)
    x0 = task.sample(torch.randn(1, 16, 88, generator=torch.Generator().manual_seed(0)),
                     waveform=audio, generator=torch.Generator().manual_seed(1))[0]
    assert x0.shape == (1, 16, 88) and torch.isfinite(x0).all()


def test_finetune_from_checkpoint_with_override(run, tree, tmp_path, capsys):
    state0, run_dir = run
    last = run_dir / "checkpoints" / "last.ckpt"
    # the CLI names no widths (its preset says 512 x 15): the stored
    # architecture wins, the explicit model.spec_dropout is re-applied on top
    # of it, and the task knobs are the CLI's
    args = [a for a in TINY if not a.startswith("model.")]
    state = train_cli.main(
        ["spec_roll", f"dataset.root={tree}", f"trainer.output_dir={tmp_path}",
         f"pretrained_path={last}", "trainer.max_epochs=1", "model.spec_dropout=0.5",
         "task.lr=1e-4", *args])
    assert state.step == 6 + 3  # continues from the stored step
    assert state.model.config.spec_dropout == 0.5
    assert state.model.config.residual_layers == 3 and state.model.config.frames == 16
    assert state.model.config.residual_channels == 16
    assert state.optimizer.param_groups[0]["lr"] == 1e-4
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ckpt = read_ckpt(out["last"])
    assert ckpt["global_step"] == 9
    assert ckpt["hyper_parameters"]["spec_dropout"] == 0.5
    # fine-tuning continued from the raw weights, not from the EMA
    first = next(iter(ckpt["state_dict"]))
    assert not torch.equal(ckpt["state_dict"][first], read_ckpt(str(last))["ema"][first])


def test_transcribe_reads_the_checkpoint(run, tmp_path, capsys):
    _, run_dir = run
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    x = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(SR) / SR)
    with wave.open(str(audio_dir / "tone.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    out_dir = transcribe_cli.main(
        [f"pretrained_path={run_dir / 'checkpoints' / 'last.ckpt'}",
         f"dataset.audio_path={audio_dir}", "dataset.audio_ext=wav", "task.w=0.5",
         "overlap_frames=4", "device=cpu", f"trainer.output_dir={tmp_path / 'tr'}"])
    manifest = json.loads((pathlib.Path(out_dir) / "manifest.json").read_text())
    assert len(manifest) == 1 and manifest[0]["file"] == "tone.wav"
    roll = np.load(next(pathlib.Path(out_dir).glob("*.npz")))["roll"]
    assert roll.shape == (int(np.ceil(SR / 512)), 88) and np.isfinite(roll).all()


def test_dual_recipe_logs_the_unconditional_loss(tree, tmp_path):
    state = train_cli.main(
        ["spec_roll", f"dataset.root={tree}", f"trainer.output_dir={tmp_path}", "dual=true",
         "dataset2.name=MAPS", f"dataset2.root={tree}", "dataset2.sequence_length=8192",
         "trainer.max_epochs=1", *TINY])
    (run_dir,) = tmp_path.glob("*/*/train-*")
    recs = _records(run_dir)
    train = [r for r in recs if "train/diffusion_loss" in r]
    assert len(train) == state.step == 3
    assert all(np.isfinite(r["train/unconditional_diffusion_loss"]) for r in train)
    # validation batches are single-dataset: only the first loss is there
    val = [r for r in recs if "val/diffusion_loss" in r]
    assert val and "val/unconditional_diffusion_loss" not in val[0]
    hp = read_ckpt(str(run_dir / "checkpoints" / "last.ckpt"))["hyper_parameters"]
    assert hp["loss_keys"] == ["diffusion_loss", "unconditional_diffusion_loss"]


def test_unsupervised_preset_monitors_the_train_loss(tree, tmp_path):
    state = train_cli.main(
        ["unsupervised_pretrained", "dataset.name=MAPS", f"dataset.root={tree}",
         f"trainer.output_dir={tmp_path}", "trainer.max_epochs=1", *TINY])
    assert state.model.config.spec_dropout == 1.0
    (run_dir,) = tmp_path.glob("*/*/train-*")
    assert len(list((run_dir / "checkpoints").glob("step_*.ckpt"))) == 1
    assert not any("warn/monitor_unresolved" in r for r in _records(run_dir))


def test_train_refuses_a_missing_card_and_an_unported_transfer(tree, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_cli.main(["spec_roll", f"dataset.root={tree}", "device=cuda"])
    # the port carries no transfer option: batches always cross as float32
    with pytest.raises(KeyError, match="unknown config key 'transfer'"):
        train_cli.main(["spec_roll", f"dataset.root={tree}", "dataloader.transfer=int16",
                        f"trainer.output_dir={tmp_path}", *TINY])


def test_module_entry_trains_in_a_subprocess(tree, tmp_path):
    """`python -m diffroll_tpu_torch train ...` with jax and the JAX package
    blocked: the verb needs neither."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['diffroll_tpu'] = None\n"
            "from diffroll_tpu_torch.__main__ import _dispatch\n"
            "sys.exit(_dispatch(sys.argv[1:]))\n")
    out = subprocess.run(
        [sys.executable, "-c", code, "train", "spec_roll", f"dataset.root={tree}",
         f"trainer.output_dir={tmp_path}", "trainer.max_epochs=1", *TINY],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["steps"] == 3 and pathlib.Path(last["last"]).exists()
    assert "test-split evaluation after fit is not ported" in out.stderr


# ------------------------------------------------------- pieces of the loop

MONITOR_CASES = [
    ("val/diffusion_loss", {"diffusion_loss": 1.0}, {"diffusion_loss": 2.0}),
    ("train/diffusion_loss", {"diffusion_loss": 1.0}, {"diffusion_loss": 2.0}),
    ("train/diffusion_loss", {}, {"diffusion_loss": 2.0}),
    ("val/diffusion_loss", {"diffusion_loss": 1.0}, {}),
    ("diffusion_loss", {"diffusion_loss": 1.0}, {"diffusion_loss": 2.0}),
    ("val/f1", {"diffusion_loss": 1.0}, {"diffusion_loss": 2.0}),
]


@pytest.mark.parametrize("monitor,train,val", MONITOR_CASES)
def test_resolve_monitor_matches_jax(monitor, train, val):
    assert _resolve_monitor(monitor, train, val) == j_resolve_monitor(monitor, train, val)


def test_metric_logger_and_step_timer(tmp_path):
    log = MetricLogger(tmp_path / "run")
    log.log_scalars(3, {"a": torch.tensor(1.5), "b": 2})
    log.log_config({"x.y": (1, 2)})
    log.close()
    (rec,) = _records(tmp_path / "run")
    assert rec["step"] == 3 and rec["a"] == 1.5 and rec["b"] == 2.0 and "time" in rec
    assert json.loads((tmp_path / "run" / "config.json").read_text()) == {"x.y": "(1, 2)"}
    timer = StepTimer()
    assert timer.rates() == {}
    timer.tick(4)
    timer.tick(4)
    rates = timer.rates()
    assert rates["perf/examples_per_sec"] == pytest.approx(4 * rates["perf/steps_per_sec"])
    assert timer.rates() == {}


def test_checkpointer_policy(tmp_path):
    cfg = compose("spec_roll", {"model.residual_channels": "16", "model.residual_layers": "2",
                                "model.frames": "16", "task.timesteps": "10"})
    model = tmodels.DiffRollModel(cfg.model)
    state = TrainState.create(model, 1e-3)
    ck = Checkpointer(tmp_path / "ck", max_to_keep=2)
    for step in (1, 2, 3):
        state.step = step
        ck.save(step, state, config_record(cfg))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_000000002.ckpt", "step_000000003.ckpt"]
    assert ck.latest_step() == 3 and ck.load()["global_step"] == 3
    ck.save_last(state, config_record(cfg), extras={"ema": {"k": torch.ones(1)}})
    assert ck.load_extra("ema", "last")["k"].item() == 1.0
    assert ck.load_extra("ema") is None  # the monitored file has no EMA
    assert ck.peek_config()["model"] == cfg.model
    assert ck.peek_config()["task"] == cfg.task
