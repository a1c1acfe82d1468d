"""The port's `sample` entry on the CPU: the recorded trajectory of
inpainting and generation against the JAX package's scan path on the same
weights, x_T and per-step draws; `export_clip` against the JAX package's on
the same roll; the CLI on the Lightning fixture in both modes, with and
without matplotlib."""

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
from diffroll_tpu.cli import sample as jsample_cli
from diffroll_tpu.config import compose as j_compose
from diffroll_tpu.io.midi import read_midi as j_read_midi
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu.tasks import TaskConfig as JTaskConfig
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import sample as sample_cli
from diffroll_tpu_torch.compat import state_dict_from_jax
from diffroll_tpu_torch.config import compose as t_compose
from diffroll_tpu_torch.io.midi import read_midi
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig
from torch_native_tiers import native_tiers_pinned  # noqa: F401

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "lightning_small.ckpt"
F32_GATE = 1e-3
C, L, T, B, STEPS = 16, 2, 32, 2, 20
GEN, INPAINT = "generation_ddpm_x0", "inpainting_ddpm_x0"
SMALL = ["model.frames=16", "dataset.sequence_length=8192", "dataloader.num_workers=1",
         "device=cpu"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _jax_noise(key, n, shape):
    """The JAX scan's per-step draws (one split key per step)."""
    keys = jax.random.split(key, n)
    return np.array(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))


@pytest.fixture(scope="module")
def pair():
    kw = dict(residual_channels=C, residual_layers=L, frames=T, timesteps=STEPS)
    jm = jmodels.build("ClassifierFreeDiffRoll", **kw)
    params = jm.init(jax.random.key(0))
    head = params["params"]["output_projection"]
    head["kernel"] = 0.1 * jax.random.normal(jax.random.key(9), head["kernel"].shape)
    tm = tmodels.build("ClassifierFreeDiffRoll", **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("name,extra", [
    ("inpainting_ddpm_x0", {"inpainting_t": (4, 12)}),
    ("generation_ddpm_x0", {}),
], ids=["inpainting", "generation"])
def test_trajectory_matches_jax_scan(pair, name, extra):
    """`task.sample(record_every=10)`, as the entry calls it: generation
    gets no audio, inpainting the waveform with the masked frames."""
    jm, params, tm = pair
    rng = np.random.default_rng(3)
    x_T = rng.standard_normal((B, T, 88)).astype(np.float32)
    wav = None if name.startswith("generation") else (
        0.1 * rng.standard_normal((B, T * 512))).astype(np.float32)
    key = jax.random.key(4)
    jtask = JTask(jm, JTaskConfig(timesteps=STEPS, sampling_type=name, w=0.5,
                                  use_megakernel=False, **extra))
    j0, jtraj = jtask.sample(params, jnp.asarray(x_T), key,
                             waveform=None if wav is None else jnp.asarray(wav),
                             record_every=10)
    ttask = TTask(tm, TTaskConfig(timesteps=STEPS, sampling_type=name, w=0.5, **extra))
    t0, ttraj = ttask.sample(torch.from_numpy(x_T),
                             waveform=None if wav is None else torch.from_numpy(wav),
                             noise=torch.from_numpy(_jax_noise(key, STEPS, x_T.shape)),
                             record_every=10)
    assert ttraj.shape == np.asarray(jtraj).shape == (2, B, T, 88)
    assert torch.equal(ttraj[-1], t0)
    assert _rel(ttraj.numpy(), jtraj) < F32_GATE and _rel(t0.numpy(), j0) < F32_GATE
    if wav is not None:
        cond = ttask.build_conditioner(torch.from_numpy(x_T), torch.from_numpy(wav))
        assert bool((cond[:, 4:12] == -1.0).all()) and not bool((cond[:, 12:] == -1.0).all())
        jcond = np.asarray(jtask.build_conditioner(jnp.asarray(x_T), jnp.asarray(wav)))
        np.testing.assert_array_equal(jcond[:, 4:12], -1.0)


@pytest.mark.parametrize("with_trajectory", [True, False])
def test_export_clip_matches_jax(tmp_path, with_trajectory):
    rng = np.random.default_rng(5)
    roll = np.zeros((64, 88), np.float32)  # notes of 1 to 20 frames (the filter drops < 0.1 s)
    for _ in range(40):
        p, on = int(rng.integers(0, 88)), int(rng.integers(0, 60))
        roll[on: on + int(rng.integers(1, 21)), p] = rng.uniform(0.4, 1.0)
    traj = rng.standard_normal((3, 64, 88)).astype(np.float32) if with_trajectory else None
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    n_j = jsample_cli.export_clip(tmp_path / "j", "clip", roll, j_compose("sampling"),
                                  trajectory=traj)
    n_t = sample_cli.export_clip(tmp_path / "t", "clip", roll, t_compose("sampling"),
                                 trajectory=traj)
    assert n_t == n_j > 0  # the manifest's note count
    jz, tz = np.load(tmp_path / "j" / "clip.npz"), np.load(tmp_path / "t" / "clip.npz")
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        np.testing.assert_array_equal(tz[k], jz[k])
    jn = [(n.pitch, n.onset, n.offset) for n in j_read_midi(str(tmp_path / "j" / "clip.mid"))]
    tn = [(n.pitch, n.onset, n.offset) for n in read_midi(str(tmp_path / "t" / "clip.mid"))]
    assert tn == jn and len(tn) == n_t


@pytest.fixture(scope="module")
def test_tree(tmp_path_factory):
    """A MAPS test split: 2 recordings of 1.5 s (4 windows of 16 frames each)."""
    root = tmp_path_factory.mktemp("maps")
    d = root / "MAPS" / "ENSTDkCl" / "MUS"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        x = np.clip(0.1 * rng.standard_normal(24000), -1, 1)
        with wave.open(str(d / f"r{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((x * 32767).astype("<i2").tobytes())
        (d / f"r{i}.txt").write_text("OnsetTime\tOffsetTime\tMidiPitch\n0.1\t0.5\t60\n")
    return root


def _manifest(run_dir):
    return json.loads((run_dir / "manifest.json").read_text())


def test_cli_generation_on_the_fixture(tmp_path):
    run_dir = sample_cli.main([f"pretrained_path={FIXTURE}", f"task.sampling_type={GEN}",
                               "num_samples=3", "dataloader.test_batch_size=2",
                               f"trainer.output_dir={tmp_path}", *SMALL])
    manifest = _manifest(run_dir)
    # num_samples caps the clips; two batches of 2 were sampled
    assert [m["clip"] for m in manifest] == ["gen_0", "gen_1", "gen_0"]
    for i, m in enumerate(manifest):
        z = np.load(run_dir / f"{i:03d}_{m['clip']}.npz")
        # 10 steps, every 10th recorded: the final state alone
        assert z["roll"].shape == (16, 88) and z["trajectory"].shape == (1, 16, 88)
        np.testing.assert_array_equal(z["trajectory"][-1], z["roll"])
        assert len(read_midi(str(run_dir / f"{i:03d}_{m['clip']}.mid"))) == m["notes"]
    assert (run_dir / "denoising.gif").read_bytes()[:3] == b"GIF"


def test_cli_inpainting_on_the_fixture(test_tree, tmp_path):
    run_dir = sample_cli.main([f"pretrained_path={FIXTURE}", f"task.sampling_type={INPAINT}",
                               "task.inpainting_t=[4,8]", "dataset.name=MAPS",
                               f"dataset.root={test_tree}", "num_samples=2",
                               f"trainer.output_dir={tmp_path}", *SMALL])
    manifest = _manifest(run_dir)
    assert [m["clip"] for m in manifest] == ["clip_0", "clip_1"]  # 8 windows, capped at 2
    z = np.load(run_dir / "000_clip_0.npz")
    assert z["trajectory"].shape == (1, 16, 88) and np.isfinite(z["roll"]).all()
    assert (run_dir / "001_clip_1.mid").exists() and (run_dir / "denoising.gif").exists()


def test_cli_without_matplotlib_keeps_the_trajectory(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises
    run_dir = sample_cli.main([f"pretrained_path={FIXTURE}", f"task.sampling_type={GEN}",
                               "num_samples=1", "dataloader.test_batch_size=1",
                               f"trainer.output_dir={tmp_path}", *SMALL])
    assert not (run_dir / "denoising.gif").exists()
    assert "matplotlib is not installed" in capsys.readouterr().err
    assert np.load(run_dir / "000_gen_0.npz")["trajectory"].shape == (1, 16, 88)


def test_module_entry_samples_in_a_subprocess(tmp_path):
    """`python -m diffroll_tpu_torch sample ...` with jax and the JAX package
    blocked: the verb needs neither."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['diffroll_tpu'] = None\n"
            "from diffroll_tpu_torch.__main__ import _dispatch\n"
            "sys.exit(_dispatch(sys.argv[1:]))\n")
    out = subprocess.run(
        [sys.executable, "-c", code, "sample", f"pretrained_path={FIXTURE}",
         "task.sampling_type=generation_ddpm_x0", "num_samples=2",
         f"trainer.output_dir={tmp_path}", *SMALL],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["clips"] == 2 and len(_manifest(pathlib.Path(last["run_dir"]))) == 2
