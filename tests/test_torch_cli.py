"""The port's transcription entry point: windowing and stitching against
the JAX package's (exactly equal), `transcribe_long` on resampled audio,
and `python -m diffroll_tpu_torch transcribe ... device=cpu` on the
Lightning fixture writing .npz, .mid and manifest.json."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffroll_tpu.io.midi import read_midi
from diffroll_tpu.io.wav import write_wav
from diffroll_tpu.tasks import transcribe as jtr
from diffroll_tpu_torch.compat import load_lightning
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
from diffroll_tpu_torch.tasks import transcribe as ttr

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "lightning_small.ckpt"


@pytest.mark.parametrize("n,overlap", [(1000, 0), (16 * 512 * 3 + 77, 4), (5, 2),
                                       (16 * 512, 8)])
def test_windows_and_stitching_match_jax(n, overlap):
    audio = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    seq = 16 * 512
    jw = jtr.split_windows(audio, seq, 512, overlap)
    tw = ttr.split_windows(audio, seq, 512, overlap)
    np.testing.assert_array_equal(tw, jw)
    rolls = np.random.default_rng(1).random((len(jw), 16, 88))
    total = int(np.ceil(n / 512))
    np.testing.assert_array_equal(ttr.stitch_rolls(rolls, overlap, total),
                                  jtr.stitch_rolls(rolls, overlap, total))
    with pytest.raises(ValueError):
        ttr.split_windows(audio, seq, 512, 16)


def test_transcribe_long_resamples_and_stitches():
    model, _ = load_lightning(str(FIXTURE), overrides={"frames": 16})
    task = DiffusionTask(model, TaskConfig(timesteps=model.config.timesteps, w=0.5))
    audio = (0.1 * np.random.default_rng(0).standard_normal(22050)).astype(np.float32)
    roll = ttr.transcribe_long(task, audio, torch.Generator().manual_seed(0),
                               sample_rate=22050, batch_size=2, overlap_frames=4)
    assert roll.shape == (int(np.ceil(16000 / 512)), 88) and np.isfinite(roll).all()
    again = ttr.transcribe_long(task, audio, torch.Generator().manual_seed(0),
                                sample_rate=22050, batch_size=2, overlap_frames=4)
    np.testing.assert_array_equal(roll, again)  # all randomness comes from the generator


def test_cli_transcribe_writes_midi_npz_manifest(tmp_path):
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(24000) / 16000
    tone = 0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(t.size)
    write_wav(audio_dir / "b.wav", tone.astype(np.float32), 16000)
    write_wav(audio_dir / "a.wav", (0.1 * rng.standard_normal(12000)).astype(np.float32),
              16000)
    out = subprocess.run(
        [sys.executable, "-m", "diffroll_tpu_torch", "transcribe",
         f"pretrained_path={FIXTURE}", f"dataset.audio_path={audio_dir}",
         "dataset.audio_ext=wav", "task.w=0.5", "overlap_frames=4", "device=cpu",
         "model.frames=16", f"trainer.output_dir={tmp_path / 'out'}",
         "dataloader.test_batch_size=2"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    run_dir = pathlib.Path(json.loads(out.stdout.strip().splitlines()[-1])["run_dir"])
    manifest = json.loads((run_dir / "manifest.json").read_text())
    assert [m["file"] for m in manifest] == ["a.wav", "b.wav"]
    for i, (name, n) in enumerate([("a", 12000), ("b", 24000)]):
        roll = np.load(run_dir / f"{i:03d}_{name}.npz")["roll"]
        assert roll.shape == (int(np.ceil(n / 512)), 88) and np.isfinite(roll).all()
        assert manifest[i]["frames"] == roll.shape[0]
        assert len(read_midi(str(run_dir / f"{i:03d}_{name}.mid"))) == manifest[i]["notes"]


def test_cli_usage_and_errors(tmp_path):
    from diffroll_tpu_torch import __main__ as entry
    from diffroll_tpu_torch.cli import transcribe

    assert entry._dispatch(["--help"]) == 0
    assert entry._dispatch(["no_such_verb"]) == 2  # an unknown verb: usage, code 2
    if not torch.cuda.is_available():
        # the entry points run on the card unless the caller asks for the CPU
        with pytest.raises(SystemExit, match="no CUDA device"):
            entry._dispatch(["train"])
    with pytest.raises(SystemExit, match="pretrained_path"):
        transcribe.main(["device=cpu"])
    with pytest.raises(SystemExit, match="no \\*.wav files"):
        transcribe.main([f"pretrained_path={FIXTURE}", f"dataset.audio_path={tmp_path}",
                         "dataset.audio_ext=wav", "device=cpu",
                         f"trainer.output_dir={tmp_path / 'out'}"])


def test_profile_idle_share_reads_the_device_timeline(tmp_path):
    """The profiler's idle share: overlapping device ops count once, host
    events are ignored, and a gap between ops counts as idle."""
    from diffroll_tpu_torch.profile_sampler import device_ops, device_timeline

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 1000.0, "dur": 400.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 1200.0, "dur": 300.0},  # overlaps
        {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0.0, "dur": 9000.0},        # host
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 2000.0, "dur": 500.0},  # after a gap
    ]}))
    span_ms, busy_ms = device_timeline(trace)
    assert span_ms == pytest.approx(1.5) and busy_ms == pytest.approx(1.0)
    by_name, gaps = device_ops(trace)
    assert list(by_name) == ["a", "copy"]  # largest first; the host op is not there
    assert by_name["a"] == {"ms": pytest.approx(0.9), "calls": 2}
    assert gaps == [{"ms": pytest.approx(0.5), "at_ms": pytest.approx(0.5), "before": "a"}]
    trace.write_text(json.dumps({"traceEvents": [{"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 1}]}))
    with pytest.raises(RuntimeError, match="no device op"):
        device_timeline(trace)
