"""The check that decides `correct`, driven through a whole run at a tiny
width on the CPU (the harness's look for a card skipped): the program passes
it; the control (the reference in fp8 in the program's place) and each fault
a cell can have, planted under the timed path, fail it. On a card, the
control at the cell's own size fails it on three seeds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import run as bench
from bench_port.reference import diffroll as ref
from bench_port.runners import train as train_runner
from bench_port.runners import transcribe as transcribe_runner

from .conftest import spec, tiny_mix, tiny_run

TRANSCRIBE = ["cfdr-transcribe", "diffroll-transcribe"]
BATCH = tiny_mix("transcribe_long")["batch_size"]


def _run(workload):
    run = tiny_run(workload)
    return bench.execute(run, 0.3, False)


@pytest.mark.parametrize("workload", TRANSCRIBE + ["diffroll-train"])
def test_the_program_passes(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", TRANSCRIBE)
def test_transcription_control_fails(workload, monkeypatch):
    def control(self, audio, generator):
        start, rolls = generator.get_state(), []
        for k in range(len(transcribe_runner.batch_sizes(self.windows_of(audio),
                                                         self.run.mix["batch_size"]))):
            generator.set_state(start)
            rolls.append(self.reference_batch(audio, generator, k, "fp8"))
        hop = self.run.cfg["mel"]["hop_length"]
        return ref.stitch(np.concatenate(rolls), self.run.mix["overlap_frames"],
                          -(-len(audio) // hop))

    monkeypatch.setattr(transcribe_runner.Runner, "transcribe", control)
    out = _run(workload)
    assert not out["correct"], out["checks"]


def _sample_fault(kind):
    from diffroll_tpu_torch.tasks.diffusion import DiffusionTask

    real = DiffusionTask.sample

    def sample(self, x_T, *args, **kw):
        if kind == "unchanged":       # the reverse process returns its state unchanged
            return x_T, None
        out, traj = real(self, x_T, *args, **kw)
        out = out.clone()
        if kind == "half_batch":      # half the batch left out, the mean of the rest given
            keep = max(out.shape[0] // 2, 1)
            out[keep:] = out[:keep].mean(0)
            if out.shape[0] == 1:
                out[0] = 0.5
        elif kind == "altered":       # one window's answer altered where it is produced
            out[0] = torch.roll(out[0], 1, dims=-1)
        elif kind == "last_row" and out.shape[0] == BATCH:   # a full batch's last row
            out[-1] = torch.roll(out[-1], 1, dims=-1)
        return out, traj

    return DiffusionTask, sample


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered", "last_row"])
@pytest.mark.parametrize("workload", TRANSCRIBE)
def test_transcription_faults_fail(workload, kind, monkeypatch):
    cls, fault = _sample_fault(kind)
    monkeypatch.setattr(cls, "sample", fault)
    out = _run(workload)
    assert not out["correct"], (kind, out["checks"])


def test_a_wrong_note_decoder_fails(monkeypatch):
    real = transcribe_runner.Runner.decode

    def decode(self, roll):
        found = real(self, roll)
        return found[1:]

    monkeypatch.setattr(transcribe_runner.Runner, "decode", decode)
    out = _run("cfdr-transcribe")
    assert not out["correct"] and out["checks"]["notes_differ"]["value"] > 0


def test_training_control_fails(monkeypatch):
    real = train_runner.Runner.setup

    def setup(self):
        real(self)
        self.first = self.reference_steps("fp8")

    monkeypatch.setattr(train_runner.Runner, "setup", setup)
    out = _run("diffroll-train")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_training_faults_fail(kind, monkeypatch):
    from diffroll_tpu_torch.tasks.diffusion import DiffusionTask

    if kind == "unchanged":           # the step leaves the weights as they were
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    else:
        real = DiffusionTask.loss_fn

        def loss_fn(self, batch, generator=None, train=True, **kw):
            if kind == "half_batch":  # half the batch left out, the mean over the rest
                half = batch["frame"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
                kw = {k: (v[:half] if torch.is_tensor(v) else v) for k, v in kw.items()}
                return real(self, batch, generator, train, **kw)
            total, rest = real(self, batch, generator, train, **kw)
            return total * 1.5, rest  # the loss altered where it is produced

        monkeypatch.setattr(DiffusionTask, "loss_fn", loss_fn)
    out = _run("diffroll-train")
    assert not out["correct"], (kind, out["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"]])
def test_the_control_fails_at_the_cells_size(workload, card):
    """Three seeds at the cell's own size: the control reads past a limit."""
    for seed in (3000000001, 3000000002, 3000000003):
        run = bench.Run(spec(), workload, seed, card)
        out = bench.execute(run, 5.0, False, control=True)
        readings = {k.split(".", 1)[1]: v for k, v in out["readings"].items()
                    if k.startswith("control.")}
        assert any(readings[k] > c["limit"] for k, c in out["checks"].items() if k in readings)


def _runner(batch_size=8, check_windows=16, seed=5):
    run = tiny_run("cfdr-transcribe", seed)
    run.mix.update(batch_size=batch_size, check_windows=check_windows)
    return transcribe_runner.Runner(run)


@pytest.mark.parametrize("seed", range(8))
def test_the_sample_holds_a_full_batch_and_a_short_one(seed):
    runner = _runner(seed=seed)
    recs = [{"i": i, "windows": n} for i, n in enumerate([3, 28, 11, 20, 1, 16, 7])]
    sizes = [transcribe_runner.batch_sizes(r["windows"], 8)[k]
             for r, k in runner.sample({"recordings": recs})]
    assert sizes[0] == 8 and sizes[1] < 8 and sum(sizes) <= 16


@pytest.mark.parametrize("windows", [1, 5, 8, 9, 17, 24])
def test_a_batch_decides_its_span_of_the_stitched_roll_alone(windows):
    runner = _runner(batch_size=4)
    frames, overlap = runner.run.cfg["frames"], runner.run.mix["overlap_frames"]
    step = frames - overlap
    rolls = np.random.default_rng(windows).random((windows, frames, 88))
    total = (windows - 1) * step + frames - 5
    whole = ref.stitch(rolls, overlap, total)
    covered = np.zeros(total, bool)
    for k, b in enumerate(transcribe_runner.batch_sizes(windows, 4)):
        first, lo, hi = runner.batch_span(windows, k, total)
        part = rolls[k * 4: k * 4 + b]
        local = ref.stitch(part, overlap, (b - 1) * step + frames)[lo:hi]
        np.testing.assert_allclose(local, whole[first + lo: first + hi], rtol=0, atol=1e-12)
        covered[first + lo: first + hi] = True
    assert covered.sum() >= total - 2 * overlap * (len(transcribe_runner.batch_sizes(windows, 4)) - 1)
