"""The port's spans (utils/profiling.py) on the CPU: off without a profile,
nested as declared under one; the benchmark's readers that put idle gaps
down to them; and the served reply's placement, which replays a window's
draws bit for bit, and its roll."""

import json
import pathlib
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port import run as bench
from bench_port import trace as bench_trace
from diffroll_tpu_torch import models
from diffroll_tpu_torch.io.wav import read_wav_bytes, write_wav
from diffroll_tpu_torch.serve import TranscriptionService, serve_forever
from diffroll_tpu_torch.serve.service import decode_roll
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
from diffroll_tpu_torch.tasks.transcribe import split_windows, stitch_rolls, transcribe_long
from diffroll_tpu_torch.train import TrainState, make_train_step
from diffroll_tpu_torch.utils import profiling

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FRAMES, HOP, SR, OVERLAP = 32, 512, 16000, 4
SEQ = FRAMES * HOP
STRIDE = SEQ - OVERLAP * HOP


def _task(timesteps=4, **kw):
    """A tiny conditional model whose output head is not zero."""
    torch.manual_seed(0)
    model = models.build("ClassifierFreeDiffRoll", residual_channels=16, residual_layers=2,
                         frames=FRAMES, timesteps=timesteps)
    torch.nn.init.normal_(model.net.output_projection.weight, std=0.1)
    return DiffusionTask(model.eval(), TaskConfig(timesteps=timesteps, w=0.5, **kw))


def _spans(prof, tmp_path):
    """The profile's user annotations as (name, start, end, thread)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(spans, child, parent):
    """Every `child` span lies inside a `parent` span of its thread."""
    kids = [s for s in spans if s[0] == child]
    outer = [s for s in spans if s[0] == parent]
    return bool(kids) and all(any(p[1] <= k[1] and k[2] <= p[2] and p[3] == k[3]
                                  for p in outer) for k in kids)


# ------------------------------------------------------------------ spans

def test_span_is_a_shared_no_op_without_a_profile(tmp_path):
    assert profiling.span("a") is profiling.span("b", "batch=0")
    with profiling.span("stale.span"):
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("fresh.span"):
            torch.ones(4).sum()
    names = [s[0] for s in _spans(prof, tmp_path)]
    assert names.count("fresh.span") == 1 and "stale.span" not in names
    assert profiling.span("c") is profiling.span("d")  # off again once the profile ends


def test_transcribe_long_emits_its_spans_nested(tmp_path):
    task = _task(use_megakernel=True)  # the whole-process sampler's plain version
    audio = (0.1 * np.random.default_rng(0).standard_normal(SEQ + 2 * STRIDE)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        roll = transcribe_long(task, audio, torch.Generator().manual_seed(0), batch_size=2,
                               overlap_frames=OVERLAP)
    assert roll.shape == (-(-len(audio) // HOP), 88)
    spans = _spans(prof, tmp_path)
    count = lambda n: sum(s[0] == n for s in spans)
    assert count("transcribe.long") == count("transcribe.split") == count("transcribe.stitch") == 1
    for name in ("transcribe.copy_in", "transcribe.draw", "transcribe.copy_out", "sample",
                 "sample.draw", "sample.k2", "conditioner"):
        assert count(name) == 2, name  # 3 windows in batches of 2
    for child, parent in (("transcribe.split", "transcribe.long"),
                          ("transcribe.copy_in", "transcribe.long"),
                          ("transcribe.draw", "transcribe.long"),
                          ("sample", "transcribe.long"),
                          ("transcribe.copy_out", "transcribe.long"),
                          ("transcribe.stitch", "transcribe.long"),
                          ("sample.draw", "sample"), ("conditioner", "sample"),
                          ("sample.k2", "sample")):
        assert _inside(spans, child, parent), (child, parent)


def test_train_step_emits_its_spans_nested(tmp_path):
    task = _task(fused_train=True)
    g = torch.Generator().manual_seed(1)
    batch = {"audio": 0.1 * torch.randn(2, SEQ, generator=g),
             "frame": (torch.rand(2, FRAMES, 88, generator=g) < 0.1).float()}
    state = TrainState.create(task.model, 1e-3)
    step = make_train_step(task.loss_fn)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        losses = step(state, batch, g)
    assert torch.isfinite(losses["diffusion_loss"]) and state.step == 1
    spans = _spans(prof, tmp_path)
    assert sum(s[0] == "train.step" for s in spans) == 1
    assert not any(s[0] == "train.allreduce" for s in spans)  # no mesh
    for child in ("train.zero_grad", "train.loss", "train.backward", "train.optimizer"):
        assert _inside(spans, child, "train.step"), child
    assert _inside(spans, "conditioner", "train.loss")
    order = sorted((s[1], s[0]) for s in spans if s[0].startswith("train.") and s[0] != "train.step")
    assert [n for _, n in order] == ["train.zero_grad", "train.loss", "train.backward",
                                     "train.optimizer"]


# ------------------------------------------------------------------ readers

class _Run:
    def __init__(self, records, mix=None):
        self.records, self.mix = records, mix or {"batch_size": 8}


def _read(metric, run):
    path = REPO / "bench_port" / "metrics" / f"{metric}.py"
    return bench.load_module(path, f"bench_port.metrics.{metric}").read(run)


def _trace(host, gaps, t1=10_000.0):
    """A stretch of [0, t1) us whose device ops leave exactly `gaps` idle,
    with the host events `host` as (name, start, end[, thread])."""
    events = [{"ph": "X", "cat": "user_annotation", "name": bench_trace.MARK, "ts": 0.0,
               "dur": t1, "tid": 1}]
    edges = [0.0] + [x for g in sorted(gaps) for x in g] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            events.append({"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a})
    for h in host:
        name, start, end = h[:3]
        cat = "user_annotation" if not name.startswith(("aten::", "cuda")) else "cpu_op"
        events.append({"ph": "X", "cat": cat, "name": name, "ts": start, "dur": end - start,
                       "tid": h[3] if len(h) > 3 else 1})
    tr = bench_trace.Trace(events)
    assert [(round(a), round(b)) for a, b in tr.gaps] == sorted(gaps)
    return tr


TRANSCRIBE_HOST = [
    ("bench.transcribe_long", 0, 9000), ("transcribe.long", 10, 8990),
    ("transcribe.split", 20, 500), ("transcribe.copy_in", 600, 700),
    ("sample", 800, 4000), ("conditioner", 850, 1000), ("sample.draw", 1100, 1300),
    ("sample.k2", 1400, 3900), ("aten::mm", 1500, 1700), ("cudaGraphLaunch", 3000, 3100),
    ("transcribe.copy_out", 4100, 8000), ("transcribe.stitch", 8100, 8900),
    ("bench.decode", 9000, 9800)]
# (gap, the span it lands on): a gap under an aten op and under a runtime call
# inside sample.k2 land on sample.k2; under bench.decode, on no port span
TRANSCRIBE_GAPS = [((100, 130), "transcribe.split"), ((640, 690), "transcribe.copy_in"),
                   ((900, 960), "conditioner"), ((1150, 1250), "sample.draw"),
                   ((1550, 1650), "sample.k2"), ((3020, 3060), "sample.k2"),
                   ((3950, 3990), "sample"), ((8200, 8210), None),  # under 20 us
                   ((8300, 8400), "transcribe.stitch"), ((8950, 8980), "transcribe.long"),
                   ((9100, 9400), None)]


@pytest.mark.parametrize("metric,names", [
    ("transcribe.idle_ms_per_batch", {"transcribe.long", "transcribe.split",
                                      "transcribe.copy_in", "transcribe.stitch"}),
    ("sampler.idle_ms_per_batch", {"sample", "sample.draw", "sample.k2", "conditioner"})])
def test_transcription_readers_sum_their_spans_gaps_per_batch(metric, names):
    tr = _trace(TRANSCRIBE_HOST, [g for g, _ in TRANSCRIBE_GAPS])
    want_us = sum(g1 - g0 for (g0, g1), n in TRANSCRIBE_GAPS if n in names)
    # 9 + 8 windows in batches of 8: 2 + 1 batches
    run = _Run({"trace": tr, "traced_windows": [9, 8]})
    assert _read(metric, run) == pytest.approx(want_us / 1e3 / 3)


TRAIN_HOST = [
    ("bench.train_step", 0, 5000), ("train.step", 10, 4990), ("train.zero_grad", 20, 100),
    ("train.loss", 200, 1500), ("conditioner", 300, 600), ("aten::stft", 320, 500),
    ("train.backward", 1600, 3000), ("aten::t", 1700, 1800),
    ("train.optimizer", 3100, 4800), ("Optimizer.step#Adam.step", 3150, 4700),
    ("aten::_foreach_add_", 3200, 3400),
    ("bench.train_step", 5000, 9990), ("train.step", 5010, 9980),
    ("train.optimizer", 8000, 9900)]
TRAIN_GAPS = [((30, 90), "train.zero_grad"), ((330, 480), "conditioner"),
              ((700, 760), "train.loss"), ((1720, 1790), "train.backward"),
              ((3050, 3090), "train.step"), ((3250, 3350), "train.optimizer"),
              ((4000, 4100), "train.optimizer"), ((4992, 5008), None),  # bench.train_step
              ((8100, 8300), "train.optimizer"), ((9000, 9015), None)]  # under 20 us


@pytest.mark.parametrize("metric,names", [
    ("train.optimizer_idle_ms_per_step", {"train.optimizer"}),
    ("train.model_idle_ms_per_step", {"train.step", "train.zero_grad", "train.loss",
                                      "train.backward", "conditioner"})])
def test_training_readers_sum_their_spans_gaps_per_step(metric, names):
    tr = _trace(TRAIN_HOST, [g for g, _ in TRAIN_GAPS])
    want_us = sum(g1 - g0 for (g0, g1), n in TRAIN_GAPS if n in names)
    assert _read(metric, _Run({"trace": tr, "traced_steps": 2})) == pytest.approx(
        want_us / 1e3 / 2)


@pytest.mark.parametrize("metric,units", [
    ("transcribe.idle_ms_per_batch", {"traced_windows": [8]}),
    ("sampler.idle_ms_per_batch", {"traced_windows": [8]}),
    ("train.optimizer_idle_ms_per_step", {"traced_steps": 2}),
    ("train.model_idle_ms_per_step", {"traced_steps": 2})])
def test_readers_report_nothing_without_the_programs_spans(metric, units):
    """A program without spans (the benchmark's own annotations only): no
    value, and no error."""
    tr = _trace([("bench.transcribe_long", 0, 9000), ("aten::mm", 100, 200)],
                [(120, 180), (5000, 6000)])
    assert _read(metric, _Run({"trace": tr, **units})) is None
    assert _read(metric, _Run({})) is None


# ------------------------------------------------------------------ serve

def _replay(task, seed, max_batch, placement, waves):
    """Each window's roll from the seed alone: the service generator's draws
    for batches 0..batch at `max_batch` rows, the window at its row."""
    g = torch.Generator().manual_seed(seed)
    shape = (max_batch, FRAMES, 88)
    draws = []
    for _ in range(max(b for b, _ in placement) + 1):
        x_T = torch.randn(shape, generator=g)
        draws.append((x_T, torch.randn((task.config.timesteps,) + shape, generator=g)))
    rolls = []
    for (b, row), wav in zip(placement, waves):
        batch = torch.zeros((max_batch, SEQ))
        batch[row] = torch.from_numpy(wav)
        x_T, noise = draws[b]
        rolls.append(task.sample(x_T, waveform=batch, noise=noise)[0][row].numpy())
    return np.stack(rolls)


def test_served_placement_replays_each_window_bit_for_bit():
    """Two concurrent requests: each window's reported (batch, row) names the
    draws it ran with, counting the warm-up's batch as 0."""
    task = _task()
    seed, max_batch = 5, 4
    rng = np.random.default_rng(3)
    audio = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in (SEQ + 2 * STRIDE, SEQ + 4 * STRIDE - 1000)]   # 3 and 5 windows
    svc = TranscriptionService(task, max_batch=max_batch, max_wait_ms=20,
                               overlap_frames=OVERLAP, seed=seed)
    got = {}
    try:
        svc.warmup()
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, svc.transcribe_with_placement(audio[i]))) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        svc.close()
    assert sorted(got) == [0, 1]
    seen = set()
    for i, (roll, placement) in got.items():
        waves = split_windows(audio[i], SEQ, HOP, OVERLAP)
        assert len(placement) == len(waves) and all(b >= 1 for b, _ in placement)
        seen.update(placement)
        want = stitch_rolls(_replay(task, seed, max_batch, placement, waves), OVERLAP,
                            len(roll))
        np.testing.assert_array_equal(roll, want)
    assert len(seen) == 8  # no two windows share a row of a batch
    assert float(np.abs(got[0][0]).max()) > 0.0


def test_http_reply_names_placement_and_returns_the_roll(tmp_path):
    """`?roll=1` returns the roll `transcribe` gives on the same draws (a
    second service from the same seed), bit for bit; every reply names its
    windows' placement."""
    task = _task()
    kw = dict(max_batch=2, max_wait_ms=50, overlap_frames=OVERLAP, seed=7)
    svc = TranscriptionService(task, **kw)
    ready = threading.Event()
    threading.Thread(target=serve_forever, args=(svc, "127.0.0.1", 0),
                     kwargs={"ready": ready}, daemon=True).start()
    assert ready.wait(10)
    server = ready.server  # type: ignore[attr-defined]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    clip = (0.1 * np.random.default_rng(4).standard_normal(SEQ + STRIDE)).astype(np.float32)
    path = tmp_path / "clip.wav"
    write_wav(path, clip, SR)
    try:
        replies = []
        for query in ("?roll=1", ""):
            req = urllib.request.Request(f"{base}/transcribe{query}", data=path.read_bytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                replies.append(json.loads(r.read()))
    finally:
        server.shutdown()
        svc.close()
    with_roll, plain = replies
    assert with_roll["placement"] == [[0, 0], [0, 1]] and plain["placement"] == [[1, 0], [1, 1]]
    assert "roll" not in plain
    roll = decode_roll(with_roll["roll"])
    assert roll.shape == (with_roll["frames"], 88) == tuple(with_roll["roll"]["shape"])
    audio, sr = read_wav_bytes(path.read_bytes(), mono=True)   # what the server heard
    twin = TranscriptionService(task, **kw)
    try:
        want = twin.transcribe(audio, sample_rate=sr)
    finally:
        twin.close()
    assert roll.dtype == want.dtype and with_roll["roll"]["dtype"] == want.dtype.name
    np.testing.assert_array_equal(roll, want)
    assert float(np.abs(want).max()) > 0.0


def test_serve_spans_on_the_service_threads(tmp_path):
    """The service's spans sit on the threads that do the work; a profile
    that records every thread holds them all."""
    cfg = pytest.importorskip("torch._C._profiler")._ExperimentalConfig
    try:
        all_threads = cfg(profile_all_threads=True)
    except TypeError:
        pytest.skip("this PyTorch's profiler records only the thread it started on")
    svc = TranscriptionService(_task(), max_batch=2, max_wait_ms=5, overlap_frames=OVERLAP)
    try:
        svc.warmup()
        with profile(activities=[ProfilerActivity.CPU], experimental_config=all_threads) as prof:
            svc.transcribe(np.zeros(SEQ + STRIDE, np.float32))
    finally:
        svc.close()
    spans = _spans(prof, tmp_path)
    tid = {s[0]: s[3] for s in spans}
    for name in ("serve.request", "serve.gather", "serve.assemble", "serve.copy_in",
                 "serve.issue", "serve.wait", "serve.copy_out", "serve.deliver"):
        assert name in tid, name
    assert tid["serve.gather"] == tid["serve.issue"] != tid["serve.wait"] == tid["serve.deliver"]
    assert tid["serve.request"] not in (tid["serve.issue"], tid["serve.wait"])
    assert _inside(spans, "sample", "serve.issue")
