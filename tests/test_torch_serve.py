"""The port's serving tier on the CPU, on a tiny model: the cases of
tests/test_serve.py (micro-batching semantics, the HTTP front, backpressure,
the int16 transfer, timing and the pipeline), a stress case with many
concurrent callers, and the service's roll against `transcribe_long` on the
same windows and the same generator draws."""

import json
import pathlib
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from diffroll_tpu_torch import models
from diffroll_tpu_torch.io.wav import write_wav
from diffroll_tpu_torch.serve import ServiceOverloaded, TranscriptionService, serve_forever
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
from diffroll_tpu_torch.tasks.transcribe import transcribe_long

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "lightning_small.ckpt"
FRAMES, HOP, SR = 32, 512, 16000
SEQ = FRAMES * HOP
JOIN_S = 60


def _task(timesteps=6):
    """A tiny conditional model whose output head is not zero, so rolls vary."""
    torch.manual_seed(0)
    model = models.build("ClassifierFreeDiffRoll", residual_channels=16, residual_layers=2,
                         frames=FRAMES, timesteps=timesteps)
    torch.nn.init.normal_(model.net.output_projection.weight, std=0.1)
    return DiffusionTask(model.eval(), TaskConfig(timesteps=timesteps, w=0.5))


@pytest.fixture(scope="module")
def service():
    svc = TranscriptionService(_task(), max_batch=4, max_wait_ms=30, overlap_frames=4)
    svc.warmup()
    yield svc
    svc.close()


def _serve(svc, **kw):
    ready = threading.Event()
    threading.Thread(target=serve_forever, args=(svc, "127.0.0.1", 0),
                     kwargs={"ready": ready, **kw}, daemon=True).start()
    assert ready.wait(10)
    server = ready.server  # type: ignore[attr-defined]
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body, timeout=120):
    return urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                  timeout=timeout)


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)


def test_transcribe_shapes_and_stitching(service):
    n = int(SEQ * 2.5)  # 2.5 windows -> a roll of ceil(n / hop) frames
    roll = service.transcribe(np.zeros(n, np.float32))
    assert roll.shape == (-(-n // HOP), 88) and np.isfinite(roll).all()


def test_transcribe_resamples_other_rates(service):
    roll = service.transcribe(np.zeros(SEQ // 2, np.float32), sample_rate=8000)
    assert roll.shape[0] == FRAMES


def test_concurrent_requests_share_batches(service):
    start = service.stats["batches"]
    results = {}

    def run(name):
        results[name] = service.transcribe(np.zeros(SEQ * 2, np.float32))

    threads = [threading.Thread(target=run, args=(f"r{i}",)) for i in range(3)]
    for t in threads:
        t.start()
    _join(threads)
    assert len(results) == 3 and all(r.shape[1] == 88 for r in results.values())
    # 3 requests of >= 2 windows with max_batch=4 and a 30 ms gather window
    assert service.stats["batches"] - start < 6


def test_many_concurrent_callers_each_get_their_own_roll(service):
    """More callers than cores, the interpreter switching threads often:
    every caller gets the roll of its own length and every window is
    counted once."""
    start = dict(service.stats)
    lengths = [SEQ // 4 + 1000 * i for i in range(12)]  # one window each
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, service.transcribe(np.full(lengths[i], 0.01, np.float32)))) for i in range(12)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(results) == list(range(12))
    assert all(results[i].shape == (-(-lengths[i] // HOP), 88) for i in range(12))
    assert service.stats["windows"] - start["windows"] == 12
    assert service.stats["requests"] - start["requests"] == 12


def test_http_endpoints(service, tmp_path):
    server, base = _serve(service, info={"model": "tiny"})
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["model"] == "tiny"
        assert set(health["stats"]) >= {"requests", "windows", "batches"}
        wav_path = tmp_path / "req.wav"
        write_wav(wav_path, np.zeros(SEQ + HOP, np.float32), SR)
        with _post(f"{base}/transcribe", wav_path.read_bytes()) as r:
            payload = json.loads(r.read())
        assert payload["frames"] == FRAMES + 1 and isinstance(payload["notes"], list)
        with _post(f"{base}/transcribe?midi=1", wav_path.read_bytes()) as r:
            assert r.read()[:4] == b"MThd"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/transcribe", b"not a wav", timeout=30)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"  # still alive
    finally:
        server.shutdown()


def test_warmup_excluded_from_stats():
    svc = TranscriptionService(_task(4), max_batch=2, max_wait_ms=5, overlap_frames=4)
    try:
        svc.warmup()
        assert svc.stats == {"requests": 0, "windows": 0, "batches": 0, "audio_seconds": 0.0}
        svc.transcribe(np.zeros(SEQ, np.float32))
        assert svc.stats["requests"] == 1 and svc.stats["windows"] == 1
    finally:
        svc.close()


def test_overload_backpressure_and_abandoned_requests():
    """A full window queue rejects with ServiceOverloaded, and the windows
    of dead requests (timed out, or rejected mid-enqueue) are dropped by the
    dispatcher instead of sampled."""
    svc = TranscriptionService(_task(4), max_batch=2, max_wait_ms=5, overlap_frames=4,
                               max_queued_windows=2)
    try:
        svc.warmup()
        svc._stop.set()  # pause the dispatcher so the queue can fill
        svc._worker.join(timeout=10)
        svc._completer.join(timeout=10)
        with pytest.raises(TimeoutError):  # one queued window, then a timeout
            svc.transcribe(np.zeros(SEQ, np.float32), timeout=0.05)
        with pytest.raises(ServiceOverloaded):  # 4 windows, room for 1
            svc.transcribe(np.zeros(SEQ * 4, np.float32))
        assert svc._queue.qsize() == 2  # both queued windows now dead
        svc._stop.clear()
        svc._worker = threading.Thread(target=svc._dispatch_loop, daemon=True)
        svc._completer = threading.Thread(target=svc._completion_loop, daemon=True)
        svc._worker.start()
        svc._completer.start()
        assert svc.transcribe(np.zeros(SEQ, np.float32)).shape == (FRAMES, 88)
        assert svc.stats["windows"] == 1, svc.stats  # only the live window was sampled
    finally:
        svc.close()


def test_http_overload_maps_to_503(service, tmp_path, monkeypatch):
    server, base = _serve(service)

    def overloaded(*a, **k):
        raise ServiceOverloaded("window queue full")

    monkeypatch.setattr(service, "transcribe_with_placement", overloaded)
    try:
        wav_path = tmp_path / "tiny.wav"
        write_wav(wav_path, np.zeros(HOP * 4, np.float32), SR)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/transcribe", wav_path.read_bytes(), timeout=30)
        assert e.value.code == 503 and e.value.headers.get("Retry-After") == "1"
    finally:
        server.shutdown()


def test_http_body_cap_and_fault_classes(service, tmp_path):
    """Bodies over the cap -> 413; a sampler fault -> 500, not 400."""
    svc = TranscriptionService(service.task, max_batch=2, max_wait_ms=5, max_body_mb=0.01,
                               overlap_frames=4)
    server, base = _serve(svc)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/transcribe", b"x" * 20_000, timeout=30)
        assert e.value.code == 413
        wav_path = tmp_path / "tiny.wav"
        write_wav(wav_path, np.zeros(HOP * 4, np.float32), SR)

        def broken(wav):
            raise RuntimeError("device fell over")

        svc._run = broken
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/transcribe", wav_path.read_bytes(), timeout=60)
        assert e.value.code == 500 and "device fell over" in e.value.read().decode()
    finally:
        server.shutdown()
        svc.close()


def test_int16_transfer_matches_f32(service):
    """The int16 transfer is exact for 16-bit PCM sources, so with the same
    draws the roll matches the f32 transfer's closely."""
    kw = dict(max_batch=4, max_wait_ms=5, overlap_frames=4, seed=0)
    clip = (np.random.RandomState(1).randn(SEQ) * 0.1).astype(np.float32)
    rolls = []
    for dtype in ("float32", "int16"):
        svc = TranscriptionService(service.task, transfer_dtype=dtype, **kw)
        try:
            rolls.append(svc.transcribe(clip))
        finally:
            svc.close()
    a, b = rolls
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) / (float(np.abs(a).max()) + 1e-6) < 0.05


def test_transfer_dtype_validated():
    with pytest.raises(ValueError, match="transfer_dtype"):
        TranscriptionService(_task(4), transfer_dtype="int8")


def test_stage_sums_at_depth_two():
    """At the default pipeline depth of 2 the stats sum each batch's stages
    by the host clock, its compute time (the host clock on the CPU) and the
    zero rows it was padded with."""
    svc = TranscriptionService(_task(4), max_batch=2, max_wait_ms=5, overlap_frames=4)
    try:
        assert svc.pipeline_depth == 2
        svc.warmup()
        stride = SEQ - 4 * HOP
        roll = svc.transcribe(np.zeros(SEQ + 2 * stride, np.float32))  # 3 windows
        assert roll.shape[0] == -(-(SEQ + 2 * stride) // HOP)
    finally:
        svc.close()
    s = svc.stats
    for k in ("queue_wait", "gather", "assemble", "copy_in", "issue", "wait", "copy_out",
              "deliver", "batch_wall"):
        assert s.get(f"sum_{k}_s", -1.0) >= 0.0, (k, s)
    assert s["sum_compute_s"] > 0.0 and s["sum_issue_s"] >= s["sum_compute_s"]
    assert s["windows"] == 3 and s["windows"] + s["padded_rows"] == 2 * s["batches"]


def test_pipelined_batches_overlap_under_load(service):
    """pipeline_depth=2 keeps each request's result while batches flow
    through the completion thread; the batch wall time is recorded."""
    results = {}

    def run(i):
        clip = np.random.RandomState(i).randn(SEQ).astype(np.float32) * 0.1
        results[i] = service.transcribe(clip)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    _join(threads)
    assert len(results) == 6 and all(r.shape == (FRAMES, 88) for r in results.values())
    assert service.stats.get("sum_batch_wall_s", 0.0) > 0.0


def test_service_roll_equals_transcribe_long():
    """A request of exactly max_batch windows is one batch; with the same
    seed the service draws x_T and the per-step noise as `transcribe_long`
    does, so the stitched rolls are equal."""
    task = _task()
    audio = (0.1 * np.random.default_rng(2).standard_normal(2 * SEQ - 4 * HOP)).astype(np.float32)
    svc = TranscriptionService(task, max_batch=2, max_wait_ms=5, overlap_frames=4, seed=3)
    try:
        got = svc.transcribe(audio)
        assert svc.stats["batches"] == 1 and svc.stats["windows"] == 2
    finally:
        svc.close()
    want = transcribe_long(task, audio, torch.Generator().manual_seed(3), batch_size=2,
                           overlap_frames=4)
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(want).max()) > 0.0


def test_serve_entry_over_http(tmp_path):
    """`python -m diffroll_tpu_torch serve` on the Lightning fixture: it
    warms up, answers /healthz and a transcription, and stops on SIGTERM."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "diffroll_tpu_torch", "serve", f"pretrained_path={FIXTURE}",
         "model.frames=16", "device=cpu", f"serve.port={port}", "serve.max_batch=2",
         "serve.overlap_frames=4"], stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        for line in proc.stderr:
            if line.startswith('{"serving"'):
                info = json.loads(line)
                break
        else:
            pytest.fail("the service never said it was serving")
        assert info["max_batch"] == 2 and info["device"] == "cpu"
        base = f"http://127.0.0.1:{port}"
        # the line comes just before the socket is bound
        for _ in range(100):
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
                    health = json.loads(r.read())
                break
            except urllib.error.URLError:
                time.sleep(0.1)
        assert health["stats"]["batches"] == 0  # the warm-up is not counted
        wav_path = tmp_path / "req.wav"
        write_wav(wav_path, np.zeros(20000, np.float32), SR)
        with _post(f"{base}/transcribe", wav_path.read_bytes(), timeout=60) as r:
            assert json.loads(r.read())["frames"] == -(-20000 // HOP)
    finally:
        proc.terminate()
        proc.wait(30)


def test_make_service_takes_the_serve_config():
    """`cli.serve.make_service` builds the warmed-up service that `serve`
    runs: the ServeConfig defaults, unless a serve.* key says otherwise."""
    from diffroll_tpu_torch.cli import serve as cli_serve
    from diffroll_tpu_torch.config import ServeConfig

    base = [f"pretrained_path={FIXTURE}", "model.frames=16", "device=cpu", "serve.max_batch=2",
            "serve.overlap_frames=4"]
    default = ServeConfig()
    for extra, wait_s in (([], default.max_wait_ms / 1e3), (["serve.max_wait_ms=100"], 0.1)):
        svc, cfg, info = cli_serve.make_service(base + extra)
        try:
            assert (svc.max_batch, svc.max_wait_s, svc.transfer_dtype, svc.pipeline_depth) == (
                2, wait_s, default.transfer, default.pipeline_depth)
            assert info["max_batch"] == 2 and cfg.serve.max_batch == 2
            assert svc.stats["batches"] == 0  # warmed up, the warm-up not counted
        finally:
            svc.close()
