"""The transcription service: a model-resident worker, a micro-batching
dispatcher and an HTTP front (counterpart of `diffroll_tpu/serve/service.py`;
the package docstring has the design)."""

from __future__ import annotations

import contextlib
import json
import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..diffusion.loop import timestep_subsequence
from ..diffusion.samplers import SAMPLER_TABLE


@dataclass
class _WindowJob:
    """One fixed-size window awaiting the batched sampler."""

    wav: np.ndarray                  # (seq_len,) f32
    request: "_Request"
    index: int                       # position within the request
    t_enqueue: float = 0.0           # monotonic, for queue-wait stats


@dataclass
class _Request:
    n_windows: int
    total_frames: int
    overlap_frames: int
    rolls: List[Optional[np.ndarray]] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    # set when the caller gave up (timeout) or enqueuing failed midway: the
    # dispatcher drops the request's still-queued windows, so an overloaded
    # backlog drains instead of spending the card on work nobody waits for
    abandoned: bool = False

    @property
    def dead(self) -> bool:
        return self.abandoned or self.done.is_set()

    def deliver(self, index: int, roll: np.ndarray):
        self.rolls[index] = roll
        if all(r is not None for r in self.rolls):
            self.done.set()


class ServiceOverloaded(RuntimeError):
    """Raised when the window queue is full: callers should back off (the
    HTTP front answers 503)."""


class TranscriptionService:
    """Window-level micro-batching around one sampler batch shape.

    The model's weights stay on its device (`task.model`). Every batch is
    `max_batch` windows, short batches zero-padded, so the card always runs
    the same shapes. On a CUDA model the reverse process is the
    whole-process sampler (K2).

    Over a mesh (`mesh`, parallel/mesh.py; one process a card under
    torchrun) `max_batch` is rounded down to a multiple of the data axis.
    Rank 0 alone keeps the HTTP front, the queue and the threads; for each
    batch its dispatcher broadcasts a header (the batch's rows, a stop flag)
    and the waveform batch, every rank draws the global batch's x_T and
    noise from the service generator (the same draws in the same order,
    the warm-up's included), samples its data stripe (K2 once a batch on
    each rank) and the rolls are gathered over the mesh. The other ranks
    run `follow` until rank 0 broadcasts stop (`close`). A batch's
    collectives are issued by one thread on each rank, in batch order. A
    model-sharded net samples from its whole weights, gathered once
    (`DiffusionTask._fused_weights`), or column-parallel on the modules.
    """

    def __init__(self, task, *, max_batch: int = 8, max_wait_ms: float = 25.0,
                 overlap_frames: int = 32, frame_threshold: float = 0.5, seed: int = 0,
                 max_body_mb: float = 64.0, max_queued_windows: int = 256,
                 transfer_dtype: str = "float32", pipeline_depth: int = 2,
                 detailed_timing: bool = False, mesh=None):
        self.task = task
        self.mesh = mesh
        mc = task.model.config
        self.device = task.model.device
        self.frames = mc.frames
        self.hop = mc.mel.hop_length
        self.sample_rate = mc.mel.sample_rate
        self.seq_len = self.frames * self.hop
        self.pitches = mc.pitches
        if mesh is not None:
            max_batch = max(max_batch // mesh.data, 1) * mesh.data
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.overlap_frames = overlap_frames
        self.frame_threshold = frame_threshold
        self.max_body_bytes = int(max_body_mb * 1024 * 1024)
        # the waveform batch's host-to-device format, the largest transfer of
        # a batch (max_batch x seq_len f32 = 10.5 MB at B=8, full size):
        # "int16" halves it, is exact for 16-bit PCM sources and is
        # dequantised on the device
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"transfer_dtype must be float32|int16, got {transfer_dtype!r}")
        self.transfer_dtype = transfer_dtype
        # batches in flight: at depth 2 the dispatcher assembles and copies
        # batch k+1 while the card computes batch k; detailed_timing needs
        # depth 1, so that each stage can be timed alone
        self.pipeline_depth = 1 if detailed_timing else max(int(pipeline_depth), 1)
        self.detailed_timing = detailed_timing
        # bounded: otherwise concurrent large requests (a thread each) grow
        # host memory without limit
        self._queue: "queue.Queue[_WindowJob]" = queue.Queue(
            maxsize=max(max_queued_windows, max_batch))
        # x_T and the per-step draws are made on the device from the
        # service's own generator, so no host-side noise crosses per batch
        cfg = task.config
        self._steps = len(timestep_subsequence(cfg.timesteps, cfg.sampling_steps))
        self._stochastic = SAMPLER_TABLE[cfg.sampling_type][3]
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._generator_lock = threading.Lock()
        # on a card the batches are issued on a stream the service owns and
        # each is followed by an event that the completion thread waits on
        # (PyTorch's current stream is per thread, so the two threads must
        # not rely on meeting on a default stream)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._stop = threading.Event()
        # the completion pipeline: the dispatcher issues a batch and hands
        # (jobs, device result, its event) to the completion thread, which
        # waits, copies to the host and delivers. The queue's size bounds the
        # batches in flight to pipeline_depth (one being completed + maxsize)
        self._completions: "queue.Queue" = queue.Queue(maxsize=max(self.pipeline_depth - 1, 1))
        self._worker = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._completer = threading.Thread(target=self._completion_loop, daemon=True)
        self.stats = {"requests": 0, "windows": 0, "batches": 0, "audio_seconds": 0.0}
        self._stats_lock = threading.Lock()
        if self.leads:
            self._worker.start()
            self._completer.start()

    @property
    def leads(self) -> bool:
        """Whether this process takes the requests: the only one, or rank 0."""
        return self.mesh is None or self.mesh.is_main

    def _share(self, wav: torch.Tensor, rows: int) -> torch.Tensor:
        """Rank 0 of a mesh: broadcast the batch's header and its waveforms
        (as f32: NCCL moves no int16) before running it; returns them."""
        if self.mesh is None:
            return wav
        if wav.dtype == torch.int16:
            wav = wav.float() * (1.0 / 32768.0)
        self._broadcast_header(rows, stop=False)
        dist.broadcast(wav, src=0)
        return wav

    def _run(self, wav: torch.Tensor) -> torch.Tensor:
        """The batch's reverse process: (max_batch, seq_len) waveforms on the
        device (f32, or int16 PCM) -> (max_batch, frames, 88) rolls there;
        over a mesh, this rank's data stripe, the rolls gathered."""
        if wav.dtype == torch.int16:
            wav = wav.float() * (1.0 / 32768.0)
        mesh = self.mesh
        shape = (self.max_batch, self.frames, self.pitches)
        with self._generator_lock:
            x_T = torch.randn(shape, generator=self._generator, device=self.device)
            noise = (torch.randn((self._steps,) + shape, generator=self._generator,
                                 device=self.device) if self._stochastic else None)
        if mesh is None:
            return self.task.sample(x_T, waveform=wav, noise=noise)[0]
        st = mesh.stripe
        part = self.task.sample(st(x_T), waveform=st(wav),
                                noise=None if noise is None
                                else noise[:, mesh.data_index::mesh.data])[0]
        return mesh.gather_stripes(part, self.max_batch)

    def _broadcast_header(self, rows: int, stop: bool) -> Tuple[int, bool]:
        """Rank 0's (rows, stop) on every rank of the mesh."""
        hdr = torch.tensor([rows, int(stop)], dtype=torch.int64, device=self.device)
        dist.broadcast(hdr, src=0)
        rows, stop = hdr.tolist()
        return rows, bool(stop)

    def follow(self) -> None:
        """A rank other than 0 of a mesh: take part in every batch rank 0
        issues, until it broadcasts stop."""
        if self.leads:
            raise RuntimeError("rank 0 leads the service; `follow` is for the other ranks")
        with self._device_stream():
            while True:
                _, stop = self._broadcast_header(0, False)
                if stop:
                    break
                wav = torch.empty((self.max_batch, self.seq_len), device=self.device)
                dist.broadcast(wav, src=0)
                self._run(wav)
                self._wait_device()
                with self._stats_lock:
                    self.stats["batches"] += 1

    # ---------------------------------------------------------------- warmup

    def warmup(self, timeout: Optional[float] = 1800.0):
        """Run one batch before taking traffic (on a card: the kernels' build
        and first launches), with its own generous timeout. The warm-up
        request is left out of the service's counters."""
        self.transcribe(np.zeros(self.seq_len, np.float32), timeout=timeout)
        with self._stats_lock:
            self.stats.clear()  # timing sums included
            self.stats.update(requests=0, windows=0, batches=0, audio_seconds=0.0)

    # ---------------------------------------------------------------- public

    def transcribe(self, audio: np.ndarray, sample_rate: Optional[int] = None,
                   timeout: Optional[float] = 300.0) -> np.ndarray:
        """Waveform of any length -> (n_frames, 88) roll. Thread-safe;
        concurrent calls share sampler batches."""
        from ..tasks.transcribe import split_windows, stitch_rolls

        audio = np.asarray(audio, np.float32)
        if sample_rate is not None and sample_rate != self.sample_rate:
            from .. import native

            audio = native.resample(audio, sample_rate, self.sample_rate)
        total_frames = max(1, math.ceil(len(audio) / self.hop))
        windows = split_windows(audio, self.seq_len, self.hop, self.overlap_frames)
        req = _Request(n_windows=len(windows), total_frames=total_frames,
                       overlap_frames=self.overlap_frames, rolls=[None] * len(windows))
        for i, wav in enumerate(windows):
            try:
                self._queue.put_nowait(_WindowJob(wav=wav, request=req, index=i,
                                                  t_enqueue=time.monotonic()))
            except queue.Full:
                req.abandoned = True  # the dispatcher drops the part already queued
                raise ServiceOverloaded(f"window queue full ({self._queue.maxsize} in "
                                        "flight); retry later") from None
        if not req.done.wait(timeout):
            req.abandoned = True  # stop the dispatcher working a dead request
            raise TimeoutError("transcription timed out")
        if req.error is not None:
            raise req.error
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["audio_seconds"] += len(audio) / self.sample_rate
        return stitch_rolls(np.stack(req.rolls), self.overlap_frames, total_frames)

    def notes(self, roll: np.ndarray, threshold: Optional[float] = None):
        """Binarised roll -> [{pitch, onset, offset}] note events (seconds)."""
        from ..eval.notes import extract_notes

        thr = self.frame_threshold if threshold is None else threshold
        pitches, intervals = extract_notes(roll, roll, thr, thr)
        scale = self.hop / self.sample_rate
        return [{"pitch": int(p) + 21, "onset": round(float(i0) * scale, 4),
                 "offset": round(float(i1) * scale, 4)}
                for p, (i0, i1) in zip(pitches, intervals)]

    def close(self):
        """Stop the threads; over a mesh rank 0's dispatcher first tells the
        other ranks to stop."""
        self._stop.set()
        if self.leads:
            self._worker.join(timeout=60 if self.mesh is not None else 5)
            self._completer.join(timeout=5)

    # ------------------------------------------------------------ dispatcher

    def _dispatch_loop(self):
        try:
            self._dispatch()
        finally:
            if self.mesh is not None:
                # from the thread that issues every batch's collectives
                with self._device_stream():
                    self._broadcast_header(0, stop=True)

    def _dispatch(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first.request.dead:
                continue
            jobs = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(jobs) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    job = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if not job.request.dead:
                    jobs.append(job)
            # again: a caller may have timed out while the batch filled
            jobs = [j for j in jobs if not j.request.dead]
            if not jobs:
                continue
            try:
                self._issue_batch(jobs)
            except Exception as e:  # noqa: BLE001 - the thread must live; every waiter gets it
                for job in jobs:
                    job.request.error = e
                    job.request.done.set()

    def _device_stream(self):
        return torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()

    def _wait_device(self):
        if self._cuda:
            self._stream.synchronize()

    def _issue_batch(self, jobs: List[_WindowJob]):
        """Assemble and issue one batch; the completion thread finishes it.

        This thread is the only one that launches the sampler: the C entry
        keeps a per-template static of the head kernel's shared-memory
        setting (`run_process` in csrc/sampler.cu) and captures its step
        graph in thread-local mode, neither of which is safe from two
        issuing threads. `fused_sample` returns once its launches are
        queued, so the card computes batch k while this thread assembles and
        copies batch k+1.
        """
        t0 = time.monotonic()
        queue_wait = sum(t0 - j.t_enqueue for j in jobs) / len(jobs)
        wav = np.zeros((self.max_batch, self.seq_len), np.float32)
        for i, job in enumerate(jobs):
            wav[i] = job.wav
        if self.transfer_dtype == "int16":
            wav = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
        host = torch.from_numpy(wav)
        if self._cuda:
            host = host.pin_memory()  # the copy then runs behind the stream's work
        t1 = time.monotonic()
        timing = {"queue_wait_s": queue_wait, "assemble_s": t1 - t0}
        done = None
        with self._device_stream():
            if self.detailed_timing:
                # the stages one after another, so that each is attributable
                wav_dev = host.to(self.device, non_blocking=True)
                self._wait_device()
                t2 = time.monotonic()
                timing["h2d_s"] = t2 - t1
                rolls_dev = self._run(self._share(wav_dev, len(jobs)))
                self._wait_device()
                timing["compute_s"] = time.monotonic() - t2
            else:
                rolls_dev = self._run(self._share(host.to(self.device, non_blocking=True),
                                                  len(jobs)))
            if self._cuda:
                done = torch.cuda.Event()
                done.record(self._stream)
        timing["t_issue"] = t1
        # blocks while pipeline_depth batches are in flight: that is the depth
        self._completions.put((jobs, rolls_dev, done, timing))

    def _completion_loop(self):
        while not self._stop.is_set():
            try:
                jobs, rolls_dev, done, timing = self._completions.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                t0 = time.monotonic()
                if done is not None:
                    done.synchronize()  # the batch's kernels have finished
                rolls = rolls_dev.cpu().numpy()
                t1 = time.monotonic()
                with self._stats_lock:
                    s = self.stats
                    s["windows"] += len(jobs)
                    s["batches"] += 1
                    s["sum_queue_wait_s"] = s.get("sum_queue_wait_s", 0.0) + timing["queue_wait_s"]
                    s["sum_assemble_s"] = s.get("sum_assemble_s", 0.0) + timing["assemble_s"]
                    if self.detailed_timing:
                        s["sum_h2d_s"] = s.get("sum_h2d_s", 0.0) + timing["h2d_s"]
                        s["sum_compute_s"] = s.get("sum_compute_s", 0.0) + timing["compute_s"]
                        s["sum_d2h_s"] = s.get("sum_d2h_s", 0.0) + (t1 - t0)
                    else:
                        # issue -> ready: compute and transfers, overlapped
                        s["sum_batch_wall_s"] = (s.get("sum_batch_wall_s", 0.0)
                                                 + (t1 - timing["t_issue"]))
            except Exception as e:  # noqa: BLE001 - the thread must live; every waiter gets it
                for job in jobs:
                    job.request.error = e
                    job.request.done.set()
                continue
            for i, job in enumerate(jobs):
                job.request.deliver(job.index, rolls[i])


# ------------------------------------------------------------------ HTTP

def _make_handler(service: TranscriptionService, info: dict):
    """The request handler class: GET /healthz, POST /transcribe."""
    import tempfile
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    from ..io.midi import write_midi
    from ..io.wav import read_wav_bytes

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code, body: bytes, ctype="application/json", headers=()):
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, e, headers=()):
            self._send(code, json.dumps({"error": str(e)}).encode(), headers=headers)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                with service._stats_lock:
                    stats = dict(service.stats)
                self._send(200, json.dumps({"status": "ok", "stats": stats, **info}).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/transcribe":
                self._send(404, b'{"error": "not found"}')
                return
            q = parse_qs(url.query)
            length = int(self.headers.get("Content-Length", 0))
            if length > service.max_body_bytes:
                self._error(413, f"body exceeds {service.max_body_bytes} bytes")
                return
            body = self.rfile.read(length)
            # client-side faults (undecodable audio, bad query) -> 400
            try:
                thr = float(q.get("threshold", [service.frame_threshold])[0])
                audio, sr = read_wav_bytes(body, mono=True)
            except Exception as e:  # noqa: BLE001 - any decode failure is the client's
                self._error(400, e)
                return
            # server-side faults (sampler, queue timeout) -> 5xx, so retry
            # policies and monitoring classify them right
            try:
                t0 = time.monotonic()
                roll = service.transcribe(audio, sample_rate=sr)
                notes = service.notes(roll, thr)
                if q.get("midi", ["0"])[0] in ("1", "true"):
                    with tempfile.NamedTemporaryFile(suffix=".mid") as tmp:
                        write_midi(tmp.name, [n["pitch"] for n in notes],
                                   [(n["onset"], n["offset"]) for n in notes])
                        tmp.seek(0)
                        self._send(200, tmp.read(), ctype="audio/midi")
                    return
                payload = {"frames": int(roll.shape[0]),
                           "audio_seconds": round(len(audio) / sr, 3),
                           "latency_s": round(time.monotonic() - t0, 4), "notes": notes}
                self._send(200, json.dumps(payload).encode())
            except ServiceOverloaded as e:
                self._error(503, e, headers=[("Retry-After", "1")])
            except TimeoutError as e:
                self._error(504, e)
            except Exception as e:  # noqa: BLE001 - must not kill the server
                self._error(500, e)

    return Handler


def serve_forever(service: TranscriptionService, host: str = "127.0.0.1", port: int = 8077,
                  info: Optional[dict] = None, ready: Optional[threading.Event] = None):
    """Blocking HTTP loop. With `ready`, the server is attached as
    `ready.server` before `ready.set()`, so a caller running this in a
    thread can `ready.wait()` and later call `ready.server.shutdown()`
    (this function returns after the shutdown)."""
    from http.server import ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        # a burst of clients is what micro-batching is for: a listen backlog
        # of the default 5 would refuse most of one
        request_queue_size = 128

    server = Server((host, port), _make_handler(service, info or {}))
    if ready is not None:
        ready.server = server  # type: ignore[attr-defined]
        ready.set()
    try:
        server.serve_forever()
    finally:
        server.server_close()
