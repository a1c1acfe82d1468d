"""The transcription service: a model-resident worker, a micro-batching
dispatcher and an HTTP front (counterpart of `diffroll_tpu/serve/service.py`;
the package docstring has the design)."""

from __future__ import annotations

import base64
import contextlib
import itertools
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
from ..utils.profiling import span


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
    # each window's (batch ordinal, row): where its draws came from
    placement: List[Optional[Tuple[int, int]]] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    # set when the caller gave up (timeout) or enqueuing failed midway: the
    # dispatcher drops the request's still-queued windows, so an overloaded
    # backlog drains instead of spending the card on work nobody waits for
    abandoned: bool = False

    @property
    def dead(self) -> bool:
        return self.abandoned or self.done.is_set()

    def deliver(self, index: int, roll: np.ndarray, placement: Tuple[int, int]):
        self.rolls[index] = roll
        self.placement[index] = placement
        if all(r is not None for r in self.rolls):
            self.done.set()


# the stages timed into `stats` as `sum_<name>`, beside `sum_deliver_s` and
# `sum_batch_wall_s`
STAGE_SUMS = ("queue_wait_s", "gather_s", "assemble_s", "copy_in_s", "issue_s", "wait_s",
              "copy_out_s", "compute_s")


class ServiceOverloaded(RuntimeError):
    """Raised when the window queue is full: callers should back off (the
    HTTP front answers 503)."""


class TranscriptionService:
    """Window-level micro-batching around one sampler batch shape.

    The model's weights stay on its device (`task.model`). Every batch is
    `max_batch` windows, short batches zero-padded, so the card always runs
    the same shapes. On a CUDA model the reverse process is the
    whole-process sampler (K2).

    Every batch drawn for gets an ordinal, the warm-up's batch 0: its x_T
    and per-step noise are the service generator's draws for that batch, in
    order, at `max_batch` rows. Each window delivered records its (ordinal,
    row), so its draws can be replayed from the seed
    (`transcribe_with_placement`). `stats` sums each stage's host time
    (`sum_<stage>_s`: gather, assemble, copy_in, issue, wait, copy_out,
    deliver, as the `serve.*` spans of utils/profiling.py bound them), the
    device time of `_run` (`sum_compute_s`: CUDA events on the service's
    stream; the host clock on the CPU) and the zero rows batches were padded
    with (`padded_rows`).

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
    (`DiffusionTask.sampler_operands`), or column-parallel on the modules.
    """

    def __init__(self, task, *, max_batch: int = 8, max_wait_ms: float = 25.0,
                 overlap_frames: int = 32, frame_threshold: float = 0.5, seed: int = 0,
                 max_body_mb: float = 64.0, max_queued_windows: int = 256,
                 transfer_dtype: str = "float32", pipeline_depth: int = 2, mesh=None):
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
        # batch k+1 while the card computes batch k
        self.pipeline_depth = max(int(pipeline_depth), 1)
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
        self._drawn = 0   # batches drawn for: the next batch's ordinal
        self._request_ids = itertools.count()
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

    def _run(self, wav: torch.Tensor) -> Tuple[int, torch.Tensor]:
        """The batch's reverse process: (max_batch, seq_len) waveforms on the
        device (f32, or int16 PCM) -> the batch's ordinal and (max_batch,
        frames, 88) rolls there; over a mesh, this rank's data stripe, the
        rolls gathered (every rank draws the same batches in the same order,
        so the ordinal is the same on every rank)."""
        if wav.dtype == torch.int16:
            wav = wav.float() * (1.0 / 32768.0)
        mesh = self.mesh
        shape = (self.max_batch, self.frames, self.pitches)
        with self._generator_lock:
            ordinal = self._drawn
            self._drawn += 1
            x_T = torch.randn(shape, generator=self._generator, device=self.device)
            noise = (torch.randn((self._steps,) + shape, generator=self._generator,
                                 device=self.device) if self._stochastic else None)
        if mesh is None:
            return ordinal, self.task.sample(x_T, waveform=wav, noise=noise)[0]
        st = mesh.stripe
        part = self.task.sample(st(x_T), waveform=st(wav),
                                noise=None if noise is None
                                else noise[:, mesh.data_index::mesh.data])[0]
        return ordinal, mesh.gather_stripes(part, self.max_batch)

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
        return self.transcribe_with_placement(audio, sample_rate, timeout)[0]

    def transcribe_with_placement(
            self, audio: np.ndarray, sample_rate: Optional[int] = None,
            timeout: Optional[float] = 300.0) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
        """`transcribe`'s roll, and each window's (batch ordinal, row) in
        window order."""
        with span("serve.request", f"request={next(self._request_ids)}"):
            return self._transcribe(audio, sample_rate, timeout)

    def _transcribe(self, audio, sample_rate, timeout):
        from ..tasks.transcribe import split_windows, stitch_rolls

        audio = np.asarray(audio, np.float32)
        if sample_rate is not None and sample_rate != self.sample_rate:
            from .. import native

            audio = native.resample(audio, sample_rate, self.sample_rate)
        total_frames = max(1, math.ceil(len(audio) / self.hop))
        windows = split_windows(audio, self.seq_len, self.hop, self.overlap_frames)
        req = _Request(n_windows=len(windows), total_frames=total_frames,
                       overlap_frames=self.overlap_frames, rolls=[None] * len(windows),
                       placement=[None] * len(windows))
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
        roll = stitch_rolls(np.stack(req.rolls), self.overlap_frames, total_frames)
        return roll, list(req.placement)

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
            t0 = time.monotonic()
            deadline = t0 + self.max_wait_s
            with span("serve.gather", f"batch={self._drawn}"):
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
            gather_s = time.monotonic() - t0
            # again: a caller may have timed out while the batch filled
            jobs = [j for j in jobs if not j.request.dead]
            if not jobs:
                continue
            try:
                self._issue_batch(jobs, gather_s)
            except Exception as e:  # noqa: BLE001 - the thread must live; every waiter gets it
                for job in jobs:
                    job.request.error = e
                    job.request.done.set()

    def _device_stream(self):
        return torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()

    def _wait_device(self):
        if self._cuda:
            self._stream.synchronize()

    def _issue_batch(self, jobs: List[_WindowJob], gather_s: float):
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
        args = f"batch={self._drawn}"   # the ordinal the batch draws as
        with span("serve.assemble", args):
            wav = np.zeros((self.max_batch, self.seq_len), np.float32)
            for i, job in enumerate(jobs):
                wav[i] = job.wav
            if self.transfer_dtype == "int16":
                wav = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
            host = torch.from_numpy(wav)
            if self._cuda:
                host = host.pin_memory()  # the copy then runs behind the stream's work
        t1 = time.monotonic()
        start = end = None
        with self._device_stream():
            with span("serve.copy_in", args):
                wav_dev = self._share(host.to(self.device, non_blocking=True), len(jobs))
            t2 = time.monotonic()
            with span("serve.issue", args):
                if self._cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(self._stream)
                ordinal, rolls_dev = self._run(wav_dev)
                if self._cuda:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record(self._stream)
            t3 = time.monotonic()
        timing = {"queue_wait_s": queue_wait, "gather_s": gather_s, "assemble_s": t1 - t0,
                  "copy_in_s": t2 - t1, "issue_s": t3 - t2, "t_issue": t1,
                  # on the CPU `_run` computes as it is called
                  "compute_s": None if self._cuda else t3 - t2}
        # blocks while pipeline_depth batches are in flight: that is the depth
        self._completions.put((jobs, ordinal, rolls_dev, start, end, timing))

    def _completion_loop(self):
        while not self._stop.is_set():
            try:
                jobs, ordinal, rolls_dev, start, end, timing = self._completions.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = f"batch={ordinal}"
            try:
                t0 = time.monotonic()
                with span("serve.wait", batch):
                    if end is not None:
                        end.synchronize()  # the batch's kernels have finished
                t1 = time.monotonic()
                with span("serve.copy_out", batch):
                    rolls = rolls_dev.cpu().numpy()
                t2 = time.monotonic()
                timing.update(wait_s=t1 - t0, copy_out_s=t2 - t1)
                if end is not None:
                    timing["compute_s"] = start.elapsed_time(end) / 1e3
                with self._stats_lock:
                    s = self.stats
                    s["windows"] += len(jobs)
                    s["batches"] += 1
                    s["padded_rows"] = s.get("padded_rows", 0) + self.max_batch - len(jobs)
                    for k in STAGE_SUMS:
                        s[f"sum_{k}"] = s.get(f"sum_{k}", 0.0) + timing[k]
                    # issue -> ready: compute and transfers, overlapped
                    s["sum_batch_wall_s"] = (s.get("sum_batch_wall_s", 0.0)
                                             + (t2 - timing["t_issue"]))
            except Exception as e:  # noqa: BLE001 - the thread must live; every waiter gets it
                for job in jobs:
                    job.request.error = e
                    job.request.done.set()
                continue
            with span("serve.deliver", batch):
                for i, job in enumerate(jobs):
                    job.request.deliver(job.index, rolls[i], (ordinal, i))
            deliver_s = time.monotonic() - t2
            with self._stats_lock:
                self.stats["sum_deliver_s"] = self.stats.get("sum_deliver_s", 0.0) + deliver_s


# ------------------------------------------------------------------ HTTP

def encode_roll(roll: np.ndarray) -> dict:
    """A roll as JSON, bit for bit: its dtype, its shape and base64 of its
    little-endian bytes (`decode_roll` reverses it)."""
    le = np.ascontiguousarray(roll, dtype=roll.dtype.newbyteorder("<"))
    return {"dtype": roll.dtype.name, "shape": list(roll.shape),
            "data": base64.b64encode(le.tobytes()).decode("ascii")}


def decode_roll(obj: dict) -> np.ndarray:
    dtype = np.dtype(obj["dtype"]).newbyteorder("<")
    return np.frombuffer(base64.b64decode(obj["data"]), dtype).reshape(obj["shape"])


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
                roll, placement = service.transcribe_with_placement(audio, sample_rate=sr)
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
                           "latency_s": round(time.monotonic() - t0, 4), "notes": notes,
                           "placement": [list(p) for p in placement]}
                if q.get("roll", ["0"])[0] in ("1", "true"):
                    payload["roll"] = encode_roll(roll)
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
