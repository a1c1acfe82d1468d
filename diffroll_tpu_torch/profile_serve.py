"""Whether the transcription service keeps the card busy through a burst.

    python -m diffroll_tpu_torch.profile_serve [--requests 32] [--out outputs/profile]

Builds the full-width ClassifierFreeDiffRoll from a seeded init (zero-init
head given N(0, 0.1^2) weights) and serves it with the ServeConfig defaults
(max_batch 8, max_wait_ms 25, int16 transfer, pipeline depth 2) in two
variants:

  cached    the service as it is: the task's prepared operands (stacked
            weights, sampler tables, FiLM biases) stay on the device
  per_call  the same service, but the operands are rebuilt before every
            batch, so each batch makes the blocking host-to-device copies
            of the tables again; such a copy waits for the stream, so the
            issue thread cannot queue a batch before the one ahead finishes

The variants run in the order cached, per_call, per_call, cached. Each
service is warmed up, then takes a burst of --requests concurrent 20 s
requests (one window each) through `transcribe`, without the HTTP front,
timed on the host (windows per second), then the same burst again under
torch.profiler: the device's idle share over the traced burst's span
(first device op to last) and its longest gaps. Prints one JSON line per
service; writes the chrome traces under --out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import threading
import time

import numpy as np
import torch

from .profile_sampler import device_ops, device_timeline


def chord_audio(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A few seeded sine chords, one per second."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = np.zeros_like(t)
    for k in range(int(seconds)):
        seg = (t >= k) & (t < k + 0.9)
        for midi in rng.integers(40, 80, size=3):
            out[seg] += 0.1 * np.sin(2 * np.pi * 440.0 * 2 ** ((midi - 69) / 12) * t[seg])
    return out.astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--out", default="outputs/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")

    # the device's activity only: the service's threads run unprofiled
    from torch.profiler import ProfilerActivity, profile

    from .config import ServeConfig
    from .models import build
    from .serve import TranscriptionService
    from .tasks.diffusion import DiffusionTask, TaskConfig

    class PerCall(TranscriptionService):
        """Rebuilds the task's prepared operands before every batch."""

        def _run(self, wav):
            self.task._fused = None
            return super()._run(wav)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = build("ClassifierFreeDiffRoll")
    torch.nn.init.normal_(model.net.output_projection.weight, std=0.1)
    model = model.to(dev).eval()
    mc = model.config
    sr = mc.mel.sample_rate
    audio = [chord_audio(20.0, sr, 10 + i) for i in range(8)]
    sv = ServeConfig()
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()  # the profiler's one-time start-up stays out of the readings

    def burst(svc):
        threads = [threading.Thread(target=svc.transcribe, args=(audio[i % len(audio)],))
                   for i in range(args.requests)]
        before = dict(svc.stats)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        seconds = time.perf_counter() - t0
        return seconds, svc.stats["batches"] - before["batches"]

    for run, variant in enumerate(("cached", "per_call", "per_call", "cached")):
        task = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps, w=0.5))
        cls = PerCall if variant == "per_call" else TranscriptionService
        svc = cls(task, max_batch=sv.max_batch, max_wait_ms=sv.max_wait_ms,
                  overlap_frames=sv.overlap_frames, transfer_dtype=sv.transfer,
                  pipeline_depth=sv.pipeline_depth)
        try:
            svc.warmup()
            seconds, batches = burst(svc)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced_s, traced_batches = burst(svc)
                torch.cuda.synchronize()
        finally:
            svc.close()
        trace = out_dir / f"serve_{run}_{variant}.json"
        prof.export_chrome_trace(str(trace))
        span_ms, busy_ms = device_timeline(trace)
        _, gaps = device_ops(trace)
        print(json.dumps({
            "card": card, "variant": variant, "run": run, "requests": args.requests,
            "max_wait_ms": sv.max_wait_ms, "transfer": sv.transfer,
            "pipeline_depth": sv.pipeline_depth,
            "seconds": seconds, "batches": batches, "windows_per_second": args.requests / seconds,
            "traced_seconds": traced_s, "traced_batches": traced_batches,
            "device_span_ms": span_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / span_ms, "longest_gaps": gaps,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
