"""Where a training step's, or a distillation step's, time goes on the card.

    python -m diffroll_tpu_torch.profile_train [--batch 16] [--routes cuda modules]
    python -m diffroll_tpu_torch.profile_train --distill [--batch 16]

Builds the full-width ClassifierFreeDiffRoll from a seeded init (zero-init
head given N(0, 0.1^2) weights) and a seeded batch, then times a whole step
(loss, backward, Adam) with CUDA events (median of 5 after 2 warm-ups) and
traces one more under torch.profiler. Training routes:

  cuda     `task.fused_train=true`: the forward-with-saves and backward
           kernels (K3 + K4)
  modules  autograd through the nn.Modules (f32, TF32 off)

`--distill` times one progressive-distillation step instead (the `distill`
entry's step, train/distill.py), with the model as its own frozen teacher:
a guided stage (9 student steps, w=0.5: the teacher's forward over 2B rows,
K1 twice a step) and an unguided one (5 student steps: K1 over B rows), the
student through K3 + K4 (`task.fused_train=true`).

Prints one JSON line per route or stage: wall and device time, the device's
idle share (the gaps between device ops in the traced step's own timeline),
the longest gaps, and device time per kernel as the trace names them; writes
the chrome traces under --out (default outputs/profile). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import statistics
import subprocess
import time

import torch

from .profile_sampler import device_ops, device_timeline

ROUTES = ("cuda", "modules")
# (stage, student steps, guided): the `distill` entry's first two stages from
# distill.start_steps=9, as chip_smoke.py runs them
DISTILL_STAGES = (("guided", 9, True), ("unguided", 5, False))


def measure(run, trace: pathlib.Path) -> dict:
    """CUDA-event times of `run()` (median of 5 after 2 warm-ups), then one
    more traced: its idle share, longest gaps and device time per kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(str(trace))
    span_ms, busy_ms = device_timeline(trace)
    per_kernel, gaps = device_ops(trace)
    ranked = list(per_kernel.items())
    return {
        "event_ms_median": statistics.median(times), "event_ms": times,
        "profiled_wall_ms": wall_ms,
        # the traced step's own timeline: first device op's start to the
        # last one's end, and the share of it with no op running
        "device_span_ms": span_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / span_ms,
        "device_ops": sum(v["calls"] for v in per_kernel.values()),
        "largest_gaps": gaps,
        "per_kernel": dict(ranked[:24]),
        "other_ms": sum(v["ms"] for _, v in ranked[24:]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--routes", nargs="+", default=list(ROUTES), choices=ROUTES)
    ap.add_argument("--distill", action="store_true",
                    help="time a distillation step (guided and unguided teacher)")
    ap.add_argument("--out", default="outputs/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from .diffusion.distill import distill_grids
    from .models import build
    from .tasks.diffusion import DiffusionTask, TaskConfig
    from .train import TrainState, make_train_step
    from .train.distill import make_distill_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = build("ClassifierFreeDiffRoll")
    torch.nn.init.normal_(model.net.output_projection.weight, std=0.1)
    model = model.to(dev).train()
    mc = model.config
    b = args.batch
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"frame": (torch.rand(b, mc.frames, mc.pitches, device=dev, generator=gen)
                       > 0.95).float(),
             "audio": 0.1 * torch.randn(b, mc.frames * mc.mel.hop_length, device=dev,
                                        generator=gen)}
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()  # the profiler's one-time start-up stays out of the readings

    if args.distill:
        teacher = model.eval().requires_grad_(False)
        for stage, n, guided in DISTILL_STAGES:
            student = copy.deepcopy(teacher).requires_grad_(True)
            task = DiffusionTask(student, TaskConfig(timesteps=mc.timesteps, fused_train=True))
            loss_fn = make_distill_loss(task, teacher, *distill_grids(mc.timesteps, n),
                                        guided=guided, w=0.5)
            state = TrainState.create(student, 1e-6)
            step = make_train_step(loss_fn)
            reading = measure(lambda: step(state, batch, gen),
                              out_dir / f"distill_{stage}_b{b}.json")
            print(json.dumps({"card": card, "distill": stage, "student_steps": n,
                              "teacher_rows": (2 if guided else 1) * b, "batch": b,
                              **reading}), flush=True)
            del state, task, student
        return 0

    for route in args.routes:
        task = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps,
                                               fused_train=route != "modules"))
        impl = None if route == "modules" else route
        state = TrainState.create(model, 1e-6)
        step = make_train_step(
            lambda bt, g, train, task=task, impl=impl: task.loss_fn(bt, g, train, impl=impl))
        reading = measure(lambda: step(state, batch, gen), out_dir / f"train_{route}_b{b}.json")
        print(json.dumps({"card": card, "route": route, "batch": b, **reading}), flush=True)
        del state, task
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
