"""Where the whole-process sampler's time goes on the card.

    python -m diffroll_tpu_torch.profile_sampler [--batch 1 2] [--steps 200]

Builds the full-width ClassifierFreeDiffRoll from a seeded init (zero-init
head given N(0, 0.1^2) weights), then for each batch size times one
200-step CFG reverse process with CUDA events (median of 3 after a warm-up)
and traces one more under torch.profiler. Prints one JSON line per batch
size: wall and device time, the device's idle share (the gaps between
device ops in the traced run's own timeline), and device time per kernel;
writes the chrome traces under --out (default outputs/profile).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_timeline(trace_path) -> tuple:
    """(span_ms, busy_ms) of the device ops in a chrome trace: the span from
    the first op's start to the last op's end, and the union of the ops'
    intervals inside it."""
    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    if not spans:
        raise RuntimeError(f"{trace_path}: the trace holds no device op")
    busy, (cur_start, cur_end) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return (cur_end - spans[0][0]) / 1e3, busy / 1e3  # cur_end: the last op's end


def device_ops(trace_path, top_gaps: int = 5) -> tuple:
    """(by_name, gaps) of the device ops in a chrome trace. `by_name` maps an
    op's name (cut to 80 characters) to its summed ms and its calls, largest
    first: every kernel and copy once, whatever host-side op enclosed its
    launch. `gaps` lists the `top_gaps` longest stretches with no op running:
    their ms, their start in ms from the first op, and the op that ended them."""
    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"][:80]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    if not ops:
        raise RuntimeError(f"{trace_path}: the trace holds no device op")
    by_name, gaps, busy_until = {}, [], ops[0][0]
    for start, end, name in ops:
        entry = by_name.setdefault(name, {"ms": 0.0, "calls": 0})
        entry["ms"] += (end - start) / 1e3
        entry["calls"] += 1
        if start > busy_until:
            gaps.append({"ms": (start - busy_until) / 1e3,
                         "at_ms": (busy_until - ops[0][0]) / 1e3, "before": name})
        busy_until = max(busy_until, end)
    gaps.sort(key=lambda g: -g["ms"])
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])), gaps[:top_gaps]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default="outputs/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampler needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from .diffusion.loop import previous_timesteps, timestep_subsequence
    from .models import build
    from .ops.fused_forward import _embed, head_weights
    from .ops.gated_stack import kernel_weights, stack_weights
    from .ops.sampler_kernel import fused_sample, sampler_tables
    from .tasks.diffusion import DiffusionTask, TaskConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = build("ClassifierFreeDiffRoll", timesteps=args.steps)
    torch.nn.init.normal_(model.net.output_projection.weight, std=0.1)
    model = model.to(dev).eval()
    mc = model.config
    task = DiffusionTask(model, TaskConfig(timesteps=args.steps, w=0.5))
    w = stack_weights(model.net)
    kw = kernel_weights(w)
    head = head_weights(model.net)
    ts = timestep_subsequence(args.steps, None)
    tables = torch.from_numpy(
        sampler_tables(task.schedule, "cfdg_ddpm_x0", ts, previous_timesteps(ts))).to(dev)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()  # the profiler's one-time start-up stays out of the readings

    with torch.no_grad():
        t_emb = _embed(torch.from_numpy(ts.astype(np.int64)).to(dev), model.net.diffusion_embedding)
        t_bias = torch.einsum("ne,lec->nlc", t_emb, w.wt) + w.bt[None]
        for b in args.batch:
            x_T = torch.randn(b, mc.frames, mc.pitches, device=dev, generator=gen)
            noise = torch.randn(len(ts), b, mc.frames, mc.pitches, device=dev, generator=gen)
            cond = torch.rand(b, mc.frames, mc.n_mels, device=dev, generator=gen)

            def run():
                return fused_sample(x_T, noise, t_bias, tables, w, head, cond,
                                    mc.dilations(), True, 0.5, True, kweights=kw)

            run()
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            trace = out_dir / f"sampler_b{b}.json"
            prof.export_chrome_trace(str(trace))
            span_ms, busy_ms = device_timeline(trace)
            per_kernel = {}
            for e in prof.key_averages():
                dt = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                if dt > 0:  # kernels and copies; host-side ops have no self device time
                    per_kernel[e.key[:80]] = {"ms": dt / 1e3, "calls": e.count}
            device_ms = sum(v["ms"] for v in per_kernel.values())
            flop = 2 * 2 * b * mc.frames * (3 * mc.residual_channels + mc.residual_channels) \
                * 2 * mc.residual_channels * mc.residual_layers * len(ts)
            print(json.dumps({
                "card": card, "batch": b, "steps": len(ts),
                "event_ms_median": statistics.median(times), "event_ms": times,
                "profiled_wall_ms": wall_ms, "device_ms": device_ms,
                # the traced run's own timeline: first device op's start to the
                # last one's end, and the share of it with no op running
                "device_span_ms": span_ms, "device_busy_ms": busy_ms,
                "idle_share": 1.0 - busy_ms / span_ms,
                "stack_tflops": flop / (statistics.median(times) * 1e-3) / 1e12,
                "per_kernel": dict(sorted(per_kernel.items(),
                                          key=lambda kv: -kv[1]["ms"])),
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
