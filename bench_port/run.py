"""Run one cell of the benchmark of `diffroll_tpu_torch` once.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Everything a cell is made of is found by name: the cell in BENCHMARK.json;
its configuration in `bench_port/configs/<config>.json`; its traffic mix in
`bench_port/traffic/<traffic>.json`, whose `runner` names the module under
`bench_port/runners/` that runs it; the limits of its check in
`bench_port/cells/<workload>.json`; each metric's reader in
`bench_port/metrics/<metric>.py`.

A run: set-up (the model and weights from the seed, the mix's inputs, every
shape warmed up), the timed window of `--seconds`, the peak memory read, the
program's state freed, then the check against the plain reference. With
`--trace 1` a bounded stretch of the window is profiled and the cell's
per-layer metrics are reported instead of its end-to-end ones.

The last lines of standard error give each number the check compared beside
its limit; the last line of standard output is the result as one JSON
object. A run with no card, or too few, or with JAX or the JAX package
loaded once the window has closed, prints no result and exits with 1.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
from typing import List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffroll_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's own record."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def cache_bytecode() -> None:
    """Keep the bytecode of every module the process imports from here on,
    PyTorch's included, in one fixed directory inside the checkout, so that
    only a checkout's first run compiles it from source (where the machine
    keeps no bytecode beside the sources, every run would)."""
    sys.pycache_prefix = str(HERE / "_cache" / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, the part before the first dot, is
    JAX's or the JAX package's, compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def finite(obj):
    """`obj` with every infinite or NaN number written as a string, so that
    the result line stays strict JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """One run of one cell: what its parts read and what they record."""

    def __init__(self, spec: dict, workload: str, seed: int, device,
                 cfg: Optional[dict] = None, mix: Optional[dict] = None):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r}; choices: {sorted(cells)}")
        self.spec, self.cell, self.seed, self.device = spec, cells[workload], seed, device
        self.cfg = cfg or load_json(HERE / "configs" / f"{self.cell['config']}.json")
        self.mix = mix or load_json(HERE / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = load_json(HERE / "cells" / f"{workload}.json")["limits"]
        self.setup_s: Optional[float] = None
        self.check_s: Optional[float] = None
        self.records: dict = {}
        self.marks: dict = {}

    def mark(self, phase: str) -> None:
        """The process's age when a phase of set-up ended (printed on stderr)."""
        self.marks[phase] = round(process_age_s(), 2)

    def runner(self):
        return importlib.import_module(f"bench_port.runners.{self.mix['runner']}").Runner(self)

    def metrics(self, traced: bool) -> List[dict]:
        """This cell's end-to-end metrics, or with `traced` its per-layer ones."""
        name = self.cell["name"]
        e2e = [m for m in self.spec["end_to_end"] if name in m.get("workloads", [name])]
        if not traced:
            return e2e
        return [m for m in self.spec["per_layer"] if name in m["workloads"]]

    def read(self, metric: dict) -> Optional[float]:
        path = HERE / "metrics" / f"{metric['name']}.py"
        return load_module(path, f"bench_port.metrics.{metric['name']}").read(self)


def execute(run: Run, seconds: float, traced: bool, control: bool = False) -> dict:
    """Set-up, the window, the check: the result's fields, the numbers
    compared under `checks` ({name: {"value", "limit"}}), and what the check
    read besides under `readings` (with `control`, the control's and the
    planted faults' readings as `control.<name>`, `control_bf16.<name>`,
    `half_batch.<name>`)."""
    import torch

    cuda = run.device.type == "cuda"
    run.mark("imports")
    if cuda:
        torch.zeros(1, device=run.device)
        torch.cuda.synchronize()
        run.mark("cuda")
    runner = run.runner()
    runner.setup()
    if cuda:
        torch.cuda.synchronize()
    run.setup_s = process_age_s()
    run.records = runner.window(seconds, traced)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    for m in run.metrics(traced):
        value = run.read(m)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    runner.free()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = runner.check(run.records, control=control)
    run.check_s = time.perf_counter() - t_check
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in run.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": run.records["attempted"],
           "failed": run.records["failed"], "metrics": metrics,
           "device": device_info(run.device, peak, run.records.get("trace"))}
    if traced and "trace" in run.records:
        out["breakdown"] = run.records["trace"].breakdown()
    out["readings"] = {k: v for k, v in readings.items() if k not in checks}
    out["checks"] = checks
    return out


def device_info(device, peak: int, trace=None) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}
    if trace is not None:
        info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return info


def card_line() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_bytecode()
    spec = load_json(ROOT / "BENCHMARK.json")
    import torch

    cells = {w["name"]: w for w in spec["workloads"]}
    chips = cells.get(args.workload, {}).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    run = Run(spec, args.workload, args.seed, torch.device("cuda"))
    result = execute(run, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"bench_port: JAX or the JAX package is loaded: {loaded}", file=sys.stderr)
        return 1
    from diffroll_tpu_torch.ops import _build

    print(f"bench_port: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    print(f"bench_port: setup_s {run.setup_s:.3f} (nvcc {_build.build_seconds} s); "
          f"check {run.check_s:.1f} s; set-up {json.dumps(run.marks)}; window "
          + json.dumps({k: v for k, v in run.records.items()
                        if isinstance(v, (int, float))}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
