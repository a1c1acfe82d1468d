"""Shared pieces of the benchmark's own tests: the cells at a tiny width on
the CPU, and the `card` fixture of the tests that need one."""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from bench_port import run as bench

HERE = pathlib.Path(__file__).resolve().parents[1]


def spec() -> dict:
    return bench.load_json(bench.ROOT / "BENCHMARK.json")


def tiny_config(name: str) -> dict:
    """A configuration at a tiny width: 16 channels, 3 layers, 64 frames, a few
    reverse steps; every other key as the file states it."""
    cfg = bench.load_json(HERE / "configs" / f"{name}.json")
    cfg.update(residual_channels=16, residual_layers=3, frames=64,
               timesteps=4 if cfg["sampling_type"].startswith("cfdg_") else 5)
    return cfg


def tiny_mix(name: str) -> dict:
    """A traffic mix cut to the tiny configurations."""
    mix = bench.load_json(HERE / "traffic" / f"{name}.json")
    if mix["runner"] == "transcribe":
        mix.update(recordings={"seconds_min": 3.0, "seconds_max": 9.0, "count": 3},
                   batch_size=2, overlap_frames=8, check_windows=6, trace_seconds=0.2)
    else:
        mix.update(batch=4, pool=5, trace_after=1, trace_steps=2)
    return mix


def tiny_run(workload: str, seed: int = 1234567890123) -> bench.Run:
    """One run of `workload` on the CPU at a tiny width, with the cell's own
    limits."""
    sp = spec()
    cell = {w["name"]: w for w in sp["workloads"]}[workload]
    return bench.Run(sp, workload, seed, torch.device("cpu"),
                     cfg=tiny_config(cell["config"]), mix=tiny_mix(cell["traffic"]))


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def dump(obj) -> str:
    return json.dumps(obj, default=str)
