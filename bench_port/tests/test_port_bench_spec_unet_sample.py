"""SpecUnet's transcription cell: its configuration against the port's
preset, the keys its runner reads, the streams' operation counts, and its
readers on records without a trace or a counter."""

from __future__ import annotations

import pytest

from bench_port import inputs, port
from bench_port import run as bench
from bench_port.counts import spec_unet, spec_unet_sample
from bench_port.runners.transcribe import batch_sizes, window_count

from .conftest import HERE, spec

CELL = "specunet-transcribe"
METRICS = ("unet.spec_rows_per_window", "unet.spec_stream_ms_per_batch",
           "mfu.transcribe_spec_unet", "idle.transcribe", "sampler.idle_ms_per_batch")


def _read(metric: str, records: dict):
    class _Run:
        cfg = bench.load_json(HERE / "configs" / "SpecUnetGuided.json")
        mix = bench.load_json(HERE / "traffic" / "transcribe_unet.json")

    _Run.records = records
    return bench.load_module(HERE / "metrics" / f"{metric}.py", f"bench_port.metrics.{metric}").read(
        _Run)


@pytest.mark.parametrize("shape", [spec_unet.UShape(), spec_unet.UShape(dim=8, frames=32)],
                         ids=["published", "tiny"])
def test_the_streams_add_up_to_the_forward(shape):
    terms = spec_unet_sample.stream_terms(shape, 3)
    assert sum(terms.values()) == spec_unet.forward_flops(shape, 3)
    assert min(terms.values()) > 0


def test_a_window_at_the_published_widths():
    terms = spec_unet_sample.stream_terms(spec_unet.UShape())
    assert [round(terms[k] / 1e9, 1) for k in ("x", "spec", "dropped")] == [48.3, 59.2, 3.2]
    window = spec_unet_sample.window_flops(spec_unet.UShape(), 200)
    assert round(window / 1e12, 2) == 19.43
    assert 2 * 200 * spec_unet.forward_flops(spec_unet.UShape()) / window == pytest.approx(
        2.279, abs=1e-3)


def test_configuration_is_the_ports_preset_at_published_widths():
    from diffroll_tpu_torch.models import PRESETS

    cfg = bench.load_json(HERE / "configs" / "SpecUnetGuided.json")
    entry = next(c for c in spec()["configs"] if c["name"] == "SpecUnetGuided")
    assert entry["reduced"] == cfg["reduced"] == [] and entry["file"].endswith(
        "SpecUnetGuided.json")
    preset = PRESETS[cfg["preset"]]
    assert preset.variant == "spec_unet"
    for key in set(port.MODEL_KEYS) | {"convnext_mult"}:
        assert cfg[key] == getattr(preset, key), key
    assert tuple(cfg["dim_mults"]) == preset.dim_mults
    assert tuple(cfg["norm_args"]) == tuple(preset.norm_args)
    for key, value in cfg["mel"].items():
        assert getattr(preset.mel, key) == value, key
    assert all(k in cfg for k in port.TASK_KEYS)
    assert set(cfg["ignored_by_the_unet"]) <= set(port.MODEL_KEYS)
    assert (cfg["sampling_type"], cfg["w"], cfg["timesteps"], cfg["frame_threshold"]) == (
        "cfdg_ddpm_x0", 0.5, 200, 0.5)
    assert (cfg["residual_channels"], cfg["dim_mults"], cfg["heads"], cfg["dim_head"],
            cfg["n_mels"], cfg["frames"], cfg["pitches"]) == (28, [1, 2, 4], 4, 32, 229, 640, 88)
    assert cfg["precision"] == bench.load_json(HERE / "configs" / "SpecUnet.json")["precision"]


def test_configuration_is_a_deployment_of_its_own():
    """The transcription recipe is the source, the model's yaml kept beside it:
    no other configuration has this source with these reduced keys."""
    configs = spec()["configs"]
    entry = next(c for c in configs if c["name"] == "SpecUnetGuided")
    cfg = bench.load_json(HERE / "configs" / "SpecUnetGuided.json")
    assert entry["source"] == cfg["source"] and entry["source"].endswith("/config/test.yaml")
    assert cfg["model_source"] == next(c for c in configs if c["name"] == "SpecUnet")["source"]
    others = [(c["source"], sorted(c["reduced"])) for c in configs if c is not entry]
    assert (entry["source"], sorted(entry["reduced"])) not in others


def test_the_cell_and_its_traffic():
    s = spec()
    cell = next(w for w in s["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "SpecUnetGuided", "transcribe_unet", 1)
    mix = bench.load_json(HERE / "traffic" / "transcribe_unet.json")
    assert (mix["runner"], mix["recordings"]["count"], mix["batch_size"],
            mix["overlap_frames"], mix["check_windows"]) == ("transcribe_unet", 16, 8, 32, 12)
    # cfdr-transcribe's recordings: a cycle, the window's least, is 164
    # windows in 14 full batches and 13 short ones of every size from 2 to 7
    assert mix["recordings"] == bench.load_json(HERE / "traffic" / "transcribe_long.json")[
        "recordings"]
    seq, stride = 640 * 512, (640 - 32) * 512
    sizes = [b for sec in inputs.recording_seconds(mix)
             for b in batch_sizes(window_count(int(sec * 16000), seq, stride),
                                  mix["batch_size"])]
    assert (sum(sizes), sizes.count(8), set(sizes)) == (164, 14, set(range(2, 9)))
    limits = bench.load_json(HERE / "cells" / f"{CELL}.json")["limits"]
    assert set(limits) == {"roll_rms", "notes_differ"} and limits["notes_differ"] == 0
    e2e = {m["name"] for m in s["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert e2e == {"windows_per_s", "setup_s"}
    layers = {m["name"] for m in s["per_layer"] if CELL in m["workloads"]}
    assert layers == set(METRICS)


@pytest.mark.parametrize("metric", METRICS)
def test_readers_report_nothing_without_a_trace_or_a_counter(metric):
    assert _read(metric, {}) is None
    assert _read(metric, {"recordings": [], "windows": 0, "elapsed_s": 1.0,
                          "traced_windows": [8]}) is None


def test_rows_a_window():
    assert _read("unet.spec_rows_per_window", {"unet.spec_rows": 48, "windows": 24}) == 2.0
