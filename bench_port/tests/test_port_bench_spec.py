"""BENCHMARK.json and the files it names, against the benchmark's contract:
names, units and lengths, the files each cell and metric is found by, the
bounds, and the run length's budget."""

from __future__ import annotations

import json
import re

import pytest

from bench_port import run as bench

from .conftest import HERE, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    raw = (bench.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert set(json.loads(raw)) == TOP_KEYS


def test_every_name_and_unit_uses_the_allowed_characters():
    s = spec()
    names = [c["name"] for c in s["configs"]] + [w["name"] for w in s["workloads"]]
    names += [w["config"] for w in s["workloads"]] + [w["traffic"] for w in s["workloads"]]
    metrics = s["end_to_end"] + s["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in s["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in s[group]}) == len(s[group])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entries_have_just_the_contracts_keys_and_lines():
    s = spec()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    assert all(_line(word) for word in s["command"]) and len(s["command"]) <= 32
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)


def test_each_cell_finds_its_files_by_name():
    s = spec()
    configs = {c["name"]: c for c in s["configs"]}
    for w in s["workloads"]:
        assert w["config"] in configs
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        limits = bench.load_json(HERE / "cells" / f"{w['name']}.json")["limits"]
        assert limits
        mix = bench.load_json(HERE / "traffic" / f"{w['traffic']}.json")
        assert (HERE / "runners" / f"{mix['runner']}.py").is_file()
    for m in s["end_to_end"] + s["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    files = [c["file"] for c in s["configs"]]
    assert len(set(files)) == len(files)
    for c in s["configs"]:
        assert c["file"].startswith("bench_port/") and (bench.ROOT / c["file"]).is_file()


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    s = spec()
    for w in s["workloads"]:
        e2e = [m["name"] for m in s["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layers = [m for m in s["per_layer"] if w["name"] in m.get("workloads", [])]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])
    assert next(m for m in s["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_every_layer_is_one_of_perf_mds_layers():
    table = (bench.ROOT / "PERF.md").read_text().split("## 3. Layers", 1)[1].split("## 4.", 1)[0]
    for m in spec()["per_layer"]:
        assert f"| {m['layer']} |" in table, m["layer"]


def test_roofline_and_mfu_names():
    for m in spec()["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_length_fits_the_check_for_24_cells():
    rs = spec()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_and_paths_stay_in_the_benchmark():
    s = spec()
    assert s["paths"] == ["bench_port"]
    assert s["command"][:3] == ["python3", "-m", "bench_port.run"]
    for word in s["command"]:
        assert not word.startswith("/") and ".." not in word
    four = [w for w in s["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(s["workloads"]) // 4)


@pytest.mark.parametrize("name", ["ClassifierFreeDiffRoll", "DiffRoll"])
def test_configuration_is_the_ports_preset_at_published_widths(name):
    from diffroll_tpu_torch.models import PRESETS

    cfg = bench.load_json(HERE / "configs" / f"{name}.json")
    entry = next(c for c in spec()["configs"] if c["name"] == name)
    assert entry["reduced"] == cfg["reduced"] == []
    preset = PRESETS[cfg["preset"]]
    for key in ("residual_channels", "residual_layers", "kernel_size", "dilation_base",
                "dilation_bound", "condition", "spec_dropout", "spec_norm", "n_mels",
                "timesteps", "frames", "pitches"):
        assert cfg[key] == getattr(preset, key), key
    assert tuple(cfg["norm_args"]) == tuple(preset.norm_args)
    for key, value in cfg["mel"].items():
        assert getattr(preset.mel, key) == value, key
    assert (cfg["residual_channels"], cfg["residual_layers"], cfg["n_mels"]) == (512, 15, 229)


def test_the_result_line_stays_strict_json():
    def refuse(name):
        raise ValueError(name)

    line = json.dumps(bench.finite({"checks": {"roll_rms": {"value": float("inf"), "limit": 0.01}},
                                    "readings": [float("nan"), 1.5]}))
    assert json.loads(line, parse_constant=refuse)["checks"]["roll_rms"]["value"] == "inf"
