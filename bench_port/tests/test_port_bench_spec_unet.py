"""The SpecUnet configuration against the port's preset: every width as
published, nothing reduced, every key the harness hands the program present;
and the cell's files."""

from __future__ import annotations

from bench_port import port
from bench_port import run as bench

from .conftest import HERE, spec


def test_configuration_is_the_ports_preset_at_published_widths():
    from diffroll_tpu_torch.models import PRESETS

    cfg = bench.load_json(HERE / "configs" / "SpecUnet.json")
    entry = next(c for c in spec()["configs"] if c["name"] == "SpecUnet")
    assert entry["reduced"] == cfg["reduced"] == [] and entry["file"].endswith("SpecUnet.json")
    preset = PRESETS[cfg["preset"]]
    assert preset.variant == "spec_unet"
    for key in set(port.MODEL_KEYS) | {"residual_channels", "convnext_mult"}:
        assert cfg[key] == getattr(preset, key), key
    assert tuple(cfg["dim_mults"]) == preset.dim_mults and tuple(cfg["norm_args"]) == tuple(
        preset.norm_args)
    for key, value in cfg["mel"].items():
        assert getattr(preset.mel, key) == value, key
    assert all(k in cfg for k in port.TASK_KEYS)
    assert set(cfg["ignored_by_the_unet"]) <= set(port.MODEL_KEYS) | set(port.TASK_KEYS)
    assert (cfg["residual_channels"], cfg["dim_mults"], cfg["convnext_mult"], cfg["heads"],
            cfg["dim_head"], cfg["n_mels"], cfg["frames"], cfg["pitches"]) == (
        28, [1, 2, 4], 2, 4, 32, 229, 640, 88)
    assert (cfg["timesteps"], cfg["training_mode"], cfg["loss_type"], cfg["lr"],
            cfg["spec_norm"], cfg["spec_dropout"]) == (200, "x_0", "l2", 5e-5, "none", 0.0)


def test_the_cell_trains_the_published_batch_and_checks_three_numbers():
    cell = next(w for w in spec()["workloads"] if w["name"] == "specunet-train")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("SpecUnet", "train_unet_b16", 1)
    mix = bench.load_json(HERE / "traffic" / "train_unet_b16.json")
    assert (mix["runner"], mix["batch"], mix["pool"], mix["trace_after"],
            mix["trace_steps"]) == ("train_unet", 16, 12, 3, 4)
    limits = bench.load_json(HERE / "cells" / "specunet-train.json")["limits"]
    assert set(limits) == {"grad_gap", "update_gap", "pred_rms"}
    layers = {m["name"] for m in spec()["per_layer"] if "specunet-train" in m["workloads"]}
    assert layers == {"mfu.train_spec_unet", "unet.attn_roofline", "unet.block_roofline"}
