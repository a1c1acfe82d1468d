"""The port's quality evidence (`diffroll_tpu_torch.quality`) on the CPU:
the synthetic corpora, the MAPS-layout tree and the longform piece bit for
bit (byte for byte) the JAX scripts', the fmask mel-bin -> key mapping and
the band scorer exactly the JAX tool's computation, and every entry end to
end at a tiny size (finite metrics, the JAX scripts' JSON keys).

The JAX-side scripts parse their arguments from `sys.argv` when they are
imported (examples/synthetic_end_to_end.py, tools/make_synthetic_tree.py),
so they are loaded with `importlib` and `sys.argv` patched to []."""

import importlib.util
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from diffroll_tpu.data.rasterize import rasterize_arrays as j_rasterize_arrays
from diffroll_tpu.dsp import mel as jmel
from diffroll_tpu.eval.evaluate import evaluate_rolls as j_evaluate_rolls
from diffroll_tpu_torch.dsp.mel import MelConfig
from diffroll_tpu_torch.quality import (
    bf16_drift, eval_boundary, eval_inpainting, eval_longform, fullsize_distill,
    make_synthetic_tree, paper_sweeps, pretrain_both_pipeline, synthetic_end_to_end)
from torch_native_tiers import native_tiers_pinned  # noqa: F401

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "lightning_small.ckpt"
# the learning check at a tiny size: clips of 32 frames (1.02 s) still hold notes
TINY = ["channels=16", "layers=2", "frames=32", "timesteps=10", "n_train=4", "n_test=2",
        "device=cpu"]
JAX_KEYS = {"frame_precision", "frame_recall", "frame_f1", "note_precision", "note_recall",
            "note_f1", "train_steps", "wall_s", "dtype", "corpus"}


def _load_script(name: str, path: pathlib.Path):
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.argv = []
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.argv, sys.path[:] = saved_argv, saved_path
    return module


@pytest.fixture(scope="module")
def jax_e2e():
    return _load_script("jax_synthetic_end_to_end", REPO / "examples" / "synthetic_end_to_end.py")


@pytest.fixture(scope="module")
def jax_tree():
    return _load_script("jax_make_synthetic_tree", REPO / "tools" / "make_synthetic_tree.py")


def _fields(notes):
    return [(n.onset, n.offset, n.pitch, n.velocity) for n in notes]


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return math.isfinite(tree)
    return True


# ---------------------------------------------------------------- (1) corpora


@pytest.mark.parametrize("seed", [0, 1000, 5000])
@pytest.mark.parametrize("corpus", ["v1", "v2"])
def test_make_clip_bit_for_bit(jax_e2e, corpus, seed):
    audio, roll = synthetic_end_to_end.make_clip(seed, corpus)
    j_audio, j_roll = jax_e2e.make_clip(seed, corpus)
    assert audio.shape == (synthetic_end_to_end.SEQ,) and roll.shape == (128, 88)
    assert audio.dtype == j_audio.dtype and roll.dtype == j_roll.dtype
    assert np.array_equal(audio, j_audio) and np.array_equal(roll, j_roll)
    assert roll.sum() > 0
    assert (synthetic_end_to_end.SR, synthetic_end_to_end.HOP, synthetic_end_to_end.FRAMES,
            synthetic_end_to_end.SEQ, synthetic_end_to_end.TIMESTEPS) == (
        jax_e2e.SR, jax_e2e.HOP, jax_e2e.FRAMES, jax_e2e.SEQ, jax_e2e.TIMESTEPS)


# ---------------------------------------------------------------- (2) the tree


def test_make_synthetic_tree_byte_for_byte(jax_tree, tmp_path):
    jax_tree.ARGS.clear()
    jax_tree.ARGS.update(out=str(tmp_path / "jax"), n_train="2", n_test="1", seconds="2.0")
    jax_tree.main()
    make_synthetic_tree.main([f"out={tmp_path / 'port'}", "n_train=2", "n_test=1",
                              "seconds=2.0"])
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert got == want and len(want) == 6
    assert {p.parts[:3] for p in want} == {("MAPS", "AkPnBcht", "MUS"),
                                           ("MAPS", "ENSTDkAm", "MUS")}
    for rel in want:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


# ---------------------------------------------------------------- (3), (4) the scorers


@pytest.mark.parametrize("band", [(29, 51), (5, 20), (60, 120)])
def test_fmask_keys_match_the_jax_tool(band):
    """The JAX tool's lines (tools/eval_inpainting.py:98-109) on its HTK
    functions against `fmask_keys`."""
    m0, m1 = band
    mel = MelConfig()
    pts = jmel.mel_to_hz_htk(np.linspace(jmel.hz_to_mel_htk(mel.f_min),
                                         jmel.hz_to_mel_htk(mel.f_max), mel.n_mels + 2))
    hz_lo, hz_hi = float(pts[m0]), float(pts[m1 + 1])
    midi = 21 + np.arange(88)
    f0s = 440.0 * 2.0 ** ((midi - 69) / 12.0)
    inside = np.where((f0s >= hz_lo) & (f0s < hz_hi))[0]
    want = (hz_lo, hz_hi, int(inside[0]), int(inside[-1]) + 1)
    assert eval_inpainting.fmask_keys(m0, m1, mel) == want


def _random_rolls(seed, n=3, frames=64):
    rng = np.random.RandomState(seed)
    label = np.zeros((n, frames, 88), np.float32)
    for i in range(n):
        for _ in range(12):
            p, t0 = rng.randint(0, 88), rng.randint(0, frames - 8)
            label[i, t0:t0 + rng.randint(2, 8), p] = 1.0
    pred = np.clip(label + 0.4 * rng.randn(*label.shape), 0, 1).astype(np.float32)
    return pred, label


@pytest.mark.parametrize("axis", ["time", "pitch"])
def test_band_scores_match_jax_evaluate_rolls(axis):
    """The JAX tool's slicing (tools/eval_inpainting.py:146-163) scored by
    JAX's `evaluate_rolls`, against `band_scores`: equal."""
    pred, label = _random_rolls(3)
    a, b = (16, 40) if axis == "time" else (30, 52)
    kw = dict(frames=(a, b)) if axis == "time" else dict(keys=(a, b))
    inside, outside = eval_inpainting.band_scores(pred, label, **kw)
    ax = 1 if axis == "time" else 2
    sl = (slice(None), slice(a, b)) if ax == 1 else (slice(None), slice(None), slice(a, b))
    lo = (slice(None), slice(None, a)) if ax == 1 else (slice(None), slice(None), slice(None, a))
    hi = (slice(None), slice(b, None)) if ax == 1 else (slice(None), slice(None), slice(b, None))
    assert inside == j_evaluate_rolls(pred[sl], label[sl])
    assert outside == j_evaluate_rolls(np.concatenate([pred[lo], pred[hi]], axis=ax),
                                       np.concatenate([label[lo], label[hi]], axis=ax))
    assert 0 < inside["note_f1"] < 1 and 0 < outside["frame_f1"] < 1
    with pytest.raises(ValueError, match="one band"):
        eval_inpainting.band_scores(pred, label)


# ---------------------------------------------------------------- (5) the learning check


@pytest.mark.parametrize("fused", ["0", "1"], ids=["autograd", "fused_plain"])
def test_learning_check_tiny(fused, capsys):
    m = synthetic_end_to_end.main(TINY + ["steps=5", "sweep_steps=1", f"fused_train={fused}"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == m
    assert JAX_KEYS | {"steps_sweep"} <= set(m)
    assert set(m["steps_sweep"]) == {f"{s}@{n}" for s in ("cfdg_ddpm_x0", "cfdg_ddim_x0")
                                     for n in (10, 50, 20)}
    assert m["fused_train"] is (fused == "1") and m["train_steps"] == 5
    assert set(m["losses"]) == {"0", "4"} and m["losses"]["0"] > 0
    assert _finite(m)


def test_learning_check_routes_and_distill_tiny():
    """The same init and draws: the fused route's plain versions (K3 + K4 on
    the CPU) train the twin as autograd does; then two distillation stages,
    each student scored beside the undistilled sampler."""
    args = synthetic_end_to_end.parse_args(TINY + ["steps=3"])
    models = {}
    for fused in ("0", "1"):
        _, twin = synthetic_end_to_end.learning_check({**args, "fused_train": fused})
        models[fused] = twin.model.net.state_dict()
    for k, v in models["0"].items():
        assert torch.allclose(models["1"][k], v, rtol=1e-3, atol=1e-5), k
    m, _ = synthetic_end_to_end.learning_check(
        {**args, "distill": "1", "distill_start": "5", "distill_stages": "2",
         "distill_steps": "2"})
    assert set(m["distill"]) == {"5steps", "3steps"} and _finite(m)


def test_the_check_over_seeds_is_the_check_at_seed_0():
    """Seed 0 of the per-seed routine, with the clips rendered once as
    `chip_smoke.py` phase learn and `tests/learning_seeds.py` run it, gives
    the check's own record exactly (its wall seconds aside)."""
    import learning_seeds

    argv = TINY + ["steps=3"]
    args = synthetic_end_to_end.parse_args(argv)
    want, _ = synthetic_end_to_end.learning_check(args)
    clips = synthetic_end_to_end.check_clips(args, torch.device("cpu"))
    got, _ = synthetic_end_to_end.learning_check(args, 0, clips)
    want.pop("wall_s"), got.pop("wall_s")
    assert got == want and want["seed"] == 0
    row, = learning_seeds.main(argv + ["seeds=0"])["rows"]
    assert row == {"seed": 0, "note_f1": want["note_f1"], "frame_f1": want["frame_f1"]}


def test_seeds_draw_their_own_weights_and_streams():
    """Seed s draws the weights after `torch.manual_seed(s)` and the training
    stream from s + 1: seeds 0 and 1 start apart, and from one start they
    train apart."""
    args = synthetic_end_to_end.parse_args(TINY + ["steps=2"])
    clips = synthetic_end_to_end.check_clips(args, torch.device("cpu"))
    starts = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        starts.append(synthetic_end_to_end.build_twin(args).net.state_dict())
    assert any(not torch.equal(starts[0][k], starts[1][k]) for k in starts[0])
    m0, t0 = synthetic_end_to_end.learning_check(args, 0, clips)
    m0s, t0s = synthetic_end_to_end.learning_check(args, 0, clips, start=starts[0])
    _, t1s = synthetic_end_to_end.learning_check(args, 1, clips, start=starts[0])
    assert m0s["losses"] == m0["losses"]   # seed 0's own draw is starts[0]
    trained = [t.model.net.state_dict() for t in (t0, t0s, t1s)]
    assert all(torch.equal(trained[0][k], trained[1][k]) for k in trained[0])
    assert any(not torch.equal(trained[1][k], trained[2][k]) for k in trained[1])


# one row a seed: (note F1, frame F1), seed 0 first
SEED_ROWS = {
    "seed_0_under_the_mean_over": [(0.47, 0.5986), (0.48, 0.6358), (0.46, 0.6201),
                                   (0.49, 0.6102), (0.47, 0.6244), (0.45, 0.5954)],
    "seed_0_over_the_mean_under": [(0.47, 0.6069), (0.46, 0.5902), (0.45, 0.5951),
                                   (0.47, 0.5920), (0.48, 0.5983), (0.46, 0.5968)],
    "note_mean_under": [(0.45, 0.62), (0.38, 0.61), (0.35, 0.63)],
}


@pytest.mark.parametrize("case", sorted(SEED_ROWS))
def test_the_learning_gate_reads_the_mean_over_seeds(case):
    rows = [{"seed": s, "note_f1": n, "frame_f1": f} for s, (n, f) in enumerate(SEED_ROWS[case])]
    summary = synthetic_end_to_end.over_seeds(rows)
    for k, i in (("note_f1", 0), ("frame_f1", 1)):
        v = [r[i] for r in SEED_ROWS[case]]
        assert summary[k]["mean"] == pytest.approx(np.mean(v), abs=1e-12)
        assert summary[k]["sd"] == pytest.approx(np.std(v, ddof=1), abs=1e-12)
    seed_0_clears = rows[0]["note_f1"] >= 0.40 and rows[0]["frame_f1"] >= 0.60
    admitted = synthetic_end_to_end.clears_on_mean(rows, 0.40, 0.60)
    assert admitted == (case == "seed_0_under_the_mean_over")
    assert seed_0_clears != admitted
    assert synthetic_end_to_end.over_seeds(rows[:1])["frame_f1"]["sd"] is None


# ---------------------------------------------------------------- (6) the tools


def test_eval_boundary_tiny():
    out = eval_boundary.main(["steps=3", "n_train=4", "n_long=1", "long_windows=3", "overlap=4",
                              "channels=16", "layers=2", "frames=32", "timesteps=10",
                              "device=cpu"])
    assert {"tiled_note_f1", "tiled_frame_f1", "stitched_note_f1", "stitched_frame_f1",
            "note_f1_delta", "frame_f1_delta"} <= set(out) and _finite(out)


def test_eval_boundary_corpus_is_the_jax_tools(jax_tree):
    """The tool's notes for a long recording are the JAX tool's
    (`make_notes(seed, n_frames)`, tools/eval_boundary.py:64-77)."""
    for seed, n_frames in ((5_000, 512), (3, 128)):
        want = jax_tree.make_notes(seed, n_frames * 512 / 16000)
        got = eval_boundary.make_notes(seed, n_frames)
        assert _fields(got) == _fields(want)


def test_longform_piece_is_the_jax_tools(jax_e2e, jax_tree):
    """The piece and its label as tools/eval_longform.py:50-59 builds them."""
    seed, seconds = 3_000_000, 6.0
    notes = jax_tree.make_notes(seed, seconds)
    audio = jax_e2e.render_notes_v2(notes, int(seconds * 16000),
                                    np.random.RandomState(1_000_000 + seed))
    n_frames = len(audio) // 512
    label, _ = j_rasterize_arrays(np.array([n.onset for n in notes]),
                                  np.array([n.offset for n in notes]),
                                  np.array([n.pitch for n in notes]), n_frames, 512, 16000,
                                  21, 108)
    got_notes, got_audio, got_label = eval_longform.longform_piece(seed, seconds)
    assert _fields(got_notes) == _fields(notes)
    assert np.array_equal(got_audio, audio) and np.array_equal(got_label, label)
    assert got_label.sum() > 0


def test_eval_longform_on_the_fixture(tmp_path):
    out = eval_longform.main([f"ckpt={FIXTURE}", "seconds=3", "overlaps=4,0", "device=cpu",
                              "model.frames=16", f"out={tmp_path / 'longform.json'}"])
    assert set(out["results"]) == {"overlap_4", "overlap_0"}
    assert out["n_frames"] == 3 * 16000 // 512 and _finite(out)
    assert json.loads((tmp_path / "longform.json").read_text()) == out


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    make_synthetic_tree.write_tree(root, n_train=1, n_test=2, seconds=1.024)
    return root


@pytest.mark.parametrize("band", ["mask=4,12", "fmask=2,6"])  # the fixture has 12 mel bins
def test_eval_inpainting_on_the_fixture(small_tree, band, tmp_path):
    out = eval_inpainting.main([f"ckpt={FIXTURE}", f"root={small_tree}", band, "seq=8192",
                                "batch=4", "device=cpu", "model.frames=16",
                                f"tmpdir={tmp_path}"])
    assert set(out["results"]) == {"transcription", "inpainting", "generation"}
    # two recordings of 32 frames: four butted 16-frame windows
    assert all(r["n_windows"] == 4 for r in out["results"].values()) and _finite(out)
    if band.startswith("fmask"):
        k0, k1 = out["mask_keys"]
        assert out["mask_mel_bins"] == [2, 6] and 0 <= k0 < k1 <= 88
    else:
        assert out["mask_frames"] == [4, 12]
    assert out["ckpt"] == str(FIXTURE) and out["global_step"] == 100_000  # the fixture's record


def test_inpainting_cross_score_on_the_fixture(small_tree, tmp_path):
    """`tests/inpainting_cross_score.py`: one checkpoint through the JAX tool
    and the port's entry, both bands' conditions over the same windows."""
    cross = _load_script("inpainting_cross_score", REPO / "tests" / "inpainting_cross_score.py")
    out = cross.main([f"ckpt={FIXTURE}", f"root={small_tree}", "mask=4,12", "seq=8192",
                      "batch=4", "frames=16", f"out={tmp_path}"])
    assert set(out["inside_band"]) == {"transcription", "inpainting", "generation"}
    for pkg in ("jax", "port"):
        assert out[pkg]["mask_frames"] == [4, 12] and out[pkg]["window_frames"] == 16
        assert all(r["n_windows"] == 4 for r in out[pkg]["results"].values())
    assert _finite(out["inside_band"])
    assert out["global_step"] == out["port"]["global_step"] == 100_000
    assert json.loads((tmp_path / "cross_score.json").read_text()) == out


def test_inpainting_cross_score_reads_a_jax_checkpoint(small_tree, tmp_path):
    """A JAX run's checkpoints directory: scored by the JAX tool alone at the
    step asked for (`last`, or a monitored `step_<N>`), its step read from the
    state the tool restored; `export=` writes it as a port `.ckpt` whose
    weights are the JAX state's and whose step is recorded."""
    import jax
    from diffroll_tpu.cli import train as jax_train
    from diffroll_tpu.train.checkpoint import Checkpointer as JCheckpointer
    from diffroll_tpu_torch.compat import peek_global_step, read_ckpt, state_dict_from_jax

    make_synthetic_tree.write_tree(tmp_path / "tree", n_train=2, n_test=1, seconds=1.024)
    jax_train.main(["spec_roll", f"dataset.root={tmp_path / 'tree'}", *RECIPE_TINY[:5],
                    "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=1",
                    "dataloader.train_batch_size=1", "dataloader.num_workers=1",
                    f"trainer.output_dir={tmp_path / 'jax'}"])
    ckpts = sorted((tmp_path / "jax").rglob("checkpoints"))[-1]
    best = JCheckpointer(ckpts).latest_step()
    cross = _load_script("inpainting_cross_score", REPO / "tests" / "inpainting_cross_score.py")
    common = [f"ckpt={ckpts}", f"root={small_tree}", "mask=4,12", "seq=16384", "batch=4",
              "frames=32"]
    out = cross.main([*common, "step=last", f"out={tmp_path / 'last'}"])
    assert out["global_step"] == 4 and set(out) == {"ckpt", "global_step", "inside_band", "jax"}
    assert all(r["n_windows"] == 2 for r in out["jax"]["results"].values())
    assert cross.main([*common, f"out={tmp_path / 'best'}"])["global_step"] == best
    dst = tmp_path / "jax_cpu_s0_last.ckpt"
    assert cross.main([*common, "step=last", f"export={dst}",
                       f"out={tmp_path / 'export'}"])["global_step"] == 4
    assert peek_global_step(str(dst)) == 4
    state = cross.jax_load(cross.jax_checkpoint(str(ckpts), "last", tmp_path / "x"), 32)[3]
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    got = read_ckpt(str(dst))["state_dict"]
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_bf16_drift_on_the_cpu():
    """On the CPU both routes run the plain version on f32 weights: no
    error against f32, the weights' rounding alone against the rounded."""
    torch.manual_seed(0)
    model = synthetic_end_to_end.build_twin({"channels": "16", "layers": "2", "frames": "32",
                                             "timesteps": "10"})
    torch.nn.init.normal_(model.net.output_projection.weight, std=0.1)
    wav = torch.from_numpy(bf16_drift.held_out_waveforms(2, 32))
    r = bf16_drift.drift(model.eval(), wav)
    assert r["batch"] == 2 and r["steps"] == 10 and r["finite"]
    assert r["k2_rel_f32_weights"] == 0.0 and r["loop_rel_f32_weights"] < 1e-5
    assert r["k2_rel_bf16_weights"] > 0 and r["ref_rounding_rel"] > 0


@pytest.mark.parametrize("module,argv", [
    (synthetic_end_to_end, ["steps=1"]),
    (eval_boundary, ["steps=1"]),
    (eval_inpainting, [f"ckpt={FIXTURE}", "root=unused"]),
    (eval_longform, [f"ckpt={FIXTURE}", "seconds=1"]),
    (bf16_drift, [f"ckpt={FIXTURE}"]),
    (paper_sweeps, ["tree=unused"]),
    (pretrain_both_pipeline, ["smoke", "paired=unused", "unpaired=unused"]),
    (fullsize_distill, ["tree=unused"]),
], ids=["synthetic_end_to_end", "eval_boundary", "eval_inpainting", "eval_longform",
        "bf16_drift", "paper_sweeps", "pretrain_both_pipeline", "fullsize_distill"])
def test_entries_refuse_a_missing_card(module, argv, monkeypatch):
    """Each entry runs on the card unless given device=cpu, and exits on
    device=cuda (the default) without one: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(argv)


# ---------------------------------------------------------------- (7) the experiment recipes

# the recipes at a tiny size: 16 x 2 nets of 32 frames (1.024 s windows)
RECIPE_TINY = ["model.residual_channels=16", "model.residual_layers=2", "task.timesteps=10",
               "model.frames=32", "dataset.sequence_length=16384", "trainer.max_epochs=1",
               "trainer.check_val_every_n_epoch=1", "dataloader.train_batch_size=2",
               "dataloader.num_workers=1", "device=cpu"]


@pytest.fixture(scope="module")
def recipe_tree(tmp_path_factory):
    """Four training and two test recordings of 1.024 s: two steps an epoch."""
    root = tmp_path_factory.mktemp("recipe_tree")
    make_synthetic_tree.write_tree(root, n_train=4, n_test=2, seconds=1.024)
    return root


def test_stage_checkpoint_finds_the_newest_run_and_its_best(tmp_path):
    """As `find <out> -type d -name checkpoints | sort | tail -1`, then the
    newest monitored checkpoint in it, else `last`."""
    old = tmp_path / "2026-01-01" / "10-00-00" / "train-x" / "checkpoints"
    new = tmp_path / "2026-01-02" / "09-00-00" / "train-x" / "checkpoints"
    for d in (old, new):
        d.mkdir(parents=True)
        (d / "last.ckpt").write_bytes(b"")
    assert paper_sweeps.stage_checkpoint(tmp_path) == new / "last.ckpt"
    (new / "step_000000300.ckpt").write_bytes(b"")
    (new / "step_000000600.ckpt").write_bytes(b"")
    assert paper_sweeps.stage_checkpoint(tmp_path) == new / "step_000000600.ckpt"
    with pytest.raises(FileNotFoundError):
        paper_sweeps.stage_checkpoint(tmp_path / "empty")


def test_paper_sweeps_tiny(tmp_path):
    """Three p points, the w-sweeps of the p = 0, 0.1 and 0.5 models and both
    inpainting bands on p = 0.1, through `sweep` and `eval_inpainting`. The
    time band 48-80 needs the recipe's 128-frame window: one 4.096 s window a
    recording."""
    tree = tmp_path / "tree"
    make_synthetic_tree.write_tree(tree, n_train=4, n_test=2, seconds=4.096)
    out = paper_sweeps.main([f"tree={tree}", f"out={tmp_path / 'out'}", "p_grid=[0.0,0.1,0.5]",
                             "w_grid=[0.0,0.5]", *RECIPE_TINY, "model.frames=128",
                             "dataset.sequence_length=65536"])
    assert [r["spec_dropout"] for r in out["p_sweep"]] == [0.0, 0.1, 0.5]
    assert set(out["w_rows"]) == {"0", "0.1", "0.5"}
    assert all([r["w"] for r in rows] == [0.0, 0.5] for rows in out["w_rows"].values())
    assert set(out["inpainting"]) == {"mask=48,80", "fmask=29,51"}
    assert set(out["walls_s"]) == {"tree", "p_sweep", "w_sweep_p0", "w_sweep_p0.1",
                                   "w_sweep_p0.5", "inpainting_mask", "inpainting_fmask"}
    assert json.loads((tmp_path / "out" / "paper_sweeps.json").read_text()) == out
    assert _finite(out)
    # each stage checkpoint with the step it holds: one epoch of two steps
    assert set(out["stage_checkpoints"]) == {"p0", "p0.1", "p0.5"}
    assert all(c["global_step"] == 2 for c in out["stage_checkpoints"].values())
    assert all(r["global_step"] == 2 and r["ckpt"] == out["stage_checkpoints"]["p0.1"]["file"]
               for r in out["inpainting"].values())


def test_eval_inpainting_names_the_step_it_scored(recipe_tree, tmp_path):
    """A run of 2 epochs of 2 steps, validated each epoch: `last.ckpt` holds
    step 4, the monitored checkpoint its own step, and each payload says
    which."""
    from diffroll_tpu_torch.cli import train as train_cli

    train_cli.main(["spec_roll", f"dataset.root={recipe_tree}", *RECIPE_TINY,
                    "trainer.max_epochs=2", f"trainer.output_dir={tmp_path / 'run'}"])
    best = paper_sweeps.stage_checkpoint(tmp_path / "run")
    for ckpt, step in ((best.parent / "last.ckpt", 4), (best, int(best.stem.split("_")[1]))):
        out = eval_inpainting.main([f"ckpt={ckpt}", f"root={recipe_tree}", "mask=4,12",
                                    "seq=16384", "batch=2", "device=cpu",
                                    f"tmpdir={tmp_path / 'eval'}"])
        assert out["ckpt"] == str(ckpt) and out["global_step"] == step


def test_pretrain_both_pipeline_smoke(tmp_path):
    """The script's four stages at its smoke geometry (8 x 2, T=4, 64 frames)
    on trees of one window a clip: each stage starts from the checkpoint the
    previous one wrote, and each student is scored."""
    for name, seed in (("paired", 0), ("unpaired", 7)):
        make_synthetic_tree.write_tree(tmp_path / name, n_train=8, n_test=2, seconds=2.048,
                                       seed=seed)
    out = pretrain_both_pipeline.main([
        "smoke", f"paired={tmp_path / 'paired'}", f"unpaired={tmp_path / 'unpaired'}",
        f"out={tmp_path / 'out'}", "distill.steps_per_stage=3", "dataloader.num_workers=1",
        "device=cpu"])
    assert "/pretrain/" in out["pretrain_ckpt"] and "/retrain_both/" in out["retrain_ckpt"]
    assert [r["w"] for r in out["wsweep"]] == [0.0, 0.5]
    assert set(out["students"]) == {"2"} and out["students"]["2"]["n_clips"] == 2
    assert {"corpora", "pretrain", "retrain_both", "wsweep", "distill",
            "distill_eval_2"} == set(out["walls_s"]) and _finite(out)
    hparams = torch.load(out["retrain_ckpt"], map_location="cpu", weights_only=False)
    assert hparams["hyper_parameters"]["port_config"]["model"]["spec_dropout"] == 0.1


def test_fullsize_distill_tiny(recipe_tree, tmp_path):
    """The teacher trained, two stages distilled, and the points scored in the
    scoring script's order, one row each."""
    out = fullsize_distill.main([f"tree={recipe_tree}", f"out={tmp_path}", *RECIPE_TINY,
                                 "distill.start_steps=5", "distill.stages=2",
                                 "distill.steps_per_stage=2"])
    assert [r["point"] for r in out["scores"]] == [
        "distilled@3", "teacher ddim_x0@3", "teacher cfdg_ddpm_x0 dense", "distilled@5"]
    assert [r["sampling_steps"] for r in out["scores"]] == [3, 3, None, 5]
    assert all(r["n_clips"] == 2 for r in out["scores"]) and _finite(out)
    assert json.loads((tmp_path / "scores.json").read_text()) == out["scores"]
