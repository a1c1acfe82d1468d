"""SpecUnet's sampling with its spectrogram stream computed once a batch
(`SpecUnetNet.cond_projections`, then the x stream alone every step), on the
CPU at the published width (dim 28) and 64 frames, on the benchmark's seeded
weights (`bench_port/weights_unet.py`):

  * the spectrogram stream once plus the x stream equals the whole forward
    (1e-5), on conditional rows, masked rows, a mixed `uncond_mask` and both
    guidance branches;
  * `cfdg_ddpm_x0` at w=0.5 equals the plain reference
    (`bench_port/reference/spec_unet_sample.py`, the whole net on both
    branches every step) on the same draws, and `transcribe_long` over 2.5
    windows equals the reference's batches stitched;
  * `unet.spec_rows` grows by 2B once a batch, whatever the steps;
  * the generation and inpainting samplers equal the route that runs the
    whole forward every step;
  * the streams' counts (`bench_port/counts/spec_unet_sample.py`) equal
    `FlopCounterMode`'s count of `cond_projections` and of the x stream;
  * the cell's check (`bench_port/runners/transcribe_unet.py`) through a
    whole run at a tiny width: the program passes it, the bf16 reference in
    its place does not, and the rows through the stream read 2 a window.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import port
from bench_port import run as bench
from bench_port import weights_unet
from bench_port.counts import spec_unet as counts
from bench_port.counts import spec_unet_sample as stream_counts
from bench_port.reference import diffroll as ref
from bench_port.reference import spec_unet as uref
from bench_port.reference import spec_unet_sample as sref
from diffroll_tpu_torch.diffusion.loop import sample_loop
from diffroll_tpu_torch.nn import unet
from diffroll_tpu_torch.tasks.transcribe import transcribe_long

torch.set_num_threads(1)
FRAMES, STEPS, B = 64, 3, 2
GAP = 1e-5   # f32 on both sides; the two routes differ in the order of their sums


def _cfg(**over):
    cfg = bench.load_json(bench.HERE / "configs" / "SpecUnetGuided.json")
    cfg.update({"frames": FRAMES, "timesteps": STEPS, **over})
    return cfg


_MODELS = {}


def _model():
    if not _MODELS:
        cfg = _cfg()
        params = weights_unet.make(cfg, 11, torch.device("cpu"))
        _MODELS["m"] = (cfg, params, port.build_model(cfg, torch.device("cpu"), params).eval())
    return _MODELS["m"]


def _task(**over):
    cfg, params, model = _model()
    return cfg, params, port.build_task({**cfg, **over}, model)


def _draws(seed, b=B):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, FRAMES, 88, generator=g),
            0.1 * torch.randn(b, FRAMES * 512, generator=g),
            torch.randn(STEPS, b, FRAMES, 88, generator=g))


def _rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("rows", ["conditional", "masked", "mixed", "guided"])
def test_stream_once_plus_x_stream_equals_the_whole_forward(rows):
    _, _, model = _model()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, FRAMES, 88, generator=g)
    t = torch.tensor([0, 1, STEPS - 1])
    cond = torch.randn(3, FRAMES, 229, generator=g) - 4.0
    mask = {"conditional": None, "masked": torch.ones(3, dtype=torch.bool),
            "mixed": torch.tensor([False, True, False]), "guided": None}[rows]
    with torch.no_grad():
        if rows == "guided":
            got = torch.cat(model.apply_cfg(x, t, cond_proj=model.cfg_cond_projections(cond)))
            want = torch.cat(model.apply_cfg(x, t, cond))
        else:
            got = model.apply(x, t, None, cond_proj=model.cond_projections(cond, mask))
            want = model.apply(x, t, cond, mask)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, atol=GAP, rtol=GAP)


def test_guided_sampling_equals_the_reference():
    cfg, params, task = _task()
    x_T, wave, noise = _draws(1)
    got, _ = task.sample(x_T, waveform=wave, noise=noise)
    want = sref.sample(params, cfg, x_T, noise, uref.conditioner(wave, cfg))
    assert want.abs().max() > 0.1 and _rel(got, want) < 1e-5


@pytest.mark.parametrize("steps", [1, STEPS])
def test_the_stream_runs_once_a_batch(steps):
    _, _, task = _task(timesteps=steps)
    x_T, wave, noise = _draws(2)
    before = unet.spec_rows
    task.sample(x_T, waveform=wave, noise=noise[:steps])
    assert unet.spec_rows - before == 2 * B


def test_transcribe_long_equals_the_reference_stitched():
    """2.5 windows at overlap 8: batches of 2 and 1 windows, each batch's
    x_T and per-step noise drawn from one generator in the program's order."""
    cfg, params, task = _task()
    hop, overlap = 512, 8
    seq = FRAMES * hop
    audio = 0.1 * np.sin(np.arange(int(2.5 * seq)) * 0.05).astype(np.float32)
    got = transcribe_long(task, audio, torch.Generator().manual_seed(3), batch_size=2,
                          overlap_frames=overlap)
    wins = ref.windows(audio, seq, seq - overlap * hop)
    g, rolls = torch.Generator().manual_seed(3), []
    for start in range(0, len(wins), 2):
        chunk = torch.from_numpy(wins[start: start + 2])
        x_T = torch.randn(len(chunk), FRAMES, 88, generator=g)
        noise = torch.randn(STEPS, len(chunk), FRAMES, 88, generator=g)
        rolls.append(sref.sample(params, cfg, x_T, noise, uref.conditioner(chunk, cfg)).numpy())
    want = ref.stitch(np.concatenate(rolls), overlap, -(-len(audio) // hop))
    assert len(wins) == 3 and got.shape == want.shape
    assert np.abs(want).max() > 0.1 and np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


@pytest.mark.parametrize("sampler", ["generation_ddpm_x0", "inpainting_ddpm_x0"])
def test_other_samplers_equal_the_whole_forward_every_step(sampler):
    over = {"inpainting_t": (16, 40)} if sampler.startswith("inpainting") else {}
    cfg, _, model = _model()
    task = port.build_task({**cfg, "sampling_type": sampler}, model, **over)
    x_T, wave, noise = _draws(4)
    before = unet.spec_rows
    got, _ = task.sample(x_T, waveform=wave, noise=noise)
    assert unet.spec_rows - before == (B if sampler.startswith("generation") else 2 * B)
    # the same plumbing over the whole conditioned forward every step
    cond = task.build_conditioner(x_T, waveform=wave)
    with torch.no_grad():
        want, _ = sample_loop(task.make_step_fn_from_net(lambda x, t, c: model.net(x, t, c), cond),
                              x_T, STEPS, noise)
    assert want.abs().max() > 0.1 and _rel(got, want) < 1e-5


def _meta_counts(dim, frames, rows):
    """FlopCounterMode's operations of `cond_projections` and of one step's
    x stream over 2 rows a window, on `meta`."""
    from diffroll_tpu_torch.models import build

    with torch.device("meta"):
        net = build("SpecUnet", residual_channels=dim, frames=frames).net
        x, t = torch.empty(2 * rows, frames, 88), torch.zeros(2 * rows, dtype=torch.long)
        cond = torch.empty(2 * rows, frames, 229)
    spec, step = FlopCounterMode(display=False), FlopCounterMode(display=False)
    with spec:
        proj = net.cond_projections(cond)
    with step:
        net(x, t, None, cond_proj=proj)
    return spec.get_total_flops(), step.get_total_flops()


@pytest.mark.parametrize("dim,frames,rows", [(8, 32, 3), (28, 640, 1)])
def test_stream_counts_equal_the_flop_counter(dim, frames, rows):
    spec, x = _meta_counts(dim, frames, rows)
    terms = stream_counts.stream_terms(counts.UShape(dim=dim, frames=frames), 2 * rows)
    assert (spec, x) == (terms["spec"], terms["x"])
    assert sum(terms.values()) == counts.forward_flops(counts.UShape(dim=dim, frames=frames),
                                                       2 * rows)


# ------------------------------------------------------------------ the cell

def _execute(monkeypatch=None, control=False, seconds=0.2):
    spec = bench.load_json(bench.ROOT / "BENCHMARK.json")
    cfg = _cfg(residual_channels=8, frames=32, timesteps=4)
    mix = bench.load_json(bench.HERE / "traffic" / "transcribe_unet.json")
    mix.update(recordings={"seconds_min": 3.0, "seconds_max": 6.0, "count": 3}, batch_size=2,
               overlap_frames=8, check_windows=3)
    run = bench.Run(spec, "specunet-transcribe", 2300000000123, torch.device("cpu"), cfg=cfg,
                    mix=mix)
    return bench.execute(run, seconds, False, control=control)


def test_the_program_passes_the_cells_check_and_the_bf16_control_fails_it():
    out = _execute(control=True)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"roll_rms", "notes_differ"}
    r = out["readings"]
    assert r["unet.spec_rows"] == 2 * r["windows"] > 0 and r["checked_windows"] > 0
    assert out["attempted"] % 3 == 0   # whole cycles of the mix's three recordings
    assert r["control_bf16.roll_rms"] > out["checks"]["roll_rms"]["limit"]
    assert set(out["metrics"]) == {"windows_per_s", "setup_s"}
