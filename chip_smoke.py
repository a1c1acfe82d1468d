"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device     CUDA present; the card's name and power limit (nvidia-smi)
  2. build      the kernels compiled from diffroll_tpu_torch/csrc (nvcc)
  3. ckpt       a full-width ClassifierFreeDiffRoll (512 x 15, T=200) from a
                seeded init, its zero-init output head given N(0, 0.1^2)
                weights, saved as a Lightning-style .ckpt
  4. transcribe `diffroll_tpu_torch.cli.transcribe.main` on a synthetic ~30 s
                16 kHz wav (two 640-frame windows, 200-step cfdg_ddpm_x0,
                w=0.5); launch counters reset just before, read just after
  5. k1         the gated-stack kernel vs its plain version at the flagship
                shape: max|d| / max|ref| < 0.05; a second run gives the same bits
  6. k2         the whole-process sampler vs its plain version at B=1 and at
                B=2 (the batch phase 4 gives it), 200 steps, shared noise:
                rel < 0.05; a second run gives the same bits; the step-loop
                route (use_megakernel=False, K1 per step) against the same
                plain trajectory
     Both gates hold the kernels against the plain f32 versions run on the
     kernels' own weight values (the stack weights rounded to bf16). Printed
     beside them: the error against the unrounded f32 weights, and the plain
     version on rounded weights against itself on f32 weights.
  7. k3         the training forward-with-saves kernel vs its plain version at
                (16, 640, 512) with the (16, 640, 229) conditioner: skip, xs, a
                each rel < 0.05; its skip output is K1's, bit for bit
  8. k4         the training backward kernel vs its plain version from the same
                saves and a seeded cotangent, with and without dcond: every
                output leaf rel < 0.05; the worst leaf is printed; a second
                run gives the same bits in every leaf
  9. train      `diffroll_tpu_torch.cli.train.main` at full width (512 x 15,
                B=16, task.fused_train=true) on a synthetic MAPS-layout corpus
                written here: one epoch of 3 optimizer steps, validation, the
                checkpoints. Launch counters reset just before, read just
                after: K3 and K4 once per step. Then the checkpoint `train`
                wrote is loaded, a few more steps run on one fixed batch (the
                loss must not rise), and one `task.sample` call runs on it
 10. train_grads one loss + backward at B=16 with fixed t, noise and mask,
                through K3 + K4 and through the nn.Module path under autograd on
                the bf16-rounded weights: every parameter gradient rel < 0.05,
                the losses within 1e-2 relative
 11. times      warm median times of the four kernels and their plain versions
                (K2 at B=1 and B=2; the summary line gives B=2), and of a whole
                training step at B=16 by three routes: K3 + K4, K3 + the plain
                backward, autograd through the nn.Modules (f32; and once more
                with TF32 products allowed); under `gemm`, the stack's two GEMM
                kernels alone at M = 1,280 and M = 2,560 rows (us per call,
                TFLOP/s, tiles and waves) with, as a yardstick only, one bf16
                `torch.matmul` of the same (M, K) x (K, 2C) shapes
                (`gemm_yardstick_ms`: it computes neither the taps nor the
                epilogues, and the port never calls it); and the backward's
                four products alone (`dg`, `dy`, the weight gradients `dwo`
                and `dw`) at M = 1,280 and M = 10,240 with their yardsticks
The two lines before the last are the kernel summary (JSON) and the card's
name and power limit; the last line is {"ok": true, "device": {...}}. Each
kernel's `bound_ms` is the larger of its operations over the card's published
bf16 peak and its bytes (every input read once, every output written once)
over the published memory rate; `library_ms` is null because no single
PyTorch call computes any of the four functions.
"""

from __future__ import annotations

import importlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

GATE = 0.05           # the bf16 kernels' gate (tests/test_ops.py, tests/test_sampler_kernel.py,
                      # tests/test_ops_grad.py)
SEED = 0
W_GUIDANCE = 0.5
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
TRAIN_BATCH = 16
TRAIN_STEPS = 3


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    d = float((out.float() - ref.float()).abs().max())
    return d / float(ref.abs().max()), d


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of `reps` CUDA-event timings of fn() (after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: operations / peak against bytes / rate."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def stack_flops(m: int, c: int, taps: int, mp: int, layers: int) -> float:
    """The forward's products over m rows: the gate GEMM (taps and the padded
    conditioner lanes) and the output GEMM."""
    return 2.0 * m * (taps * c + mp) * 2 * c * layers + 2.0 * m * c * 2 * c * layers


def bwd_flops(m: int, c: int, taps: int, mp: int, layers: int, dcond: bool) -> float:
    """The backward's products: dWo, dg, dWd + dWc, dy, and dcond where asked."""
    per_layer = (2.0 * m * c * 2 * c) * 2 + 2.0 * m * (taps * c + mp) * 2 * c \
        + 2.0 * m * taps * 2 * c * c + (2.0 * m * 2 * c * mp if dcond else 0.0)
    return per_layer * layers


def write_maps_corpus(root: pathlib.Path, n: int, seconds: float, sr: int, seed: int) -> None:
    """`n` recordings in the MAPS layout: 16 kHz mono wavs of seeded sine
    notes under <root>/MAPS/AkPnBcht/MUS/, each beside its tab-separated
    `OnsetTime OffsetTime MidiPitch` label file."""
    folder = root / "MAPS" / "AkPnBcht" / "MUS"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        audio = np.zeros_like(t)
        rows = ["OnsetTime\tOffsetTime\tMidiPitch"]
        for _ in range(24):
            onset = float(rng.uniform(0.0, seconds - 1.0))
            offset = onset + float(rng.uniform(0.2, 1.0))
            midi = int(rng.integers(40, 88))
            seg = (t >= onset) & (t < offset)
            audio[seg] += 0.1 * np.sin(2 * np.pi * 440.0 * 2 ** ((midi - 69) / 12) * t[seg])
            rows.append(f"{onset:.6f}\t{offset:.6f}\t{midi}")
        name = f"MAPS_MUS-synth{i:03d}_AkPnBcht"
        write_wav(folder / f"{name}.wav", audio.astype(np.float32), sr)
        (folder / f"{name}.txt").write_text("\n".join(rows) + "\n")


def leaves_of(out) -> dict:
    """The named tensors of a backward's (dx, dt_bias, dcond, dweights)."""
    dx, dtb, dcond, dw = out
    named = {"dx": dx, "dt_bias": dtb, "dcond": dcond}
    named.update({f"d{k}": v for k, v in dw._asdict().items()})
    return {k: v for k, v in named.items() if v is not None}


def worst_leaf(got: dict, want: dict) -> tuple:
    """(name, rel, abs) of the leaf that disagrees most."""
    if got.keys() != want.keys():
        raise RuntimeError(f"leaves differ: {sorted(got)} vs {sorted(want)}")
    errs = {k: rel_err(got[k], want[k]) for k in want}
    name = max(errs, key=lambda k: errs[k][0])
    return name, errs[name][0], errs[name][1]


def chord_wav(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A few seeded sine chords, one per second."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = np.zeros_like(t)
    for k in range(int(seconds)):
        seg = (t >= k) & (t < k + 0.9)
        for midi in rng.integers(40, 80, size=3):
            out[seg] += 0.1 * np.sin(2 * np.pi * 440.0 * 2 ** ((midi - 69) / 12) * t[seg])
    return out.astype(np.float32)


def write_wav(path: pathlib.Path, samples: np.ndarray, sample_rate: int) -> None:
    """Mono float [-1, 1] -> 16-bit PCM WAV."""
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port first: without it the script fails here, having printed nothing
    from diffroll_tpu_torch import models
    from diffroll_tpu_torch.cli import train as cli_train
    from diffroll_tpu_torch.cli import transcribe as cli_transcribe
    from diffroll_tpu_torch.compat import load_lightning
    from diffroll_tpu_torch.diffusion.loop import previous_timesteps, timestep_subsequence
    from diffroll_tpu_torch.ops import _build
    from diffroll_tpu_torch.ops.fused_forward import _embed
    from diffroll_tpu_torch.ops.gated_stack import (
        gated_stack, gated_stack_ref, kernel_weights, stack_weights)
    from diffroll_tpu_torch.profile_gemm import bwd_gemm_times, gemm_times
    gs_module = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")
    gt_module = importlib.import_module("diffroll_tpu_torch.ops.gated_stack_train")
    from diffroll_tpu_torch.ops.gated_stack_train import bwd, bwd_ref, fwd_saves, fwd_saves_ref
    from diffroll_tpu_torch.ops.sampler_kernel import (
        fused_sample, fused_sample_ref, head_weights, sampler_tables)
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
    from diffroll_tpu_torch.train import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions run full f32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_power()
    dev = torch.device("cuda")
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        torch.manual_seed(SEED)
        model = models.build("ClassifierFreeDiffRoll")
        torch.nn.init.normal_(model.net.output_projection.weight, std=0.1)
        mc = model.config
        ckpt = tmp / "flagship.ckpt"
        torch.save({"state_dict": model.net.state_dict(),
                    "hyper_parameters": {
                        "residual_channels": mc.residual_channels,
                        "residual_layers": mc.residual_layers,
                        "kernel_size": mc.kernel_size,
                        "dilation_base": mc.dilation_base,
                        "dilation_bound": mc.dilation_bound,
                        "timesteps": mc.timesteps,
                        "sampling": {"type": "cfdg_ddpm_x0", "w": W_GUIDANCE}}}, ckpt)
        n_params = sum(p.numel() for p in model.net.parameters())
        phase("ckpt", params=n_params, bytes=ckpt.stat().st_size)

        audio_dir = tmp / "audio"
        audio_dir.mkdir()
        sr = mc.mel.sample_rate
        write_wav(audio_dir / "chords.wav", chord_wav(30.0, sr, SEED), sr)
        gated_stack.launches = 0
        fused_sample.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_dir = cli_transcribe.main([
            f"pretrained_path={ckpt}", f"dataset.audio_path={audio_dir}",
            "dataset.audio_ext=wav", f"task.w={W_GUIDANCE}", "overlap_frames=32",
            "device=cuda", f"trainer.output_dir={tmp / 'out'}"])
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launches = {"gated_stack": gated_stack.launches, "fused_sample": fused_sample.launches}
        roll = np.load(run_dir / "000_chords.npz")["roll"]
        want_frames = math.ceil(30.0 * sr / mc.mel.hop_length)
        if roll.shape != (want_frames, mc.pitches) or not np.isfinite(roll).all():
            raise RuntimeError(f"bad roll: shape {roll.shape}, finite {np.isfinite(roll).all()}")
        if not (run_dir / "000_chords.mid").exists() or not (run_dir / "manifest.json").exists():
            raise RuntimeError("transcribe wrote no .mid / manifest.json")
        if launches["fused_sample"] < 1 or launches["gated_stack"] < 1:
            raise RuntimeError(f"the main path skipped a kernel: {launches}")
        manifest = json.loads((run_dir / "manifest.json").read_text())
        phase("transcribe", seconds=e2e, roll_shape=list(roll.shape),
              roll_range=[float(roll.min()), float(roll.max())],
              notes=manifest[0]["notes"], launches=launches)

        model, _ = load_lightning(str(ckpt), device=dev)

        # ---- train: the CLI at full width on a corpus written here
        write_maps_corpus(tmp / "data", TRAIN_BATCH * TRAIN_STEPS, 21.0, sr, SEED)
        for fn in (gated_stack, fused_sample, fwd_saves, bwd):
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = cli_train.main([
            "spec_roll", f"dataset.root={tmp / 'data'}", "task.fused_train=true",
            "device=cuda", "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
            "trainer.log_every_n_steps=1", f"dataloader.train_batch_size={TRAIN_BATCH}",
            "trainer.ema_decay=0.999", f"trainer.output_dir={tmp / 'train_out'}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = {"fwd_saves": fwd_saves.launches, "bwd": bwd.launches,
                          "gated_stack": gated_stack.launches}
        run_dirs = list((tmp / "train_out").glob("*/*/train-*"))
        if len(run_dirs) != 1:
            raise RuntimeError(f"expected one train run dir, found {run_dirs}")
        records = [json.loads(l) for l in (run_dirs[0] / "metrics.jsonl").read_text().splitlines()]
        train_losses = [r["train/diffusion_loss"] for r in records if "train/diffusion_loss" in r]
        val_losses = [r["val/diffusion_loss"] for r in records if "val/diffusion_loss" in r]
        if state.step != TRAIN_STEPS or len(train_losses) != TRAIN_STEPS or not val_losses:
            raise RuntimeError(f"train took {state.step} steps, logged {len(train_losses)} train "
                               f"and {len(val_losses)} validation losses")
        if not all(math.isfinite(v) for v in train_losses + val_losses):
            raise RuntimeError(f"non-finite loss: {train_losses} {val_losses}")
        if train_launches["fwd_saves"] != TRAIN_STEPS or train_launches["bwd"] != TRAIN_STEPS:
            raise RuntimeError(f"K3 / K4 not launched once per step: {train_launches}")
        torch.manual_seed(SEED)  # the seed the CLI initialised the weights from
        init = models.build("ClassifierFreeDiffRoll").net.state_dict()
        moved = sum(int(not torch.equal(init[k], v.cpu())) for k, v in
                    state.model.net.state_dict().items())
        if moved != len(init):
            raise RuntimeError(f"only {moved} of {len(init)} parameter tensors changed")
        last_ckpt = run_dirs[0] / "checkpoints" / "last.ckpt"
        best_ckpts = sorted((run_dirs[0] / "checkpoints").glob("step_*.ckpt"))
        if not last_ckpt.exists() or not best_ckpts:
            raise RuntimeError("train wrote no last / monitored checkpoint")
        del state

        # the checkpoint train wrote: reload, a few more steps on one fixed
        # batch through the task, then one sample call
        trained, task_updates = load_lightning(str(last_ckpt), device=dev)
        tcfg = TaskConfig(fused_train=True).replace(**task_updates)
        ttask = DiffusionTask(trained, tcfg)
        tstate = TrainState.create(trained, 1e-4)
        tgen = torch.Generator(device=dev).manual_seed(SEED + 7)
        fixed = {"frame": (torch.rand(TRAIN_BATCH, mc.frames, mc.pitches, device=dev,
                                      generator=tgen) > 0.95).float(),
                 "audio": 0.1 * torch.randn(TRAIN_BATCH, mc.frames * mc.mel.hop_length,
                                            device=dev, generator=tgen)}
        draws = dict(t=torch.randint(0, mc.timesteps, (TRAIN_BATCH,), device=dev, generator=tgen),
                     noise=torch.randn(TRAIN_BATCH, mc.frames, mc.pitches, device=dev,
                                       generator=tgen),
                     uncond_mask=torch.rand(TRAIN_BATCH, device=dev, generator=tgen) < 0.1)
        step = make_train_step(lambda b, g, train: ttask.loss_fn(b, g, train, **draws))
        fixed_losses = [float(step(tstate, fixed, tgen)["diffusion_loss"]) for _ in range(6)]
        if not all(math.isfinite(v) for v in fixed_losses) or fixed_losses[-1] > fixed_losses[0]:
            raise RuntimeError(f"the loss on a repeated batch rose: {fixed_losses}")
        trained.eval()
        x_T = torch.randn(1, mc.frames, mc.pitches, device=dev, generator=tgen)
        sampled, _ = ttask.sample(x_T, waveform=fixed["audio"][:1], generator=tgen)
        torch.cuda.synchronize()
        if sampled.shape != x_T.shape or not torch.isfinite(sampled).all():
            raise RuntimeError("sampling from the trained checkpoint gave a bad roll")
        phase("train", seconds=train_s, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
              launches=train_launches, train_losses=train_losses, val_losses=val_losses,
              params_changed=moved, checkpoints=[last_ckpt.name] + [c.name for c in best_ckpts],
              fixed_batch_losses=fixed_losses,
              sample_range=[float(sampled.min()), float(sampled.max())])
        del trained, ttask, tstate

    net = model.net
    dil = mc.dilations()
    w = stack_weights(net)
    kw = kernel_weights(w)
    # the plain versions are gated on the kernels' own weight values (the
    # stack weights rounded to bf16, as the kernels receive them), so the
    # gate measures the kernels' arithmetic; the f32-weight numbers are
    # reported beside them
    wq = w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})
    head = head_weights(net)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    with torch.no_grad():
        b, t_len, c = 2, mc.frames, mc.residual_channels
        x = torch.randn(b, t_len, c, device=dev, generator=gen)
        cond = torch.rand(b, t_len, mc.n_mels, device=dev, generator=gen)
        tb = 0.1 * torch.randn(mc.residual_layers, b, c, device=dev, generator=gen)
        k1_ref = gated_stack_ref(x, tb, cond, wq, dil)
        k1_out = gated_stack(x, tb, cond, w, dil, kweights=kw)
        k1_same_bits = torch.equal(k1_out, gated_stack(x, tb, cond, w, dil, kweights=kw))
        torch.cuda.synchronize()
        k1_rel, k1_abs = rel_err(k1_out, k1_ref)
        k1_ref32 = gated_stack_ref(x, tb, cond, w, dil)
        phase("k1", shape=[b, t_len, c], rel=k1_rel, max_abs_err=k1_abs,
              same_bits_on_rerun=k1_same_bits,
              rel_f32_weights=rel_err(k1_out, k1_ref32)[0],
              ref_rounding_rel=rel_err(k1_ref, k1_ref32)[0])
        if not (k1_rel < GATE and k1_same_bits):
            raise RuntimeError(f"K1 disagrees with its plain version (rel {k1_rel}) or with "
                               f"itself on a second run (same bits: {k1_same_bits})")

        task = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps, w=W_GUIDANCE))
        ts = timestep_subsequence(mc.timesteps, None)
        tables = torch.from_numpy(
            sampler_tables(task.schedule, "cfdg_ddpm_x0", ts, previous_timesteps(ts))).to(dev)
        t_emb = _embed(torch.from_numpy(ts.astype(np.int64)).to(dev), net.diffusion_embedding)
        t_bias = torch.einsum("ne,lec->nlc", t_emb, w.wt) + w.bt[None]
        window_s = t_len * mc.mel.hop_length / sr
        k2_abs, k2_args = 0.0, {}
        # B=1: one 20.48 s window; B=2: the batch the transcribe phase gives K2
        # (two windows, four CFG streams)
        for bk in (1, 2):
            wav = torch.stack([torch.from_numpy(chord_wav(window_s, sr, SEED + 1 + i))
                               for i in range(bk)]).to(dev)
            x_T = torch.randn(bk, t_len, mc.pitches, device=dev, generator=gen)
            noise = torch.randn((len(ts), bk, t_len, mc.pitches), device=dev, generator=gen)
            args = (x_T, noise, t_bias, tables, w, head, task.build_conditioner(x_T, wav),
                    dil, True, W_GUIDANCE, True)
            ref = fused_sample_ref(x_T, noise, t_bias, tables, wq, *args[5:])
            ref32 = fused_sample_ref(*args)
            out = fused_sample(*args, kweights=kw)
            same_bits = torch.equal(out, fused_sample(*args, kweights=kw))
            scan = DiffusionTask(model, task.config.replace(use_megakernel=False)).sample(
                x_T, waveform=wav, noise=noise)[0]
            torch.cuda.synchronize()
            rel, abs_err = rel_err(out, ref)
            scan_rel, scan_abs = rel_err(scan, ref)
            phase("k2", batch=bk, steps=len(ts), rel=rel, max_abs_err=abs_err,
                  same_bits_on_rerun=same_bits,
                  scan_rel=scan_rel, scan_max_abs_err=scan_abs,
                  rel_f32_weights=rel_err(out, ref32)[0],
                  scan_rel_f32_weights=rel_err(scan, ref32)[0],
                  # the plain version against itself: bf16-rounded vs f32 weights
                  ref_rounding_rel=rel_err(ref, ref32)[0],
                  finite=bool(torch.isfinite(out).all()))
            if not (rel < GATE and scan_rel < GATE and torch.isfinite(out).all() and same_bits):
                raise RuntimeError(f"K2 / the step loop disagree with the plain trajectory "
                                   f"at B={bk}: rel {rel}, scan rel {scan_rel}, same bits on "
                                   f"a second run: {same_bits}")
            k2_abs = max(k2_abs, abs_err)
            k2_args[bk] = args

        # ---- k3 / k4 at the training batch
        bt = TRAIN_BATCH
        x16 = torch.randn(bt, t_len, c, device=dev, generator=gen)
        cond16 = torch.rand(bt, t_len, mc.n_mels, device=dev, generator=gen)
        tb16 = 0.1 * torch.randn(mc.residual_layers, bt, c, device=dev, generator=gen)
        cot16 = torch.randn(bt, t_len, c, device=dev, generator=gen)
        skip3, xs3, a3 = fwd_saves(x16, tb16, cond16, w, dil, kweights=kw)
        skip_r, xs_r, a_r = fwd_saves_ref(x16, tb16, cond16, wq, dil)
        k1_same = torch.equal(skip3, gated_stack(x16, tb16, cond16, w, dil, kweights=kw))
        torch.cuda.synchronize()
        k3_errs = {"skip": rel_err(skip3, skip_r), "xs": rel_err(xs3, xs_r), "a": rel_err(a3, a_r)}
        phase("k3", shape=[bt, t_len, c], skip_is_k1_bitwise=k1_same,
              **{f"{k}_rel": v[0] for k, v in k3_errs.items()},
              **{f"{k}_max_abs_err": v[1] for k, v in k3_errs.items()})
        if not all(v[0] < GATE for v in k3_errs.values()) or not k1_same:
            raise RuntimeError(f"K3 disagrees with its plain version or with K1: {k3_errs}")
        k3_abs = k3_errs["skip"][1]
        del skip_r, xs_r, a_r

        saves3 = (tb16, cond16, w, xs3, a3)
        k4_abs = 0.0
        for need_dcond in (True, False):
            got = leaves_of(bwd(dil, saves3, cot16, need_dcond, kweights=kw))
            again = leaves_of(bwd(dil, saves3, cot16, need_dcond, kweights=kw))
            want = leaves_of(bwd_ref(dil, (tb16, cond16, wq, xs3, a3), cot16, need_dcond))
            torch.cuda.synchronize()
            name, rel, abs_err = worst_leaf(got, want)
            k4_same_bits = all(torch.equal(got[k], again[k]) for k in got)
            phase("k4", need_dcond=need_dcond, leaves=sorted(want), worst_leaf=name,
                  rel=rel, max_abs_err=abs_err, same_bits_on_rerun=k4_same_bits)
            if not (rel < GATE and k4_same_bits):
                raise RuntimeError(f"K4 disagrees with its plain version at {name} (rel {rel}) "
                                   f"or with itself on a second run (same bits: {k4_same_bits})")
            k4_abs = max(k4_abs, abs_err)
            del got, again, want

    # ---- train_grads: the whole loss through K3 + K4 against autograd
    batch16 = {"frame": (torch.rand(bt, t_len, mc.pitches, device=dev, generator=gen) > 0.95).float(),
               "audio": 0.1 * torch.randn(bt, t_len * mc.mel.hop_length, device=dev, generator=gen)}
    draws = dict(t=torch.randint(0, mc.timesteps, (bt,), device=dev, generator=gen),
                 noise=torch.randn(bt, t_len, mc.pitches, device=dev, generator=gen),
                 uncond_mask=torch.rand(bt, device=dev, generator=gen) < 0.1)
    rounded = models.build("ClassifierFreeDiffRoll").to(dev)
    rounded.net.load_state_dict(net.state_dict())
    with torch.no_grad():
        for layer in rounded.net.residual_layers:
            for conv in (layer.dilated_conv, layer.conditioner_projection, layer.output_projection):
                conv.weight.copy_(conv.weight.to(torch.bfloat16).float())
    model.train()
    rounded.train()
    fused_task = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps, fused_train=True))
    plain_task = DiffusionTask(rounded, TaskConfig(timesteps=mc.timesteps, fused_train=False))
    grads, loss_vals = {}, {}
    for key, tk in (("fused", fused_task), ("autograd", plain_task)):
        tk.model.net.zero_grad(set_to_none=True)
        total, _ = tk.loss_fn(batch16, None, True, **draws)
        total.backward()
        loss_vals[key] = float(total.detach())
        grads[key] = {n: p.grad.detach().clone() for n, p in tk.model.net.named_parameters()}
        tk.model.net.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    name, rel, abs_err = worst_leaf(grads["fused"], grads["autograd"])
    loss_rel = abs(loss_vals["fused"] - loss_vals["autograd"]) / abs(loss_vals["autograd"])
    phase("train_grads", batch=bt, leaves=len(grads["autograd"]), worst_leaf=name, rel=rel,
          max_abs_err=abs_err, loss_fused=loss_vals["fused"],
          loss_autograd=loss_vals["autograd"], loss_rel=loss_rel)
    if not (rel < GATE and loss_rel < 1e-2):
        raise RuntimeError(f"the fused training loss or its gradients disagree with autograd: "
                           f"{name} rel {rel}, loss rel {loss_rel}")
    del grads, rounded, plain_task

    def step_ms(impl, fused):
        """A whole training step at B=16 on the fixed batch: loss, backward, Adam."""
        tk = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps, fused_train=fused))
        st = TrainState.create(model, 1e-6)
        step = make_train_step(lambda b, g, train: tk.loss_fn(b, g, train, impl=impl, **draws))
        return time_ms(lambda: step(st, batch16, None), 5, 2)

    step_times = {"step_k3_k4_ms": step_ms("cuda", True),
                  "step_k3_plain_bwd_ms": step_ms("cuda_fwd", True),
                  "step_autograd_ms": step_ms(None, False)}
    # the same autograd step with TF32 products allowed, as a user who does not
    # ask for full f32 would run it; every other phase keeps TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    step_times["step_autograd_tf32_ms"] = step_ms(None, False)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model.eval()

    with torch.no_grad():
        times = {
            "k1_ms": time_ms(lambda: gated_stack(x, tb, cond, w, dil, kweights=kw), 20, 3),
            "k1_plain_ms": time_ms(lambda: gated_stack_ref(x, tb, cond, w, dil), 5),
            "k3_ms": time_ms(lambda: fwd_saves(x16, tb16, cond16, w, dil, kweights=kw), 10, 2),
            "k3_plain_ms": time_ms(lambda: fwd_saves_ref(x16, tb16, cond16, w, dil), 3),
            "k4_ms": time_ms(lambda: bwd(dil, saves3, cot16, False, kweights=kw), 10, 2),
            "k4_dcond_ms": time_ms(lambda: bwd(dil, saves3, cot16, True, kweights=kw), 5, 1),
            "k4_plain_ms": time_ms(lambda: bwd_ref(dil, saves3, cot16, False), 3),
            **step_times,
        }
        for bk, args in k2_args.items():
            times[f"k2_b{bk}_ms"] = time_ms(lambda: fused_sample(*args, kweights=kw), 3)
            times[f"k2_b{bk}_plain_ms"] = time_ms(lambda: fused_sample_ref(*args), 3)
        # the stack's two GEMM kernels alone, M = 1,280 (one clip's two
        # guidance streams) and M = 2,560 rows, beside a matmul yardstick
        gemm = {}
        for seqs in (2, 4):
            xg = torch.randn(seqs, t_len, c, device=dev, generator=gen)
            tbg = 0.1 * torch.randn(mc.residual_layers, seqs, c, device=dev, generator=gen)
            gemm[f"m{seqs * t_len}"] = gemm_times(gs_module, xg, tbg, w, kw, dil)
        # the backward's four products alone, one clip's rows and the training batch's
        for xb, tbb, condb in ((x, tb, cond), (x16, tb16, cond16)):
            gemm[f"bwd_m{xb.shape[0] * t_len}"] = bwd_gemm_times(
                gt_module, xb, tbb, condb, w, kw, dil)
        phase("times", card=card, **times, gemm=gemm)

    # ---- bounds, from this run's inputs: each input read once, each output
    # written once, against the products each function does
    L, taps, mp = mc.residual_layers, kw.taps, kw.mp
    w_bytes = nbytes(kw.wcat, kw.wo, kw.b_eff, kw.bo)
    bounds = {"k1": bound(stack_flops(b * t_len, c, taps, mp, L),
                          nbytes(x, tb, cond, k1_out) + w_bytes)}
    for bk, key in ((2, "k2"), (1, "k2_b1")):  # the summary line gives B=2
        x_Tk, noisek, condk = k2_args[bk][0], k2_args[bk][1], k2_args[bk][6]
        rows = 2 * bk * t_len  # both guidance streams
        head_flops = 2.0 * rows * (mc.pitches * c + c * c + c * mc.pitches)
        # the conditioner's lanes are projected once per clip for all layers;
        # each step's gate GEMM contracts over the taps only
        cond_proj_flops = 2.0 * rows * mp * 2 * c * L
        bounds[key] = bound(
            len(ts) * (stack_flops(rows, c, taps, 0, L) + head_flops) + cond_proj_flops,
            nbytes(x_Tk, noisek, t_bias, tables, condk, x_Tk, *head) + w_bytes)
    bounds["k3"] = bound(stack_flops(bt * t_len, c, taps, mp, L),
                         nbytes(x16, tb16, cond16, skip3, xs3, a3) + w_bytes)
    dw_bytes = 4 * (kw.wcat.numel() + kw.wo.numel() + 2 * kw.bo.numel())
    bounds["k4"] = bound(bwd_flops(bt * t_len, c, taps, mp, L, False),
                         nbytes(xs3, a3, cond16, tb16, cot16, cot16, tb16)
                         + nbytes(kw.wcat, kw.wo) + dw_bytes)
    phase("bounds", peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
          peak_tbytes_per_s=PEAK_BYTES_PER_S / 1e12, **bounds)

    def row(key, name, source, replaces, n_launch, abs_err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[key]["bound_ms"], "bound_by": bounds[key]["bound_by"],
                "library_ms": None}

    train_src = "diffroll_tpu_torch/csrc/gated_stack_train.cu"
    print(json.dumps({"kernels": [
        row("k1", "gated_stack", "diffroll_tpu_torch/csrc/gated_stack.cu",
            "diffroll_tpu/ops/gated_stack.py:290", launches["gated_stack"], k1_abs,
            times["k1_ms"], times["k1_plain_ms"]),
        row("k2", "fused_sample", "diffroll_tpu_torch/csrc/sampler.cu",
            "diffroll_tpu/ops/sampler_kernel.py:385", launches["fused_sample"], k2_abs,
            times["k2_b2_ms"], times["k2_b2_plain_ms"]),
        row("k3", "fwd_saves", train_src, "diffroll_tpu/ops/gated_stack_train.py:49",
            train_launches["fwd_saves"], k3_abs, times["k3_ms"], times["k3_plain_ms"]),
        row("k4", "bwd", train_src, "diffroll_tpu/ops/gated_stack_train.py:388",
            train_launches["bwd"], k4_abs, times["k4_ms"], times["k4_plain_ms"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
