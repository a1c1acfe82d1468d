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
                shape: max|d| / max|ref| < 0.05
  6. k2         the whole-process sampler vs its plain version at B=1 and at
                B=2 (the batch phase 4 gives it), 200 steps, shared noise:
                rel < 0.05; the step-loop route (use_megakernel=False, K1
                per step) against the same plain trajectory
     Both gates hold the kernels against the plain f32 versions run on the
     kernels' own weight values (the stack weights rounded to bf16). Printed
     beside them: the error against the unrounded f32 weights, and the plain
     version on rounded weights against itself on f32 weights.
  7. times      warm median times of both kernels and their plain versions
                (K2 at B=1 and B=2; the summary line gives B=2)
The two lines before the last are the kernel summary (JSON) and the card's
name and power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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

GATE = 0.05           # the bf16 kernels' gate (tests/test_ops.py, tests/test_sampler_kernel.py)
SEED = 0
W_GUIDANCE = 0.5


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
    from diffroll_tpu_torch.cli import transcribe as cli_transcribe
    from diffroll_tpu_torch.compat import load_lightning
    from diffroll_tpu_torch.diffusion.loop import previous_timesteps, timestep_subsequence
    from diffroll_tpu_torch.ops import _build
    from diffroll_tpu_torch.ops.fused_forward import _embed
    from diffroll_tpu_torch.ops.gated_stack import (
        gated_stack, gated_stack_ref, kernel_weights, stack_weights)
    from diffroll_tpu_torch.ops.sampler_kernel import (
        fused_sample, fused_sample_ref, head_weights, sampler_tables)
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig

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
        torch.cuda.synchronize()
        k1_rel, k1_abs = rel_err(k1_out, k1_ref)
        k1_ref32 = gated_stack_ref(x, tb, cond, w, dil)
        phase("k1", shape=[b, t_len, c], rel=k1_rel, max_abs_err=k1_abs,
              rel_f32_weights=rel_err(k1_out, k1_ref32)[0],
              ref_rounding_rel=rel_err(k1_ref, k1_ref32)[0])
        if not k1_rel < GATE:
            raise RuntimeError(f"K1 disagrees with its plain version: rel {k1_rel}")

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
            scan = DiffusionTask(model, task.config.replace(use_megakernel=False)).sample(
                x_T, waveform=wav, noise=noise)[0]
            torch.cuda.synchronize()
            rel, abs_err = rel_err(out, ref)
            scan_rel, scan_abs = rel_err(scan, ref)
            phase("k2", batch=bk, steps=len(ts), rel=rel, max_abs_err=abs_err,
                  scan_rel=scan_rel, scan_max_abs_err=scan_abs,
                  rel_f32_weights=rel_err(out, ref32)[0],
                  scan_rel_f32_weights=rel_err(scan, ref32)[0],
                  # the plain version against itself: bf16-rounded vs f32 weights
                  ref_rounding_rel=rel_err(ref, ref32)[0],
                  finite=bool(torch.isfinite(out).all()))
            if not (rel < GATE and scan_rel < GATE and torch.isfinite(out).all()):
                raise RuntimeError(f"K2 / the step loop disagree with the plain trajectory "
                                   f"at B={bk}: rel {rel}, scan rel {scan_rel}")
            k2_abs = max(k2_abs, abs_err)
            k2_args[bk] = args

        times = {
            "k1_ms": time_ms(lambda: gated_stack(x, tb, cond, w, dil, kweights=kw), 20, 3),
            "k1_plain_ms": time_ms(lambda: gated_stack_ref(x, tb, cond, w, dil), 5),
        }
        for bk, args in k2_args.items():
            times[f"k2_b{bk}_ms"] = time_ms(lambda: fused_sample(*args, kweights=kw), 3)
            times[f"k2_b{bk}_plain_ms"] = time_ms(lambda: fused_sample_ref(*args), 3)
        phase("times", card=card, **times)

    print(json.dumps({"kernels": [
        {"name": "gated_stack", "route": "cuda",
         "source": "diffroll_tpu_torch/csrc/gated_stack.cu",
         "replaces": "diffroll_tpu/ops/gated_stack.py:290",
         "launches": launches["gated_stack"], "max_abs_err": k1_abs,
         "ms": times["k1_ms"], "plain_ms": times["k1_plain_ms"]},
        {"name": "fused_sample", "route": "cuda",
         "source": "diffroll_tpu_torch/csrc/sampler.cu",
         "replaces": "diffroll_tpu/ops/sampler_kernel.py:385",
         "launches": launches["fused_sample"], "max_abs_err": k2_abs,
         "ms": times["k2_b2_ms"], "plain_ms": times["k2_b2_plain_ms"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
