"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, in the order they run (each prints one line; any failure raises and
exits non-zero):
  1. device     CUDA present; the card's name and power limit (nvidia-smi)
  2. build      the kernels compiled from diffroll_tpu_torch/csrc (nvcc)
  3. ckpt       a full-width ClassifierFreeDiffRoll (512 x 15, T=200) from a
                seeded init, its zero-init output head given N(0, 0.1^2)
                weights, saved as a Lightning-style .ckpt
  4. transcribe `diffroll_tpu_torch.cli.transcribe.main` on a synthetic ~30 s
                16 kHz wav (two 640-frame windows, 200-step cfdg_ddpm_x0,
                w=0.5); launch counters reset just before, read just after
  5. train      `diffroll_tpu_torch.cli.train.main` at full width (512 x 15,
                B=16, task.fused_train=true) on a synthetic MAPS-layout corpus
                written here (48 train recordings, and 4 test recordings of
                21 s: 8 windows): one epoch of 3 optimizer steps, validation,
                the checkpoints, then the test split on the EMA weights: it
                must write test_metrics.json. Launch counters reset just
                before, read just after: K3 and K4 once per step. Then the
                checkpoint `train` wrote is loaded, a few more steps run on one
                fixed batch (the loss must not rise), and one `task.sample`
                call runs on it
  6. test       `diffroll_tpu_torch.cli.test.main` on that checkpoint over the
                test split: one batch of 8 windows, so K2 once at B=8 (and K1
                200 times inside it); n_clips must be 4 and the metrics
                finite (the F1 of a random model is printed, not gated);
                seconds per test batch
  7. sample     `diffroll_tpu_torch.cli.sample.main` in inpainting_ddpm_x0
                (task.inpainting_t=[100,200], the test split) and in
                generation_ddpm_x0, num_samples=2 each: the manifest, npz
                with the 20-snapshot trajectory and MIDI must exist, K1 must
                launch 200 times per batch (8 windows: 16 guided sequences;
                8 unguided) and K2 not at all; whether the GIF was written
  8. serve      the service `python -m diffroll_tpu_torch serve` builds from
                that checkpoint with the ServeConfig defaults (max_batch=8,
                max_wait_ms=25, int16 transfer, pipeline depth 2), warmed up,
                behind the HTTP front on a free localhost port: /healthz and
                8 concurrent 20 s requests (one window each) must each return
                a roll of the right length in fewer batches than windows, K2
                launched once per batch; then a burst of 32 concurrent such
                requests for windows per second (B=8 clips/s) and the mean
                batch wall time, each stage's mean a batch and the compute
                time of a batch (sum_compute_s, by CUDA events). The same
                again with max_wait_ms=100, as a labelled comparison
  9. distill    `diffroll_tpu_torch.cli.distill.main` on the checkpoint phase 5
                wrote, over its corpus, at full width (B=16,
                task.fused_train=true, distill.start_steps=9 distill.stages=2
                distill.steps_per_stage=3): stage 1 folds CFG (w=0.5) into a
                9-step student, stage 2 distils it to 5 steps. Launch counters
                reset just before, read just after: K1 twice a step (the
                guided teacher as one forward of 32 sequences), K3 and K4
                once; the logged losses finite; both stage checkpoints
                written. Then `cli.test.main` on each student (ddim_x0, its
                steps, w=0): one test batch of 8 windows, K2 once, finite
                metrics. Then one distill step's ms by CUDA events (median of
                5), guided (9 steps) and unguided (5)
 10. baseline   `diffroll_tpu_torch.cli.train.main baseline` at full width
                (DiffRollBaseline: 512 x 15, kernel 7, dilation 1) for 3 steps
                through the nn.Modules, then its test split (the 200-step walk
                at B=8); no kernel launched. Then one of its training steps at
                B=16 and the walk at B=8 by CUDA events
 11. trainable  `cli.train.main spec_roll model.condition=trainable_spec` (and then
                `trainable_z`) at full width (512 x 15, B=16, task.fused_train=true,
                which still launches no kernel: `supports_fused` admits only the
                fixed conditioning) on the train recordings alone (no post-fit
                test): 3 steps, validation with the val_hook's figures (or its one
                stderr line without matplotlib: the heatmap of the learned
                substitute), the checkpoint; then `cli.transcribe.main` on one
                20.48 s window (200-step cfdg_ddpm_x0, w=0.5) through the modules
 12. v2         the same for DiffRollv2 (16 x 30, task.timesteps=500, the
                preset's): 3 steps, then one window of 500 guided steps
 13. unet       `cli.train.main pianoroll dataset.name=MAPS` (dim 28, epsilon
                objective, huber): 3 steps; then `cli.infer.main num_samples=2`
                (200 ddpm steps): npz with the trajectory, MIDI and manifest.json
 14. spec_unet  `cli.train.main spec_roll model_name=SpecUnet`: 3 steps and the
                post-fit test over one 10 s test recording (one window), which
                must write test_metrics.json
     Each of 11-14 prints one line: the wall times (the sampling entry's
     over the whole process), a training step at B=16 by CUDA events (median
     of 3 after a warm-up, on a fixed batch), the ms a reverse step takes by
     events (its sampling entry's process, strided to 50 steps), the run's
     peak memory (max_memory_allocated) and the K1-K4 launch counts, all zero
 15. variants_hold the six new configurations (trainable_spec, trainable_z,
                DiffRollv2, DiffRollv2Debug, Unet, SpecUnet) at their published
                widths: the same module on the CPU and on the card on the same
                seeded weights, two windows (the second row unconditional):
                forward max|d| / max|ref| < 1e-3, every parameter gradient of a
                training loss < 2e-3, the loss within 1e-4 relative; the worst
                leaf is printed
 16. bf16       `model.dtype=bfloat16` at the flagship's widths through the modules
                (512 x 15, B=16, task.fused_train=false; no kernel covers the bf16
                modules): one training step by CUDA events (the median of 3 after a
                warm-up) in f32 with TF32 off, with TF32, and in bf16; on the same
                seeded weights, batch and draws the bf16 loss within 1e-2 relative
                of f32 and every parameter gradient max|d| / max|ref| < 0.05, the
                worst above 1e-3 (bf16 differs from f32), a block's outputs bf16
                (the cosine of the whole gradient printed beside). Then `cli.train.main
                spec_roll model.condition=trainable_spec model.dtype=bfloat16
                trainer.adam_moments_dtype=bfloat16` on the train recordings: 3
                steps, finite losses, bf16 moments (their bytes against f32's); then
                `cli.transcribe.main` on one 20.48 s window of that checkpoint, and
                a strided 50-step process by events in bf16 and in f32 on the same
                draws: ms a step each and the trajectory's error (not gated: a
                random model amplifies bf16 rounding, ROADMAP Queue 3)
 17. dp         the data axis. Two ranks share the one card in a gloo group (NCCL
                refuses two ranks on one GPU), each a process of this script
                (`--dp-worker`): `cli.train.main spec_roll task.fused_train=true`
                at global B=16 for 3 steps on phase 5's corpus (8 rows a rank; K3 and
                K4 once a step on each rank; both ranks end with the same parameter
                bits; one run directory, rank 0's); one fixed-draw step against
                the single-process step at B=16 (every gradient rel < 0.05 through
                K3 + K4, < 1e-4 through the f32 modules); `cli.test.main` on phase
                5's checkpoint (n_clips 4, K2 once a rank at B=4, the rolls rank 0
                gathered within rel 0.05 of the single-process test's, its 8 rows
                distinct, each row's error printed, and every metric within 1e-3);
                one `distill` stage (K1 twice and K3, K4 once a step on each rank;
                rank 0 alone writes). Then one
                process at world size 1 over NCCL, in the environment `torchrun
                --nproc_per_node=1` sets (`--nccl-worker`): `train`, 3 steps. The
                2-rank step's ms is printed under the label "2 ranks sharing one
                card: not a scaling figure". Steps and stages are cut, not widths
 18. mp         the model axis, data=1 x model=2: two ranks share the one card in a
                gloo group (`--mesh-worker mp`): `cli.train.main spec_roll
                task.fused_train=true trainer.model_axis=2` at B=16 for 3 steps on
                phase 5's corpus (K3 and K4 once a step on each rank; both ranks'
                gathered parameters the same bits; each rank's parameter and moment
                bytes beside one process's and the JAX rule's share, which they must
                equal); one fixed-draw step against the single-process step (every
                gradient rel < 0.05 through K3 + K4, < 1e-4 through the column-
                parallel f32 modules); the model_axis=2 checkpoint loaded by one
                process, which runs `transcribe` of one window through K2; one
                `distill` stage (K1 twice and K3, K4 once a step on each rank)
 19. serve_mesh the service `serve` builds over the data axis (data=2, `max_batch` 8:
                4 rows a rank, K2 once a batch on each rank): two requests through
                rank 0's `transcribe` (8 windows, then 1) against a one-process
                service with the same seed and the same batches (rel < 0.05, each
                window's error printed); 8 concurrent 20 s requests through rank
                0's HTTP front (the right length each, fewer batches than
                requests), then a burst of 32 for windows per second; then the
                same two requests through the service at data=1 x model=2 (each
                rank's parameter bytes below one process's, K2 once a batch on each
                rank on the gathered weights; rel < 0.05 against one process)
 20. sp         sequence parallelism, data=2: the flagship's 640-frame window split
                320 + 320 (halo at most 8), `sequence_parallel_forward` of (2, 640)
                against the single-process modules forward (rel < 1e-4, f32, TF32
                off) and a strided 20-step `sample_sequence_parallel` against the
                dense modules sampler on the same draws (rel < 1e-3); no kernel
     The times of 17-20 are printed under the label "2 ranks sharing one card:
     not a scaling figure". Steps and stages are cut, not widths
 21. learn      the quality evidence (diffroll_tpu_torch/quality) on the twin of
                the flagship (128 x 8, 128 frames, T=100, B=8). First K3 and K4 at
                the shape of its training steps ((8, 128, 128), dilations 1-2-4-8,
                one row tile a sequence) against their plain versions on the
                kernels' bf16-rounded weights: K3's skip K1's bit for bit, skip /
                xs / a and every K4 leaf (with and without dcond) rel < 0.05, the
                same bits on a second run; the worst K4 leaf printed (these
                launches are not counted). (a) the learning
                check at the JAX script's defaults (2000 steps on 64 v2 clips,
                scored on 8 held-out clips by cfdg_ddpm_x0 w=0.5, `sweep_steps=1`)
                over seeds (seed s: the weights drawn after torch.manual_seed(s),
                the training stream seeded s + 1), 0-5 through K3 + K4 and 0-2
                through autograd (f32, TF32 off) from the same inits and draws,
                each run also scored by cfdg_ddim_x0 at 25 steps. Each run: the
                loss at steps 0, 1000, 1999 (the last below half the first), the
                25-step frame F1 within 0.05 of the dense score, finite metrics,
                K3 and K4 2000 times on the fused route and 0 on the other, K2 10
                times. Each route's mean over its seeds: note F1 >= 0.40 and
                frame F1 >= 0.60. Printed: every seed's F1s, each route's mean
                and sd, the routes' difference on each shared seed, the JAX
                script's six-seed frame F1 (a reference, not a gate). (b) a MAPS-layout
                tree (32 + 8 recordings of 4.096 s), `cli.train.main spec_roll` at
                the twin's widths (~1000 steps at B=8, K3 + K4), then on its
                checkpoint `eval_inpainting` (mask=48,80 and fmask=29,51: K2 3
                times each; `scored_step`, the step of the weights it scored,
                must be the run's last), `eval_longform` (60 s, cut from 180: K2 5 times) and
                `eval_boundary` (steps=1000 n_train=64 n_long=2, cut from 4000,
                128, 8: K3 + K4 1000 times, K2 4): finite metrics. (c) the
                trained twin of (a)'s fused seed 0, 100 guided steps at B=1 and B=8
                by K2 and by the step loop, against the plain version on the same
                bf16-rounded weights (< 0.05) and on f32 weights (printed, not
                gated). The cuts are listed under `reduced`
 22. paper      `quality.pretrain_both_pipeline smoke` (the paper's recipe:
                unconditional pretraining, the dual-loss retrain, a w-sweep,
                guided distillation and the student's test) at the smallest
                width the kernels take (128 channels) and 128 frames, the
                smoke's 2 layers, T=4, corpora and steps. First every kernel
                at the shapes the pipeline gives it, on random weights, against
                its plain version on the bf16-rounded weights (< 0.05, the same
                bits on a second run; `kernels_held`): K3 + K4 at B=8, K1 at
                the guided teacher's 16 sequences, K2 over the w-sweep's guided
                4-step process and the 2-step one-stream student at B=8. Then
                each stage's wall seconds, the step of each checkpoint a later
                stage started from (`stage_steps`), K1-K4 each launched at least once (K3 as often as K4)
                with the counters reset just before and read just after, finite
                metrics, and the native host library on its C++ tier where the
                host has g++
 23. k1         the gated-stack kernel vs its plain version at the flagship
                shape: max|d| / max|ref| < 0.05; a second run gives the same bits
 24. k2         the whole-process sampler vs its plain version at B=1 and at
                B=2 (the batch phase 4 gives it), 200 steps, shared noise:
                rel < 0.05; a second run gives the same bits; the step-loop
                route (use_megakernel=False, K1 per step) against the same
                plain trajectory, and a second loop for the same bits
 25. k2_b8      the same at B=8 (the test and serving batch: 10,240 rows in
                each stream), guided, w=0.5: rel < 0.05, the same bits; the
                step loop there is the sample path's inpainting batch (K1 on
                16 sequences), held the same way
 26. k2_gen     the same at B=1 for generation_ddpm_x0 (one stream, S=1,
                spec := -1)
 27. k2_ddim    the same at B=2 for cfdg_ddim_x0 (50 steps, no noise)
 28. k1_uncond  generation_ddpm_x0 at B=2 and at B=8 (the sample path's
                generation batch: K1 on 8 sequences): K2 and the step loop
                (K1 per step) against the plain trajectory, each rel < 0.05
                and the same bits on a second run
 29. k2_student K2 as `test` runs a distilled student: B=8, ddim_x0, one
                stream (unguided, w=0), no noise, at 9 and at 5 steps: rel <
                0.05 and the same bits on a second run
     The k gates hold the kernels against the plain f32 versions run on the
     kernels' own weight values (the stack weights rounded to bf16). Printed
     beside them in phase 24: the error against the unrounded f32 weights,
     and the plain version on rounded weights against itself on f32 weights.
 30. k3         the training forward-with-saves kernel vs its plain version at
                (16, 640, 512) with the (16, 640, 229) conditioner: skip, xs, a
                each rel < 0.05; its skip output is K1's, bit for bit
 31. k1_s32     K1 as the guided teacher of a distill step runs it: (32, 640,
                512), the conditional rows then spec := -1: rel < 0.05 and the
                same bits on a second run
 32. k4         the training backward kernel vs its plain version from the same
                saves and a seeded cotangent, with and without dcond: every
                output leaf rel < 0.05; the worst leaf is printed; a second
                run gives the same bits in every leaf
 33. train_grads one loss + backward at B=16 with fixed t, noise and mask,
                through K3 + K4 and through the nn.Module path under autograd on
                the bf16-rounded weights: every parameter gradient rel < 0.05,
                the losses within 1e-2 relative
 34. distill_grads one guided distill loss + backward at B=16 with fixed
                transitions and noise: the teacher through K1 and the student
                through K3 + K4, against both through the nn.Modules on the
                bf16-rounded weights: every student gradient rel < 0.05, the
                losses within 1e-2 relative
 35. times      warm median times of the four kernels and their plain versions
                (K1 also at S=32; K2 at B=1, B=2 and B=8, and on the 9- and
                5-step students at B=8; the summary line gives B=2, and B=8
                under `*_b8`), of a whole training step at B=16 by two
                routes: K3 + K4, autograd through the nn.Modules (f32; and
                once more with TF32 products allowed), and of phase 9's
                distill steps; `hidden_epilogue_share`: for K1, K1 at S=32,
                K3 and K2 at each batch, the share of forward GEMM tiles
                whose epilogue runs under the other consumer warpgroup's k
                loop, from `pass_tiles` at the shapes they ran on this card's
                SMs;
                under `gemm`, the stack's two GEMM kernels alone at M = 1,280
                and M = 2,560 rows (us per call, TFLOP/s, tiles and waves)
                with, as a yardstick only, one bf16 `torch.matmul` of the same
                (M, K) x (K, 2C) shapes (`gemm_yardstick_ms`: it computes
                neither the taps nor the epilogues, and the port never calls
                it); and the backward's four products alone (`dg`, `dy`, the
                weight gradients `dwo` and `dw`) at M = 1,280 and M = 10,240
                with their yardsticks; under `group_norm`, the U-Nets'
                GroupNorm (ops/group_norm.py) at B=16, each distinct shape of
                SpecUnet's forward norms and of the 8-group ResNet-block
                norms: y, dx, dgamma and dbeta against F.group_norm in f64
                on the same inputs (max|d| / max|ref| < 1e-5, `failed` the
                shapes over it; the phase fails on any), its forward and
                backward beside F.group_norm's (device time, by CUDA graph
                replay), and `slower`, the shapes where either is slower
                than PyTorch's; under `depthwise_conv`, the same for the
                U-Nets' depthwise 7x7 conv (ops/depthwise_conv.py) at B=16,
                each distinct shape of SpecUnet's and UnetNet's forward
                depthwise convs: y, dx, dw and db against F.conv2d in f64
                (the phase fails on any shape at or over 1e-5), forward and
                backward beside F.conv2d's, each pass's bytes bound
The two lines before the last are the kernel summary (JSON) and the card's
name and power limit; the last line is {"ok": true, "device": {...}}. Each
kernel's `bound_ms` is the larger of its operations over the card's published
bf16 peak and its bytes (every input read once, every output written once)
over the published memory rate; `library_ms` is null because no single
PyTorch call computes any of the four TPU kernels' functions. A kernel's
`launches` is its count on its first path, transcribe for K1 and K2, train
for K3 and K4, spec_unet for group_norm (the U-Nets' GroupNorm,
csrc/group_norm.cu: it replaces no TPU kernel; its `ms`, `library_ms` and
bounds are its forward's at the largest SpecUnet norm at B=16, `_bwd` its
backward's, `library_ms` F.group_norm's, which is also the plain version the
CPU takes; its `max_abs_err` is the largest of y's against F.group_norm in
f64 over every shape of phase times, `max_rel_err` the largest of y, dx,
dgamma and dbeta) and for depthwise_conv (the U-Nets' depthwise 7x7 conv,
csrc/depthwise_conv.cu, likewise: no TPU kernel, its forward and backward at
the largest shape, F.conv2d as both library call and plain version, y, dx,
dw and db against F.conv2d in f64);
`launches_by_path` gives the count of each user-facing path that the script
drives with the counters reset just before and read just after (transcribe,
train, test, sample, serve, distill, distill_test: the students' test runs,
baseline, trainable, v2, unet, spec_unet and bf16, each 0 of K1-K4, unet
and spec_unet one group_norm a forward norm and one depthwise_conv a forward
depthwise conv, the rest 0 of both,
dp_train, dp_test and dp_distill: rank 0's counts in phase dp, mp_train and
mp_distill: rank 0's in phase mp, serve_mesh and sp: rank 0's, sp 0 of every
kernel; learn_fused and learn_autograd: the learning check's two routes
(seed 0's run; every seed's run is gated on the same counts),
learn_cli_train, eval_inpainting_mask, eval_inpainting_fmask, eval_longform
and eval_boundary: phase learn's tools; paper: the whole pipeline of phase
paper).
K1's `max_abs_err` is its single pass's; `max_abs_err_step_loop` is the
largest of its step loops' 200-step trajectories against the plain ones.
"""

from __future__ import annotations

import copy
import importlib
import io
import json
import math
import os
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
TEST_RECORDINGS = 4   # of 21 s: two 640-frame windows each, one test batch of 8
SERVE_BATCH = 8       # serve.max_batch's default, and dataloader.test_batch_size's
STEPS = 200
DISTILL_STAGES = (9, 5)   # distill.start_steps=9 distill.stages=2: CFG folded into the first
DISTILL_STEPS = 3         # optimizer steps per stage
TIMED_STEPS = 50          # the new families' reverse process by events: a strided part


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


# every distinct (C, H, W, groups) of SpecUnet's 63 forward norms at its
# published widths, and the 8-group norms of UnetNet(dim=32, use_convnext=False)
GROUP_NORM_SHAPES = [(18, 640, 88, 1), (28, 320, 44, 1), (28, 640, 88, 1), (56, 160, 22, 1),
                     (56, 320, 44, 1), (56, 640, 88, 1), (112, 160, 22, 1), (112, 320, 44, 1),
                     (168, 320, 44, 1), (224, 160, 22, 1), (336, 160, 22, 1), (32, 320, 44, 8),
                     (32, 640, 88, 8), (64, 160, 22, 8), (64, 320, 44, 8), (128, 160, 22, 8)]


def graph_ms(fn, reps: int = 20) -> float:
    """Median device ms of fn() captured once in a CUDA graph and replayed
    (warmed up on a side stream first): the launches' host cost left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps, 2)


def hold_and_time(port, aten, leaves, dy, names, gate: float) -> dict:
    """One shape's row, on the same inputs: `port(*leaves)` and its gradients
    held against `aten`'s in f64 (`<name>_rel`: max|d| / max|ref|, and
    `<name>_max_abs_err`, for the output and each leaf's gradient; `failed`
    where any is at or over `gate`), then both routes' forward and backward
    in f32, device ms by CUDA graph replay (the backward: a graph of forward
    and `torch.autograd.grad` less the forward's); `slower` where either pass
    of the port's is slower than PyTorch's. Grad is on inside, also under
    phase times' no_grad."""
    with torch.enable_grad():
        y = port(*leaves)
        got = (y, *torch.autograd.grad(y, leaves, dy))
        ref = [t.detach().double().requires_grad_() for t in leaves]
        y64 = aten(*ref)
        want = (y64, *torch.autograd.grad(y64, ref, dy.double()))
    row = {}
    for key, a, b in zip(names, got, want):
        d = float((a.detach().double() - b.detach()).abs().max())
        row[f"{key}_rel"] = d / float(b.detach().abs().max())
        row[f"{key}_max_abs_err"] = d
    del got, y, ref, y64, want
    for key, fn in (("port", port), ("aten", aten)):
        with torch.enable_grad():
            fwd = graph_ms(lambda: fn(*leaves))
            both = graph_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, dy))
        row[f"fwd_{key}_ms"], row[f"bwd_{key}_ms"] = fwd, both - fwd
    row["failed"] = max(row[f"{k}_rel"] for k in names) >= gate
    row["slower"] = row["fwd_port_ms"] > row["fwd_aten_ms"] or \
        row["bwd_port_ms"] > row["bwd_aten_ms"]
    return row


def times_summary(rows: dict, names, batch: int, gate: float, largest: dict) -> dict:
    """A kernel pair's per-shape rows with the shapes `failed` and `slower`,
    and the largest errors: `max_abs_err` the output's, `max_rel_err` any
    of `names`'."""
    return {"batch": batch, "gate": gate, "shapes": rows,
            "failed": [k for k, r in rows.items() if r["failed"]],
            "slower": [k for k, r in rows.items() if r["slower"]], "largest": largest,
            "max_abs_err": max(r[f"{names[0]}_max_abs_err"] for r in rows.values()),
            "max_rel_err": max(r[f"{k}_rel"] for r in rows.values() for k in names)}


GN_GATE = 1e-5   # GroupNorm against F.group_norm in f64, as tests/test_torch_kernels_gpu.py
GN_OPS = 7       # operations a value, forward or backward: f32, far below the bytes' time


def group_norm_times(dev, batch: int = 16) -> dict:
    """Per shape, at `batch` rows: the port's GroupNorm (ops/group_norm.py)
    against F.group_norm (`hold_and_time`: y, dx, dgamma, dbeta in f64 under
    GN_GATE, both routes' device ms); and `largest`, the shape with the most
    values, with its bytes bounds from the run's tensors."""
    from diffroll_tpu_torch.ops import group_norm as gn

    F = torch.nn.functional
    names = ("y", "dx", "dgamma", "dbeta")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out, largest = {}, None
    for c, h, w, groups in GROUP_NORM_SHAPES:
        x = (0.5 + 2.0 * torch.randn(batch, c, h, w, device=dev, generator=gen)).requires_grad_()
        weight = (1.0 + 0.05 * torch.randn(c, device=dev, generator=gen)).requires_grad_()
        bias = (0.1 * torch.randn(c, device=dev, generator=gen)).requires_grad_()
        dy = torch.randn(batch, c, h, w, device=dev, generator=gen)
        row = hold_and_time(lambda x, w, b: gn.group_norm(x, groups, w, b, 1e-6),
                            lambda x, w, b: F.group_norm(x, groups, w, b, 1e-6),
                            (x, weight, bias), dy, names, GN_GATE)
        row["bytes_bound_ms"] = 1e3 * 2 * x.numel() * 4 / PEAK_BYTES_PER_S
        name = f"{c}x{h}x{w}_g{groups}"
        out[name] = row
        if largest is None or x.numel() > largest["values"]:
            # forward: x, gamma, beta read, y written; backward: dy, x, gamma,
            # mean, rstd read, dx, dgamma, dbeta written
            stats = 2 * batch * groups * 4
            largest = {"shape": [batch, c, h, w], "groups": groups, "name": name,
                       "values": x.numel(),
                       "bound": bound(GN_OPS * x.numel(), 2 * nbytes(x, weight) + nbytes(bias)
                                      + stats),
                       "bound_bwd": bound(GN_OPS * x.numel(), 3 * nbytes(x) + 2 * nbytes(weight)
                                          + nbytes(bias) + stats)}
        del x, weight, bias, dy
    return times_summary(out, names, batch, GN_GATE, largest)


# every distinct (C, H, W) of SpecUnet's 24 forward depthwise 7x7 convs at its
# published widths, and the two more of UnetNet's at its defaults
DEPTHWISE_SHAPES = [(18, 640, 88), (28, 320, 44), (28, 640, 88), (56, 160, 22), (56, 320, 44),
                    (112, 160, 22), (112, 320, 44), (168, 320, 44), (224, 160, 22),
                    (336, 160, 22)]
DW_GATE = 1e-5   # the depthwise convs against F.conv2d in f64, as tests/test_torch_kernels_gpu.py
DW_OPS = 2 * 49  # operations a value and pass: 49 multiply-adds, under the bytes' time in f32


def depthwise_conv_times(dev, batch: int = 16) -> dict:
    """Per shape, at `batch` rows: the port's depthwise 7x7 conv
    (ops/depthwise_conv.py) against F.conv2d, aten's conv_depthwise2d kernels
    (`hold_and_time`: y, dx, dw, db in f64 under DW_GATE, both routes' device
    ms), with each pass's bytes bound; and `largest`, the shape with the most
    values, with its bounds from the run's tensors."""
    from diffroll_tpu_torch.ops import depthwise_conv as dwc

    F = torch.nn.functional
    names = ("y", "dx", "dw", "db")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out, largest = {}, None
    for c, h, w in DEPTHWISE_SHAPES:
        x = (0.5 + torch.randn(batch, c, h, w, device=dev, generator=gen)).requires_grad_()
        weight = (torch.randn(c, 1, 7, 7, device=dev, generator=gen) / 7).requires_grad_()
        bias = (0.1 * torch.randn(c, device=dev, generator=gen)).requires_grad_()
        dy = torch.randn(batch, c, h, w, device=dev, generator=gen)
        row = hold_and_time(dwc.depthwise_conv, lambda x, w, b: F.conv2d(x, w, b, 1, 3, 1, c),
                            (x, weight, bias), dy, names, DW_GATE)
        # forward: x read, y written; backward: dy and x read, dx written
        row["bytes_bound_ms"] = 1e3 * 2 * x.numel() * 4 / PEAK_BYTES_PER_S
        row["bytes_bound_bwd_ms"] = 1e3 * 3 * x.numel() * 4 / PEAK_BYTES_PER_S
        name = f"{c}x{h}x{w}"
        out[name] = row
        if largest is None or x.numel() > largest["values"]:
            largest = {"shape": [batch, c, h, w], "name": name, "values": x.numel(),
                       "bound": bound(DW_OPS * x.numel(), 2 * nbytes(x) + nbytes(weight, bias)),
                       "bound_bwd": bound(2 * DW_OPS * x.numel(),
                                          3 * nbytes(x) + 2 * nbytes(weight, bias))}
        del x, weight, bias, dy
    return times_summary(out, names, batch, DW_GATE, largest)


def stack_flops(m: int, c: int, taps: int, mp: int, layers: int) -> float:
    """The forward's products over m rows: the gate GEMM (taps and the padded
    conditioner lanes) and the output GEMM."""
    return 2.0 * m * (taps * c + mp) * 2 * c * layers + 2.0 * m * c * 2 * c * layers


def bwd_flops(m: int, c: int, taps: int, mp: int, layers: int, dcond: bool) -> float:
    """The backward's products: dWo, dg, dWd + dWc, dy, and dcond where asked."""
    per_layer = (2.0 * m * c * 2 * c) * 2 + 2.0 * m * (taps * c + mp) * 2 * c \
        + 2.0 * m * taps * 2 * c * c + (2.0 * m * 2 * c * mp if dcond else 0.0)
    return per_layer * layers


def write_maps_corpus(root: pathlib.Path, n: int, seconds: float, sr: int, seed: int,
                      subset: str = "AkPnBcht") -> None:
    """`n` recordings in the MAPS layout: 16 kHz mono wavs of seeded sine
    notes under <root>/MAPS/<subset>/MUS/, each beside its tab-separated
    `OnsetTime OffsetTime MidiPitch` label file. AkPnBcht is in MAPS's train
    split, ENSTDkCl in its test split."""
    folder = root / "MAPS" / subset / "MUS"
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
        name = f"MAPS_MUS-synth{i:03d}_{subset}"
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
    """Mono float [-1, 1] -> a 16-bit PCM WAV file."""
    path.write_bytes(wav_bytes(samples, sample_rate))


def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    """Mono float [-1, 1] -> the bytes of a 16-bit PCM WAV file."""
    buf = io.BytesIO()
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def kernel_launches(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


def fixed_batch(mc, dev, gen, b: int = TRAIN_BATCH) -> dict:
    """A seeded batch of `b` windows on the card: sparse rolls, noise audio."""
    return {"frame": (torch.rand(b, mc.frames, mc.pitches, device=dev, generator=gen)
                      > 0.95).float(),
            "audio": 0.1 * torch.randn(b, mc.frames * mc.mel.hop_length, device=dev,
                                       generator=gen)}



def reset_launches(*fns) -> None:
    torch.cuda.synchronize()
    for fn in fns:
        fn.launches = 0


def run_test_phase(ckpt: pathlib.Path, data: pathlib.Path, out: pathlib.Path, kernels) -> dict:
    """`cli.test.main` on `ckpt` over the test split under `data`; returns
    this path's launch counts."""
    from diffroll_tpu_torch.cli import test as cli_test

    reset_launches(*kernels)
    t0 = time.perf_counter()
    metrics = cli_test.main([f"pretrained_path={ckpt}", f"dataset.root={data}",
                             "device=cuda", "audio_format=wav", f"trainer.output_dir={out}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches(kernels)
    batches = -(-2 * TEST_RECORDINGS // SERVE_BATCH)
    if metrics["n_clips"] != TEST_RECORDINGS or not all(
            math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"test scored {metrics['n_clips']} recordings: {metrics}")
    if launches != {"gated_stack": STEPS * batches, "fused_sample": batches, "group_norm": 0,
                    "depthwise_conv": 0}:
        raise RuntimeError(f"test did not run K2 once per batch of {SERVE_BATCH}: {launches}")
    phase("test", seconds=seconds, batches=batches, batch_size=SERVE_BATCH,
          seconds_per_batch=seconds / batches, n_clips=metrics["n_clips"],
          note_f1=metrics["note_f1"], frame_f1=metrics["frame_f1"],
          eval_overlap_frames=metrics["eval_overlap_frames"], launches=launches)
    return launches


def run_sample_phase(ckpt: pathlib.Path, data: pathlib.Path, out: pathlib.Path, frames: int,
                 kernels) -> dict:
    """`cli.sample.main` in inpainting (the test split's 8 windows, one
    guided batch) and generation (one unguided batch of 8), num_samples=2;
    returns this path's launch counts."""
    from diffroll_tpu_torch.cli import sample as cli_sample

    runs, total = {}, dict.fromkeys(kernel_launches(kernels), 0)
    for mode, extra in (("inpainting_ddpm_x0", ["task.inpainting_t=[100,200]", "dataset.name=MAPS",
                                                f"dataset.root={data}"]),
                        ("generation_ddpm_x0", [])):
        reset_launches(*kernels)
        t0 = time.perf_counter()
        run_dir = cli_sample.main([f"pretrained_path={ckpt}", f"task.sampling_type={mode}",
                                   "num_samples=2", "device=cuda",
                                   f"trainer.output_dir={out}", *extra])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernel_launches(kernels)
        manifest = json.loads((run_dir / "manifest.json").read_text())
        if len(manifest) != 2:
            raise RuntimeError(f"sample {mode} wrote {len(manifest)} clips")
        for i, m in enumerate(manifest):
            z = np.load(run_dir / f"{i:03d}_{m['clip']}.npz")
            if z["trajectory"].shape != (STEPS // 10, frames, 88) or not np.isfinite(
                    z["trajectory"]).all() or not (run_dir / f"{i:03d}_{m['clip']}.mid").exists():
                raise RuntimeError(f"sample {mode}: bad clip {m}: {z['trajectory'].shape}")
        # one batch of 8 windows / noise draws: K1 once per step, K2 never
        if launches != {"gated_stack": STEPS, "fused_sample": 0, "group_norm": 0,
                        "depthwise_conv": 0}:
            raise RuntimeError(f"sample {mode} did not take the step loop: {launches}")
        runs[mode] = {"seconds": seconds, "launches": launches,
                      "notes": [m["notes"] for m in manifest],
                      "gif_written": (run_dir / "denoising.gif").exists()}
        for k in total:
            total[k] += launches[k]
    phase("sample", runs=runs, launches=total)
    return total


def run_serve_phase(ckpt: pathlib.Path, sr: int, frames_per_s: float, kernels) -> dict:
    """The service `python -m diffroll_tpu_torch serve` builds from the
    checkpoint with the ServeConfig defaults (max_wait_ms=25), behind the
    HTTP front on a free localhost port; then the same with max_wait_ms=100
    as a labelled comparison; each with its stages' mean host time a batch
    and its compute time a batch (`sum_compute_s`, by CUDA events) over the
    throughput burst. Returns the default service's launch counts."""
    import threading
    import urllib.request

    from diffroll_tpu_torch.cli import serve as cli_serve
    from diffroll_tpu_torch.serve import serve_forever

    argv = [f"pretrained_path={ckpt}", "device=cuda"]  # the sampling preset: w=0.5
    seconds_each = 20.0
    bodies = [wav_bytes(chord_wav(seconds_each, sr, SEED + 10 + i), sr)
              for i in range(SERVE_BATCH)]
    want_frames = math.ceil(seconds_each * frames_per_s)

    def drive(extra):
        """One service: warm-up, /healthz, a burst of 8 concurrent requests
        (one window each), then a burst of 32 (four batches' worth) timed
        for windows per second. Returns its readings and launch counts."""
        t0 = time.perf_counter()
        svc, cfg, info = cli_serve.make_service(argv + extra)
        warmup_s = time.perf_counter() - t0
        reset_launches(*kernels)
        ready = threading.Event()
        threading.Thread(target=serve_forever, args=(svc, "127.0.0.1", 0),
                         kwargs={"info": info, "ready": ready}, daemon=True).start()
        if not ready.wait(30):
            raise RuntimeError("the HTTP front did not start")
        server = ready.server
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def burst(n):
            """n concurrent POSTs; returns their payloads (a failed one: None)."""
            out = [None] * n

            def post(i):
                req = urllib.request.Request(f"{base}/transcribe",
                                             data=bodies[i % len(bodies)], method="POST")
                with urllib.request.urlopen(req, timeout=600) as r:
                    out[i] = json.loads(r.read())

            threads = [threading.Thread(target=post, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            return out

        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            if health["status"] != "ok" or health["stats"]["batches"] != 0:
                raise RuntimeError(f"healthz: {health}")
            first = burst(SERVE_BATCH)
            stats = dict(svc.stats)
            if any(p is None or p["frames"] != want_frames for p in first):
                raise RuntimeError(f"serve returned {[p and p['frames'] for p in first]} "
                                   f"frames, want {want_frames}")
            if not stats["batches"] < stats["windows"] == SERVE_BATCH:
                raise RuntimeError(f"the requests did not share batches: {stats}")
            n_load = 4 * SERVE_BATCH
            t0 = time.perf_counter()
            load = burst(n_load)
            load_s = time.perf_counter() - t0
            if any(p is None for p in load):
                raise RuntimeError("a request of the throughput burst failed")
            after = dict(svc.stats)
        finally:
            server.shutdown()
            svc.close()
        torch.cuda.synchronize()
        launches = kernel_launches(kernels)
        if launches["fused_sample"] != after["batches"] or launches["gated_stack"] < STEPS \
                or launches["group_norm"] or launches["depthwise_conv"]:
            raise RuntimeError(f"serve did not run K2 once per batch (and no U-Net "
                               f"kernel): {launches}, {after}")
        batches = after["batches"] - stats["batches"]
        sv = cfg.serve
        return {"max_wait_ms": sv.max_wait_ms, "transfer": sv.transfer,
                "pipeline_depth": sv.pipeline_depth, "warmup_s": warmup_s,
                "first_burst_batches": stats["batches"],
                "first_burst_windows": stats["windows"], "load_requests": n_load,
                "load_seconds": load_s, "load_batches": batches,
                "windows_per_second": n_load / load_s,
                "mean_batch_wall_s": (after["sum_batch_wall_s"]
                                      - stats["sum_batch_wall_s"]) / batches,
                # each stage's mean a batch of the burst, at the service's depth
                "mean_stage_s": {k[4:]: (after[k] - stats.get(k, 0.0)) / batches
                                 for k in after if k.startswith("sum_")},
                "padded_rows": after.get("padded_rows", 0) - stats.get("padded_rows", 0),
                "launches": launches}

    default = drive([])
    wide = drive(["serve.max_wait_ms=100"])
    phase("serve", requests=SERVE_BATCH, frames=want_frames,
          burst="8 concurrent 20 s requests, then 32 (each one window; 8 distinct bodies)",
          default=default, max_wait_100ms=wide, launches=default["launches"])
    return default["launches"]


def run_distill_phase(ckpt: pathlib.Path, data: pathlib.Path, out: pathlib.Path,
                      kernels) -> tuple:
    """`cli.distill.main` on the checkpoint `train` wrote, over its corpus:
    two stages (9 steps folding CFG at w=0.5, then 5) of DISTILL_STEPS steps
    each, the teacher on K1 and the student on K3 + K4; then `cli.test.main`
    on each student (ddim_x0, its own steps, w=0): one test batch of 8
    windows through K2. Then each stage's step ms by CUDA events on a fixed
    batch. Returns the launch counts of the distill run and of the students'
    test runs."""
    import contextlib
    import copy
    import re

    from diffroll_tpu_torch.cli import distill as cli_distill
    from diffroll_tpu_torch.cli import test as cli_test
    from diffroll_tpu_torch.compat import load_lightning
    from diffroll_tpu_torch.diffusion.distill import distill_grids
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
    from diffroll_tpu_torch.train import TrainState, make_train_step
    from diffroll_tpu_torch.train.distill import make_distill_loss

    gated_stack, fused_sample, fwd_saves, bwd, group_norm, depthwise_conv = kernels
    reset_launches(*kernels)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        summary = cli_distill.main([
            f"pretrained_path={ckpt}", f"dataset.root={data}", "task.fused_train=true",
            f"distill.start_steps={DISTILL_STAGES[0]}", f"distill.stages={len(DISTILL_STAGES)}",
            f"distill.steps_per_stage={DISTILL_STEPS}", "device=cuda",
            f"dataloader.train_batch_size={TRAIN_BATCH}", f"trainer.output_dir={out}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(log.getvalue(), file=sys.stderr, end="")
    launches = kernel_launches(kernels)
    n_steps = len(DISTILL_STAGES) * DISTILL_STEPS
    # the teacher twice a step (one forward of 2B rows when guided), the
    # student's forward-with-saves and backward once
    if launches != {"gated_stack": 2 * n_steps, "fused_sample": 0, "fwd_saves": n_steps,
                    "bwd": n_steps, "group_norm": 0, "depthwise_conv": 0}:
        raise RuntimeError(f"distill did not launch K1 twice and K3, K4 once a step: "
                           f"{launches}")
    losses = [float(v) for v in re.findall(r"distill_loss (\S+)", log.getvalue())]
    if summary["stages"] != list(DISTILL_STAGES) or len(losses) != 2 * len(DISTILL_STAGES) \
            or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"distill: stages {summary['stages']}, losses {losses}")
    run_dir = pathlib.Path(summary["run_dir"])
    stage_ckpts = {n: run_dir / f"distilled_{n}steps" / "checkpoints" / "last.ckpt"
                   for n in DISTILL_STAGES}
    if not all(c.exists() for c in stage_ckpts.values()):
        raise RuntimeError(f"distill wrote no stage checkpoint: {stage_ckpts}")

    test_kernels = (gated_stack, fused_sample, group_norm, depthwise_conv)
    tests, test_launches = {}, dict.fromkeys(kernel_launches(test_kernels), 0)
    for n, stage_ckpt in stage_ckpts.items():
        reset_launches(*test_kernels)
        t0 = time.perf_counter()
        metrics = cli_test.main([f"pretrained_path={stage_ckpt}", "task.sampling_type=ddim_x0",
                                 f"task.sampling_steps={n}", "task.w=0", f"dataset.root={data}",
                                 "device=cuda", "audio_format=wav", f"trainer.output_dir={out}"])
        torch.cuda.synchronize()
        got = kernel_launches(test_kernels)
        # one batch of 8 windows: K2 once, its n steps one stream each
        if got != {"gated_stack": n, "fused_sample": 1, "group_norm": 0, "depthwise_conv": 0} \
                or metrics["n_clips"] != TEST_RECORDINGS \
                or not all(math.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"test on the {n}-step student: {got}, {metrics}")
        tests[f"{n}_steps"] = {"seconds": time.perf_counter() - t0, "launches": got,
                               "note_f1": metrics["note_f1"], "frame_f1": metrics["frame_f1"]}
        for k in test_launches:
            test_launches[k] += got[k]

    # one distill step by CUDA events, guided and unguided, on a fixed batch
    dev = torch.device("cuda")
    teacher, _ = load_lightning(str(ckpt), device=dev)
    teacher.requires_grad_(False)
    mc = teacher.config
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    batch = fixed_batch(mc, dev, gen)
    step_ms = {}
    for n, guided in zip(DISTILL_STAGES, (True, False)):
        student = copy.deepcopy(teacher).requires_grad_(True)
        task = DiffusionTask(student, TaskConfig(timesteps=mc.timesteps, fused_train=True))
        loss_fn = make_distill_loss(task, teacher, *distill_grids(mc.timesteps, n),
                                    guided=guided, w=W_GUIDANCE)
        state = TrainState.create(student, 1e-6)
        step = make_train_step(loss_fn)
        step_ms["guided" if guided else "unguided"] = time_ms(
            lambda: step(state, batch, gen), 5, 2)
        del student, task, state
    phase("distill", seconds=seconds, stages=summary["stages"], steps_per_stage=DISTILL_STEPS,
          batch=TRAIN_BATCH, losses=losses, launches=launches, student_tests=tests,
          step_ms_by_events=step_ms)
    return launches, test_launches, step_ms


def run_baseline_phase(data: pathlib.Path, out: pathlib.Path, kernels) -> dict:
    """`cli.train.main baseline` at full width (DiffRollBaseline: 512 x 15,
    kernel 7, dilation 1) for TRAIN_STEPS steps through the nn.Modules, then
    its test split (one batch of 8 windows, the 200-step walk). No kernel may
    launch. Then a training step and the walk by CUDA events."""
    from diffroll_tpu_torch.cli import train as cli_train
    from diffroll_tpu_torch.tasks import BaselineConfig, BaselineTask
    from diffroll_tpu_torch.train import make_train_step

    reset_launches(*kernels)
    t0 = time.perf_counter()
    state = cli_train.main([
        "baseline", f"dataset.root={data}", "device=cuda", "trainer.max_epochs=1",
        "trainer.check_val_every_n_epoch=1", "trainer.log_every_n_steps=1",
        f"dataloader.train_batch_size={TRAIN_BATCH}", "audio_format=wav",
        f"trainer.output_dir={out}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches(kernels)
    (run_dir,) = out.glob("*/*/train-*")
    records = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/amt_loss"] for r in records if "train/amt_loss" in r]
    metrics_path = run_dir / "test_metrics.json"
    metrics = json.loads(metrics_path.read_text()) if metrics_path.exists() else {}
    if state.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in losses):
        raise RuntimeError(f"baseline took {state.step} steps, losses {losses}")
    if metrics.get("n_clips") != TEST_RECORDINGS or not all(
            math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"baseline test split: {metrics}")
    if any(launches.values()):
        raise RuntimeError(f"the baseline launched a kernel: {launches}")
    # by CUDA events on the trained model: one training step at B=16 and the
    # test's evaluation walk over one batch of 8 windows (200 forwards)
    model, dev = state.model, torch.device("cuda")
    mc = model.config
    task = BaselineTask(model, BaselineConfig())
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    batch = fixed_batch(mc, dev, gen)
    step = make_train_step(task.loss_fn)
    step_ms = time_ms(lambda: step(state, batch, gen), 5, 2)
    x_T = torch.randn(SERVE_BATCH, mc.frames, mc.pitches, device=dev, generator=gen)
    walk_ms = time_ms(lambda: task.sample(x_T, waveform=batch["audio"][:SERVE_BATCH],
                                          generator=gen), 1, 1)
    phase("baseline", seconds=seconds, steps=TRAIN_STEPS, batch=TRAIN_BATCH, train_losses=losses,
          model=mc.name, kernel_size=mc.kernel_size,
          test_metrics={k: metrics[k] for k in ("n_clips", "note_f1", "frame_f1")},
          step_ms_by_events=step_ms, walk_b8_ms_by_events=walk_ms, launches=launches)
    return launches



def run_family(argv, data: pathlib.Path, out: pathlib.Path, kernels, then: str,
               audio_dir: pathlib.Path) -> dict:
    """One model family the kernels do not cover, through the entries a user
    calls. `cli.train.main argv` for TRAIN_STEPS steps at B=16 on the corpus
    under `data`, with validation (the val_hook's figures, or its one stderr
    line without matplotlib), the checkpoints, and the post-fit test where
    the corpus has a test split. Then, on the checkpoint, `then`:
    'transcribe' (one 20.48 s window under `audio_dir`, the model's full
    step count, cfdg_ddpm_x0 at w=0.5), 'infer' (num_samples=2) or 'test'
    (the post-fit test's metrics). Then one training step by CUDA events
    (the median of 3 after a warm-up) on a fixed batch, and the ms a step of
    the reverse process by events, as the sampling entry runs it but over
    TIMED_STEPS strided steps. No kernel may launch anywhere in the run; the
    peak memory is the whole run's."""
    import contextlib

    from diffroll_tpu_torch.cli import _common
    from diffroll_tpu_torch.cli import infer as cli_infer
    from diffroll_tpu_torch.cli import train as cli_train
    from diffroll_tpu_torch.cli import transcribe as cli_transcribe
    from diffroll_tpu_torch.compat import load_lightning
    from diffroll_tpu_torch.tasks import DiffusionTask
    from diffroll_tpu_torch.train import make_train_step

    dev = torch.device("cuda")
    reset_launches(*kernels)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        state = cli_train.main([
            *argv, f"dataset.root={data}", "device=cuda", "trainer.max_epochs=1",
            "trainer.check_val_every_n_epoch=1", "trainer.log_every_n_steps=1",
            f"dataloader.train_batch_size={TRAIN_BATCH}", "audio_format=wav",
            f"trainer.output_dir={out}"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(log.getvalue(), file=sys.stderr, end="")
    (run_dir,) = out.glob("*/*/train-*")
    records = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/diffusion_loss"] for r in records if "train/diffusion_loss" in r]
    val = [r["val/diffusion_loss"] for r in records if "val/diffusion_loss" in r]
    if state.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS or not val or not all(
            math.isfinite(v) for v in losses + val):
        raise RuntimeError(f"{argv}: {state.step} steps, losses {losses}, val {val}")
    mc = state.model.config
    figures = sorted(f.name for f in (run_dir / "figures").glob("*.png")) \
        if (run_dir / "figures").is_dir() else []
    no_mpl = "matplotlib is not installed" in log.getvalue()
    want = ["val_rolls"] + (["val_trainable_params"] if mc.condition != "fixed" else [])
    if not no_mpl and sorted(f.rsplit("_", 1)[0] for f in figures) != want:
        raise RuntimeError(f"{argv}: the val_hook wrote {figures} and printed no notice")
    ckpt = run_dir / "checkpoints" / "last.ckpt"
    reading = {"model": mc.name, "variant": mc.variant, "condition": mc.condition,
               "params": sum(p.numel() for p in state.model.net.parameters()),
               "train_seconds": train_s, "train_losses": losses, "val_losses": val,
               "figures": figures, "val_hook_notice": no_mpl}

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    task_cfg = _common.stored_task_config(str(ckpt))
    if then == "test":
        metrics = json.loads((run_dir / "test_metrics.json").read_text())
        if metrics["n_clips"] != 1 or not all(math.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"{argv}: post-fit test {metrics}")
        reading["test_metrics"] = {k: metrics[k] for k in ("n_clips", "note_f1", "frame_f1")}
    elif then == "transcribe":
        t0 = time.perf_counter()
        tr_dir = cli_transcribe.main([
            f"pretrained_path={ckpt}", f"dataset.audio_path={audio_dir}",
            "dataset.audio_ext=wav", "task.sampling_type=cfdg_ddpm_x0", f"task.w={W_GUIDANCE}",
            "overlap_frames=32", "device=cuda", f"trainer.output_dir={out}"])
        torch.cuda.synchronize()
        roll = np.load(tr_dir / "000_window.npz")["roll"]
        if roll.shape != (mc.frames, mc.pitches) or not np.isfinite(roll).all() or not (
                tr_dir / "000_window.mid").exists():
            raise RuntimeError(f"{argv}: transcribe gave a roll of {roll.shape}")
        reading.update(transcribe_seconds=time.perf_counter() - t0,
                       roll_range=[float(roll.min()), float(roll.max())])
        task_cfg = task_cfg.replace(sampling_type="cfdg_ddpm_x0", w=W_GUIDANCE)
    else:  # infer
        t0 = time.perf_counter()
        inf_dir = cli_infer.main([f"pretrained_path={ckpt}", "num_samples=2", "device=cuda",
                                  f"trainer.output_dir={out}"])
        torch.cuda.synchronize()
        manifest = json.loads((inf_dir / "manifest.json").read_text())
        for m in manifest:
            z = np.load(inf_dir / f"{m['clip']}.npz")
            if z["trajectory"].shape != (mc.timesteps // 10, mc.frames, mc.pitches) or not \
                    np.isfinite(z["roll"]).all() or not (inf_dir / f"{m['clip']}.mid").exists():
                raise RuntimeError(f"infer wrote a bad clip {m}: {z['trajectory'].shape}")
        if len(manifest) != 2:
            raise RuntimeError(f"infer wrote {len(manifest)} clips")
        reading.update(infer_seconds=time.perf_counter() - t0,
                       notes=[m["notes"] for m in manifest])

    # one training step and one reverse process by CUDA events
    task = DiffusionTask(state.model, task_cfg)
    step = make_train_step(task.loss_fn)
    batch = fixed_batch(mc, dev, gen)
    reading["step_ms_by_events"] = time_ms(lambda: step(state, batch, gen), 3, 1)
    model, _ = load_lightning(str(ckpt), device=dev)
    # the entry above ran the whole process; the events time a strided part
    # of it, to keep the script inside its time
    sampler = DiffusionTask(model, task_cfg.replace(sampling_steps=TIMED_STEPS))
    rows = 2 if then == "infer" else 1
    x_T = torch.randn(rows, mc.frames, mc.pitches, device=dev, generator=gen)
    wav = None if then == "infer" else torch.from_numpy(
        chord_wav(mc.frames * mc.mel.hop_length / mc.mel.sample_rate, mc.mel.sample_rate,
                  SEED + 22))[None].to(dev)
    out_x = []
    reading["reverse_ms_per_step_by_events"] = time_ms(
        lambda: out_x.append(sampler.sample(x_T, waveform=wav, generator=gen)[0]), 1, 0
    ) / TIMED_STEPS
    if not torch.isfinite(out_x[0]).all():
        raise RuntimeError(f"{argv}: the reverse process gave non-finite values")
    # no stack kernel; the U-Nets' norms and depthwise convs, and only theirs, on
    # their kernels
    launches = kernel_launches(kernels)
    unet_kernels, is_unet = ("group_norm", "depthwise_conv"), mc.variant in ("unet", "spec_unet")
    if any(v for k, v in launches.items() if k not in unet_kernels) or \
            any((launches[k] > 0) != is_unet for k in unet_kernels):
        raise RuntimeError(f"{argv} launched {launches}")
    reading.update(reverse_batch=rows, steps=mc.timesteps, timed_steps=TIMED_STEPS,
                   sampler=task_cfg.sampling_type,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    del state, task, step, model, sampler
    return reading


def run_family_phases(tmp: pathlib.Path, sr: int, kernels) -> dict:
    """The phases trainable, v2, unet and spec_unet; returns each path's
    launch counts (K1-K4 zero; the U-Nets' GroupNorm and depthwise conv
    kernels in unet and spec_unet)."""
    import shutil

    # a train-only corpus (the 48 recordings): its `train` skips the post-fit
    # test; spec_unet's adds one 10 s test recording (one window)
    train_only = tmp / "train_only"
    shutil.copytree(tmp / "data" / "MAPS" / "AkPnBcht", train_only / "MAPS" / "AkPnBcht")
    one_test = tmp / "one_test"
    shutil.copytree(train_only, one_test)
    write_maps_corpus(one_test, 1, 10.0, sr, SEED + 1, subset="ENSTDkCl")
    audio_dir = tmp / "window"
    audio_dir.mkdir()
    write_wav(audio_dir / "window.wav", chord_wav(20.48, sr, SEED + 23), sr)

    paths = {}
    t0 = time.perf_counter()
    runs = {cond: run_family(["spec_roll", f"model.condition={cond}", "task.fused_train=true"],
                             train_only, tmp / cond, kernels, "transcribe", audio_dir)
            for cond in ("trainable_spec", "trainable_z")}
    paths["trainable"] = {k: sum(r["launches"][k] for r in runs.values())
                          for k in kernel_launches(kernels)}
    phase("trainable", seconds=time.perf_counter() - t0, batch=TRAIN_BATCH, runs=runs,
          launches=paths["trainable"])
    for name, argv, data, then in (
            # the preset's 500 steps (spec_roll's task would set the model's T to 200)
            ("v2", ["spec_roll", "model_name=DiffRollv2", "task.timesteps=500"], train_only,
             "transcribe"),
            ("unet", ["pianoroll", "dataset.name=MAPS"], train_only, "infer"),
            ("spec_unet", ["spec_roll", "model_name=SpecUnet"], one_test, "test")):
        t0 = time.perf_counter()
        reading = run_family(argv, data, tmp / name, kernels, then, audio_dir)
        paths[name] = reading["launches"]
        phase(name, seconds=time.perf_counter() - t0, batch=TRAIN_BATCH, **reading)
    return paths


HOLD = (("trainable_spec", "ClassifierFreeDiffRoll", {"condition": "trainable_spec"}),
        ("trainable_z", "ClassifierFreeDiffRoll", {"condition": "trainable_z"}),
        ("v2", "DiffRollv2", {"spec_dropout": 0.5}),
        ("v2debug", "DiffRollv2Debug", {"spec_dropout": 0.5}),
        ("unet", "Unet", {}),
        ("spec_unet", "SpecUnet", {"spec_dropout": 0.5}))
FWD_GATE, GRAD_GATE = 1e-3, 2e-3   # f32 on both sides (tests/test_torch_variants.py)


def run_variants_hold(dev) -> None:
    """Each new configuration at its published widths, the same module on the
    CPU and on the card on the same seeded weights (the zero-init heads given
    N(0, 0.1^2)), over two windows, the second row unconditional where the
    model is conditioned (spec_dropout 0.5 where the preset has none, so the
    given mask is applied): the forward's max|d| / max|ref| < 1e-3 and every
    parameter's gradient of one training loss (fixed t, noise and mask) < 2e-3,
    the loss itself within 1e-4 relative. TF32 is off, as everywhere in this
    script."""
    from diffroll_tpu_torch import models
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig

    readings, failed = {}, []
    for label, name, kw in HOLD:
        t0 = time.perf_counter()
        torch.manual_seed(SEED)
        cpu = models.build(name, **kw)
        head = getattr(cpu.net, "output_projection", None)
        if head is not None:
            torch.nn.init.normal_(head.weight, std=0.1)
        card = copy.deepcopy(cpu).to(dev)
        mc = cpu.config
        g = torch.Generator().manual_seed(SEED + 24)
        batch = fixed_batch(mc, "cpu", g, 2)
        draws = dict(t=torch.randint(0, mc.timesteps, (2,), generator=g),
                     noise=torch.randn(2, mc.frames, mc.pitches, generator=g),
                     uncond_mask=torch.tensor([False, True]))
        x_t = torch.randn(2, mc.frames, mc.pitches, generator=g)
        cond = cpu.conditioner(waveform=batch["audio"], roll=batch["frame"])
        mask = None if cond is None else draws["uncond_mask"]
        recipe = (dict(training_mode="epsilon", loss_type="huber") if mc.variant == "unet"
                  else dict(training_mode="x_0", loss_type="l2"))
        out, grads, loss = {}, {}, {}
        for side, model in (("cpu", cpu), ("card", card)):
            d = torch.device("cpu") if side == "cpu" else dev
            model.eval()
            with torch.no_grad():
                out[side] = model.apply(x_t.to(d), draws["t"].to(d),
                                        None if cond is None else cond.to(d),
                                        None if mask is None else mask.to(d)).cpu()
            model.train()
            task = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps, **recipe))
            total, _ = task.loss_fn({k: v.to(d) for k, v in batch.items()}, None, True,
                                    **{k: v.to(d) for k, v in draws.items()})
            total.backward()
            loss[side] = float(total.detach())
            grads[side] = {n: p.grad.detach().cpu() for n, p in model.net.named_parameters()
                           if p.grad is not None}
        torch.cuda.synchronize()
        fwd_rel, fwd_abs = rel_err(out["card"], out["cpu"])
        leaf, grad_rel, grad_abs = worst_leaf(grads["card"], grads["cpu"])
        readings[label] = {
            "model": name, "params": sum(p.numel() for p in cpu.net.parameters()),
            "forward_rel": fwd_rel, "forward_max_abs_err": fwd_abs, "worst_leaf": leaf,
            "grad_rel": grad_rel, "grad_max_abs_err": grad_abs, "leaves": len(grads["cpu"]),
            "loss_cpu": loss["cpu"], "loss_card": loss["card"], "seconds": time.perf_counter() - t0}
        if not (fwd_rel < FWD_GATE and grad_rel < GRAD_GATE
                and abs(loss["card"] - loss["cpu"]) <= 1e-4 * abs(loss["cpu"])):
            failed.append(label)
        del cpu, card, grads, out
        torch.cuda.empty_cache()
    phase("variants_hold", batch=2, tf32=False, configs=readings, failed=failed)
    if failed:
        raise RuntimeError(f"the card disagrees with the CPU on {failed}")


BF16_LOSS_GATE = 1e-2      # the bf16 loss against f32 (the fused loss's gate, phase train_grads)
BF16_DIFFERS = 1e-3        # the worst bf16 leaf must differ from f32 by more: bf16's rounding
                           # (2^-8 relative) reaches it, two f32 runs of one chain do not
DP_FUSED_GATE, DP_MODULES_GATE = GATE, 1e-4   # the 2-rank step's gradients against 1 rank's
DP_METRICS_TOL = 1e-3      # the 2-rank test's metrics against the single-process test's
DP_TIMEOUT_S = 900


def seeded_step_inputs(mc, dev, b: int = TRAIN_BATCH, seed: int = SEED + 31):
    """A global batch of `b` windows and its draws (t, noise, dropout mask),
    from a CPU generator, so every process makes the same ones."""
    g = torch.Generator().manual_seed(seed)
    batch = {"frame": (torch.rand(b, mc.frames, mc.pitches, generator=g) > 0.95).float(),
             "audio": 0.1 * torch.randn(b, mc.frames * mc.mel.hop_length, generator=g)}
    draws = {"t": torch.randint(0, mc.timesteps, (b,), generator=g),
             "noise": torch.randn(b, mc.frames, mc.pitches, generator=g),
             "uncond_mask": torch.rand(b, generator=g) < 0.1}
    return ({k: v.to(dev) for k, v in batch.items()}, {k: v.to(dev) for k, v in draws.items()})


def params_digest(net) -> str:
    """A hash of every parameter's bits."""
    import hashlib

    h = hashlib.sha256()
    for name, p in net.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_bf16_phase(tmp: pathlib.Path, ckpt: pathlib.Path, kernels) -> dict:
    """`model.dtype=bfloat16` and `trainer.adam_moments_dtype=bfloat16` at the
    flagship's widths, through the modules (no kernel covers them): one
    training step at B=16 by events in f32 with TF32 off, with TF32, and in
    bf16; the bf16 loss and gradients against f32 on the same weights, batch
    and draws; then the train entry with both fields on trainable_spec (3
    steps), and transcribe of one window on its checkpoint, timed over a
    strided part, beside the same model in f32. Returns its launch counts
    (all zero)."""
    from diffroll_tpu_torch import models
    from diffroll_tpu_torch.cli import train as cli_train
    from diffroll_tpu_torch.cli import transcribe as cli_transcribe
    from diffroll_tpu_torch.compat import load_lightning
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
    from diffroll_tpu_torch.train import TrainState, make_train_step

    dev = torch.device("cuda")
    reset_launches(*kernels)
    t0 = time.perf_counter()
    f32, _ = load_lightning(str(ckpt), device=dev)
    bf16 = models.build("ClassifierFreeDiffRoll", dtype="bfloat16").to(dev)
    bf16.net.load_state_dict(f32.net.state_dict())
    mc = f32.config
    batch, draws = seeded_step_inputs(mc, dev)
    loss, grads = {}, {}
    with torch.no_grad():   # a block of the bf16 net computes and returns bf16 on the card
        blk = bf16.net.residual_layers[0]
        t_emb = bf16.net.diffusion_embedding(draws["t"])
        h = torch.zeros(TRAIN_BATCH, mc.frames, blk.diffusion_projection.out_features,
                        device=dev)
        block_dtypes = sorted({str(v.dtype) for v in blk(h, t_emb, blk.cond_proj(
            torch.zeros(TRAIN_BATCH, mc.frames, mc.n_mels, device=dev)))})
    for label, model in (("f32", f32), ("bf16", bf16)):
        model.train()
        model.net.zero_grad(set_to_none=True)
        task = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps))
        total, _ = task.loss_fn(batch, None, True, **draws)
        total.backward()
        loss[label] = float(total.detach())
        grads[label] = {n: p.grad.detach().clone() for n, p in model.net.named_parameters()}
        model.net.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    leaf_rel = {n: rel_err(grads["bf16"][n], g)[0] for n, g in grads["f32"].items()}
    worst = max(leaf_rel, key=leaf_rel.get)
    over = sorted((n for n, r in leaf_rel.items() if r >= GATE), key=leaf_rel.get, reverse=True)
    loss_rel = abs(loss["bf16"] - loss["f32"]) / abs(loss["f32"])
    flat = {k: torch.cat([g.flatten() for g in grads[k].values()]) for k in grads}
    cos = float(torch.nn.functional.cosine_similarity(flat["bf16"], flat["f32"], dim=0))
    del grads, flat

    def step_ms(model):
        task = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps))
        st = TrainState.create(model, 0.0)   # lr 0: the weights stay the compared ones
        step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train, **draws))
        return time_ms(lambda: step(st, batch, None), 3, 1)

    times = {"step_f32_ms": step_ms(f32)}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    times["step_tf32_ms"] = step_ms(f32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    times["step_bf16_ms"] = step_ms(bf16)
    del f32, bf16
    torch.cuda.empty_cache()

    # the entries: train (trainable_spec, bf16 compute, bf16 moments), then transcribe
    out = tmp / "bf16_out"
    state = cli_train.main([
        "spec_roll", "model.condition=trainable_spec", "model.dtype=bfloat16",
        "trainer.adam_moments_dtype=bfloat16", f"dataset.root={tmp / 'train_only'}",
        "device=cuda", "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
        "trainer.log_every_n_steps=1", f"dataloader.train_batch_size={TRAIN_BATCH}",
        "audio_format=wav", f"trainer.output_dir={out}"])
    torch.cuda.synchronize()
    (run_dir,) = out.glob("*/*/train-*")
    records = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/diffusion_loss"] for r in records if "train/diffusion_loss" in r]
    moments = [v for st in state.optimizer.state.values() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    moment_bytes = sum(m.numel() * m.element_size() for m in moments)
    n_params = sum(p.numel() for p in state.model.net.parameters())
    if state.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in losses):
        raise RuntimeError(f"bf16 train: {state.step} steps, losses {losses}")
    if not moments or any(m.dtype != torch.bfloat16 for m in moments) or \
            state.model.net.dtype != torch.bfloat16:
        raise RuntimeError("bf16 train: the moments or the compute are not bf16")
    del state
    ckpt16 = run_dir / "checkpoints" / "last.ckpt"
    t1 = time.perf_counter()
    tr_dir = cli_transcribe.main([
        f"pretrained_path={ckpt16}", f"dataset.audio_path={tmp / 'window'}",
        "dataset.audio_ext=wav", f"task.w={W_GUIDANCE}", "overlap_frames=32", "device=cuda",
        f"trainer.output_dir={out}"])
    torch.cuda.synchronize()
    transcribe_s = time.perf_counter() - t1
    roll = np.load(tr_dir / "000_window.npz")["roll"]
    if roll.shape != (mc.frames, mc.pitches) or not np.isfinite(roll).all():
        raise RuntimeError(f"bf16 transcribe gave a roll of {roll.shape}")
    # a strided process by events, and the same draws through the model in f32
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    wav = torch.from_numpy(chord_wav(mc.frames * mc.mel.hop_length / mc.mel.sample_rate,
                                     mc.mel.sample_rate, SEED + 22))[None].to(dev)
    x_T = torch.randn(1, mc.frames, mc.pitches, device=dev, generator=gen)
    noise = torch.randn(TIMED_STEPS, 1, mc.frames, mc.pitches, device=dev, generator=gen)
    x0, ms = {}, {}
    for label, dtype_over in (("bf16", None), ("f32", {"dtype": "float32"})):
        m, _ = load_lightning(str(ckpt16), device=dev, overrides=dtype_over)
        sampler = DiffusionTask(m, TaskConfig(timesteps=mc.timesteps, sampling_steps=TIMED_STEPS,
                                              w=W_GUIDANCE))
        got = []
        ms[label] = time_ms(lambda: got.append(sampler.sample(x_T, waveform=wav, noise=noise)[0]),
                            1, 1) / TIMED_STEPS
        x0[label] = got[-1]
        del m, sampler
    traj_rel, traj_abs = rel_err(x0["bf16"], x0["f32"])
    launches = kernel_launches(kernels)
    if any(launches.values()):
        raise RuntimeError(f"bf16 launched a kernel: {launches}")
    phase("bf16", seconds=time.perf_counter() - t0, batch=TRAIN_BATCH, **times,
          loss_f32=loss["f32"], loss_bf16=loss["bf16"], loss_rel=loss_rel,
          worst_leaf=worst, worst_leaf_rel=leaf_rel[worst], leaves=len(leaf_rel),
          worst_leaf_floor=BF16_DIFFERS, block_output_dtypes=block_dtypes,
          leaves_at_or_over_gate={n: leaf_rel[n] for n in over}, grad_cosine=cos,
          train_losses=losses, moments_bytes=moment_bytes, moments_bytes_f32=8 * n_params,
          transcribe_seconds=transcribe_s, reverse_ms_per_step_bf16=ms["bf16"],
          reverse_ms_per_step_f32=ms["f32"], timed_steps=TIMED_STEPS,
          trajectory_rel_vs_f32=traj_rel, trajectory_max_abs_vs_f32=traj_abs,
          launches=launches)
    if not (loss_rel < BF16_LOSS_GATE and BF16_DIFFERS < leaf_rel[worst] < GATE):
        raise RuntimeError(f"bf16 against f32: loss rel {loss_rel}, {worst} rel {leaf_rel[worst]}")
    if block_dtypes != ["torch.bfloat16"]:
        raise RuntimeError(f"bf16: a block of the bf16 net returned {block_dtypes}")
    return launches


def dp_worker(rank: int, world: int, port: int, spec_path: str) -> int:
    """One rank of phase dp: a gloo group of `world` ranks on the one card."""
    import torch.distributed as dist

    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    from diffroll_tpu_torch.cli import distill as cli_distill
    from diffroll_tpu_torch.cli import test as cli_test
    from diffroll_tpu_torch.cli import train as cli_train
    from diffroll_tpu_torch.compat import load_lightning
    from diffroll_tpu_torch.ops import _build
    from diffroll_tpu_torch.ops.gated_stack import gated_stack
    from diffroll_tpu_torch.ops.gated_stack_train import bwd, fwd_saves
    from diffroll_tpu_torch.ops.depthwise_conv import depthwise_conv
    from diffroll_tpu_torch.ops.group_norm import group_norm
    from diffroll_tpu_torch.ops.sampler_kernel import fused_sample
    from diffroll_tpu_torch.parallel import setup_mesh
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
    from diffroll_tpu_torch.tasks import diffusion as task_module
    from diffroll_tpu_torch.train import TrainState, make_train_step
    from diffroll_tpu_torch import config as tconfig

    _build.library()
    kernels = (gated_stack, fused_sample, fwd_saves, bwd, group_norm, depthwise_conv)
    dev = torch.device("cuda")
    res = {"rank": rank}
    # K2's batch as the sharded test gives it
    k2_rows = []
    inner = task_module.fused_sample

    def recording(*args, **kw):
        k2_rows.append(int(args[0].shape[0]))
        return inner(*args, **kw)

    task_module.fused_sample = recording

    reset_launches(*kernels)
    t0 = time.perf_counter()
    state = cli_train.main(spec["train_args"])
    torch.cuda.synchronize()
    res["train"] = {"seconds": time.perf_counter() - t0, "step": state.step,
                    "launches": kernel_launches(kernels), "digest": params_digest(state.model.net)}
    del state

    # one fixed-draw step on this rank's stripe, K3 + K4 and the modules
    mesh = setup_mesh(tconfig.compose("spec_roll"), dev)
    model, _ = load_lightning(spec["ckpt"], device=dev)
    batch, draws = seeded_step_inputs(model.config, dev)
    batch = {k: mesh.stripe(v) for k, v in batch.items()}
    draws = {k: mesh.stripe(v) for k, v in draws.items()}
    init = {n: p.detach().clone() for n, p in model.net.named_parameters()}
    grads = {}
    for fused in (True, False):
        with torch.no_grad():
            for n, p in model.net.named_parameters():
                p.copy_(init[n])
        task = DiffusionTask(model, TaskConfig(timesteps=model.config.timesteps,
                                               fused_train=fused), mesh=mesh)
        st = TrainState.create(model, 0.0)
        step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train, **draws), mesh)
        step(st, batch, None)
        grads["fused" if fused else "modules"] = {
            n: p.grad.detach().cpu() for n, p in model.net.named_parameters()}
        if fused:
            res["step_ms"] = time_ms(lambda: step(st, batch, None), 3, 1)
    if rank == 0:
        torch.save(grads, pathlib.Path(spec["out"]) / "dp_grads.pt")
    del model, grads

    reset_launches(*kernels)
    k2_rows.clear()
    t0 = time.perf_counter()
    res["test"] = {"metrics": cli_test.main(spec["test_args"])}
    torch.cuda.synchronize()
    res["test"].update(seconds=time.perf_counter() - t0, launches=kernel_launches(kernels),
                       k2_rows=list(k2_rows))

    reset_launches(*kernels)
    t0 = time.perf_counter()
    summary = cli_distill.main(spec["distill_args"])
    torch.cuda.synchronize()
    res["distill"] = {"seconds": time.perf_counter() - t0, "stages": summary["stages"],
                      "launches": kernel_launches(kernels)}
    (pathlib.Path(spec["out"]) / f"dp_rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def nccl_worker(spec_path: str) -> int:
    """Phase dp's last part: one process of a `torchrun --nproc_per_node=1`
    environment; `train` initialises the NCCL group itself."""
    import torch.distributed as dist

    spec = json.loads(pathlib.Path(spec_path).read_text())
    from diffroll_tpu_torch.cli import train as cli_train
    from diffroll_tpu_torch.ops import _build
    from diffroll_tpu_torch.ops.gated_stack_train import bwd, fwd_saves

    _build.library()
    reset_launches(fwd_saves, bwd)
    t0 = time.perf_counter()
    state = cli_train.main(spec["nccl_args"])
    torch.cuda.synchronize()
    res = {"seconds": time.perf_counter() - t0, "step": state.step,
           "backend": str(dist.get_backend()), "world": dist.get_world_size(),
           "launches": kernel_launches((fwd_saves, bwd))}
    (pathlib.Path(spec["out"]) / "nccl.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env():
    """This script's path, and the environment its worker processes run in:
    no launcher's variables, the checkout first on the path."""
    script = str(pathlib.Path(__file__).resolve())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(pathlib.Path(script).parent)] + [p for p in [env.get("PYTHONPATH")] if p])
    return script, env


def run_workers(cmds, envs, what: str) -> None:
    """Start every command at once, wait for all with a timeout, kill all on
    a failure or the timeout."""
    procs = [subprocess.Popen(c, env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c, e in zip(cmds, envs)]
    try:
        logs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"{what}: the processes did not finish in {DP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{what}: process {i} exited {p.returncode}:\n{log[-3000:]}")


def step_against_one_process(ckpt: pathlib.Path, grads_path: pathlib.Path, what: str) -> dict:
    """The whole gradients of a fixed-draw step over the mesh (rank 0 saved
    them, on both routes) against one process's step at B=16 on the same
    weights, batch and draws: the worst leaf of each route, held to 0.05
    through K3 + K4 and 1e-4 through the f32 modules."""
    from diffroll_tpu_torch.compat import load_lightning
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
    from diffroll_tpu_torch.train import TrainState, make_train_step

    dev = torch.device("cuda")
    model, _ = load_lightning(str(ckpt), device=dev)
    batch, draws = seeded_step_inputs(model.config, dev)
    mesh_grads = torch.load(grads_path)
    init = {n: p.detach().clone() for n, p in model.net.named_parameters()}
    step_rel = {}
    for route, fused, gate in (("fused", True, DP_FUSED_GATE), ("modules", False, DP_MODULES_GATE)):
        with torch.no_grad():
            for n, p in model.net.named_parameters():
                p.copy_(init[n])
        task = DiffusionTask(model, TaskConfig(timesteps=model.config.timesteps,
                                               fused_train=fused))
        st = TrainState.create(model, 0.0)
        make_train_step(lambda b, g, train: task.loss_fn(b, g, train, **draws))(st, batch, None)
        want = {n: p.grad.detach().cpu() for n, p in model.net.named_parameters()}
        name, rel, _ = worst_leaf(mesh_grads[route], want)
        step_rel[route] = {"worst_leaf": name, "rel": rel, "gate": gate}
        if not rel < gate:
            raise RuntimeError(f"{what} step ({route}) against one process: {name} rel {rel}")
    return step_rel


def run_dp_phase(tmp: pathlib.Path, ckpt: pathlib.Path, last_ckpt: pathlib.Path,
                 kernels) -> dict:
    """Phase dp: two ranks in a gloo group share the one card (NCCL refuses two
    ranks on one GPU), each a process of its own: `train` at global B=16 with
    K3 + K4 for 3 steps on phase 5's corpus (each rank its stripe of 8), one
    fixed-draw step against the single-process step at B=16, `test` on the
    trained checkpoint (K2 once a rank at B=4) against the single-process
    test, and one distill stage. Then one process at world size 1 over NCCL.
    Returns the launch counts of dp_train, dp_test and dp_distill (rank 0's;
    both ranks' are checked)."""
    from diffroll_tpu_torch.cli import test as cli_test

    t0 = time.perf_counter()
    out = tmp / "dp"
    out.mkdir()
    common = [f"dataset.root={tmp / 'data'}", "device=cuda", "audio_format=wav",
              f"dataloader.train_batch_size={TRAIN_BATCH}"]
    spec = {
        "out": str(out), "ckpt": str(ckpt),
        "train_args": ["spec_roll", "task.fused_train=true", "trainer.max_epochs=1",
                       "trainer.check_val_every_n_epoch=1", "trainer.log_every_n_steps=1",
                       f"trainer.output_dir={out / 'train'}", *common],
        "test_args": [f"pretrained_path={last_ckpt}", f"trainer.output_dir={out / 'test'}",
                      *common],
        "distill_args": [f"pretrained_path={last_ckpt}", f"distill.start_steps={DISTILL_STAGES[0]}",
                         "distill.stages=1", f"distill.steps_per_stage={DISTILL_STEPS}",
                         "task.fused_train=true", f"trainer.output_dir={out / 'distill'}",
                         *common],
        "nccl_args": ["spec_roll", "task.fused_train=true", "trainer.max_epochs=1",
                      "trainer.check_val_every_n_epoch=1", f"trainer.output_dir={out / 'nccl'}",
                      f"dataset.root={tmp / 'train_only'}", "device=cuda",
                      f"dataloader.train_batch_size={TRAIN_BATCH}"]}
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    script, env = worker_env()
    port = free_port()
    run_workers([[sys.executable, script, "--dp-worker", str(r), "2", str(port), str(spec_path)]
                 for r in range(2)], [env, env], "dp (2 gloo ranks)")
    ranks = [json.loads((out / f"dp_rank{r}.json").read_text()) for r in range(2)]
    r0, r1 = ranks

    # train: K3 and K4 once a step on each rank, the same bits on both
    for r in ranks:
        if r["train"]["step"] != TRAIN_STEPS or r["train"]["launches"]["fwd_saves"] != \
                TRAIN_STEPS or r["train"]["launches"]["bwd"] != TRAIN_STEPS:
            raise RuntimeError(f"dp train on rank {r['rank']}: {r['train']}")
    if r0["train"]["digest"] != r1["train"]["digest"]:
        raise RuntimeError("dp train: the two ranks ended with different parameters")
    runs = list((out / "train").glob("*/*/train-*"))
    if len(runs) != 1 or not (runs[0] / "checkpoints" / "last.ckpt").exists():
        raise RuntimeError(f"dp train wrote {runs}: rank 0 alone must write")

    # the fixed-draw step against one process at B=16
    step_rel = step_against_one_process(ckpt, out / "dp_grads.pt", "dp")

    # test: n_clips, K2 once a rank at B=4, the metrics of one process
    single = cli_test.main([f"pretrained_path={last_ckpt}", f"trainer.output_dir={out / 'single'}",
                            f"dataset.root={tmp / 'data'}", "device=cuda", "audio_format=wav"])
    # the rolls rank 0 gathered and reassembled, against the single process's
    # (every row's x_T and noise are the same draws; K2 runs at B=4, not 8)
    (dp_npz,) = (out / "test").glob("*/*/test-*/batch0_rolls.npz")
    (one_npz,) = (out / "single").glob("*/*/test-*/batch0_rolls.npz")
    dp_rolls, one_rolls = (torch.from_numpy(np.load(f)["pred"]) for f in (dp_npz, one_npz))
    if dp_rolls.shape != one_rolls.shape or dp_rolls.shape[0] != SERVE_BATCH:
        raise RuntimeError(f"dp test rolls {tuple(dp_rolls.shape)}, one process "
                           f"{tuple(one_rolls.shape)}")
    rolls_rel, rolls_abs = rel_err(dp_rolls, one_rolls)
    rows_rel = [rel_err(dp_rolls[i], one_rolls[i])[0] for i in range(SERVE_BATCH)]
    # the rows differ from one another, so a misplaced stripe cannot pass
    rows_distinct = len({r.numpy().tobytes() for r in one_rolls})
    if not rolls_rel < GATE or rows_distinct != SERVE_BATCH:
        raise RuntimeError(f"dp test rolls against one process: rel {rolls_rel} (rows {rows_rel}), "
                           f"{rows_distinct} distinct rows of {SERVE_BATCH}")
    metric_diff = {}
    for r in ranks:
        got = r["test"]["metrics"]
        if got["n_clips"] != TEST_RECORDINGS or r["test"]["launches"]["fused_sample"] != 1 or \
                r["test"]["k2_rows"] != [SERVE_BATCH // 2]:
            raise RuntimeError(f"dp test on rank {r['rank']}: {r['test']}")
        metric_diff = {k: abs(got[k] - single[k]) for k in single}
        if max(metric_diff.values()) > DP_METRICS_TOL or sorted(got) != sorted(single):
            raise RuntimeError(f"dp test metrics {got} against one process {single}")
    for r in ranks:
        d = r["distill"]
        if d["stages"] != [DISTILL_STAGES[0]] or d["launches"]["gated_stack"] != \
                2 * DISTILL_STEPS or d["launches"]["fwd_saves"] != DISTILL_STEPS:
            raise RuntimeError(f"dp distill on rank {r['rank']}: {d}")
    if len(list((out / "distill").glob("*/*/distill-*/distilled_*steps"))) != 1:
        raise RuntimeError("dp distill: rank 0 alone must write the stage checkpoint")

    # one process at world size 1 over NCCL, as torchrun --nproc_per_node=1 sets it up
    nccl_env = {**env, "RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    run_workers([[sys.executable, script, "--nccl-worker", str(spec_path)]], [nccl_env],
                "dp (NCCL, world size 1)")
    nccl = json.loads((out / "nccl.json").read_text())
    if nccl["backend"] != "nccl" or nccl["world"] != 1 or nccl["step"] != TRAIN_STEPS or \
            nccl["launches"] != {"fwd_saves": TRAIN_STEPS, "bwd": TRAIN_STEPS}:
        raise RuntimeError(f"dp over NCCL: {nccl}")
    phase("dp", seconds=time.perf_counter() - t0, ranks=2, backend="gloo", global_batch=TRAIN_BATCH,
          train={k: r0["train"][k] for k in ("seconds", "step", "launches")},
          same_bits_on_both_ranks=True,
          step_ms={"2 ranks sharing one card: not a scaling figure": [r["step_ms"] for r in ranks]},
          step_vs_one_process=step_rel,
          test={"metrics": {k: r0["test"]["metrics"][k] for k in ("n_clips", "note_f1", "frame_f1")},
                "max_metric_diff_vs_one_process": max(metric_diff.values()),
                "rolls_vs_one_process": {"rel": rolls_rel, "max_abs": rolls_abs,
                                         "rows_rel": rows_rel, "gate": GATE,
                                         "rows_distinct": rows_distinct,
                                         "same_bits": bool(torch.equal(dp_rolls, one_rolls))},
                "tolerance": DP_METRICS_TOL, "k2_rows_per_rank": r0["test"]["k2_rows"],
                "seconds": r0["test"]["seconds"], "launches": r0["test"]["launches"]},
          distill={k: r0["distill"][k] for k in ("seconds", "stages", "launches")},
          nccl_world1=nccl)
    full = lambda d: {fn.__name__: d.get(fn.__name__, 0) for fn in kernels}  # noqa: E731
    return {"dp_train": full(r0["train"]["launches"]), "dp_test": full(r0["test"]["launches"]),
            "dp_distill": full(r0["distill"]["launches"])}


MESH_PHASES = ("mp", "serve_mesh", "sp")
SP_STEPS = 20             # phase sp's strided reverse process
SP_FORWARD_GATE, SP_SAMPLE_GATE = 1e-4, 1e-3   # f32 against the dense modules (TF32 off)


def mesh_worker(name: str, rank: int, world: int, port: int, spec_path: str) -> int:
    """One rank of phase `name` (mp, serve_mesh or sp): a gloo group of
    `world` ranks on the one card."""
    import torch.distributed as dist

    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    from diffroll_tpu_torch.ops import _build
    from diffroll_tpu_torch.ops.gated_stack import gated_stack
    from diffroll_tpu_torch.ops.gated_stack_train import bwd, fwd_saves
    from diffroll_tpu_torch.ops.depthwise_conv import depthwise_conv
    from diffroll_tpu_torch.ops.group_norm import group_norm
    from diffroll_tpu_torch.ops.sampler_kernel import fused_sample

    _build.library()
    kernels = (gated_stack, fused_sample, fwd_saves, bwd, group_norm, depthwise_conv)
    res = {"mp": mp_rank, "serve_mesh": serve_mesh_rank, "sp": sp_rank}[name](rank, spec, kernels)
    res["rank"] = rank
    (pathlib.Path(spec["out"]) / f"{name}_rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mp_rank(rank: int, spec: dict, kernels) -> dict:
    """Phase mp on one rank (data=1, model=2): `train` with K3 + K4, one
    fixed-draw step on both routes (rank 0 saves the whole gradients), one
    distill stage."""
    from diffroll_tpu_torch import config as tconfig
    from diffroll_tpu_torch.cli import distill as cli_distill
    from diffroll_tpu_torch.cli import train as cli_train
    from diffroll_tpu_torch.compat import load_lightning, param_sharding
    from diffroll_tpu_torch.parallel import setup_mesh, shard_module
    from diffroll_tpu_torch.parallel.model_axis import full_state_dict, full_tensors
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
    from diffroll_tpu_torch.train import TrainState, make_train_step

    dev = torch.device("cuda")
    res = {}
    reset_launches(*kernels)
    t0 = time.perf_counter()
    state = cli_train.main(spec["train_args"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    net = state.model.net
    whole = full_state_dict(net)
    moments = [v for st in state.optimizer.state.values() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    rule = param_sharding(net, 2)
    res["train"] = {
        "seconds": seconds, "step": state.step, "launches": kernel_launches(kernels),
        "digest": params_digest_of(whole), "sharded_leaves": len(rule),
        "param_bytes": nbytes(*net.parameters()), "moment_bytes": nbytes(*moments),
        "one_process_param_bytes": nbytes(*whole.values()),
        "jax_rule_share_bytes": sum(v.numel() * 4 // (2 if n in rule else 1)
                                    for n, v in whole.items())}
    del state, net, whole, moments

    mesh = setup_mesh(tconfig.compose("spec_roll", {"trainer.model_axis": "2",
                                                    "trainer.data_axis": "1"}), dev)
    grads = {}
    for route, fused in (("fused", True), ("modules", False)):
        model, _ = load_lightning(spec["ckpt"], device=dev)
        batch, draws = seeded_step_inputs(model.config, dev)
        st = TrainState.create(model, 0.0)   # lr 0: the weights stay the compared ones
        shard_module(model.net, mesh, st.optimizer)
        task = DiffusionTask(model, TaskConfig(timesteps=model.config.timesteps,
                                               fused_train=fused), mesh=mesh)
        step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train, **draws), mesh)
        step(st, batch, None)
        got = full_tensors(model.net, {n: p.grad for n, p in model.net.named_parameters()})
        grads[route] = {n: g.detach().cpu() for n, g in got.items()}
        if fused:
            res["step_ms"] = time_ms(lambda: step(st, batch, None), 3, 1)
        del model, st, task, step
    if rank == 0:
        torch.save(grads, pathlib.Path(spec["out"]) / "mp_grads.pt")
    del grads

    reset_launches(*kernels)
    t0 = time.perf_counter()
    summary = cli_distill.main(spec["distill_args"])
    torch.cuda.synchronize()
    res["distill"] = {"seconds": time.perf_counter() - t0, "stages": summary["stages"],
                      "run_dir": summary["run_dir"], "launches": kernel_launches(kernels)}
    return res


def serve_mesh_rank(rank: int, spec: dict, kernels) -> dict:
    """Phase serve_mesh on one rank (data=2, or model=2): the service
    `serve` builds; rank 0 takes two requests through `transcribe` (the
    rolls saved), then the HTTP bursts where `spec["bodies"]` holds any;
    the other rank follows."""
    import threading
    import urllib.request

    from diffroll_tpu_torch.cli import serve as cli_serve
    from diffroll_tpu_torch.serve import serve_forever

    reset_launches(*kernels)
    svc, cfg, info = cli_serve.make_service(spec["serve_args"])
    res = {"max_batch": svc.max_batch,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in svc.task.model.net.parameters())}
    if not svc.leads:
        svc.follow()
        torch.cuda.synchronize()
        res.update(batches=svc.stats["batches"], launches=kernel_launches(kernels))
        return res
    reset_launches(*kernels)
    audio = np.load(spec["audio"])
    rolls = {k: svc.transcribe(audio[k]) for k in ("long", "short")}
    np.savez(pathlib.Path(spec["out"]) / spec["rolls"], **rolls)
    if not spec["bodies"]:
        svc.close()
        torch.cuda.synchronize()
        res.update(batches=svc.stats["batches"], launches=kernel_launches(kernels))
        return res
    ready = threading.Event()
    threading.Thread(target=serve_forever, args=(svc, "127.0.0.1", 0),
                     kwargs={"info": info, "ready": ready}, daemon=True).start()
    if not ready.wait(30):
        raise RuntimeError("the HTTP front did not start")
    server = ready.server
    url = f"http://127.0.0.1:{server.server_address[1]}/transcribe"
    bodies = [pathlib.Path(b).read_bytes() for b in spec["bodies"]]

    def burst(n):
        out = [None] * n

        def post(i):
            req = urllib.request.Request(url, data=bodies[i % len(bodies)], method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                out[i] = json.loads(r.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        return out

    try:
        before = dict(svc.stats)
        first = burst(SERVE_BATCH)
        mid = dict(svc.stats)
        t0 = time.perf_counter()
        load = burst(4 * SERVE_BATCH)
        load_s = time.perf_counter() - t0
        after = dict(svc.stats)
    finally:
        server.shutdown()
        svc.close()
    torch.cuda.synchronize()
    res.update(frames=[p and p["frames"] for p in first + load],
               first_burst_batches=mid["batches"] - before["batches"],
               load_batches=after["batches"] - mid["batches"], load_seconds=load_s,
               load_requests=4 * SERVE_BATCH, batches=after["batches"],
               launches=kernel_launches(kernels))
    return res


def sp_rank(rank: int, spec: dict, kernels) -> dict:
    """Phase sp on one rank (data=2): the flagship's forward and a strided
    reverse process with the window's 640 frames split 320 + 320; rank 0
    holds both against the dense modules on the same inputs and draws."""
    from diffroll_tpu_torch import config as tconfig
    from diffroll_tpu_torch.compat import load_lightning
    from diffroll_tpu_torch.parallel import (
        sample_sequence_parallel, sequence_parallel_forward, setup_mesh)
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig

    dev = torch.device("cuda")
    mesh = setup_mesh(tconfig.compose("spec_roll", {"trainer.data_axis": "2"}), dev)
    model, _ = load_lightning(spec["ckpt"], device=dev)
    mc = model.config
    g = torch.Generator().manual_seed(SEED + 41)
    x = torch.randn(2, mc.frames, mc.pitches, generator=g).to(dev)
    t = torch.randint(0, mc.timesteps, (2,), generator=g).to(dev)
    cond = torch.rand(2, mc.frames, mc.n_mels, generator=g).to(dev)
    x_T = torch.randn(1, mc.frames, mc.pitches, generator=g).to(dev)
    noise = torch.randn(SP_STEPS, 1, mc.frames, mc.pitches, generator=g).to(dev)
    wav = torch.from_numpy(chord_wav(mc.frames * mc.mel.hop_length / mc.mel.sample_rate,
                                     mc.mel.sample_rate, SEED + 42))[None].to(dev)
    task = DiffusionTask(model.eval(), TaskConfig(timesteps=mc.timesteps, sampling_steps=SP_STEPS,
                                                  w=W_GUIDANCE, use_fused=False,
                                                  use_megakernel=False))
    reset_launches(*kernels)
    with torch.no_grad():
        out = sequence_parallel_forward(mesh, model.net, x, t, cond)
        fwd_ms = time_ms(lambda: sequence_parallel_forward(mesh, model.net, x, t, cond), 3, 1)
    t0 = time.perf_counter()
    x0 = sample_sequence_parallel(task, x_T, mesh, waveform=wav, noise=noise)[0]
    torch.cuda.synchronize()
    res = {"frames_per_rank": mc.frames // mesh.data, "forward_ms": fwd_ms,
           "sample_seconds": time.perf_counter() - t0, "launches": kernel_launches(kernels)}
    if rank == 0:
        with torch.no_grad():
            dense = model.apply(x, t, cond)
        want, _ = task.sample(x_T, waveform=wav, noise=noise)
        res["forward_rel"], res["forward_max_abs"] = rel_err(out, dense)
        res["sample_rel"], res["sample_max_abs"] = rel_err(x0, want)
    return res


def params_digest_of(tensors: dict) -> str:
    """A hash of the bits of named tensors, in name order."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_mesh_workers(name: str, tmp: pathlib.Path, spec: dict) -> list:
    """Two processes of this script, ranks of a gloo group on the one card,
    running phase `name`; returns each rank's readings."""
    out = tmp / name
    out.mkdir(exist_ok=True)
    spec = {"out": str(out), **spec}
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    script, env = worker_env()
    port = free_port()
    run_workers([[sys.executable, script, "--mesh-worker", name, str(r), "2", str(port),
                  str(spec_path)] for r in range(2)], [env, env], f"{name} (2 gloo ranks)")
    return [json.loads((out / f"{name}_rank{r}.json").read_text()) for r in range(2)]


def run_mp_phase(tmp: pathlib.Path, ckpt: pathlib.Path, kernels) -> dict:
    """Phase mp: the model axis, data=1 x model=2, two ranks sharing the one
    card (gloo): `train` at B=16 with K3 + K4 for 3 steps (both ranks' whole
    parameters the same bits; each rank's bytes beside one process's and
    the JAX rule's share), a fixed-draw step against one process, the
    model_axis=2 checkpoint loaded by one process for `transcribe` of one
    window (K2), and one distill stage. Returns the launch counts of
    mp_train and mp_distill (rank 0's; both ranks' are checked)."""
    from diffroll_tpu_torch.cli import transcribe as cli_transcribe
    from diffroll_tpu_torch.ops.sampler_kernel import fused_sample

    t0 = time.perf_counter()
    out = tmp / "mp"
    axes = ["trainer.model_axis=2", "trainer.data_axis=1"]
    common = [f"dataset.root={tmp / 'data'}", "device=cuda", "audio_format=wav",
              f"dataloader.train_batch_size={TRAIN_BATCH}", *axes]
    spec = {"ckpt": str(ckpt),
            "train_args": ["spec_roll", "task.fused_train=true", "trainer.max_epochs=1",
                           "trainer.check_val_every_n_epoch=1", "trainer.log_every_n_steps=1",
                           f"trainer.output_dir={out / 'train'}", *common],
            "distill_args": [f"pretrained_path={ckpt}", f"distill.start_steps={DISTILL_STAGES[0]}",
                             "distill.stages=1", f"distill.steps_per_stage={DISTILL_STEPS}",
                             "task.fused_train=true", f"trainer.output_dir={out / 'distill'}",
                             *common]}
    ranks = run_mesh_workers("mp", tmp, spec)
    r0, r1 = ranks
    for r in ranks:
        tr, d = r["train"], r["distill"]
        if tr["step"] != TRAIN_STEPS or tr["launches"]["fwd_saves"] != TRAIN_STEPS or \
                tr["launches"]["bwd"] != TRAIN_STEPS:
            raise RuntimeError(f"mp train on rank {r['rank']}: {tr}")
        if tr["param_bytes"] != tr["jax_rule_share_bytes"] or \
                not tr["param_bytes"] < tr["one_process_param_bytes"]:
            raise RuntimeError(f"mp train on rank {r['rank']}: the chunks are not the rule's: {tr}")
        if d["stages"] != [DISTILL_STAGES[0]] or d["launches"]["gated_stack"] != \
                2 * DISTILL_STEPS or d["launches"]["fwd_saves"] != DISTILL_STEPS or \
                d["launches"]["bwd"] != DISTILL_STEPS:
            raise RuntimeError(f"mp distill on rank {r['rank']}: {d}")
    if r0["train"]["digest"] != r1["train"]["digest"]:
        raise RuntimeError("mp train: the two ranks' whole parameters differ")
    runs = list((out / "train").glob("*/*/train-*"))
    if len(runs) != 1 or not (runs[0] / "checkpoints" / "last.ckpt").exists():
        raise RuntimeError(f"mp train wrote {runs}: rank 0 alone must write")
    if len(list((out / "distill").glob("*/*/distill-*/distilled_*steps"))) != 1:
        raise RuntimeError("mp distill: rank 0 alone must write the stage checkpoint")
    step_rel = step_against_one_process(ckpt, out / "mp_grads.pt", "mp")

    # the model_axis=2 checkpoint in one process: transcribe one window through K2
    reset_launches(fused_sample)
    tr_dir = cli_transcribe.main([
        f"pretrained_path={runs[0] / 'checkpoints' / 'last.ckpt'}",
        f"dataset.audio_path={tmp / 'window'}", "dataset.audio_ext=wav", f"task.w={W_GUIDANCE}",
        "device=cuda", f"trainer.output_dir={out / 'transcribe'}"])
    torch.cuda.synchronize()
    roll = np.load(next(pathlib.Path(tr_dir).glob("*.npz")))["roll"]
    if not np.isfinite(roll).all() or fused_sample.launches != 1:
        raise RuntimeError(f"mp checkpoint in one process: roll {roll.shape}, "
                           f"K2 {fused_sample.launches}")
    phase("mp", seconds=time.perf_counter() - t0, ranks=2, data=1, model=2, backend="gloo",
          batch=TRAIN_BATCH,
          train={k: r0["train"][k] for k in ("seconds", "step", "launches", "sharded_leaves")},
          bytes_per_rank={f"rank{r['rank']}": {k: r["train"][k] for k in (
              "param_bytes", "moment_bytes", "one_process_param_bytes",
              "jax_rule_share_bytes")} for r in ranks},
          same_bits_on_both_ranks=True,
          step_ms={"2 ranks sharing one card: not a scaling figure": [r["step_ms"] for r in ranks]},
          step_vs_one_process=step_rel, one_process_transcribe={
              "roll_shape": list(roll.shape), "launches_k2": fused_sample.launches},
          distill={k: r0["distill"][k] for k in ("seconds", "stages", "launches")})
    full = lambda d: {fn.__name__: d.get(fn.__name__, 0) for fn in kernels}  # noqa: E731
    return {"mp_train": full(r0["train"]["launches"]), "mp_distill": full(r0["distill"]["launches"])}


def run_serve_mesh_phase(tmp: pathlib.Path, ckpt: pathlib.Path, kernels) -> dict:
    """Phase serve_mesh: the service over the data axis (data=2), two ranks
    sharing the one card (gloo), `serve`'s defaults (max_batch 8: 4 rows a
    rank). Two requests through rank 0's `transcribe` (8 windows, then 1:
    two batches) against a one-process service with the same seed and the
    same batches, rel < 0.05 with each row's error printed; then 8
    concurrent 20 s requests through rank 0's HTTP front, and a burst of 32
    for windows per second. K2 once a batch on each rank. Then the same two
    requests through a service at data=1 x model=2 (each rank its chunk of
    the weights, K2 on the weights gathered once), against the same
    one-process rolls, rel < 0.05. Returns rank 0's launch counts of the
    data-axis run."""
    from diffroll_tpu_torch.cli import serve as cli_serve
    from diffroll_tpu_torch.tasks.transcribe import split_windows

    t0 = time.perf_counter()
    sr = 16000
    argv = [f"pretrained_path={ckpt}", "device=cuda"]
    svc_frames, hop, overlap = 640, 512, 32
    seq = svc_frames * hop
    long = chord_wav((seq + 7 * (seq - overlap * hop)) / sr, sr, SEED + 51)
    short = chord_wav(12.0, sr, SEED + 52)
    if len(split_windows(long, seq, hop, overlap)) != SERVE_BATCH:
        raise RuntimeError("serve_mesh: the long request is not one batch of windows")
    np.savez(tmp / "serve_mesh_audio.npz", long=long, short=short)
    bodies = []
    for i in range(SERVE_BATCH):
        path = tmp / f"serve_mesh_body{i}.wav"
        write_wav(path, chord_wav(20.0, sr, SEED + 10 + i), sr)
        bodies.append(str(path))
    ranks = run_mesh_workers("serve_mesh", tmp, {
        "serve_args": argv + ["trainer.data_axis=2"], "audio": str(tmp / "serve_mesh_audio.npz"),
        "bodies": bodies, "rolls": "data_rolls.npz"})
    r0, r1 = ranks
    want_frames = math.ceil(20.0 * sr / hop)
    if not r0["max_batch"] == r1["max_batch"] == SERVE_BATCH or any(
            f != want_frames for f in r0["frames"]):
        raise RuntimeError(f"serve_mesh: max_batch {r0['max_batch']}, frames {r0['frames']}")
    # rank 0's counts start after the warm-up, rank 1's before it
    if not (r0["launches"]["fused_sample"] == r0["batches"] and
            r1["launches"]["fused_sample"] == r1["batches"] == r0["batches"] + 1):
        raise RuntimeError(f"serve_mesh: K2 not once a batch on each rank: {ranks}")
    if not r0["first_burst_batches"] < SERVE_BATCH:
        raise RuntimeError(f"serve_mesh: the burst's requests shared no batch: {r0}")
    # the model axis (data=1 x model=2): each rank holds its chunk of the
    # weights and runs K2 on the whole batch, on the weights gathered once
    m0, m1 = run_mesh_workers("serve_mesh", tmp, {
        "serve_args": argv + ["trainer.model_axis=2"], "audio": str(tmp / "serve_mesh_audio.npz"),
        "bodies": [], "rolls": "model_rolls.npz"})
    if not (m0["launches"]["fused_sample"] == m0["batches"] and
            m1["launches"]["fused_sample"] == m1["batches"] == m0["batches"] + 1):
        raise RuntimeError(f"serve_mesh (model=2): K2 not once a batch on each rank: {m0} {m1}")
    if not m0["param_bytes"] == m1["param_bytes"] < r0["param_bytes"]:
        raise RuntimeError(f"serve_mesh (model=2): the ranks do not hold chunks: {m0} {m1}")
    got = np.load(tmp / "serve_mesh" / "data_rolls.npz")
    got_mp = np.load(tmp / "serve_mesh" / "model_rolls.npz")
    svc, _, _ = cli_serve.make_service(argv)
    try:
        audio = np.load(tmp / "serve_mesh_audio.npz")
        want = {k: svc.transcribe(audio[k]) for k in ("long", "short")}
        batch_size = batch_size_dependence(svc.task, split_windows(long, seq, hop, overlap))
    finally:
        svc.close()
    rows = {k: rel_err(torch.from_numpy(got[k]), torch.from_numpy(want[k]))[0] for k in want}
    rows_mp = {k: rel_err(torch.from_numpy(got_mp[k]), torch.from_numpy(want[k]))[0]
               for k in want}
    if got_mp["long"].shape != want["long"].shape or not max(rows_mp.values()) < GATE:
        raise RuntimeError(f"serve_mesh (model=2) rolls against one process: {rows_mp}")
    stride = svc_frames - overlap   # each window's frames of the long request's stitched roll
    windows = [rel_err(torch.from_numpy(got["long"][s: s + svc_frames]),
                       torch.from_numpy(want["long"][s: s + svc_frames]))[0]
               for s in range(0, stride * SERVE_BATCH, stride)]
    if got["long"].shape != want["long"].shape or not max(rows.values()) < GATE:
        raise RuntimeError(f"serve_mesh rolls against one process: {rows}")
    phase("serve_mesh", seconds=time.perf_counter() - t0, ranks=2, data=2, backend="gloo",
          max_batch=r0["max_batch"], rows_per_rank=r0["max_batch"] // 2,
          rolls_vs_one_process={"rel": rows, "gate": GATE,
                                "long_request_window_rel": windows},
          one_process_b4_vs_b8=batch_size,
          http_requests=SERVE_BATCH, frames=want_frames,
          first_burst_batches=r0["first_burst_batches"],
          windows_per_second={"2 ranks sharing one card: not a scaling figure":
                              r0["load_requests"] / r0["load_seconds"]},
          load_batches=r0["load_batches"], launches=r0["launches"],
          launches_rank1=r1["launches"],
          model_axis={"data": 1, "model": 2, "rolls_vs_one_process": {"rel": rows_mp,
                                                                      "gate": GATE},
                      "param_bytes_per_rank": m0["param_bytes"],
                      "param_bytes_one_process": r0["param_bytes"],
                      "launches": m0["launches"], "launches_rank1": m1["launches"]})
    return {fn.__name__: r0["launches"].get(fn.__name__, 0) for fn in kernels}


def batch_size_dependence(task, windows: np.ndarray) -> dict:
    """One process, the long request's 8 windows (int16 PCM, as the service
    sends them): the mel and K2's rolls of the even rows as a batch of 4
    against the same rows of the batch of 8, on the same draws; each row's
    rel error (what a stripe of the mesh service computes differently from
    one process, whatever the mesh does)."""
    from diffroll_tpu_torch.diffusion.loop import timestep_subsequence

    dev = torch.device("cuda")
    pcm = (np.clip(windows, -1.0, 1.0) * 32767.0).astype(np.int16)
    wav = torch.from_numpy(pcm).to(dev).float() * (1.0 / 32768.0)
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    x_T = torch.randn((len(windows),) + (640, 88), generator=g, device=dev)
    n = len(timestep_subsequence(task.config.timesteps, task.config.sampling_steps))
    noise = torch.randn((n,) + tuple(x_T.shape), generator=g, device=dev)
    with torch.no_grad():
        mel8 = task.model.conditioner(waveform=wav)
        mel4 = task.model.conditioner(waveform=wav[0::2])
    b8 = task.sample(x_T, waveform=wav, noise=noise)[0]
    b4 = task.sample(x_T[0::2], waveform=wav[0::2], noise=noise[:, 0::2])[0]
    return {"mel_rows_rel": [rel_err(mel4[i], mel8[2 * i])[0] for i in range(len(mel4))],
            "k2_rows_rel": [rel_err(b4[i], b8[2 * i])[0] for i in range(len(b4))]}


def run_sp_phase(tmp: pathlib.Path, ckpt: pathlib.Path, kernels) -> dict:
    """Phase sp: sequence parallelism, data=2, two ranks sharing the one
    card: the flagship's 640-frame window split 320 + 320 (halo at most 8):
    the forward against the dense modules (rel < 1e-4, f32, TF32 off) and a
    strided 20-step reverse process against the dense modules sampler on the
    same draws (rel < 1e-3). No kernel launches. Returns rank 0's counts."""
    t0 = time.perf_counter()
    ranks = run_mesh_workers("sp", tmp, {"ckpt": str(ckpt)})
    r0 = ranks[0]
    if any(any(r["launches"].values()) for r in ranks):
        raise RuntimeError(f"sp launched a kernel: {[r['launches'] for r in ranks]}")
    if not (r0["forward_rel"] < SP_FORWARD_GATE and r0["sample_rel"] < SP_SAMPLE_GATE):
        raise RuntimeError(f"sp against the dense modules: {r0}")
    phase("sp", seconds=time.perf_counter() - t0, ranks=2, data=2, backend="gloo",
          frames_per_rank=r0["frames_per_rank"], forward_rel=r0["forward_rel"],
          forward_max_abs=r0["forward_max_abs"], forward_gate=SP_FORWARD_GATE,
          sample_rel=r0["sample_rel"], sample_max_abs=r0["sample_max_abs"],
          sample_gate=SP_SAMPLE_GATE, sample_steps=SP_STEPS,
          forward_ms={"2 ranks sharing one card: not a scaling figure":
                      [r["forward_ms"] for r in ranks]},
          sample_seconds={"2 ranks sharing one card: not a scaling figure":
                          [r["sample_seconds"] for r in ranks]},
          launches=r0["launches"])
    return {fn.__name__: r0["launches"].get(fn.__name__, 0) for fn in kernels}


LEARN_STEPS = 2000        # the learning check at the JAX script's defaults
LEARN_CLIPS = 64
# The learning check's F1 gates read the mean over a route's seeds (seed s:
# weights drawn after torch.manual_seed(s), training stream seeded s + 1; seed
# 0 is the check itself). A random model reads near 0. One run spreads over
# seeds with sd ~0.018 frame F1 (the port's six: 0.5954-0.6358, sd 0.0177; the
# JAX script's own recipe on the CPU: 0.6051-0.6470, mean 0.6304; PERF.md
# section 6), so a gate on one seed at 0.60 sits inside that spread. The mean
# of six has a sixth of one run's variance (sd ~0.007), so the same thresholds
# separate starts better both ways: a start whose true mean is 0.595 passes
# one seed 39% of the time and the six-seed mean 24%; one at 0.585, 20% against
# 2%; one at the port's 0.6146, 80% against 98%. Three seeds give sd ~0.010
# (31%, 7%, 92%). The thresholds are those of the one-seed gate before it.
LEARN_NOTE_F1, LEARN_FRAME_F1 = 0.40, 0.60
LEARN_SEEDS = {"learn_fused": 6, "learn_autograd": 3}   # seeds 0 .. n - 1 of each route
JAX_SCRIPT_FRAME_F1 = {"mean": 0.6304, "range": [0.6051, 0.6470], "seeds": 6,
                       "run": "tests/learning_seeds.py jax, on the CPU"}   # printed, not gated
LEARN_DDIM_STEPS = 25     # tests/test_convergence.py:69-79's strided gate, at a quarter of 100
LEARN_DDIM_TOL = 0.05
TREE_TRAIN, TREE_TEST, TREE_SECONDS = 32, 8, 4.096   # one 128-frame window a recording
CLI_TWIN_EPOCHS = 250     # 32 recordings at B=8: 4 steps an epoch, 1,000 steps
LONGFORM_SECONDS = 60     # cut from the JAX tool's 180
BOUNDARY_ARGS = ["steps=1000", "n_train=64", "n_long=2"]   # cut from 4000, 128, 8
TWIN_KEYS = ["model.residual_channels=128", "model.residual_layers=8", "model.frames=128",
             "dataset.sequence_length=65536", "task.timesteps=100"]


def finite_tree(tree) -> bool:
    if isinstance(tree, dict):
        return all(finite_tree(v) for v in tree.values())
    if isinstance(tree, float):
        return math.isfinite(tree)
    return True


def random_twin(size: dict):
    """The twin (`synthetic_end_to_end.build_twin`, `size` its overrides) on
    the card, from seed 0, with an N(0, 0.1^2) head so its output is not 0."""
    from diffroll_tpu_torch.quality import synthetic_end_to_end

    torch.manual_seed(0)
    twin = synthetic_end_to_end.build_twin(size)
    torch.nn.init.normal_(twin.net.output_projection.weight, std=0.1)
    return twin.to(torch.device("cuda"))


def kernel_rounded(w):
    """The stack weights as the kernels receive them: rounded to bf16."""
    return w._replace(**{k: getattr(w, k).to(torch.bfloat16).float() for k in ("wd", "wc", "wo")})


def hold_training_kernels(twin, b: int, where: str) -> dict:
    """K3 and K4 at the shape every training step of phase `where` gives
    them: `twin`'s widths and dilations, B=`b` sequences of its frames (one
    row tile a sequence at 128 frames, the dilation halo at both ends of
    it), the 229-bin conditioner. Held against their plain versions on the
    kernels' own bf16-rounded weights: K3's skip is K1's bit for bit, skip /
    xs / a and every K4 leaf (with and without dcond) below GATE, and a
    second run gives the same bits. Returns the readings; raises on a miss."""
    from diffroll_tpu_torch.ops.fused_forward import FusedOperands
    from diffroll_tpu_torch.ops.gated_stack import gated_stack
    from diffroll_tpu_torch.ops.gated_stack_train import bwd, bwd_ref, fwd_saves, fwd_saves_ref

    dev = torch.device("cuda")
    dil, c, frames = twin.config.dilations(), twin.config.residual_channels, twin.config.frames
    ops = FusedOperands.of(twin.net)
    w, kw = ops.weights, ops.kernel
    wq = kernel_rounded(w)
    n_layers = len(dil)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(b, frames, c, device=dev, generator=gen)
    tb = 0.1 * torch.randn(n_layers, b, c, device=dev, generator=gen)
    cond = torch.rand(b, frames, twin.config.n_mels, device=dev, generator=gen)
    cot = torch.randn(b, frames, c, device=dev, generator=gen)
    with torch.no_grad():
        skip, xs, a = fwd_saves(x, tb, cond, w, dil, kweights=kw)
        skip2, xs2, a2 = fwd_saves(x, tb, cond, w, dil, kweights=kw)
        skip_r, xs_r, a_r = fwd_saves_ref(x, tb, cond, wq, dil)
        k1_same = torch.equal(skip, gated_stack(x, tb, cond, w, dil, kweights=kw))
    torch.cuda.synchronize()
    k3 = {"skip": rel_err(skip, skip_r), "xs": rel_err(xs, xs_r), "a": rel_err(a, a_r)}
    k3_same = torch.equal(skip, skip2) and torch.equal(xs, xs2) and torch.equal(a, a2)
    out = {"shape": [b, frames, c], "layers": n_layers, "dilations": list(dil),
           "k3_skip_is_k1_bitwise": k1_same, "k3_same_bits_on_rerun": k3_same,
           **{f"k3_{k}_rel": v[0] for k, v in k3.items()}, "k4": {}}
    ok = k1_same and k3_same and all(v[0] < GATE for v in k3.values())
    for need_dcond in (True, False):
        with torch.no_grad():
            got = leaves_of(bwd(dil, (tb, cond, w, xs, a), cot, need_dcond, kweights=kw))
            again = leaves_of(bwd(dil, (tb, cond, w, xs, a), cot, need_dcond, kweights=kw))
            want = leaves_of(bwd_ref(dil, (tb, cond, wq, xs, a), cot, need_dcond))
        torch.cuda.synchronize()
        name, rel, abs_err = worst_leaf(got, want)
        same = all(torch.equal(got[k], again[k]) for k in got)
        out["k4"]["dcond" if need_dcond else "no_dcond"] = {
            "leaves": sorted(want), "worst_leaf": name, "rel": rel, "max_abs_err": abs_err,
            "same_bits_on_rerun": same}
        ok = ok and rel < GATE and same and ("dcond" in got) == need_dcond
    out["gate"] = GATE
    if not ok:
        phase(where, failed_hold="training_kernels", **out)
        raise RuntimeError(f"{where}: K3 or K4 at the path's training shape disagrees with "
                           f"its plain version or with itself on a second run: {out}")
    return out


def run_learn_phase(tmp: pathlib.Path, kernels) -> dict:
    """Phase learn: K3 and K4 held at the twin's shape, the learning check on
    both training routes, the quality tools on a CLI-trained twin, and the
    trained twin's reverse process against the plain version (ROADMAP Queue
    3's bf16 item). Returns each path's launches."""
    from diffroll_tpu_torch.cli import train as cli_train
    from diffroll_tpu_torch.quality import (
        bf16_drift, eval_boundary, eval_inpainting, eval_longform, make_synthetic_tree,
        synthetic_end_to_end)

    t_phase = time.perf_counter()
    paths, routes, twin = {}, {}, None
    # the kernels of every training step below, at that step's shape, against
    # their plain versions (these launches are not counted: each path resets)
    twin_hold = hold_training_kernels(random_twin({}), synthetic_end_to_end.BATCH, "learn")
    # (a) the learning check at the JAX defaults over each route's seeds, both
    # routes from the same inits and draws: K3 + K4, then autograd through the
    # f32 modules (TF32 is off). Each seed's run is gated on its own losses,
    # DDIM score and launches; the F1 gates read each route's mean
    t_check = time.perf_counter()
    check_args = synthetic_end_to_end.parse_args([
        f"steps={LEARN_STEPS}", f"n_train={LEARN_CLIPS}", "corpus=v2", "sweep_steps=1",
        "device=cuda"])
    clips = synthetic_end_to_end.check_clips(check_args, torch.device("cuda"))
    for name, n_seeds in LEARN_SEEDS.items():
        fused = name == "learn_fused"
        rows = []
        for seed in range(n_seeds):
            reset_launches(*kernels)
            t0 = time.perf_counter()
            m, tw = synthetic_end_to_end.learning_check(
                {**check_args, "fused_train": str(int(fused))}, seed, clips)
            ddim = tw.score("cfdg_ddim_x0", LEARN_DDIM_STEPS)
            torch.cuda.synchronize()
            launches = kernel_launches(kernels)
            losses = m["losses"]
            first, mid, last = (losses[str(i)] for i in (0, LEARN_STEPS // 2, LEARN_STEPS - 1))
            row = dict(seed=seed, note_f1=m["note_f1"], frame_f1=m["frame_f1"],
                       note_p_r=[m["note_precision"], m["note_recall"]],
                       frame_p_r=[m["frame_precision"], m["frame_recall"]],
                       losses={"0": first, str(LEARN_STEPS // 2): mid,
                               str(LEARN_STEPS - 1): last},
                       ddim25={"note_f1": ddim["note_f1"], "frame_f1": ddim["frame_f1"]},
                       steps_sweep=m["steps_sweep"], seconds=time.perf_counter() - t0,
                       train_and_score_s=m["wall_s"], launches=launches)
            rows.append(row)
            want_k34 = LEARN_STEPS if fused else 0
            if not (last < 0.5 * first and ddim["frame_f1"] >= m["frame_f1"] - LEARN_DDIM_TOL
                    and launches["fwd_saves"] == want_k34 and launches["bwd"] == want_k34
                    and launches["fused_sample"] == 10 and finite_tree(m)):
                phase("learn", failed_route=name, failed_seed=seed, **row)
                raise RuntimeError(f"learn: seed {seed} of the {name} route missed a gate: {row}")
            if seed == 0:  # `launches_by_path`: seed 0's run, the check itself
                paths[name] = launches
                if fused:
                    twin = tw
            del tw
        routes[name] = dict(fused_train=fused, seeds=rows,
                            **synthetic_end_to_end.over_seeds(rows),
                            clears_on_mean=synthetic_end_to_end.clears_on_mean(
                                rows, LEARN_NOTE_F1, LEARN_FRAME_F1))
    fused_minus_autograd = [  # over the seeds both routes ran
        {"seed": f["seed"], "note_f1": f["note_f1"] - a["note_f1"],
         "frame_f1": f["frame_f1"] - a["frame_f1"]}
        for f, a in zip(routes["learn_fused"]["seeds"], routes["learn_autograd"]["seeds"])]
    check = dict(seconds=time.perf_counter() - t_check,
                 gate={"mean_note_f1": LEARN_NOTE_F1, "mean_frame_f1": LEARN_FRAME_F1},
                 jax_script_frame_f1=JAX_SCRIPT_FRAME_F1,
                 fused_minus_autograd=fused_minus_autograd)
    if not all(r["clears_on_mean"] for r in routes.values()):
        phase("learn", failed_gate="mean F1 over seeds", routes=routes, check=check)
        raise RuntimeError(f"learn: a route's mean F1 over its seeds is under the gate: {routes}")

    # (b) the tools on a twin trained through the CLI on a MAPS-layout tree
    tree = tmp / "quality_tree"
    make_synthetic_tree.write_tree(tree, TREE_TRAIN, TREE_TEST, TREE_SECONDS)
    reset_launches(*kernels)
    t0 = time.perf_counter()
    state = cli_train.main([
        "spec_roll", f"dataset.root={tree}", *TWIN_KEYS, "task.fused_train=true",
        "task.lr=4e-4", "dataloader.train_batch_size=8", "dataloader.val_batch_size=8",
        f"trainer.max_epochs={CLI_TWIN_EPOCHS}",
        f"trainer.check_val_every_n_epoch={CLI_TWIN_EPOCHS}", "trainer.log_every_n_steps=100",
        "device=cuda", f"trainer.output_dir={tmp / 'quality_train'}"])
    torch.cuda.synchronize()
    tools = {"cli_train": {"seconds": time.perf_counter() - t0, "steps": state.step}}
    paths["learn_cli_train"] = tools["cli_train"]["launches"] = kernel_launches(kernels)
    run_dir = next((tmp / "quality_train").glob("*/*/train-*"))
    ckpt = run_dir / "checkpoints" / "last.ckpt"
    post_fit = json.loads((run_dir / "test_metrics.json").read_text())
    tools["cli_train"]["test_metrics"] = {k: post_fit[k] for k in ("n_clips", "note_f1",
                                                                  "frame_f1")}
    del state
    if paths["learn_cli_train"]["fwd_saves"] != tools["cli_train"]["steps"]:
        raise RuntimeError(f"learn: cli train launched K3 {paths['learn_cli_train']}")
    on_ckpt = [f"ckpt={ckpt}", "w=0.5", "device=cuda"]
    # (path, tool, its arguments, K2 launches, K3 and K4 launches)
    runs = (("eval_inpainting_mask", eval_inpainting,
             on_ckpt + [f"root={tree}", "mask=48,80", f"tmpdir={tmp / 'inpainting'}"], 3, 0),
            ("eval_inpainting_fmask", eval_inpainting,
             on_ckpt + [f"root={tree}", "fmask=29,51", f"tmpdir={tmp / 'inpainting'}"], 3, 0),
            ("eval_longform", eval_longform, on_ckpt + [f"seconds={LONGFORM_SECONDS}"], 5, 0),
            ("eval_boundary", eval_boundary, BOUNDARY_ARGS + ["device=cuda"], 4, 1000))
    for name, module, argv, k2_calls, k34_calls in runs:
        reset_launches(*kernels)
        t0 = time.perf_counter()
        out = module.main(argv)
        torch.cuda.synchronize()
        paths[name] = kernel_launches(kernels)
        tools[name] = {"seconds": time.perf_counter() - t0, "launches": paths[name],
                       "result": out}
        if not (finite_tree(out) and paths[name]["fused_sample"] == k2_calls
                and paths[name]["fwd_saves"] == k34_calls == paths[name]["bwd"]):
            phase("learn", failed_tool=name, **tools[name])
            raise RuntimeError(f"learn: {name} gave non-finite metrics or launched "
                               f"{paths[name]} (K2 {k2_calls}, K3 / K4 {k34_calls} expected)")
        if name.startswith("eval_inpainting"):
            # the training step whose weights the band scores read: last.ckpt's
            tools[name]["scored_step"] = out["global_step"]
            if out["global_step"] != tools["cli_train"]["steps"]:
                raise RuntimeError(f"learn: {name} scored step {out['global_step']}, "
                                   f"not the run's last ({tools['cli_train']['steps']})")

    # (c) the trained twin's 100-step guided process at B=1 and B=8, K2 and the
    # step loop against the plain version on the same bf16-rounded weights
    # (gated) and on f32 weights (ROADMAP Queue 3's reading, not gated)
    drift = [bf16_drift.drift(twin.model, twin.test_audio[:b]) for b in (1, 8)]
    seconds = time.perf_counter() - t_phase
    phase("learn", seconds=seconds, twin_training_kernels=twin_hold, routes=routes,
          check=check, tools=tools, drift=drift,
          reduced={"eval_longform": f"seconds={LONGFORM_SECONDS} (180 in the JAX tool)",
                   "eval_boundary": " ".join(BOUNDARY_ARGS) + " (4000, 128, 8)",
                   "cli_train": f"{TREE_TRAIN} + {TREE_TEST} recordings of {TREE_SECONDS} s, "
                                f"~{CLI_TWIN_EPOCHS * TREE_TRAIN // 8} steps"})
    bad = [r for r in drift if not (r["finite"] and r["k2_rel_bf16_weights"] < GATE
                                    and r["loop_rel_bf16_weights"] < GATE)]
    if bad:
        raise RuntimeError(f"learn: K2 or the step loop on the trained twin disagrees with "
                           f"the plain version on the same bf16-rounded weights: {bad}")
    del twin
    return paths


PAPER_KEYS = ["model.residual_channels=128", "model.frames=128",
              "dataset.sequence_length=65536"]   # the kernels' widths; the smoke's 2 layers
PAPER_SIZE = {"layers": "2", "timesteps": "4"}     # the smoke's depth and T, at PAPER_KEYS
PAPER_BATCH = 8            # COMMON's train and test batches; the guided teacher runs 2 x 8


def hold_paper_kernels() -> dict:
    """The kernels at the shapes phase paper gives them: the smoke's net (2
    layers) at 128 channels, 128 frames and T=4, on random weights. K3 + K4
    at the training batch (every stage, twice a step in the dual retrain),
    K1 at the guided distillation teacher's 2 x 8 sequences, K2 over the
    w-sweep's guided process (cfdg_ddpm_x0, w=0.5, noise drawn) and the
    2-step student's one-stream ddim_x0 as `test` samples it, at B=8. Each
    against its plain version on the kernels' bf16-rounded weights below
    GATE, with the same bits on a second run. Returns the readings; raises
    on a miss."""
    from diffroll_tpu_torch.diffusion.samplers import SAMPLER_TABLE
    from diffroll_tpu_torch.ops.gated_stack import gated_stack, gated_stack_ref
    from diffroll_tpu_torch.ops.sampler_kernel import fused_sample, fused_sample_ref
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig

    twin = random_twin(PAPER_SIZE)
    mc, dev = twin.config, torch.device("cuda")
    out = {"training": hold_training_kernels(twin, PAPER_BATCH, "paper")}
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    s, dil = 2 * PAPER_BATCH, mc.dilations()
    task = DiffusionTask(twin, TaskConfig(timesteps=mc.timesteps))
    ops = task.sampler_operands().operands
    w, kw = ops.weights, ops.kernel
    wq = kernel_rounded(w)
    x = torch.randn(s, mc.frames, mc.residual_channels, device=dev, generator=gen)
    tb = 0.1 * torch.randn(len(dil), s, mc.residual_channels, device=dev, generator=gen)
    cond = torch.rand(s, mc.frames, mc.n_mels, device=dev, generator=gen)
    with torch.no_grad():
        k1 = gated_stack(x, tb, cond, w, dil, kweights=kw)
        k1_same = torch.equal(k1, gated_stack(x, tb, cond, w, dil, kweights=kw))
        k1_rel, k1_abs = rel_err(k1, gated_stack_ref(x, tb, cond, wq, dil))
    out["k1_teacher"] = {"shape": list(x.shape), "rel": k1_rel, "max_abs_err": k1_abs,
                         "same_bits_on_rerun": k1_same}
    ok = k1_rel < GATE and k1_same
    window_s = mc.frames * mc.mel.hop_length / mc.mel.sample_rate
    wav = torch.stack([torch.from_numpy(chord_wav(window_s, mc.mel.sample_rate, SEED + 62 + i))
                       for i in range(PAPER_BATCH)]).to(dev)
    for name, sampler, steps, w_mix in (("k2_wsweep", "cfdg_ddpm_x0", None, 0.5),
                                        ("k2_student", "ddim_x0", 2, 0.0)):
        task = DiffusionTask(twin, TaskConfig(timesteps=mc.timesteps, sampling_type=sampler,
                                              sampling_steps=steps, w=w_mix))
        so = task.sampler_operands()
        w, head, kw = so.operands.weights, so.operands.head, so.operands.kernel
        tables, t_bias, stochastic = so.tables, so.t_bias, so.stochastic
        guided = bool(SAMPLER_TABLE[sampler][2])
        x_T = torch.randn(PAPER_BATCH, mc.frames, mc.pitches, device=dev, generator=gen)
        noise = (torch.randn((tables.shape[0],) + tuple(x_T.shape), device=dev, generator=gen)
                 if stochastic else None)
        with torch.no_grad():
            cond = task.build_conditioner(x_T, wav)
            args = (x_T, noise, t_bias, tables, w, head, cond, dil, guided, w_mix, stochastic)
            got = fused_sample(*args, kweights=kw)
            same = torch.equal(got, fused_sample(*args, kweights=kw))
            ref = fused_sample_ref(x_T, noise, t_bias, tables, kernel_rounded(w), *args[5:])
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, ref)
        finite = bool(torch.isfinite(got).all())
        out[name] = {"batch": PAPER_BATCH, "sampler": sampler, "steps": tables.shape[0],
                     "streams": 2 if guided else 1, "noise": stochastic, "rel": rel,
                     "max_abs_err": abs_err, "same_bits_on_rerun": same, "finite": finite}
        ok = ok and rel < GATE and same and finite
    out["gate"] = GATE
    if not ok:
        phase("paper", failed_hold="paper_kernels", **out)
        raise RuntimeError(f"paper: K1 or K2 at the pipeline's shapes disagrees with its plain "
                           f"version or with itself on a second run: {out}")
    return out


def run_paper_phase(tmp: pathlib.Path, kernels) -> dict:
    """Phase paper: `quality.pretrain_both_pipeline smoke` on the card at the
    smallest width the kernels take (128 channels: K4's 128 x 128 tiles) and
    one row tile a sequence (128 frames), the smoke's depth, steps and
    corpora: pretraining, the dual retrain, the w-sweep, a guided
    distillation and the student's test. Returns its launches."""
    import shutil

    from diffroll_tpu_torch import native
    from diffroll_tpu_torch.compat import peek_global_step
    from diffroll_tpu_torch.quality import pretrain_both_pipeline

    # every kernel at the shapes below, against its plain version (these
    # launches are not counted: the counts are reset after)
    held = hold_paper_kernels()
    reset_launches(*kernels)
    t0 = time.perf_counter()
    out = pretrain_both_pipeline.main([
        "smoke", f"paired={tmp / 'paper_paired'}", f"unpaired={tmp / 'paper_unpaired'}",
        f"out={tmp / 'paper_out'}", *PAPER_KEYS, "device=cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches(kernels)
    native_tier = native.available()
    # the step of each checkpoint a later stage started from
    stage_steps = {k: peek_global_step(out[k]) for k in ("pretrain_ckpt", "retrain_ckpt")}
    phase("paper", seconds=seconds, kernels_held=held, stage_seconds=out["walls_s"],
          launches=launches, stage_steps=stage_steps,
          native_cpp_tier=native_tier, wsweep_note_f1=[r["note_f1"] for r in out["wsweep"]],
          students={n: {k: m[k] for k in ("n_clips", "note_f1", "frame_f1")}
                    for n, m in out["students"].items()},
          reduced="the script's smoke sizes (8 + 2 clips a tree, 2 layers, T=4, one epoch a "
                  "stage, 200 distill steps to a 2-step student) at 128 channels and 128 frames")
    if not all(launches[k] > 0 for k in ("gated_stack", "fused_sample", "fwd_saves", "bwd")) \
            or launches["fwd_saves"] != launches["bwd"] or launches["group_norm"] \
            or launches["depthwise_conv"]:
        raise RuntimeError(f"paper: the pipeline skipped a kernel: {launches}")
    if shutil.which("g++") and not native_tier:
        raise RuntimeError("paper: the native library fell back to numpy on a host with g++")
    if not (finite_tree(out["students"]) and out["students"] and finite_tree(
            {str(i): r for i, r in enumerate(out["wsweep"])})):
        raise RuntimeError(f"paper: non-finite metrics {out}")
    return launches


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
    from diffroll_tpu_torch.ops.fused_forward import FusedOperands
    from diffroll_tpu_torch.ops.gated_stack import gated_stack, gated_stack_ref
    from diffroll_tpu_torch.profile_gemm import bwd_gemm_times, gemm_times
    gs_module = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")
    gt_module = importlib.import_module("diffroll_tpu_torch.ops.gated_stack_train")
    from diffroll_tpu_torch.ops.gated_stack_train import bwd, bwd_ref, fwd_saves, fwd_saves_ref
    from diffroll_tpu_torch.ops.depthwise_conv import depthwise_conv
    from diffroll_tpu_torch.ops.group_norm import group_norm
    from diffroll_tpu_torch.ops.sampler_kernel import (
        fused_sample, fused_sample_ref, sampler_tables)
    from diffroll_tpu_torch.diffusion.distill import distill_grids
    from diffroll_tpu_torch.diffusion.samplers import SAMPLER_TABLE
    from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
    from diffroll_tpu_torch.train import TrainState, make_train_step
    from diffroll_tpu_torch.train.distill import make_distill_loss

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
        reset_launches(gated_stack, fused_sample, group_norm, depthwise_conv)
        t0 = time.perf_counter()
        run_dir = cli_transcribe.main([
            f"pretrained_path={ckpt}", f"dataset.audio_path={audio_dir}",
            "dataset.audio_ext=wav", f"task.w={W_GUIDANCE}", "overlap_frames=32",
            "device=cuda", f"trainer.output_dir={tmp / 'out'}"])
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launches = kernel_launches((gated_stack, fused_sample, group_norm, depthwise_conv))
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
        write_maps_corpus(tmp / "data", TEST_RECORDINGS, 21.0, sr, SEED + 1, subset="ENSTDkCl")
        reset_launches(gated_stack, fused_sample, fwd_saves, bwd, group_norm, depthwise_conv)
        t0 = time.perf_counter()
        state = cli_train.main([
            "spec_roll", f"dataset.root={tmp / 'data'}", "task.fused_train=true",
            "device=cuda", "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
            "trainer.log_every_n_steps=1", f"dataloader.train_batch_size={TRAIN_BATCH}",
            "trainer.ema_decay=0.999", f"trainer.output_dir={tmp / 'train_out'}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = kernel_launches((fwd_saves, bwd, gated_stack, fused_sample, group_norm,
                                          depthwise_conv))
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
        # the test split after fit, on the EMA weights: K2 at B=8
        post_fit = run_dirs[0] / "test_metrics.json"
        if not post_fit.exists():
            raise RuntimeError("train wrote no test_metrics.json after fit")
        post_fit = json.loads(post_fit.read_text())
        if post_fit["n_clips"] != TEST_RECORDINGS or train_launches["fused_sample"] < 1:
            raise RuntimeError(f"the post-fit test scored {post_fit['n_clips']} recordings, "
                               f"K2 launched {train_launches['fused_sample']} times")
        del state

        # the checkpoint train wrote: reload, a few more steps on one fixed
        # batch through the task, then one sample call
        trained, task_updates = load_lightning(str(last_ckpt), device=dev)
        tcfg = TaskConfig(fused_train=True).replace(**task_updates)
        ttask = DiffusionTask(trained, tcfg)
        tstate = TrainState.create(trained, 1e-4)
        tgen = torch.Generator(device=dev).manual_seed(SEED + 7)
        fixed = fixed_batch(mc, dev, tgen)
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
              sample_range=[float(sampled.min()), float(sampled.max())],
              test_metrics={k: post_fit[k] for k in ("n_clips", "note_f1", "frame_f1")})
        del trained, ttask, tstate

        # ---- the entries that use a trained model: test, sample, serve
        kernels = (gated_stack, fused_sample, group_norm, depthwise_conv)
        path_launches = {"transcribe": launches, "train": train_launches,
                         "test": run_test_phase(last_ckpt, tmp / "data", tmp / "test_out",
                                                kernels),
                         "sample": run_sample_phase(last_ckpt, tmp / "data", tmp / "sample_out",
                                                    mc.frames, kernels),
                         "serve": run_serve_phase(ckpt, sr, sr / mc.mel.hop_length, kernels)}
        all_kernels = (gated_stack, fused_sample, fwd_saves, bwd, group_norm, depthwise_conv)
        (path_launches["distill"], path_launches["distill_test"],
         distill_step_ms) = run_distill_phase(last_ckpt, tmp / "data", tmp / "distill_out",
                                              all_kernels)
        path_launches["baseline"] = run_baseline_phase(tmp / "data", tmp / "baseline_out",
                                                       all_kernels)
        path_launches.update(run_family_phases(tmp, sr, all_kernels))
        run_variants_hold(dev)
        path_launches["bf16"] = run_bf16_phase(tmp, ckpt, all_kernels)
        path_launches.update(run_dp_phase(tmp, ckpt, last_ckpt, all_kernels))
        path_launches.update(run_mp_phase(tmp, ckpt, all_kernels))
        path_launches["serve_mesh"] = run_serve_mesh_phase(tmp, ckpt, all_kernels)
        path_launches["sp"] = run_sp_phase(tmp, ckpt, all_kernels)
        path_launches.update(run_learn_phase(tmp, all_kernels))
        path_launches["paper"] = run_paper_phase(tmp, all_kernels)

    net = model.net
    dil = mc.dilations()
    ops = FusedOperands.of(net)
    w, kw, head = ops.weights, ops.kernel, ops.head
    # the plain versions are gated on the kernels' own weight values (the
    # stack weights rounded to bf16, as the kernels receive them), so the
    # gate measures the kernels' arithmetic; the f32-weight numbers are
    # reported beside them
    wq = kernel_rounded(w)
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
        window_s = t_len * mc.mel.hop_length / sr

        def process(sampling_type, steps, bk):
            """`fused_sample`'s arguments for one reverse process at B=bk
            (seeded waveforms, x_T and noise), and the waveforms."""
            ts = timestep_subsequence(mc.timesteps, steps)
            tables = torch.from_numpy(sampler_tables(task.schedule, sampling_type, ts,
                                                     previous_timesteps(ts))).to(dev)
            t_bias = ops.step_biases(net, ts)
            stochastic = bool((tables[:, 2] != 0).any())
            generation = sampling_type.startswith("generation")
            guided = SAMPLER_TABLE[sampling_type][2]
            wav = None if generation else torch.stack(
                [torch.from_numpy(chord_wav(window_s, sr, SEED + 1 + i))
                 for i in range(bk)]).to(dev)
            x_T = torch.randn(bk, t_len, mc.pitches, device=dev, generator=gen)
            noise = (torch.randn((len(ts), bk, t_len, mc.pitches), device=dev, generator=gen)
                     if stochastic else None)
            # generation conditions on spec := -1 with one stream; the guided
            # samplers run the conditional stream and the spec := -1 one; a
            # distilled student (ddim_x0) the conditional stream alone
            cond = (torch.full((bk, t_len, mc.n_mels), -1.0, device=dev) if generation
                    else task.build_conditioner(x_T, wav))
            return (x_T, noise, t_bias, tables, w, head, cond, dil, guided, W_GUIDANCE,
                    stochastic), wav

        def step_loop(sampling_type, steps, x_T, wav, noise):
            """The same process by the step loop: K1 once per step."""
            cfg = task.config.replace(sampling_type=sampling_type, sampling_steps=steps,
                                      use_megakernel=False)
            return DiffusionTask(model, cfg).sample(x_T, waveform=wav, noise=noise)[0]

        def hold_k2(name, sampling_type, steps, bk, loop=False, f32=False):
            """K2 against the plain process on the kernels' weight values,
            and a second run for the same bits; `loop` adds the step loop
            (K1 per step, at the sequences the sample path gives it) against
            the same plain trajectory, and a second loop for the same bits;
            `f32` adds the errors against the unrounded f32 weights."""
            args, wav = process(sampling_type, steps, bk)
            x_T, noise = args[0], args[1]
            ref = fused_sample_ref(x_T, noise, args[2], args[3], wq, *args[5:])
            out = fused_sample(*args, kweights=kw)
            same_bits = torch.equal(out, fused_sample(*args, kweights=kw))
            torch.cuda.synchronize()
            rel, abs_err = rel_err(out, ref)
            finite = bool(torch.isfinite(out).all())
            fields, ok, scan_abs = {}, rel < GATE and same_bits and finite, 0.0
            if loop:
                before = gated_stack.launches
                scan = step_loop(sampling_type, steps, x_T, wav, noise)
                passes = gated_stack.launches - before
                scan_same = torch.equal(scan, step_loop(sampling_type, steps, x_T, wav, noise))
                scan_rel, scan_abs = rel_err(scan, ref)
                fields = dict(scan_rel=scan_rel, scan_max_abs_err=scan_abs,
                              scan_k1_launches=passes, scan_k1_sequences=bk * (1 + args[8]),
                              scan_same_bits_on_rerun=scan_same)
                ok = (ok and scan_rel < GATE and scan_same and passes == args[3].shape[0]
                      and bool(torch.isfinite(scan).all()))
            if f32:
                ref32 = fused_sample_ref(*args)
                fields.update(rel_f32_weights=rel_err(out, ref32)[0],
                              scan_rel_f32_weights=rel_err(scan, ref32)[0],
                              # the plain version against itself: bf16-rounded vs f32 weights
                              ref_rounding_rel=rel_err(ref, ref32)[0])
            phase(name, batch=bk, sampler=sampling_type, steps=args[3].shape[0],
                  streams=2 if args[8] else 1, noise=args[10], rel=rel, max_abs_err=abs_err,
                  same_bits_on_rerun=same_bits, finite=finite, **fields)
            if not ok:
                raise RuntimeError(f"{name}: K2 or the step loop disagrees with the plain "
                                   f"trajectory at B={bk} ({sampling_type}): rel {rel}, "
                                   f"same bits on a second run: {same_bits}, {fields}")
            return args, abs_err, scan_abs

        k2_abs, k2_args, loop_abs = 0.0, {}, 0.0
        # B=1: one 20.48 s window; B=2: the batch the transcribe phase gives K2
        # (two windows, four CFG streams); B=8: the test and serving batch, and
        # the sample path's guided step loop (inpainting: 16 sequences in K1)
        for name, bk, f32 in (("k2", 1, True), ("k2", 2, True), ("k2_b8", 8, False)):
            k2_args[bk], abs_err, scan_abs = hold_k2(name, "cfdg_ddpm_x0", None, bk, True, f32)
            k2_abs, loop_abs = max(k2_abs, abs_err), max(loop_abs, scan_abs)
        for name, sampler, steps, bk in (("k2_gen", "generation_ddpm_x0", None, 1),
                                         ("k2_ddim", "cfdg_ddim_x0", 50, 2)):
            k2_abs = max(k2_abs, hold_k2(name, sampler, steps, bk)[1])
        # the step loop for generation: K1 on unguided rows, spec := -1, at
        # B=2 and at the sample path's B=8
        for bk in (2, 8):
            loop_abs = max(loop_abs, hold_k2("k1_uncond", "generation_ddpm_x0", None, bk, True)[2])
        # a distilled student as `test` samples it: B=8, one stream, ddim_x0
        # (no noise) on the 9- and 5-step grids
        student_args = {}
        for n in DISTILL_STAGES:
            student_args[n], abs_err, _ = hold_k2("k2_student", "ddim_x0", n, SERVE_BATCH)
            k2_abs = max(k2_abs, abs_err)

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

        # ---- k1_s32: the guided teacher of a distill step, one forward over
        # 2B = 32 sequences (the conditional rows, then spec := -1)
        x32 = torch.cat([x16, torch.randn(bt, t_len, c, device=dev, generator=gen)])
        tb32 = torch.cat([tb16, tb16], dim=1)
        cond32 = torch.cat([cond16, torch.full_like(cond16, -1.0)])
        k1_32 = gated_stack(x32, tb32, cond32, w, dil, kweights=kw)
        k1_32_same = torch.equal(k1_32, gated_stack(x32, tb32, cond32, w, dil, kweights=kw))
        k1_32_ref = gated_stack_ref(x32, tb32, cond32, wq, dil)
        torch.cuda.synchronize()
        k1_32_rel, k1_32_abs = rel_err(k1_32, k1_32_ref)
        phase("k1_s32", shape=list(x32.shape), tiles_waves=list(gs_module.tile_waves(
            2 * bt, t_len, c)), rel=k1_32_rel, max_abs_err=k1_32_abs,
            same_bits_on_rerun=k1_32_same)
        if not (k1_32_rel < GATE and k1_32_same):
            raise RuntimeError(f"K1 at S=32 disagrees with its plain version (rel {k1_32_rel}) "
                               f"or with itself on a second run (same bits: {k1_32_same})")
        del k1_32_ref

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

    # ---- distill_grads: one guided distill loss + backward with fixed draws,
    # the teacher on K1 and the student on K3 + K4, against the teacher and
    # the student through the modules on the bf16-rounded weights
    n_first = DISTILL_STAGES[0]
    grid, mids = distill_grids(mc.timesteps, n_first)
    ddraws = dict(i=torch.arange(bt, device=dev) % n_first,  # the last transition included
                  noise=torch.randn(bt, t_len, mc.pitches, device=dev, generator=gen))
    dgrads, dloss = {}, {}
    for key, teacher, cfg in (
            ("fused", model, TaskConfig(timesteps=mc.timesteps, fused_train=True)),
            ("modules", rounded, TaskConfig(timesteps=mc.timesteps, use_fused=False))):
        student = copy.deepcopy(teacher).requires_grad_(True)
        before = (gated_stack.launches, fwd_saves.launches, bwd.launches)
        loss_fn = make_distill_loss(DiffusionTask(student, cfg), teacher, grid, mids,
                                    guided=True, w=W_GUIDANCE)
        total, _ = loss_fn(batch16, None, True, **ddraws)
        total.backward()
        launched = tuple(a - b for a, b in zip(
            (gated_stack.launches, fwd_saves.launches, bwd.launches), before))
        if launched != ((2, 1, 1) if key == "fused" else (0, 0, 0)):
            raise RuntimeError(f"distill_grads {key}: launched (K1, K3, K4) = {launched}")
        dloss[key] = float(total.detach())
        dgrads[key] = {n: p.grad.detach().clone() for n, p in student.net.named_parameters()}
        del student, loss_fn
    torch.cuda.synchronize()
    dname, drel, dabs = worst_leaf(dgrads["fused"], dgrads["modules"])
    dloss_rel = abs(dloss["fused"] - dloss["modules"]) / abs(dloss["modules"])
    phase("distill_grads", batch=bt, student_steps=n_first, guided=True,
          leaves=len(dgrads["modules"]), worst_leaf=dname, rel=drel, max_abs_err=dabs,
          loss_fused=dloss["fused"], loss_modules=dloss["modules"], loss_rel=dloss_rel)
    if not (drel < GATE and dloss_rel < 1e-2):
        raise RuntimeError(f"the distill loss or its gradients through K1 + K3 + K4 disagree "
                           f"with the modules: {dname} rel {drel}, loss rel {dloss_rel}")
    del grads, rounded, plain_task, dgrads

    def step_ms(impl, fused):
        """A whole training step at B=16 on the fixed batch: loss, backward, Adam."""
        tk = DiffusionTask(model, TaskConfig(timesteps=mc.timesteps, fused_train=fused))
        st = TrainState.create(model, 1e-6)
        step = make_train_step(lambda b, g, train: tk.loss_fn(b, g, train, impl=impl, **draws))
        return time_ms(lambda: step(st, batch16, None), 5, 2)

    step_times = {"step_k3_k4_ms": step_ms("cuda", True),
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
            "k1_s32_ms": time_ms(lambda: gated_stack(x32, tb32, cond32, w, dil, kweights=kw),
                                 10, 2),
            "k1_s32_plain_ms": time_ms(lambda: gated_stack_ref(x32, tb32, cond32, w, dil), 3),
            "distill_step_ms": distill_step_ms,
        }
        for n, args in student_args.items():
            times[f"k2_student{n}_b8_ms"] = time_ms(lambda: fused_sample(*args, kweights=kw), 5)
            times[f"k2_student{n}_b8_plain_ms"] = time_ms(lambda: fused_sample_ref(*args), 1, 0)

        def hidden_share(seqs):
            """Forward GEMM tiles whose epilogue runs under the other warpgroup's
            k loop, over all of a pass's, at `seqs` sequences of the window."""
            tiles, hidden = gs_module.pass_tiles(seqs, t_len, c, mc.residual_layers, sms)
            return hidden / tiles

        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        times["hidden_epilogue_share"] = {
            "k1": hidden_share(x.shape[0]), "k1_s32": hidden_share(x32.shape[0]),
            "k3": hidden_share(x16.shape[0]),
            **{f"k2_b{bk}": hidden_share(bk * (1 + args[8])) for bk, args in k2_args.items()}}
        for bk, args in k2_args.items():
            times[f"k2_b{bk}_ms"] = time_ms(lambda: fused_sample(*args, kweights=kw), 3)
            # the plain process at B=8 takes seconds: one unwarmed run
            times[f"k2_b{bk}_plain_ms"] = time_ms(lambda: fused_sample_ref(*args),
                                                  *((1, 0) if bk == 8 else (3,)))
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
        norm_times = group_norm_times(dev)
        dw_times = depthwise_conv_times(dev)
        phase("times", card=card, **times, gemm=gemm, group_norm=norm_times,
              depthwise_conv=dw_times)
        if norm_times["failed"]:
            raise RuntimeError(f"the GroupNorm kernels against F.group_norm in f64 at "
                               f"{norm_times['failed']}")
        if dw_times["failed"]:
            raise RuntimeError(f"the depthwise conv kernels against F.conv2d in f64 at "
                               f"{dw_times['failed']}")

    # ---- bounds, from this run's inputs: each input read once, each output
    # written once, against the products each function does
    L, taps, mp = mc.residual_layers, kw.taps, kw.mp
    w_bytes = nbytes(kw.wcat, kw.wo, kw.b_eff, kw.bo)
    bounds = {"k1": bound(stack_flops(b * t_len, c, taps, mp, L),
                          nbytes(x, tb, cond, k1_out) + w_bytes)}
    bounds["k1_s32"] = bound(stack_flops(2 * bt * t_len, c, taps, mp, L),
                             nbytes(x32, tb32, cond32, k1_32) + w_bytes)
    processes = [(k2_args[bk], key) for bk, key in ((2, "k2"), (1, "k2_b1"), (8, "k2_b8"))]
    processes += [(student_args[n], f"k2_student{n}_b8") for n in DISTILL_STAGES]
    for args, key in processes:  # the summary line gives B=2
        x_Tk, noisek, t_biask, tablesk, condk = (args[i] for i in (0, 1, 2, 3, 6))
        rows = (2 if args[8] else 1) * x_Tk.shape[0] * t_len  # the guidance streams
        head_flops = 2.0 * rows * (mc.pitches * c + c * c + c * mc.pitches)
        # the conditioner's lanes are projected once per clip for all layers;
        # each step's gate GEMM contracts over the taps only
        cond_proj_flops = 2.0 * rows * mp * 2 * c * L
        bounds[key] = bound(
            tablesk.shape[0] * (stack_flops(rows, c, taps, 0, L) + head_flops) + cond_proj_flops,
            nbytes(x_Tk, noisek, t_biask, tablesk, condk, x_Tk, *head) + w_bytes)
    bounds["k3"] = bound(stack_flops(bt * t_len, c, taps, mp, L),
                         nbytes(x16, tb16, cond16, skip3, xs3, a3) + w_bytes)
    dw_bytes = 4 * (kw.wcat.numel() + kw.wo.numel() + 2 * kw.bo.numel())
    bounds["k4"] = bound(bwd_flops(bt * t_len, c, taps, mp, L, False),
                         nbytes(xs3, a3, cond16, tb16, cot16, cot16, tb16)
                         + nbytes(kw.wcat, kw.wo) + dw_bytes)
    bounds["group_norm"] = norm_times["largest"]["bound"]
    bounds["group_norm_bwd"] = norm_times["largest"]["bound_bwd"]
    bounds["depthwise_conv"] = dw_times["largest"]["bound"]
    bounds["depthwise_conv_bwd"] = dw_times["largest"]["bound_bwd"]
    phase("bounds", peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
          peak_tbytes_per_s=PEAK_BYTES_PER_S / 1e12, **bounds)

    def row(key, name, source, replaces, n_launch, abs_err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[key]["bound_ms"], "bound_by": bounds[key]["bound_by"],
                "library_ms": None,
                "launches_by_path": {p: n[name] for p, n in path_launches.items() if name in n}}

    train_src = "diffroll_tpu_torch/csrc/gated_stack_train.cu"
    # `launches`: the kernel's first path, transcribe for K1 and K2, train
    # for K3 and K4; `launches_by_path` has every path's own count
    k2_row = row("k2", "fused_sample", "diffroll_tpu_torch/csrc/sampler.cu",
                 "diffroll_tpu/ops/sampler_kernel.py:385", launches["fused_sample"], k2_abs,
                 times["k2_b2_ms"], times["k2_b2_plain_ms"])
    k2_row.update(ms_b8=times["k2_b8_ms"], plain_ms_b8=times["k2_b8_plain_ms"],
                  bound_ms_b8=bounds["k2_b8"]["bound_ms"])
    for n in DISTILL_STAGES:  # a distilled student at B=8: one stream, n steps, no noise
        k2_row.update({f"ms_student{n}_b8": times[f"k2_student{n}_b8_ms"],
                       f"plain_ms_student{n}_b8": times[f"k2_student{n}_b8_plain_ms"],
                       f"bound_ms_student{n}_b8": bounds[f"k2_student{n}_b8"]["bound_ms"]})
    # K1's error is its single pass's; its step loops' 200-step trajectories beside it
    k1_row = row("k1", "gated_stack", "diffroll_tpu_torch/csrc/gated_stack.cu",
                 "diffroll_tpu/ops/gated_stack.py:290", launches["gated_stack"], k1_abs,
                 times["k1_ms"], times["k1_plain_ms"])
    k1_row.update(max_abs_err_step_loop=loop_abs, ms_s32=times["k1_s32_ms"],
                  plain_ms_s32=times["k1_s32_plain_ms"], bound_ms_s32=bounds["k1_s32"]["bound_ms"],
                  max_abs_err_s32=k1_32_abs)
    # the U-Nets' GroupNorm: its forward at the largest SpecUnet norm, beside
    # F.group_norm, which is both its library call and the CPU's plain version
    norm_shape = norm_times["shapes"][norm_times["largest"]["name"]]
    gn_row = row("group_norm", "group_norm", "diffroll_tpu_torch/csrc/group_norm.cu", None,
                 path_launches["spec_unet"]["group_norm"], norm_times["max_abs_err"],
                 norm_shape["fwd_port_ms"], norm_shape["fwd_aten_ms"])
    gn_row.update(library_ms=norm_shape["fwd_aten_ms"], shape=norm_times["largest"]["shape"],
                  max_rel_err=norm_times["max_rel_err"], ms_bwd=norm_shape["bwd_port_ms"],
                  library_ms_bwd=norm_shape["bwd_aten_ms"],
                  bound_ms_bwd=bounds["group_norm_bwd"]["bound_ms"])
    # the U-Nets' depthwise 7x7 conv: its forward at the largest shape, beside
    # F.conv2d, which is both its library call and the CPU's plain version
    dw_shape = dw_times["shapes"][dw_times["largest"]["name"]]
    dw_row = row("depthwise_conv", "depthwise_conv", "diffroll_tpu_torch/csrc/depthwise_conv.cu",
                 None, path_launches["spec_unet"]["depthwise_conv"], dw_times["max_abs_err"],
                 dw_shape["fwd_port_ms"], dw_shape["fwd_aten_ms"])
    dw_row.update(library_ms=dw_shape["fwd_aten_ms"], shape=dw_times["largest"]["shape"],
                  max_rel_err=dw_times["max_rel_err"], ms_bwd=dw_shape["bwd_port_ms"],
                  library_ms_bwd=dw_shape["bwd_aten_ms"],
                  bound_ms_bwd=bounds["depthwise_conv_bwd"]["bound_ms"])
    print(json.dumps({"kernels": [
        k1_row,
        k2_row,
        row("k3", "fwd_saves", train_src, "diffroll_tpu/ops/gated_stack_train.py:50",
            train_launches["fwd_saves"], k3_abs, times["k3_ms"], times["k3_plain_ms"]),
        row("k4", "bwd", train_src, "diffroll_tpu/ops/gated_stack_train.py:388",
            train_launches["bwd"], k4_abs, times["k4_ms"], times["k4_plain_ms"]),
        gn_row,
        dw_row,
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1:2] == ["--nccl-worker"]:
        sys.exit(nccl_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-worker"] and sys.argv[2] in MESH_PHASES:
        sys.exit(mesh_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
                             sys.argv[6]))
    sys.exit(main())
