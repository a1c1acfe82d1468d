"""The gated stack's two GEMM kernels alone, on the card.

    python -m diffroll_tpu_torch.profile_gemm [--seqs 2 4 16]

For each number of sequences S (M = S x 640 rows: S=2 is one clip under
classifier-free guidance, S=4 two, S=16 a training batch) it runs passes of
the flagship stack (C=512, 15 layers, no conditioner lanes: K = 1,536, the
sampler's form) and prints one JSON line: us per call and TFLOP/s of
`gate_kernel` and `out_kernel` (a pass that launches that GEMM's 15 calls
alone, less a pass that launches neither, by CUDA events, median of 10), the
whole pass's time, the tiles and waves of `tile_waves`, and beside them, as a
yardstick, a bf16 `torch.matmul` of the same (M, K) x (K, 2C) shapes, which
computes neither the taps nor the epilogues and which the port never calls.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess

import torch


def event_ms(fn, reps: int = 10, warmup: int = 2) -> float:
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


def gemm_times(gs, x, tb, w, kw, dil) -> dict:
    """Passes of the stack without conditioner lanes: per-call us and TFLOP/s
    of the two GEMM kernels, each launched alone."""
    seqs, t_len, c = x.shape
    m, taps, n_layers = seqs * t_len, kw.taps, kw.wo.shape[0]

    def run():
        return gs.gated_stack(x, tb, None, w, dil, kweights=kw)

    pass_ms = event_ms(run)
    ms = {}
    try:
        for part in (0, 1, 2):  # neither GEMM (the wrapper and prep_kernel), gate, out
            gs.PARTS = part
            ms[part] = event_ms(run)
    finally:
        gs.PARTS = 3
    gate_us, out_us = (1e3 * (ms[part] - ms[0]) / n_layers for part in (1, 2))
    tiles, waves = gs.tile_waves(seqs, t_len, c)
    return {"m": m, "tiles": tiles, "waves": waves, "gate_us": gate_us, "out_us": out_us,
            "gate_tflops": 2.0 * m * taps * c * 2 * c / gate_us / 1e6,
            "out_tflops": 2.0 * m * c * 2 * c / out_us / 1e6,
            "pass_ms": pass_ms, "pass_without_gemms_ms": ms[0],
            "gemm_yardstick_ms": {"gate": matmul_yardstick_ms(m, taps * c, 2 * c, x.device),
                                  "out": matmul_yardstick_ms(m, c, 2 * c, x.device)}}


def matmul_yardstick_ms(m: int, k: int, n: int, dev) -> float:
    a = torch.randn(m, k, device=dev, dtype=torch.bfloat16)
    b = torch.randn(k, n, device=dev, dtype=torch.bfloat16)
    return event_ms(lambda: torch.matmul(a, b), reps=20, warmup=3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, nargs="+", default=[2, 4, 16])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gemm needs a CUDA card")
    from .models import build

    gs = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = build("ClassifierFreeDiffRoll").to(dev).eval()
    mc = model.config
    w = gs.stack_weights(model.net)
    kw = gs.kernel_weights(w)
    dil, c = mc.dilations(), mc.residual_channels
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for seqs in args.seqs:
            x = torch.randn(seqs, mc.frames, c, device=dev, generator=gen)
            tb = 0.1 * torch.randn(mc.residual_layers, seqs, c, device=dev, generator=gen)
            print(json.dumps({"card": card, **gemm_times(gs, x, tb, w, kw, dil)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
