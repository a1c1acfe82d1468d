"""The gated stack's GEMM kernels alone, forward and backward, on the card.

    python -m diffroll_tpu_torch.profile_gemm [--seqs 2 4 16] [--bwd-seqs 2 16]

For each number of sequences S (M = S x 640 rows: S=2 is one clip under
classifier-free guidance, S=4 two, S=16 a training batch) it runs passes of
the flagship stack (C=512, 15 layers, no conditioner lanes: K = 1,536, the
sampler's form) and prints one JSON line: us per call and TFLOP/s of
`gate_kernel` and `out_kernel` (a pass that launches that GEMM's 15 calls
alone, less a pass that launches neither, by CUDA events, median of 10), the
whole pass's time, the tiles and waves of `tile_waves`, and beside them, as a
yardstick, a bf16 `torch.matmul` of the same (M, K) x (K, 2C) shapes, which
computes neither the taps nor the epilogues and which the port never calls.
For each S of --bwd-seqs it then runs the backward sweep (with the conditioner,
no conditioner gradient) and prints a line with the four products of a layer:
`dg`, `dy` and the two weight gradients `dwo` and `dw` (a sweep that launches
that product's 15 calls alone, less a sweep that launches nothing), the split
`wgrad_plan` gave each weight gradient, the elementwise rest, and a matmul
yardstick of each product's shape (the weight gradients' as `a.t() @ b`).
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


def bwd_gemm_times(gt, x, tb, cond, w, kw, dil) -> dict:
    """The backward sweep from K3's saves: per-call us and TFLOP/s of dg, dy and
    the two weight-gradient products, each launched alone. `gt` is the module
    `ops.gated_stack_train`."""
    seqs, t_len, c = x.shape
    m, taps, n_layers = seqs * t_len, kw.taps, kw.wo.shape[0]
    rows_w = taps * c + (kw.mp if cond is not None else 0)
    _, xs, a = gt.fwd_saves(x, tb, cond, w, dil, kweights=kw)
    cot = torch.randn_like(x)
    saves = (tb, cond, w, xs, a)

    def run():
        return gt.bwd(dil, saves, cot, False, kweights=kw)

    sweep_ms = event_ms(run)
    bits = {"none": 0, "dg": 1, "dwo": 2, "dw": 4, "dy": 8, "rest": 16}
    ms = {}
    try:
        for name, part in bits.items():
            gt.PARTS = part
            ms[name] = event_ms(run)
    finally:
        gt.PARTS = 31
    # (M, K) x (K, N) of each product; the weight gradients contract over the rows
    shapes = {"dg": (m, 2 * c, c), "dy": (m, taps * 2 * c, c),
              "dwo": (c, m, 2 * c), "dw": (rows_w, m, 2 * c)}
    out = {"m": m, "sweep_ms": sweep_ms, "sweep_without_launches_ms": ms["none"],
           "rest_ms": ms["rest"] - ms["none"],
           "wgrad_plan": {"dwo": gt.wgrad_plan(seqs, t_len, c, 2 * c),
                          "dw": gt.wgrad_plan(seqs, t_len, rows_w, 2 * c)},
           "gemm_yardstick_ms": {}}
    for name, (mm, kk, nn) in shapes.items():
        us = 1e3 * (ms[name] - ms["none"]) / n_layers
        out[f"{name}_us"] = us
        out[f"{name}_tflops"] = 2.0 * mm * kk * nn / us / 1e6
        out["gemm_yardstick_ms"][name] = matmul_yardstick_ms(
            mm, kk, nn, x.device, a_transposed=name in ("dwo", "dw"))
    return out


def matmul_yardstick_ms(m: int, k: int, n: int, dev, a_transposed: bool = False) -> float:
    a = torch.randn(k, m, device=dev, dtype=torch.bfloat16).t() if a_transposed \
        else torch.randn(m, k, device=dev, dtype=torch.bfloat16)
    b = torch.randn(k, n, device=dev, dtype=torch.bfloat16)
    return event_ms(lambda: torch.matmul(a, b), reps=20, warmup=3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, nargs="+", default=[2, 4, 16])
    ap.add_argument("--bwd-seqs", type=int, nargs="+", default=[2, 16])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gemm needs a CUDA card")
    from .models import build
    from .ops.fused_forward import FusedOperands

    gs = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")
    gt = importlib.import_module("diffroll_tpu_torch.ops.gated_stack_train")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = build("ClassifierFreeDiffRoll").to(dev).eval()
    mc = model.config
    ops = FusedOperands.of(model.net)
    w, kw = ops.weights, ops.kernel
    dil, c = mc.dilations(), mc.residual_channels
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for seqs in args.seqs:
            x = torch.randn(seqs, mc.frames, c, device=dev, generator=gen)
            tb = 0.1 * torch.randn(mc.residual_layers, seqs, c, device=dev, generator=gen)
            print(json.dumps({"card": card, **gemm_times(gs, x, tb, w, kw, dil)}), flush=True)
        for seqs in args.bwd_seqs:
            x = torch.randn(seqs, mc.frames, c, device=dev, generator=gen)
            tb = 0.1 * torch.randn(mc.residual_layers, seqs, c, device=dev, generator=gen)
            cond = torch.rand(seqs, mc.frames, mc.n_mels, device=dev, generator=gen)
            print(json.dumps({"card": card, "backward": True,
                              **bwd_gemm_times(gt, x, tb, cond, w, kw, dil)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
