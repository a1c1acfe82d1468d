"""A trained model's guided reverse process through the kernels, held
against the plain version on f32 weights and on the same bf16-rounded
weights.

The kernels (K2, and K1 in the step loop) take the stack's weights rounded
to bf16, as the TPU kernels do. Against the plain version on those rounded
weights the difference is the kernels' arithmetic (gate 0.05, the
trajectory gate of tests/test_sampler_kernel.py); against the plain version
on f32 weights it adds what rounding the weights costs over a whole
trajectory. Both are max|d| / max|ref| over the (B, T, 88) output.

    python -m diffroll_tpu_torch.quality.bf16_drift ckpt=<file.ckpt> [batch=1,8] \
        [device=cuda|cpu]

The process runs every one of the model's timesteps at w=0.5. The waveforms
are v2 recordings of the model's window (`make_synthetic_tree`'s held-out
seeds 100000 + i, rendered as its test split renders them); x_T and the
per-step noise come from a generator seeded 0.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cli._common import device_named
from ..compat import load_lightning
from ..models.base import DiffRollModel
from ..ops.sampler_kernel import fused_sample, fused_sample_ref
from ..tasks import DiffusionTask, TaskConfig
from .make_synthetic_tree import render_recording
from .synthetic_end_to_end import HOP, SR, parse_args

GATE = 0.05


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def held_out_waveforms(n: int, frames: int) -> np.ndarray:
    """(n, frames * HOP) v2 recordings: the tree's test clips 0..n-1 when
    the window is the tree's recording length."""
    return np.stack([render_recording(100_000 + i, frames * HOP / SR)[1] for i in range(n)])


@torch.no_grad()
def drift(model: DiffRollModel, waveform: torch.Tensor) -> Dict[str, float]:
    """The guided (cfdg_ddpm_x0, w=0.5) process over `waveform` (B, L) by
    K2 and by the step loop, each against the plain version on bf16-rounded
    and on f32 weights; and the plain version on the rounded weights against
    itself on f32 weights, with no kernel in either."""
    mc = model.config
    w = 0.5
    cfg = TaskConfig(timesteps=mc.timesteps, sampling_type="cfdg_ddpm_x0", w=w)
    task = DiffusionTask(model, cfg)
    so = task.sampler_operands()
    wts, tables, t_bias = so.operands.weights, so.tables, so.t_bias
    rounded = wts._replace(**{k: getattr(wts, k).to(torch.bfloat16).float()
                              for k in ("wd", "wc", "wo")})
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    bsz = waveform.shape[0]
    x_T = torch.randn((bsz, mc.frames, mc.pitches), generator=gen, device=dev)
    noise = torch.randn((tables.shape[0],) + tuple(x_T.shape), generator=gen, device=dev)
    cond = task.build_conditioner(x_T, waveform)
    rest = (so.operands.head, cond, mc.dilations(), True, w, so.stochastic)
    k2 = fused_sample(x_T, noise, t_bias, tables, wts, *rest, kweights=so.operands.kernel)
    loop = DiffusionTask(model, cfg.replace(use_megakernel=False)).sample(
        x_T, waveform=waveform, noise=noise)[0]
    ref_q = fused_sample_ref(x_T, noise, t_bias, tables, rounded, *rest)
    ref32 = fused_sample_ref(x_T, noise, t_bias, tables, wts, *rest)
    finite = bool(torch.isfinite(k2).all() and torch.isfinite(loop).all())
    return {"batch": bsz, "steps": int(tables.shape[0]), "finite": finite,
            "k2_rel_bf16_weights": rel_err(k2, ref_q), "k2_rel_f32_weights": rel_err(k2, ref32),
            "loop_rel_bf16_weights": rel_err(loop, ref_q),
            "loop_rel_f32_weights": rel_err(loop, ref32),
            "ref_rounding_rel": rel_err(ref_q, ref32),
            "ref_max_abs": float(ref32.abs().max())}


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    device = device_named(args.get("device", "cuda"))
    model, _ = load_lightning(args["ckpt"], device=device)
    batches = [int(b) for b in args.get("batch", "1,8").split(",")]
    wav = torch.from_numpy(held_out_waveforms(max(batches), model.config.frames)).to(device)
    readings = [drift(model, wav[:b]) for b in batches]
    out = {"ckpt": args["ckpt"], "gate": GATE, "readings": readings}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
