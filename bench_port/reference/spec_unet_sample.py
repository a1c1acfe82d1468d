"""The plain reference of SpecUnet's guided transcription: the `cfdg_ddpm_x0`
reverse process (sony/DiffRoll `task/diffusion.py` with
`config/task/classifierfree_diffusion.yaml`; arXiv 2210.05148) over
`spec_unet.py`'s net.

Plain PyTorch in float32, imported by nothing of the program; on a card call
`diffroll.exact_f32()` first. Every step runs the whole net, both streams, on
both guidance branches: nothing is computed once and kept. The schedule is
T linear betas from `beta_start` to `beta_end`; a step predicts x0 on the
conditional rows and on the rows with the log-mel := -1, mixes them as
(1 + w) x0(spec) - w x0(spec := -1), and takes the DDPM posterior step
`diffroll.sample` takes, the last step returning x0 / sqrt(acum[0]). The
draws are given, in the order the program takes them: x_T, then every
step's noise. `precision="bf16"` is `spec_unet.py`'s control (every
product's operands rounded to bfloat16); the sampler's state stays f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import diffroll as ref
from . import spec_unet as uref


def sample(params: Dict[str, torch.Tensor], cfg: dict, x_T: torch.Tensor, noise: torch.Tensor,
           cond: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """x_T (B, T, 88), noise (steps, B, T, 88), cond (B, T, n_mels) the
    log-mel (`spec_unet.conditioner`) -> the x0 roll (B, T, 88), with the
    net over `params` (the port's state-dict names)."""
    net = uref.SpecUnet(params, cfg, precision)
    sch = ref.schedule(cfg)
    sac, s1m = sch["sac"], sch["s1m"]
    w = float(cfg["w"])
    b = x_T.shape[0]
    cond2 = torch.cat([cond, torch.full_like(cond, -1.0)])
    x = x_T.float()
    n = cfg["timesteps"]
    for s, t in enumerate(range(n - 1, -1, -1)):
        tv = torch.full((2 * b,), t, dtype=torch.long, device=x.device)
        both = net(torch.cat([x, x]), tv, cond2)
        x0 = (1.0 + w) * both[:b] - w * both[b:]
        if t == 0:
            return x0 / float(sac[0])
        tp = t - 1
        sigma = s1m[tp] / s1m[t] * math.sqrt(max(1.0 - (sac[t] / sac[tp]) ** 2, 0.0))
        c_dir = math.sqrt(max(1.0 - sac[tp] ** 2 - sigma ** 2, 0.0))
        x = (float(sac[tp]) * x0 + float(c_dir / s1m[t]) * (x - float(sac[t]) * x0)
             + float(sigma) * noise[s])
    return x
