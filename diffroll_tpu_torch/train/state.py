"""Train state: the model (which owns the weights), the optimizer and the
step counter (counterpart of `diffroll_tpu/train/state.py`).

The optimizer is `torch.optim.Adam(lr)` with default betas and eps and no
weight decay: the reference's own setting, which the JAX package's
`make_optimizer` and `fused_adam_apply` reproduce. With
`trainer.adam_moments_dtype=bfloat16` it is `BF16MomentAdam`, the
counterpart of `fused_adam_apply(moments_dtype='bfloat16')`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch

from ..models.base import DiffRollModel

BETAS, EPS = (0.9, 0.999), 1e-8
_SR_KEY = 0x5ADA      # the JAX package keys its rounding bits off fold_in(key(0x5ADA), count)


def stochastic_round_bf16(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding: add 16 uniform low bits below
    bf16's mantissa cut, then truncate. Unbiased (E[round(x)] == x), unlike
    round-to-nearest, which loses moment updates smaller than half an ulp.
    The add runs in int64 on the f32 bit pattern read as unsigned, so it
    cannot overflow; the truncated pattern is exactly a bf16 value."""
    bits = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device,
                         dtype=torch.int64)
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + bits) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)  # back to the int32 pattern
    return r.to(torch.int32).view(torch.float32).to(torch.bfloat16)


class BF16MomentAdam(torch.optim.Optimizer):
    """Adam (no weight decay) whose moments mu and nu are stored in bf16.

    Each step upcasts them to f32 for the recursion and the update, as
    `fused_adam_apply` does: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), then writes m
    and v back with `stochastic_round_bf16`. The rounding bits come from a
    `torch.Generator` on the parameters' device seeded from `seed` and the
    step count (JAX's `jax.random` bits cannot be replayed), so every data-
    parallel rank draws the same bits and the update is a function of
    (state, gradients). Plain torch ops: the JAX version is XLA, not a
    Pallas kernel.
    """

    def __init__(self, params: Iterable, lr: float, betas=BETAS, eps: float = EPS,
                 seed: int = 0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self.seed = int(seed)

    def _generator(self, device: torch.device, count: int) -> torch.Generator:
        seed = ((_SR_KEY * 1_000_003 + self.seed) * 1_000_003 + count) % (1 << 63)
        return torch.Generator(device=device).manual_seed(seed)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        gens: Dict[tuple, torch.Generator] = {}
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.bfloat16)
                st["step"] += 1
                count = int(st["step"])
                g = p.grad.float()
                m = b1 * st["exp_avg"].float() + (1.0 - b1) * g
                v = b2 * st["exp_avg_sq"].float() + (1.0 - b2) * (g * g)
                c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
                p.sub_((lr * (m / c1) / (torch.sqrt(v / c2) + eps)).to(p.dtype))
                key = (p.device, count)
                if key not in gens:
                    gens[key] = self._generator(p.device, count)
                st["exp_avg"].copy_(stochastic_round_bf16(m, gens[key]))
                st["exp_avg_sq"].copy_(stochastic_round_bf16(v, gens[key]))
        return loss

    def load_state_dict(self, state_dict):
        # torch casts a loaded state to each parameter's dtype; the moments stay bf16
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = st[k].to(torch.bfloat16)


def make_optimizer(model: DiffRollModel, lr: float, moments_dtype: Optional[str] = None,
                   seed: int = 0) -> torch.optim.Optimizer:
    """`torch.optim.Adam`, or with `moments_dtype='bfloat16'` the
    bf16-moment Adam (`trainer.adam_moments_dtype`; its rounding bits are
    seeded from `seed`, `trainer.seed`)."""
    if moments_dtype is None:
        return torch.optim.Adam(model.net.parameters(), lr=lr, betas=BETAS, eps=EPS,
                                weight_decay=0.0)
    if moments_dtype != "bfloat16":
        raise ValueError(f"adam_moments_dtype={moments_dtype!r}: only 'bfloat16' "
                         "(or None for f32 moments) is supported")
    return BF16MomentAdam(model.net.parameters(), lr, seed=seed)


@dataclasses.dataclass
class TrainState:
    step: int
    model: DiffRollModel
    optimizer: torch.optim.Optimizer
    # the EMA of the weights, when `fit` keeps one (trainer.ema_decay)
    ema: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: DiffRollModel, lr: float, moments_dtype: Optional[str] = None,
               seed: int = 0) -> "TrainState":
        return cls(step=0, model=model,
                   optimizer=make_optimizer(model, lr, moments_dtype, seed))
