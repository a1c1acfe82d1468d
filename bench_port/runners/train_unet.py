"""Training a U-Net configuration on the port's normal path: `make_train_step`
over `DiffusionTask.loss_fn`, whose forward is `model.apply` under autograd
(no kernel of the port: `supports_fused` is false for the U-Nets), then
`TrainState`'s Adam; one batch of the mix's windows a step, with PyTorch's
default precision (cuDNN convolutions in TF32, products in f32).

As `runners/train.py` (pool, three checked steps in set-up, the window),
with the weights of `weights_unet.py`, and a traced stretch that keeps the
card's side of the program's spans (`trace_annotated.py`). Of the first
three steps the check reads `grad_gap`, `update_gap` and `loss_gap` as
`runners/train.py` defines them, and
  pred_rms   the relative RMS gap of step 1's x0 prediction over the batch
             (infinite where the program predicted for other rows).
With `control`, beside the fp8 and bf16 controls and the half batch, the
reference with TF32 in every product (`control_tf32.`; on a card only).
The window's `unet.attn_rows` (rows through the bottleneck's full attention)
and the launches of the port's kernels K1-K4 are printed, not compared.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional

import torch

from .. import inputs, port, trace_annotated, weights_unet
from ..reference import diffroll as ref
from ..reference import spec_unet as uref
from . import train

CHECKED_STEPS = train.CHECKED_STEPS


def attn_rows() -> Optional[int]:
    """Rows through the U-Net's full attention so far; None where the program
    does not count them."""
    from diffroll_tpu_torch.nn import unet

    return getattr(unet, "attn_rows", None)


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off in every matmul and cuDNN convolution, then the
    process's own setting again (the program's PyTorch defaults)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Runner(train.Runner):
    def __init__(self, run):
        super().__init__(run)
        self.pred: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ the program
    def build_step(self):
        from diffroll_tpu_torch.train.state import TrainState
        from diffroll_tpu_torch.train.step import make_train_step

        cfg = self.run.cfg
        model = port.build_model(cfg, self.run.device, self.params)
        task = port.build_task(cfg, model)

        def loss(batch, generator, train):
            total, (losses, tensors) = task.loss_fn(batch, generator, train, t=batch["t"],
                                                    noise=batch["noise"])
            if self.pred is None:
                self.pred = tensors["pred_roll"].detach().clone()
            return total, (losses, tensors)

        self.state = TrainState.create(model, cfg["lr"])
        self.task = task
        return make_train_step(loss)

    @staticmethod
    def launches() -> Dict[str, int]:
        from diffroll_tpu_torch.ops.gated_stack import gated_stack
        from diffroll_tpu_torch.ops.sampler_kernel import fused_sample

        return {"k1": gated_stack.launches, "k2": fused_sample.launches,
                **train.Runner.launches()}

    # ------------------------------------------------------------ phases
    def setup(self) -> None:
        run = self.run
        self.params = weights_unet.make(run.cfg, inputs.torch_seed(run.seed, train.WEIGHT_STREAM),
                                        run.device)
        self.pool = self.make_pool()
        run.mark("inputs")
        self.step = self.build_step()
        run.mark("model")
        self.generator = torch.Generator(device=run.device).manual_seed(
            inputs.torch_seed(run.seed, train.POOL_STREAM + 1))
        start = {k: v.detach().clone() for k, v in self.named_params().items()}
        losses, grad_norms = [], {}
        for j in range(CHECKED_STEPS):
            losses.append(self.step(self.state, self.pool[j], self.generator)["diffusion_loss"])
            if j == 0:
                opt = self.state.optimizer
                grad_norms = {k: opt.state[p]["exp_avg"].norm() / (1.0 - train.BETA1)
                              for k, p in self.named_params().items() if p in opt.state}
        update_norms = {k: (p.detach() - start[k]).norm() for k, p in self.named_params().items()}
        self.first = {"losses": torch.stack(losses).tolist(),
                      "grad_norms": {k: float(v) for k, v in grad_norms.items()},
                      "update_norms": {k: float(v) for k, v in update_norms.items()},
                      "pred": self.pred}

    def window(self, seconds: float, traced: bool) -> dict:
        """Steps until the deadline, on pool batches from 3 on, cycling; with
        `traced`, `trace_steps` steps after the first `trace_after` profiled."""
        mix = self.run.mix
        before, rows_before = self.launches(), attn_rows()
        losses: List[torch.Tensor] = []
        prof, traced_steps = {}, 0
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while True:
            if traced and n == mix["trace_after"]:
                with trace_annotated.stretch(prof):
                    for _ in range(mix["trace_steps"]):
                        losses.append(self._one(n))
                        n += 1
                traced_steps = mix["trace_steps"]
            losses.append(self._one(n))
            n += 1
            if time.perf_counter() >= deadline:
                break
        finite = torch.isfinite(torch.stack(losses)).tolist()  # waits for the last step
        elapsed = time.perf_counter() - t0
        after, rows_after = self.launches(), attn_rows()
        out = {"elapsed_s": elapsed, "steps": n, "windows": n * mix["batch"],
               **{f"{k}_launches": after[k] - before[k] for k in after},
               "attempted": n, "failed": finite.count(False)}
        if rows_after is not None:
            out["unet.attn_rows"] = rows_after - rows_before
        if traced_steps:
            out["trace"], out["traced_steps"] = prof["trace"], traced_steps
        return out

    def free(self) -> None:
        super().free()
        self.pred = None

    # ------------------------------------------------------------ the check
    def reference_steps(self, precision: str = "f32", rows: Optional[int] = None) -> dict:
        """The reference's first three steps from the same weights and
        batches: each step's loss, the first gradient's norm a leaf, each
        leaf's change after the three, and step 1's prediction. `rows` keeps
        the first rows of each batch alone (the half-batch fault)."""
        cfg = self.run.cfg
        params = {k: v.detach().clone() for k, v in self.params.items()}
        start = {k: v.clone() for k, v in params.items()}
        state: dict = {}
        losses, grad_norms, keep = [], {}, {}
        for j in range(CHECKED_STEPS):
            b = self.pool[j]
            cut = slice(None) if rows is None else slice(0, rows)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            net = uref.SpecUnet(leaves, cfg, precision)
            loss = uref.train_loss(net, cfg, b["audio"][cut], b["frame"][cut], b["t"][cut],
                                   b["noise"][cut], keep if j == 0 else None)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                         allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
            losses.append(float(loss.detach()))
            params = {k: v.detach() for k, v in leaves.items()}
            if j == 0:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            with torch.no_grad():
                ref.adam_update(params, grads, state, j + 1, cfg["lr"])
        return {"losses": losses, "grad_norms": grad_norms,
                "update_norms": {k: float((params[k] - start[k]).norm()) for k in params},
                "pred": keep["pred"]}

    @staticmethod
    def gaps(got: dict, want: dict) -> Dict[str, float]:
        out = train.Runner.gaps(got, want)
        p, w = got["pred"], want["pred"]
        if p is None or p.shape != w.shape:
            out["pred_rms"] = float("inf")
        else:
            gap = float((p.float() - w).norm() / w.norm())
            out["pred_rms"] = gap if math.isfinite(gap) else float("inf")
        return out

    def check(self, records: dict, control: bool = False) -> Dict[str, float]:
        with tf32(False):
            want = self.reference_steps()
            out = self.gaps(self.first, want)
            runs = (("control", "fp8", None), ("control_bf16", "bf16", None),
                    ("half_batch", "f32", self.run.mix["batch"] // 2))
            for name, prec, rows in runs if control else ():
                got = self.reference_steps(prec, rows)
                out.update({f"{name}.{k}": v for k, v in self.gaps(got, want).items()
                            if not k.endswith("_leaf")})
        if control and self.run.device.type == "cuda":
            with tf32(True):
                got = self.reference_steps()
            out.update({f"control_tf32.{k}": v for k, v in self.gaps(got, want).items()
                        if not k.endswith("_leaf")})
        for k in ("steps", "unet.attn_rows", "k1_launches", "k2_launches", "k3_launches",
                  "k4_launches"):
            if k in records:
                out[k] = records[k]
        return out
