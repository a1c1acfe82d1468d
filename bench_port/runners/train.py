"""Training: the port's `make_train_step` over `DiffusionTask.loss_fn` with
`fused_train=True` (the conditioner's mel, K3, K4, the loss, Adam), one
batch of the mix's windows a step.

Set-up builds the model from the seed's weights and one train state, makes a
pool of distinct batches on the card (audio, rolls, and each row's timestep
and noise, which `loss_fn` takes as given), and drives the state through its
first three steps on pool batches 0-2. Those steps warm up every shape and
are the ones the check holds against the reference; the window goes on with
the same state on the pool's other batches, cycling, until its deadline, and
ends on a synchronize.

The check reads, of the first three steps (leaves whose reference gradient
is under a thousandth of the median leaf's left out, by that rule):
  grad_gap      the widest gap of a leaf's first-gradient norm (the
                optimizer's first moment after step 1, over 1 - beta1)
  update_gap    the widest gap of a leaf's change over the three steps
  loss_gap      the widest relative gap of a step's loss
each leaf's gap |port norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf. The cell's limits file
names the ones compared.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import inputs, port, trace, weights
from ..reference import diffroll as ref

WEIGHT_STREAM, POOL_STREAM = 20, 21
CHECKED_STEPS = 3
BETA1 = 0.9
SMALL_LEAF = 1e-3   # leaves whose reference gradient is under this share of the median's


class Runner:
    def __init__(self, run):
        self.run = run
        self.state = None
        self.step = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.pool: List[dict] = []
        self.first: dict = {}

    # ------------------------------------------------------------ inputs
    def make_pool(self) -> List[dict]:
        """`pool` batches of `batch` windows on the card: seeded Gaussian audio
        (0.1 rms), rolls of `note_frames`-frame notes held in a
        `note_density` share of (block, key) cells, each row's timestep and
        noise."""
        run = self.run
        cfg, mix, dev = run.cfg, run.mix, run.device
        g = torch.Generator(device=dev).manual_seed(inputs.torch_seed(run.seed, POOL_STREAM))
        b, frames, keys = mix["batch"], cfg["frames"], cfg["pitches"]
        samples = frames * cfg["mel"]["hop_length"]
        blocks = -(-frames // mix["note_frames"])
        pool = []
        for _ in range(mix["pool"]):
            cells = torch.rand((b, blocks, keys), generator=g, device=dev) < mix["note_density"]
            frame = cells.repeat_interleave(mix["note_frames"], dim=1)[:, :frames].float()
            pool.append({
                "audio": 0.1 * torch.randn((b, samples), generator=g, device=dev),
                "frame": frame,
                "t": torch.randint(0, cfg["timesteps"], (b,), generator=g, device=dev),
                "noise": torch.randn((b, frames, keys), generator=g, device=dev),
            })
        return pool

    # ------------------------------------------------------------ the program
    def build_step(self):
        from diffroll_tpu_torch.train.state import TrainState
        from diffroll_tpu_torch.train.step import make_train_step

        run = self.run
        cfg, dev = run.cfg, run.device
        model = port.build_model(cfg, dev, self.params)
        task = port.build_task(cfg, model, fused_train=True)

        def loss(batch, generator, train):
            return task.loss_fn(batch, generator, train, t=batch["t"], noise=batch["noise"])

        self.state = TrainState.create(model, cfg["lr"])
        self.task = task
        return make_train_step(loss)

    def named_params(self) -> Dict[str, torch.Tensor]:
        return {f"net.{k}": v for k, v in self.state.model.net.named_parameters()}

    @staticmethod
    def launches() -> Dict[str, int]:
        from diffroll_tpu_torch.ops.gated_stack_train import bwd, fwd_saves

        return {"k3": fwd_saves.launches, "k4": bwd.launches}

    # ------------------------------------------------------------ phases
    def setup(self) -> None:
        run = self.run
        self.params = weights.make(port.model_shapes(run.cfg),
                                   inputs.torch_seed(run.seed, WEIGHT_STREAM), run.device)
        self.pool = self.make_pool()
        run.mark("inputs")
        self.step = self.build_step()
        run.mark("model")
        self.generator = torch.Generator(device=run.device).manual_seed(
            inputs.torch_seed(run.seed, POOL_STREAM + 1))
        start = {k: v.detach().clone() for k, v in self.named_params().items()}
        losses, grad_norms = [], {}
        for j in range(CHECKED_STEPS):
            losses.append(self.step(self.state, self.pool[j], self.generator)["diffusion_loss"])
            if j == 0:
                opt = self.state.optimizer
                grad_norms = {k: opt.state[p]["exp_avg"].norm() / (1.0 - BETA1)
                              for k, p in self.named_params().items() if p in opt.state}
        update_norms = {k: (p.detach() - start[k]).norm() for k, p in self.named_params().items()}
        self.first = {"losses": torch.stack(losses).tolist(),
                      "grad_norms": {k: float(v) for k, v in grad_norms.items()},
                      "update_norms": {k: float(v) for k, v in update_norms.items()}}

    def window(self, seconds: float, traced: bool) -> dict:
        """Steps until the deadline, on pool batches from 3 on, cycling; with
        `traced`, `trace_steps` steps after the first `trace_after` profiled."""
        mix = self.run.mix
        before = self.launches()
        losses, prof, traced_steps = [], {}, 0
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while True:
            if traced and n == mix["trace_after"]:
                with trace.stretch(prof):
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
        after = self.launches()
        out = {"elapsed_s": elapsed, "steps": n, "windows": n * mix["batch"],
               "k3_launches": after["k3"] - before["k3"],
               "k4_launches": after["k4"] - before["k4"],
               "attempted": n, "failed": finite.count(False)}
        if traced_steps:
            out["trace"], out["traced_steps"] = prof["trace"], traced_steps
        return out

    def _one(self, n: int) -> torch.Tensor:
        batch = self.pool[CHECKED_STEPS + n % (len(self.pool) - CHECKED_STEPS)]
        with trace.annotate("bench.train_step"):
            return self.step(self.state, batch, self.generator)["diffusion_loss"]

    def free(self) -> None:
        self.state = self.step = self.task = None

    # ------------------------------------------------------------ the check
    def reference_steps(self, precision: str = "f32", rows: Optional[int] = None) -> dict:
        """The reference's first three steps from the same weights and
        batches: each step's loss, the first gradient's norm a leaf, and each
        leaf's change after the three. `rows` keeps the first rows of each
        batch alone (the half-batch fault)."""
        cfg = self.run.cfg
        params = {k: v.detach().clone() for k, v in self.params.items()}
        start = {k: v.clone() for k, v in params.items()}
        state: dict = {}
        losses, grad_norms = [], {}
        for j in range(CHECKED_STEPS):
            b = self.pool[j]
            keep = slice(None) if rows is None else slice(0, rows)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            net = ref.Denoiser(leaves, cfg, precision)
            loss = ref.train_loss(net, cfg, b["audio"][keep], b["frame"][keep],
                                  b["t"][keep], b["noise"][keep])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            params = {k: v.detach() for k, v in leaves.items()}
            if j == 0:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            with torch.no_grad():
                ref.adam_update(params, grads, state, j + 1, cfg["lr"])
        return {"losses": losses, "grad_norms": grad_norms,
                "update_norms": {k: float((params[k] - start[k]).norm()) for k in params}}

    @staticmethod
    def gaps(got: dict, want: dict) -> Dict[str, float]:
        """The three numbers of `got` against `want` (both `reference_steps`
        shaped)."""
        g_ref = want["grad_norms"]
        median = float(np.median(list(g_ref.values())))
        kept = [k for k, v in g_ref.items() if v >= SMALL_LEAF * median]

        def leaf_gaps(key: str) -> Dict[str, float]:
            ref_n = want[key]
            floor = float(np.median([ref_n[k] for k in kept]))
            gaps = {}
            for k in kept:
                gap = (abs(got[key][k] - ref_n[k]) / max(ref_n[k], floor)
                       if k in got[key] else float("inf"))
                gaps[k] = gap if np.isfinite(gap) else float("inf")
            return gaps

        loss = max((abs(a - b) / abs(b) if np.isfinite(a) else float("inf"))
                   for a, b in zip(got["losses"], want["losses"]))
        grad, update = leaf_gaps("grad_norms"), leaf_gaps("update_norms")
        return {"loss_gap": loss, "grad_gap": max(grad.values()),
                "update_gap": max(update.values()),
                "grad_gap_leaf": max(grad, key=grad.get),
                "update_gap_leaf": max(update, key=update.get)}

    def check(self, records: dict, control: bool = False) -> Dict[str, float]:
        ref.exact_f32()
        want = self.reference_steps()
        out = self.gaps(self.first, want)
        if control:
            for name, got in (("control", self.reference_steps("fp8")),
                              ("control_bf16", self.reference_steps("bf16")),
                              ("half_batch", self.reference_steps(
                                  rows=self.run.mix["batch"] // 2))):
                out.update({f"{name}.{k}": v for k, v in self.gaps(got, want).items()
                            if not k.endswith("_leaf")})
        return out
