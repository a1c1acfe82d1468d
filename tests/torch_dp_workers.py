"""One rank of the data-parallel checks in tests/test_torch_parallel.py.

    python tests/torch_dp_workers.py <rank> <spec.json>

Joins a gloo group of `spec["world"]` ranks on localhost, runs each named
scenario and saves its results to <spec["out"]>/rank<rank>.pt. Imports no
jax: the JAX side of the comparisons runs in the test process.
"""

from __future__ import annotations

import json
import pathlib
import sys
import traceback

import torch
import torch.distributed as dist

from diffroll_tpu_torch import config as tconfig
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import distill as distill_cli
from diffroll_tpu_torch.cli import test as test_cli
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.cli import transcribe as transcribe_cli
from diffroll_tpu_torch.parallel import setup_mesh
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
from diffroll_tpu_torch.train import TrainState, make_train_step


def step_scenario(rank, spec):
    """One training step on this rank's stripe of a global batch, with the
    global draws given, on the modules route and on the fused one."""
    inp = torch.load(spec["step_inputs"], weights_only=False)
    cfg = tconfig.ExperimentConfig().replace(dataloader=tconfig.DataloaderConfig(
        train_batch_size=inp["batch"]["frame"].shape[0]))
    mesh = setup_mesh(cfg, torch.device("cpu"))
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend}
    for fused in (False, True):
        model = tmodels.build("ClassifierFreeDiffRoll", **inp["kw"])
        model.net.load_state_dict(inp["state_dict"])
        task = DiffusionTask(model, TaskConfig(timesteps=inp["kw"]["timesteps"],
                                               fused_train=fused), mesh=mesh)
        batch = {k: mesh.stripe(torch.from_numpy(v)) for k, v in inp["batch"].items()}
        draws = {k: mesh.stripe(v) for k, v in inp["draws"].items()}
        state = TrainState.create(model, inp["lr"])
        step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train, **draws), mesh)
        losses = step(state, batch, None)
        out[fused] = {"loss": float(losses["diffusion_loss"]),
                      "params": {n: p.detach().clone() for n, p in model.net.named_parameters()},
                      "grads": {n: p.grad.clone() for n, p in model.net.named_parameters()}}
    return out


def cli_scenario(rank, spec):
    """The entries over the data axis: train (with its post-fit test),
    test, transcribe, distill and train baseline."""
    out = {}
    state = train_cli.main(spec["train_args"])
    out["train"] = {"step": state.step,
                    "params": {n: p.detach().clone() for n, p in state.model.net.named_parameters()},
                    "ema": {n: v.clone() for n, v in state.ema.items()}}
    out["test"] = test_cli.main(spec["test_args"])
    out["transcribe"] = transcribe_cli.main(spec["transcribe_args"])
    out["distill"] = distill_cli.main(spec["distill_args"])
    state = train_cli.main(spec["baseline_args"])
    out["baseline"] = {"step": state.step, "params": {
        n: p.detach().clone() for n, p in state.model.net.named_parameters()}}
    return out


def errors_scenario(rank, spec):
    """The data axis's refusals inside a group of 2."""
    msgs = {}
    for name, over in (("data_axis", {"trainer.data_axis": "3"}),
                       ("batch", {"dataloader.train_batch_size": "3"}),
                       ("model_axis", {"trainer.model_axis": "2"})):
        try:
            setup_mesh(tconfig.compose("spec_roll", over), torch.device("cpu"))
            msgs[name] = None
        except (ValueError, NotImplementedError) as e:
            msgs[name] = f"{type(e).__name__}: {e}"
    return msgs


SCENARIOS = {"step": step_scenario, "cli": cli_scenario, "errors": errors_scenario}


def main(rank: int, spec_path: str) -> int:
    spec = json.loads(pathlib.Path(spec_path).read_text())
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            rank=rank, world_size=spec["world"])
    results = {}
    try:
        for name in spec["scenarios"]:
            results[name] = SCENARIOS[name](rank, spec)
    except Exception:
        traceback.print_exc()
        return 1
    torch.save(results, pathlib.Path(spec["out"]) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2]))
