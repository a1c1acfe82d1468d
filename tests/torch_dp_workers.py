"""One rank of the mesh checks in tests/test_torch_parallel.py (the data
axis) and tests/test_torch_model_axis.py (the model axis, the service over
a mesh, sequence parallelism).

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
from diffroll_tpu_torch.cli import _common
from diffroll_tpu_torch.cli import serve as serve_cli
from diffroll_tpu_torch.parallel import (
    sample_sequence_parallel, sequence_parallel_forward, setup_mesh)
from diffroll_tpu_torch.parallel.model_axis import full_state_dict, full_tensors
from diffroll_tpu_torch.tasks import DiffusionTask, TaskConfig
from diffroll_tpu_torch.train import TrainState, make_train_step


def step_scenario(rank, spec):
    """One training step on this rank's stripe of a global batch, with the
    global draws given, on the modules route and on the fused one."""
    inp = torch.load(spec["step_inputs"], weights_only=False)
    cfg = tconfig.ExperimentConfig().replace(dataloader=tconfig.DataloaderConfig(
        train_batch_size=inp["batch"]["frame"].shape[0]))
    mesh = setup_mesh(cfg, torch.device("cpu"))
    out = {"rank": mesh.rank, "size": mesh.data, "backend": mesh.backend}
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
    """The mesh's refusals inside a group of 2."""
    msgs = {}
    for name, over in (("data_axis", {"trainer.data_axis": "3"}),
                       ("batch", {"dataloader.train_batch_size": "3"}),
                       ("model_axis", {"trainer.model_axis": "3"}),
                       ("model_axis_zero", {"trainer.model_axis": "0"}),
                       ("mesh_size", {"trainer.data_axis": "2", "trainer.model_axis": "2"})):
        try:
            setup_mesh(tconfig.compose("spec_roll", over), torch.device("cpu"))
            msgs[name] = None
        except (ValueError, NotImplementedError) as e:
            msgs[name] = f"{type(e).__name__}: {e}"
    # an entry that does not train ignores the train batch
    mesh = setup_mesh(tconfig.compose("spec_roll", {"dataloader.train_batch_size": "3"}),
                      torch.device("cpu"), train=False)
    msgs["batch_not_training"] = None if mesh is None else mesh.data
    return msgs


def _mesh_cfg(spec, **over):
    """The config of `spec["mesh"]` (data x model), with `over` on top."""
    m = spec["mesh"]
    return tconfig.compose("spec_roll", {"trainer.data_axis": str(m["data"]),
                                         "trainer.model_axis": str(m["model"]), **over})


def _sharded_step(mesh, inp, route):
    """One step of `inp`'s model (`inp["name"]`, the 1-D flagship where
    unset) sharded over `mesh`, on the global draws given: the whole
    (gathered) parameters and gradients, the loss, and this rank's chunk
    shapes and bytes."""
    kw = dict(inp["kw"], **({"dtype": "bfloat16"} if route == "bf16" else {}))
    model = tmodels.build(inp.get("name", "ClassifierFreeDiffRoll"), **kw)
    model.net.load_state_dict(inp["state_dict"])
    if mesh.rank:
        # the chunks are cut from rank 0's whole weights, whatever this rank holds
        with torch.no_grad():
            for p in model.net.parameters():
                p.add_(1.0)
    state = TrainState.create(model, inp["lr"], "bfloat16" if route == "bf16" else None)
    _common.shard_model(model, mesh, state.optimizer)
    task = DiffusionTask(model, TaskConfig(timesteps=inp["kw"]["timesteps"],
                                           fused_train=route == "fused", **inp.get("task", {})),
                         mesh=mesh)
    batch = {k: mesh.stripe(torch.from_numpy(v)) for k, v in inp["batch"].items()}
    draws = {k: mesh.stripe(v) for k, v in inp["draws"].items()}
    step = make_train_step(lambda b, g, train: task.loss_fn(b, g, train, **draws), mesh)
    losses = step(state, batch, None)
    net = model.net
    return {
        "loss": float(losses["diffusion_loss"]),
        "params": full_state_dict(net),
        "grads": full_tensors(net, {n: p.grad for n, p in net.named_parameters()}),
        "chunks": {n: tuple(p.shape) for n, p in net.named_parameters()},
        "param_bytes": sum(p.numel() * p.element_size() for p in net.parameters()),
        "moment_bytes": sum(v.numel() * v.element_size() for st in state.optimizer.state.values()
                            for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))}


def _step_mesh(spec, inp):
    b = inp["batch"]["frame"].shape[0]
    return setup_mesh(_mesh_cfg(spec, **{"dataloader.train_batch_size": str(b)}),
                      torch.device("cpu"))


def mp_step_scenario(rank, spec):
    """One training step of the 1-D flagship over the (data, model) mesh of
    `spec["mesh"]` on the modules route, the fused one and the modules in
    bf16 (with bf16 Adam moments)."""
    inp = torch.load(spec["step_inputs"], weights_only=False)
    mesh = _step_mesh(spec, inp)
    out = {"rank": mesh.rank, "data": mesh.data, "model": mesh.model}
    for route in ("modules", "fused", "bf16"):
        out[route] = _sharded_step(mesh, inp, route)
    return out


def mp_presets_scenario(rank, spec):
    """One training step on the modules route of each of the other presets
    in `spec["preset_inputs"]` (the 2-D net and a U-Net: their convs and
    norms column-parallel) over the mesh of `spec["mesh"]`."""
    presets = torch.load(spec["preset_inputs"], weights_only=False)
    mesh = _step_mesh(spec, next(iter(presets.values())))
    return {key: _sharded_step(mesh, inp, "modules") for key, inp in presets.items()}


def _whole(state):
    return {"step": state.step, "params": full_state_dict(state.model.net),
            "ema": None if state.ema is None else full_tensors(state.model.net, state.ema)}


def mp_cli_scenario(rank, spec):
    """The entries at model_axis=2: train (its checkpoint), train resumed
    from the single-process checkpoint for no epoch (it writes the state it
    loaded, whole), distill and train baseline."""
    out = {"train": _whole(train_cli.main(spec["train_args"])),
           "resume": _whole(train_cli.main(spec["resume_args"]))}
    out["distill"] = distill_cli.main(spec["distill_args"])
    out["baseline"] = _whole(train_cli.main(spec["baseline_args"]))
    return out


def mp_eval_scenario(rank, spec):
    """test and transcribe over the (data, model) mesh: the weights whole on
    every rank, the batches striped by data index."""
    return {"test": test_cli.main(spec["test_args"]),
            "transcribe": transcribe_cli.main(spec["transcribe_args"])}


def serve_scenario(rank, spec):
    """The service over the data axis: rank 0 takes two requests through
    `transcribe` and one through HTTP, the other ranks follow."""
    import threading
    import urllib.request

    import numpy as np

    from diffroll_tpu_torch.serve import serve_forever

    service, cfg, info = serve_cli.make_service(spec["serve_args"])
    out = {"max_batch": service.max_batch}
    if not service.leads:
        service.follow()
        out["batches"] = service.stats["batches"]
        return out
    audio = np.load(spec["serve_audio"])
    out["rolls"] = [service.transcribe(audio[k]) for k in ("a", "b")]
    ready = threading.Event()
    th = threading.Thread(target=serve_forever, args=(service, "127.0.0.1", spec["http_port"]),
                          kwargs={"info": info, "ready": ready}, daemon=True)
    th.start()
    ready.wait(30)
    req = urllib.request.Request(f"http://127.0.0.1:{spec['http_port']}/transcribe",
                                 data=pathlib.Path(spec["serve_wav"]).read_bytes(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        out["http"] = json.loads(r.read())
    ready.server.shutdown()
    th.join(30)
    out["batches"] = service.stats["batches"]
    service.close()
    return out


def sp_scenario(rank, spec):
    """Sequence parallelism over the data axis of 2: the forward
    (conditional and not), the sampler, and the undersized-shard refusal."""
    inp = torch.load(spec["sp_inputs"], weights_only=False)
    mesh = setup_mesh(_mesh_cfg({"mesh": {"data": 2, "model": 1}}), torch.device("cpu"))
    model = tmodels.build("ClassifierFreeDiffRoll", **inp["kw"])
    model.net.load_state_dict(inp["state_dict"])
    x, t, cond = inp["x"], inp["t"], inp["cond"]
    out = {"data": mesh.data}
    with torch.no_grad():
        out["cond"] = sequence_parallel_forward(mesh, model.net, x, t, cond)
        out["uncond"] = sequence_parallel_forward(mesh, model.net, x, t, None)
    task = DiffusionTask(model, TaskConfig(timesteps=inp["kw"]["timesteps"], w=0.5,
                                           sampling_type="cfdg_ddpm_x0"))
    out["sample"] = sample_sequence_parallel(task, inp["x_T"], mesh, waveform=inp["wav"],
                                             noise=inp["noise"])[0]
    try:
        sequence_parallel_forward(mesh, model.net, x[:, :4], t, None)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


SCENARIOS = {"step": step_scenario, "cli": cli_scenario, "errors": errors_scenario,
             "mp_step": mp_step_scenario, "mp_presets": mp_presets_scenario,
             "mp_cli": mp_cli_scenario,
             "mp_eval": mp_eval_scenario, "serve": serve_scenario, "sp": sp_scenario}


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
