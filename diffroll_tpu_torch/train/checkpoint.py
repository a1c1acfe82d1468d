"""Checkpointing with "reload weights, override config" semantics
(counterpart of `diffroll_tpu/train/checkpoint.py`), in a torch format.

A checkpoint is one Lightning-style file, `<dir>/step_<N>.ckpt` or
`<dir>/last.ckpt`:

  * `state_dict`        the net's weights under the reference's names
  * `hyper_parameters`  the reference's hparams (architecture, task knobs),
                        plus `port_config`: the full model and task configs
  * `optimizer_state`, `global_step`, and any extras (`ema`: the EMA weights
    as a state_dict)

so `transcribe pretrained_path=<file>` and `compat.load_lightning` read what
`train` wrote, as they read a published checkpoint.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Dict, Optional

import torch

from ..compat.torch_ckpt import config_from_hparams, read_ckpt, task_config_from_hparams


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def hyper_parameters(config: Dict[str, Any]) -> Dict[str, Any]:
    """The config record ({'model_name', 'model', 'task'}) as Lightning
    hyper_parameters: the reference's keys, then the full configs."""
    m, t = config["model"], config["task"]
    return {
        "residual_channels": m.residual_channels, "residual_layers": m.residual_layers,
        "kernel_size": m.kernel_size, "dilation_base": m.dilation_base,
        "dilation_bound": m.dilation_bound, "spec_dropout": m.spec_dropout,
        "condition": m.condition, "unconditional": m.unconditional, "n_mels": m.n_mels,
        "norm_args": list(m.norm_args), "timesteps": t.timesteps,
        "beta_start": t.beta_start, "beta_end": t.beta_end, "loss_type": t.loss_type,
        "loss_keys": list(t.loss_keys), "frame_threshold": t.frame_threshold, "lr": t.lr,
        "training": {"mode": t.training_mode},
        "sampling": {"type": t.sampling_type, "w": t.w},
        "port_config": {"model_name": config.get("model_name", m.name),
                        "model": _jsonable(m), "task": _jsonable(t)},
    }


class Checkpointer:
    """Manages `<dir>/step_<N>.ckpt` (monitored, top-k) and `<dir>/last.ckpt`."""

    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 2):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step) -> pathlib.Path:
        if step == "last":
            return self.directory / "last.ckpt"
        return self.directory / f"step_{step:09d}.ckpt"

    def save_last(self, state, config: Optional[Dict[str, Any]] = None,
                  extras: Optional[Dict[str, Any]] = None) -> pathlib.Path:
        """Overwrite the rolling `last` checkpoint."""
        return self._save(self._path("last"), state, config, extras)

    def save(self, step: int, state, config: Optional[Dict[str, Any]] = None,
             extras: Optional[Dict[str, Any]] = None) -> pathlib.Path:
        path = self._save(self._path(step), state, config, extras)
        self._gc()
        return path

    def _save(self, path, state, config, extras) -> pathlib.Path:
        payload = {
            "state_dict": state.model.net.state_dict(),
            "hyper_parameters": hyper_parameters(config) if config is not None else {},
            "optimizer_state": state.optimizer.state_dict(),
            "global_step": int(state.step),
        }
        payload.update(extras or {})
        tmp = path.with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(path)
        return path

    def _gc(self):
        ckpts = sorted(self.directory.glob("step_*.ckpt"))
        for stale in ckpts[: -self.max_to_keep]:
            stale.unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.directory.glob("step_*.ckpt"))
        if not ckpts:
            return None
        return int(ckpts[-1].stem.split("_")[1])

    def resolve(self, step=None) -> pathlib.Path:
        """The file of `step`: the newest monitored one by default, else `last`."""
        if step is None:
            step = self.latest_step()
            if step is None and self._path("last").exists():
                step = "last"
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return self._path(step)

    def load(self, step=None) -> Dict[str, Any]:
        """The whole checkpoint as written (tensors on the CPU)."""
        return read_ckpt(str(self.resolve(step)))

    def peek_config(self, step=None) -> Dict[str, Any]:
        """The stored config record: {'model_name', 'model', 'task'}."""
        hparams = self.load(step)["hyper_parameters"]
        if not hparams:
            return {}
        port = hparams.get("port_config", {})
        return {"model_name": port.get("model_name", "ClassifierFreeDiffRoll"),
                "model": config_from_hparams(hparams),
                "task": task_config_from_hparams(hparams)}

    def load_extra(self, name: str, step=None) -> Optional[Any]:
        """An extra (e.g. 'ema') if the checkpoint has it."""
        try:
            return self.load(step).get(name)
        except FileNotFoundError:
            return None
