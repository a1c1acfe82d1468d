"""PyTorch-Lightning checkpoints for the port (counterpart of
`diffroll_tpu/compat/torch_ckpt.py`).

The port's modules keep the reference's parameter names and layouts, so a
Lightning `state_dict` loads with `load_state_dict` once the recomputed
buffers (mel, schedule and embedding tables) are dropped.

Published checkpoints were written by Hydra + Lightning: their
`hyper_parameters` pickle omegaconf containers and Lightning's
AttributeDict, none of which need to be installed. The tolerant unpickler
stubs any missing class with a dict and `plain_hparams` coerces the stubs
to plain Python values.

`state_dict_from_jax` is the inverse of the JAX package's
`convert_state_dict`: it carries JAX params into a port state_dict
(kernel (K, I, O) -> (O, I, K), Dense (I, O) -> (O, I)).
"""

from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config.overrides import apply_overrides
from ..models import PRESETS
from ..models.base import DiffRollConfig, DiffRollModel


class _Stub(dict):
    """Stand-in for an unimportable pickled class (dict-backed)."""

    def __setstate__(self, state):
        if isinstance(state, tuple):  # (state, slotstate)
            merged = {}
            for part in state:
                if part:
                    merged.update(part)
            state = merged
        if isinstance(state, dict):
            self.update(state)

    # list-subclass pickles append items instead of setting state
    def append(self, v):
        self.setdefault("_list_items", []).append(v)

    def extend(self, vs):
        self.setdefault("_list_items", []).extend(vs)


_STUB_CACHE: Dict[Tuple[str, str], type] = {}


def _make_stub(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (_Stub,), {"__module__": module})
    return _STUB_CACHE[key]


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _make_stub(module, name)


class _TolerantPickleModule:
    """Duck-typed `pickle_module` for torch.load."""

    Unpickler = _TolerantUnpickler

    @staticmethod
    def load(f, **kw):
        return _TolerantUnpickler(f, **kw).load()

    @staticmethod
    def loads(b, **kw):
        return _TolerantUnpickler(io.BytesIO(b), **kw).load()


def plain_hparams(obj: Any) -> Any:
    """Coerce stubbed omegaconf/Lightning containers to plain Python."""
    if isinstance(obj, _Stub):
        d = dict(obj)
        if "_content" in d:
            return plain_hparams(d["_content"])
        if "_val" in d:
            return plain_hparams(d["_val"])
        if "_list_items" in d:
            return plain_hparams(d["_list_items"])
        return {k: plain_hparams(v) for k, v in d.items() if not k.startswith("_")}
    if isinstance(obj, dict):
        return {k: plain_hparams(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain_hparams(v) for v in obj]
    return obj


# state_dict entries that are recomputed buffers, not weights
SKIP_PREFIXES = (
    "mel_layer.",
    "normalization",
    "betas", "alphas", "sqrt_", "posterior_",
    "diffusion_embedding.embedding",
    "spec_layer.",
)


def config_from_hparams(hparams: Dict[str, Any],
                        name: str = "ClassifierFreeDiffRoll") -> DiffRollConfig:
    """Best-effort DiffRollConfig from a checkpoint's hyper_parameters."""
    cfg = PRESETS.get(name, DiffRollConfig())
    fields = ("residual_channels", "residual_layers", "kernel_size",
              "dilation_base", "dilation_bound", "spec_dropout", "condition",
              "unconditional", "n_mels", "timesteps")
    updates = {}
    for f in fields:
        if hparams.get(f) is not None:
            v = hparams[f]
            updates[f] = tuple(v) if isinstance(v, list) else v
    if hparams.get("norm_args") is not None:
        na = list(hparams["norm_args"])
        updates["norm_args"] = (float(na[0]), float(na[1]), str(na[2]))
    spec = hparams.get("spec_args") or {}
    if spec:
        mel_map = {"sample_rate": int, "n_fft": int, "hop_length": int,
                   "n_mels": int, "f_min": float, "f_max": float,
                   "center": bool, "normalized": bool, "pad_mode": str,
                   "power": float, "win_length": int}
        mel_updates = {k: cast(spec[k]) for k, cast in mel_map.items()
                       if spec.get(k) is not None}
        updates["mel"] = dataclasses.replace(cfg.mel, **mel_updates)
        if "n_mels" in mel_updates:
            updates["n_mels"] = mel_updates["n_mels"]
    return cfg.replace(**updates)


def task_updates_from_hparams(hparams: Dict[str, Any]) -> Dict[str, Any]:
    """Task knobs recorded in a checkpoint, as TaskConfig field updates."""
    out: Dict[str, Any] = {}
    flat = {"timesteps": int, "beta_start": float, "beta_end": float,
            "loss_type": str, "frame_threshold": float, "lr": float}
    for k, cast in flat.items():
        if hparams.get(k) is not None:
            out[k] = cast(hparams[k])
    if hparams.get("loss_keys"):
        out["loss_keys"] = tuple(hparams["loss_keys"])
    training = hparams.get("training") or {}
    if training.get("mode"):
        out["training_mode"] = str(training["mode"])
    sampling = hparams.get("sampling") or {}
    if sampling.get("type"):
        out["sampling_type"] = str(sampling["type"])
    if sampling.get("w") is not None:
        out["w"] = float(sampling["w"])
    return out


def _read_ckpt(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """torch.load with the tolerant pickle module -> (hparams, state_dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_TolerantPickleModule)
    state_dict = ckpt.get("state_dict", ckpt)
    hparams = plain_hparams(ckpt.get("hyper_parameters", {}))
    return (hparams if isinstance(hparams, dict) else {}), state_dict


def _weights_only(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state_dict.items()
            if not any(k.startswith(p) for p in SKIP_PREFIXES)}


def load_lightning(
    path: str,
    model_name: str = "ClassifierFreeDiffRoll",
    device: str | torch.device = "cpu",
    overrides: Optional[Dict[str, Any]] = None,
) -> Tuple[DiffRollModel, Dict[str, Any]]:
    """A Lightning .ckpt -> (port model on `device` in eval mode, TaskConfig
    field updates recorded in the checkpoint). `overrides` are dotted model
    config keys (`{"frames": "16"}`) applied over the recorded hparams. The
    weights go in through `load_state_dict`, strictly: a layout mismatch
    raises."""
    hparams, state_dict = _read_ckpt(path)
    cfg = apply_overrides(config_from_hparams(hparams, model_name), overrides or {})
    model = DiffRollModel(cfg)
    model.net.load_state_dict(_weights_only(state_dict))
    return model.to(device).eval(), task_updates_from_hparams(hparams)


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params ({'params': tree} or the tree) -> port state_dict."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, leaf: str, arr) -> None:
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "bias":
            out[f"{name}.bias"] = torch.from_numpy(a.copy())
        elif a.ndim == 3:    # Conv1d kernel (K, I, O) -> (O, I, K)
            out[f"{name}.weight"] = torch.from_numpy(a.transpose(2, 1, 0).copy())
        elif a.ndim == 2:    # Dense kernel (I, O) -> (O, I)
            out[f"{name}.weight"] = torch.from_numpy(a.transpose(1, 0).copy())
        else:
            raise ValueError(f"unexpected leaf {name}/{leaf} of shape {a.shape}")

    for scope, sub in p.items():
        if scope.startswith("residual_layers_"):
            idx = scope[len("residual_layers_"):]
            for mod, leaves in sub.items():
                for leaf, arr in leaves.items():
                    put(f"residual_layers.{idx}.{mod}", leaf, arr)
        elif scope == "diffusion_embedding":
            for mod, leaves in sub.items():
                for leaf, arr in leaves.items():
                    put(f"diffusion_embedding.{mod}", leaf, arr)
        else:
            for leaf, arr in sub.items():
                put(scope, leaf, arr)
    return out
