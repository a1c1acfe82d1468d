"""One checkpoint scored through both packages' inpainting paths on the CPU:
the JAX package's `tools/eval_inpainting.py` (its loader, draws, sampler and
scoring, run as it is, with the checkpoint's window passed to its loader as
a `model.frames` override, which the tool's own keys cannot give) and the
port's `quality.eval_inpainting device=cpu`. The same F1 inside the band
from both says that a gap between the packages' inpainting scores comes
from what their trainings learned, not from the sampling or scoring path;
a gap here puts it in that path.

    JAX_PLATFORMS=cpu python tests/inpainting_cross_score.py ckpt=<port .ckpt> \\
        root=<MAPS tree> [mask=48,80 | fmask=29,51] [w=0.5] [seq=65536] \\
        [frames=128] [batch=8] [scorers=jax,port] [out=<dir>]
    JAX_PLATFORMS=cpu python tests/inpainting_cross_score.py \\
        ckpt=<a JAX run's checkpoints directory> [step=<N> | step=last] root=... [out=<dir>]
    JAX_PLATFORMS=cpu python tests/inpainting_cross_score.py \\
        ckpt=<a JAX run's checkpoints directory> step=<N> | step=last export=<file.ckpt>

A JAX checkpoints directory (`step_<N>/`, `last/`) is scored by the JAX tool
alone (the port reads no orbax checkpoint), at `step=` or, by default, at
the checkpoint the tool itself picks (the newest `step_<N>`, else `last`).
`scorers=jax` scores a port `.ckpt` through the JAX tool alone. With
`export=` the JAX checkpoint at `step=` is written as a port `.ckpt` (its
weights through `compat.state_dict_from_jax`, the port's config record of
the same model and task, its `global_step`) and nothing is scored; the
port's entries, `tests/inpainting_seeds.py score` among them, then read it
on the card.

The last stdout line is JSON: `global_step`, the training step of the
scored weights (a port `.ckpt` records it; a JAX checkpoint's state holds
it), each package's payload and the inside-band note / frame F1 of each
condition side by side; `<out>/cross_score.json` holds the same.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import pathlib
import sys
from typing import Dict, List, Optional, Tuple

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_checkpoint(ckpt_dir: str, step: Optional[str], out: pathlib.Path) -> str:
    """The directory the JAX loader reads for `step` of `ckpt_dir`: `ckpt_dir`
    itself when `step` is None, else a directory under `out` linking only that
    checkpoint (the JAX `Checkpointer` loads the newest `step_<N>`, else
    `last`)."""
    if step is None:
        return ckpt_dir
    name = "last" if step == "last" else f"step_{int(step):09d}"
    src = pathlib.Path(ckpt_dir).absolute() / name
    if not src.is_dir():
        raise SystemExit(f"no checkpoint {name} under {ckpt_dir}")
    link_dir = out / "jax_ckpt" / name
    link_dir.mkdir(parents=True, exist_ok=True)
    link = link_dir / name
    if link.is_symlink():
        link.unlink()
    link.symlink_to(src)
    return str(link_dir)


def jax_load(ckpt: str, frames: int) -> Tuple:
    """The JAX package's `load_pretrained` on `ckpt` (a `.ckpt` file or a
    checkpoints directory) at `model.frames=<frames>`: (cfg, model, task,
    state)."""
    from diffroll_tpu.cli import _common
    from diffroll_tpu.config import compose

    cfg = compose("test", {"pretrained_path": ckpt})
    return _common.load_pretrained(cfg, overrides={"model.frames": frames})


def export_port_ckpt(ckpt: str, frames: int, dst: pathlib.Path) -> int:
    """The JAX checkpoint `ckpt` as a port `.ckpt` at `dst`: its raw weights,
    the config record of the same model and task, its step. Returns the
    step."""
    import jax
    import numpy as np
    import torch

    from diffroll_tpu_torch.compat import state_dict_from_jax
    from diffroll_tpu_torch.dsp.mel import MelConfig
    from diffroll_tpu_torch.models.base import DiffRollConfig
    from diffroll_tpu_torch.tasks import TaskConfig
    from diffroll_tpu_torch.train.checkpoint import hyper_parameters

    cfg, _, _, state = jax_load(ckpt, frames)

    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    model = DiffRollConfig(**{**fields(cfg.model), "mel": MelConfig(**fields(cfg.model.mel)),
                              "dtype": np.dtype(cfg.model.dtype).name})
    task = TaskConfig(**fields(cfg.task))
    step = int(state.step)
    torch.save({"state_dict": state_dict_from_jax(jax.tree.map(np.asarray, state.params)),
                "hyper_parameters": hyper_parameters(
                    {"model_name": cfg.model_name, "model": model, "task": task}),
                "global_step": step}, dst)
    return step


def jax_tool_scores(args: Dict[str, str], ckpt: str, out: pathlib.Path) -> Tuple[Dict, int]:
    """`tools/eval_inpainting.py` on `ckpt`, its checkpoint loaded at
    `model.frames=<frames>`: (the payload it writes, the step of the state
    its loader restored)."""
    from diffroll_tpu.cli import _common

    spec = importlib.util.spec_from_file_location("jax_eval_inpainting",
                                                  REPO / "tools" / "eval_inpainting.py")
    tool = importlib.util.module_from_spec(spec)
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.argv = []
    try:
        spec.loader.exec_module(tool)
    finally:
        sys.argv, sys.path[:] = saved_argv, saved_path
    band = {k: args[k] for k in ("mask", "fmask") if k in args} or {"mask": "48,80"}
    tool.ARGS.update(ckpt=ckpt, root=args["root"], w=args.get("w", "0.5"),
                     seq=args.get("seq", "65536"), batch=args.get("batch", "8"),
                     tmpdir=str(out / "jax_tmp"), out=str(out / "jax.json"), **band)
    load = _common.load_pretrained
    steps = []

    def load_at_frames(cfg, **kw):
        loaded = load(cfg, overrides={"model.frames": int(args.get("frames", "128"))})
        steps.append(int(loaded[3].step))
        return loaded

    _common.load_pretrained = load_at_frames
    try:
        tool.main()
    finally:
        _common.load_pretrained = load
    return json.loads((out / "jax.json").read_text()), steps[0]


def port_scores(args: Dict[str, str], out: pathlib.Path) -> Dict:
    from diffroll_tpu_torch.quality import eval_inpainting

    band = [f"{k}={args[k]}" for k in ("mask", "fmask") if k in args] or ["mask=48,80"]
    return eval_inpainting.main([
        f"ckpt={args['ckpt']}", f"root={args['root']}", *band, f"w={args.get('w', '0.5')}",
        f"seq={args.get('seq', '65536')}", f"batch={args.get('batch', '8')}", "device=cpu",
        f"model.frames={args.get('frames', '128')}", f"tmpdir={out / 'port_tmp'}"])


def main(argv: Optional[List[str]] = None) -> Dict:
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    out = pathlib.Path(args.get("out", "outputs/inpainting_cross_score"))
    out.mkdir(parents=True, exist_ok=True)
    is_jax = pathlib.Path(args["ckpt"]).is_dir()
    ckpt = (jax_checkpoint(args["ckpt"], args.get("step"), out) if is_jax
            else args["ckpt"])
    if "export" in args:
        if not is_jax:
            raise SystemExit("export= converts a JAX checkpoints directory")
        step = export_port_ckpt(ckpt, int(args.get("frames", "128")),
                                pathlib.Path(args["export"]))
        summary = {"ckpt": args["ckpt"], "global_step": step, "export": args["export"]}
        print(json.dumps(summary))
        return summary
    scorers = ["jax"] if is_jax else args.get("scorers", "jax,port").split(",")
    payloads = {}
    if "jax" in scorers:
        payloads["jax"], step = jax_tool_scores(args, ckpt, out)
    if not is_jax:
        from diffroll_tpu_torch.compat import peek_global_step

        step = peek_global_step(ckpt)
    if "port" in scorers:
        payloads["port"] = port_scores(args, out)
    inside = {cond: {pkg: {k: p["results"][cond]["inside_mask"][k]
                           for k in ("note_f1", "frame_f1")} for pkg, p in payloads.items()}
              for cond in next(iter(payloads.values()))["results"]}
    summary = {"ckpt": args["ckpt"], "global_step": step, "inside_band": inside, **payloads}
    (out / "cross_score.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
