"""One checkpoint of the port scored through both packages' inpainting paths
on the CPU: the JAX package's `tools/eval_inpainting.py` (its loader, draws,
sampler and scoring, run as it is, with the checkpoint's window passed to
its loader as a `model.frames` override, which the tool's own keys cannot
give) and the port's `quality.eval_inpainting device=cpu`. The same F1 inside
the band from both says that a gap between the packages' inpainting scores
comes from what their trainings learned, not from the sampling or scoring
path; a gap here puts it in that path.

    JAX_PLATFORMS=cpu python tests/inpainting_cross_score.py ckpt=<port .ckpt> \
        root=<MAPS tree> [mask=48,80 | fmask=29,51] [w=0.5] [seq=65536] \
        [frames=128] [batch=8] [out=<dir>]

The last stdout line is JSON: each package's payload and the inside-band
note / frame F1 of each condition side by side; `<out>/cross_score.json`
holds the same.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import pathlib
import sys
from typing import Dict, List, Optional

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_tool_scores(args: Dict[str, str], out: pathlib.Path) -> Dict:
    """`tools/eval_inpainting.py` on `args`, its checkpoint loaded at
    `model.frames=<frames>`; returns the payload it writes."""
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
    tool.ARGS.update(ckpt=args["ckpt"], root=args["root"], w=args.get("w", "0.5"),
                     seq=args.get("seq", "65536"), batch=args.get("batch", "8"),
                     tmpdir=str(out / "jax_tmp"), out=str(out / "jax.json"), **band)
    load = _common.load_pretrained
    _common.load_pretrained = functools.partial(
        load, overrides={"model.frames": int(args.get("frames", "128"))})
    try:
        tool.main()
    finally:
        _common.load_pretrained = load
    return json.loads((out / "jax.json").read_text())


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
    payloads = {"jax": jax_tool_scores(args, out), "port": port_scores(args, out)}
    inside = {cond: {pkg: {k: payloads[pkg]["results"][cond]["inside_mask"][k]
                           for k in ("note_f1", "frame_f1")} for pkg in payloads}
              for cond in payloads["port"]["results"]}
    summary = {"ckpt": args["ckpt"], "inside_band": inside, **payloads}
    (out / "cross_score.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
