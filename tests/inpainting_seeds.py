"""Inside-band inpainting over training seeds: the p-sweep's p=0.1 recipe
trained once per seed through the port, and checkpoints scored through one
scorer, each score beside the training step whose weights it read.

    python tests/inpainting_seeds.py train seeds=0,1,2,3,4,5 [tree=outputs/psweep_tree] \\
        [out=outputs/inpainting_seeds] [device=cuda|cpu] [init=<dir>] [key.sub=value ...]
    python tests/inpainting_seeds.py score <file.ckpt | directory> ... \\
        [tree=outputs/psweep_tree] [out=outputs/inpainting_seeds] [device=cuda|cpu]
    python tests/inpainting_seeds.py tally <score's or cross_score's .json> ...

`train` writes the recipe's tree where `tree=` has none, then runs
`paper_sweeps`' p-sweep stage (`sweep spec_roll p_grid=[0.1]`: 128 x 8,
T=100, 2016 steps, validated at steps 504, 1008, 1512 and 2016, K3 + K4 on
the card) once per seed with `trainer.seed=<seed>`. Of each run it keeps two
weights-only checkpoints under `<out>/ckpts/`:
`port_<device>_s<seed>_last.ckpt` (the final step) and `..._best.ckpt`
(`paper_sweeps.stage_checkpoint`: the newest monitored checkpoint, the one
the JAX scripts and `paper_sweeps` score), and it writes each run's post-fit
test scores to `<out>/train.json`. With `init=<dir>` each run starts from
`<dir>/init_s<seed>.ckpt` (`tests/train_lockstep.py init` writes the JAX
package's initial weights of a seed so) instead of the port's own draw.

`score` runs `quality.eval_inpainting` at w=0.5 on every `.ckpt` it is given
(a directory: each `.ckpt` in it, sorted) for both of `paper_sweeps`' bands
(`mask=48,80`, `fmask=29,51`): one entry, one device, one set of draws
(seed 7). `<out>/scores.json` holds one row per checkpoint: its file, the
`global_step` it records, the package, platform, seed and which checkpoint it
is where its name reads `<package>_<platform>_s<seed>_<which>.ckpt`
(`tests/inpainting_cross_score.py export=` writes a JAX checkpoint so), and
each condition's note and frame F1 inside and outside each band. The last
stdout line is JSON: the inside-band inpainting note F1 of each group of
rows (scorer, package, platform, which) with its mean and standard
deviation, and the difference of its mean and Welch's t against the JAX
package's group of the same scorer and checkpoint, or, inside mask 48-80
where the rows hold none, against the JAX package's twelve seeds on record
(`JAX_ON_RECORD`). `tally` prints the same groups over
`score`'s `scores.json` files and `tests/inpainting_cross_score.py`'s
`cross_score.json` files (the JAX tool's scores, named for the checkpoint
file, or for a JAX checkpoints directory for the directory the summary is
in).

The script imports only the port and runs on the card unless `device=cpu`.
"""

from __future__ import annotations

import itertools
import json
import math
import pathlib
import re
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
# The JAX package's p=0.1 twins, seeds 0-11 (trained on the CPU in f32, read at
# step 2016): the mean, sd and count of their inpainting note F1 inside mask
# 48-80 by each scorer (PERF.md section 6). `tally` and `score` hold a group
# against them where the rows hold no JAX group of that scorer.
JAX_ON_RECORD = {"eval_inpainting/cuda": (0.0953, 0.0203, 12),
                 "jax_tool/cpu": (0.0969, 0.0163, 12)}
NAME = re.compile(r"(?P<package>[a-z]+)_(?P<platform>[a-z]+)_s(?P<seed>\d+)_(?P<which>[a-z]+)$")


def slim_copy(src: pathlib.Path, dst: pathlib.Path) -> None:
    """`src` without its optimizer state: the weights, the config record and
    the step, all the scorers read."""
    from diffroll_tpu_torch.compat import read_ckpt

    ckpt = read_ckpt(str(src))
    torch.save({k: ckpt[k] for k in ("state_dict", "hyper_parameters", "global_step")}, dst)


def train(seeds: List[int], tree: pathlib.Path, out: pathlib.Path, device: str,
          extra: List[str], init: Optional[pathlib.Path] = None) -> List[Dict]:
    from diffroll_tpu_torch.cli import sweep as sweep_cli
    from diffroll_tpu_torch.quality import paper_sweeps

    paper_sweeps.ensure_tree(tree)
    (out / "ckpts").mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in seeds:
        run = out / f"s{seed}"
        start = [] if init is None else [f"pretrained_path={init / f'init_s{seed}.ckpt'}"]
        p_row, = sweep_cli.main(paper_sweeps.p_sweep_argv(
            tree, run, "[0.1]", f"device={device}", [*extra, f"trainer.seed={seed}", *start]))
        best = paper_sweeps.stage_checkpoint(run)
        for which, src in (("last", best.parent / "last.ckpt"), ("best", best)):
            slim_copy(src, out / "ckpts" / f"port_{device}_s{seed}_{which}.ckpt")
        rows.append({"seed": seed, "best": best.name, **p_row})
        (out / "train.json").write_text(json.dumps(rows, indent=2))
    return rows


def named(row: Dict, name: str) -> Dict:
    """`row` with the package, platform, seed and which checkpoint `name`
    (`<package>_<platform>_s<seed>_<which>`) gives, where it reads so."""
    m = NAME.match(name)
    if m:
        row.update(m.groupdict(), seed=int(m["seed"]))
    return row


def band_f1(results: Dict) -> Dict:
    """Each condition's note and frame F1 inside and outside a band."""
    return {cond: {side: {k: r[f"{side}_mask"][k] for k in ("note_f1", "frame_f1")}
                   for side in ("inside", "outside")}
            for cond, r in results.items()}


def cross_score_row(path: pathlib.Path) -> Dict:
    """A row of `tests/inpainting_cross_score.py`'s summary at `path`: the JAX
    tool's scores, named for the checkpoint file or, for a JAX checkpoints
    directory, for the directory the summary was written to."""
    summary = json.loads(path.read_text())
    jax = summary["jax"]
    band = (f"mask={','.join(map(str, jax['mask_frames']))}" if "mask_frames" in jax
            else f"fmask={','.join(map(str, jax['mask_mel_bins']))}")
    ckpt = pathlib.Path(summary["ckpt"])
    return named({"ckpt": str(ckpt), "global_step": summary["global_step"],
                  "scorer": "jax_tool/cpu", band: band_f1(jax["results"])},
                 ckpt.stem if ckpt.suffix == ".ckpt" else path.parent.name)


def score_one(path: pathlib.Path, tree: pathlib.Path, out: pathlib.Path, device: str) -> Dict:
    from diffroll_tpu_torch.compat import peek_global_step
    from diffroll_tpu_torch.quality import eval_inpainting, paper_sweeps

    row = named({"ckpt": str(path), "global_step": peek_global_step(str(path)),
                 "scorer": f"eval_inpainting/{device}"}, path.stem)
    for band, spec in paper_sweeps.BANDS:
        payload = eval_inpainting.main([
            f"ckpt={path}", f"root={tree}", f"{band}={spec}", "w=0.5", "seq=65536",
            f"tmpdir={out / 'tmp'}", f"device={device}"])
        row[f"{band}={spec}"] = band_f1(payload["results"])
    return row


def welch_t(a: Tuple[float, float, int], b: Tuple[float, float, int]) -> Optional[float]:
    """Welch's t of the means of two groups, each given as (mean, sd, n) (None
    below two values a side)."""
    (mean_a, sd_a, n_a), (mean_b, sd_b, n_b) = a, b
    if n_a < 2 or n_b < 2:
        return None
    se = math.sqrt(sd_a ** 2 / n_a + sd_b ** 2 / n_b)
    return float((mean_a - mean_b) / se) if se > 0 else None


def band_means(rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """The mean note F1 of `rows`, for each band they were all scored at, of
    inpainting inside and outside the band and of transcription inside it."""
    out = {}
    for band in sorted({k for r in rows for k in r if "=" in k}):
        if all(band in r for r in rows):
            out[band] = {f"{cond}_{side}": float(np.mean([r[band][cond][side]["note_f1"]
                                                          for r in rows]))
                         for cond, side in (("inpainting", "inside"),
                                            ("inpainting", "outside"),
                                            ("transcription", "inside"))}
    return out


def groups(rows: List[Dict], band: str = "mask=48,80") -> Dict[str, Dict]:
    """The inside-band inpainting note F1 of each (scorer, package, platform,
    which), its mean, sd, and Welch's t against the JAX package's rows of the
    same scorer and `which`."""
    def key(r):
        return (r["scorer"], r.get("package", "?"), r.get("platform", "?"), r.get("which", "?"))

    out = {}
    for k, rs in itertools.groupby(sorted(rows, key=key), key=key):
        rs = list(rs)
        vals = [r[band]["inpainting"]["inside"]["note_f1"] for r in rs]
        out["/".join(k)] = {"seeds": [r.get("seed") for r in rs],
                            "steps": [r["global_step"] for r in rs], "note_f1": vals,
                            "mean": float(np.mean(vals)),
                            "sd": float(np.std(vals, ddof=1)) if len(vals) > 1 else None,
                            "band_means": band_means(rs)}
    for name, g in out.items():
        scorer, package, _, which = name.rsplit("/", 3)
        ref = next((n for n in out if n.startswith(f"{scorer}/jax/") and n.endswith("/" + which)),
                   None)
        if package == "jax":
            continue
        if ref is not None:
            g["vs"], vs = ref, (out[ref]["mean"], out[ref]["sd"], len(out[ref]["note_f1"]))
        elif band == "mask=48,80" and scorer in JAX_ON_RECORD:
            g["vs"], vs = f"{scorer}/jax on record", JAX_ON_RECORD[scorer]
        else:
            continue
        g["d"] = g["mean"] - vs[0]
        g["welch_t"] = welch_t((g["mean"], g["sd"], len(g["note_f1"])), vs)
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    positional = [a for a in argv if "=" not in a]
    if not positional or positional[0] not in ("train", "score", "tally"):
        raise SystemExit(__doc__)
    if positional[0] == "tally":
        rows = []
        for p in map(pathlib.Path, positional[1:]):
            scores = json.loads(p.read_text())
            if "rows" not in scores:
                rows.append(cross_score_row(p))
                continue
            device = "cpu" if scores["device"] == "cpu" else "cuda"
            rows += [{"scorer": f"eval_inpainting/{device}", **r} for r in scores["rows"]]
        summary = {"groups": groups(rows)}
        print(json.dumps(summary))
        return summary
    from diffroll_tpu_torch.cli import _common

    device = args.get("device", "cuda")
    _common.device_named(device)
    tree = pathlib.Path(args.get("tree", "outputs/psweep_tree"))
    out = pathlib.Path(args.get("out", "outputs/inpainting_seeds"))
    out.mkdir(parents=True, exist_ok=True)
    card = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    if positional[0] == "train":
        seeds = [int(s) for s in args.get("seeds", "0").split(",")]
        extra = [f"{k}={v}" for k, v in args.items() if "." in k]
        init = pathlib.Path(args["init"]) if "init" in args else None
        summary = {"device": card, "runs": train(seeds, tree, out, device, extra, init)}
    else:
        paths = []
        for p in map(pathlib.Path, positional[1:]):
            paths += sorted(p.glob("*.ckpt")) if p.is_dir() else [p]
        rows = [score_one(p, tree, out, device) for p in paths]
        (out / "scores.json").write_text(json.dumps({"device": card, "rows": rows}, indent=2))
        summary = {"device": card, "groups": groups(rows)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
