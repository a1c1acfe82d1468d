"""Sweeps for the paper's tables (counterpart of `diffroll_tpu/cli/sweep.py`).

Two modes:

  * eval-side (default): the full test-split eval at each point of a
    w x frame-threshold grid over one checkpoint -> `sweep.json` (+ figure);
  * training-side (`p_grid=`): one `train` run per spec_dropout value, each
    evaluated on the test split after `fit` -> `p_sweep.json` (+ figure).
Both run over the data axis under torchrun; rank 0 alone writes.

    python -m diffroll_tpu_torch sweep pretrained_path=<file.ckpt> dataset.root=... \
        w_grid=[0,0.1,0.5,1,1.5,4] threshold_grid=[0.5]
    python -m diffroll_tpu_torch sweep spec_roll p_grid=[0,0.1,0.3,0.5] \
        dataset.root=... trainer.max_epochs=20

The figures need matplotlib; without it stderr says so and the JSON tables
stand alone.
"""

from __future__ import annotations

import json
import pathlib
import sys
from typing import List, Optional

from ..config import from_argv
from . import _common
from .test import run_test


def _grid(tok: str) -> List[float]:
    return [float(v) for v in tok.split("=", 1)[1].strip("[]").split(",")]


def _save_figure(path: pathlib.Path, xlabel: str, ylabel: str, series) -> None:
    """One line per (label, xs, ys, marker); where matplotlib is not
    installed, one stderr line instead (the JSON table has already landed)."""
    try:
        import matplotlib
    except ImportError:
        print(f"{path.name} skipped: matplotlib is not installed", file=sys.stderr)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3))
    for label, xs, ys, marker in series:
        ax.plot(xs, ys, marker=marker, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def run_p_sweep(p_grid: List[float], rest: List[str]):
    """The paper's main experiment: one trained model per spec_dropout p,
    each evaluated on the test split, collected into the note / frame F1 vs
    p table. Each point is a whole `train` run."""
    from . import train as train_cli

    out_tok = [t for t in rest if t.startswith("trainer.output_dir=")]
    base = pathlib.Path(out_tok[-1].split("=", 1)[1]) if out_tok else pathlib.Path("outputs")
    sweep_dir = base / "p_sweep"
    rest = [t for t in rest if not t.startswith("trainer.output_dir=")]
    # the data axis every point's `train` joins (rank 0 alone writes and reads)
    main_rank = _common.is_main(_common.setup_mesh(from_argv(rest, "spec_roll")[0])[0])

    rows = []
    for p in p_grid:
        out = sweep_dir / f"p{p:g}"
        print(f"=== p-sweep point spec_dropout={p:g} -> {out}", file=sys.stderr)
        train_cli.main([*rest, f"model.spec_dropout={p}", f"trainer.output_dir={out}"])
        if not main_rank:
            continue
        metric_files = sorted(out.rglob("test_metrics.json"))
        if not metric_files:
            raise FileNotFoundError(f"training at p={p} produced no test_metrics.json "
                                    f"under {out} (no test split?)")
        rows.append({"spec_dropout": p, **json.loads(metric_files[-1].read_text())})
        print(json.dumps(rows[-1]), file=sys.stderr)
    if not main_rank:
        return rows

    (sweep_dir / "p_sweep.json").write_text(json.dumps(rows, indent=2))
    ps = [r["spec_dropout"] for r in rows]
    _save_figure(sweep_dir / "p_sweep.png", "spec dropout p", "F1 (%)",
                 [(k.replace("_", " "), ps, [100 * r[k] for r in rows], m)
                  for k, m in (("note_f1", "o"), ("frame_f1", "s"))])
    print(json.dumps({"run_dir": str(sweep_dir), "points": len(rows)}))
    return rows


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else argv
    w_grid = [0.0, 0.1, 0.5, 1.0, 1.5, 4.0]
    thr_grid = [0.5]
    p_grid: Optional[List[float]] = None
    rest = []
    for tok in argv:
        if tok.startswith("w_grid="):
            w_grid = _grid(tok)
        elif tok.startswith("threshold_grid="):
            thr_grid = _grid(tok)
        elif tok.startswith("p_grid="):
            p_grid = _grid(tok)
        else:
            rest.append(tok)

    if p_grid is not None:
        return run_p_sweep(p_grid, rest)

    cfg, _, overrides = from_argv(rest, "test")
    mesh, device = _common.setup_mesh(cfg)
    cfg, model, task, _ = _common.load_pretrained(cfg, overrides=overrides, device=device,
                                                  mesh=mesh)
    main_rank = _common.is_main(mesh)
    run_dir = _common.make_run_dir(cfg, "sweep") if main_rank else None

    rows = []
    for w in w_grid:
        # one sampling pass per w; every threshold is scored from its rolls
        c = cfg.replace(task=cfg.task.replace(w=w))
        # the baseline's one-shot walk has no guidance: its task stays as it is
        t = task if c.task_type == "baseline" else type(task)(model, c.task, mesh=mesh)
        by_thr = run_test(c, model, t, thresholds=thr_grid)
        for thr in thr_grid:
            rows.append({"w": w, "frame_threshold": thr, **by_thr[thr]})
            if main_rank:
                print(json.dumps(rows[-1]), file=sys.stderr)
    if not main_rank:
        return rows

    (run_dir / "sweep.json").write_text(json.dumps(rows, indent=2))
    _save_figure(run_dir / "sweep.png", "guidance w", "note F1 (%)",
                 [(f"thr={thr}", [r["w"] for r in rows if r["frame_threshold"] == thr],
                   [100 * r["note_f1"] for r in rows if r["frame_threshold"] == thr], "o")
                  for thr in thr_grid])
    print(json.dumps({"run_dir": str(run_dir), "points": len(rows)}))
    return rows


if __name__ == "__main__":
    main()
