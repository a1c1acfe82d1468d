"""Run logging: a JSONL metrics stream, the config record and figures
(counterpart of `diffroll_tpu/utils/logging.py`). Every scalar goes to
`<run_dir>/metrics.jsonl`, every figure to a PNG under `<run_dir>/figures/`.
The JAX package also writes TensorBoard event files when
`torch.utils.tensorboard` imports; that needs the `tensorboard` package,
which the port does not require, so the port writes no event files."""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Dict


class MetricLogger:
    def __init__(self, run_dir: str | pathlib.Path):
        self.run_dir = pathlib.Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a", buffering=1)

    def log_scalars(self, step: int, scalars: Dict[str, Any]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")

    def log_config(self, config: Dict[str, Any]):
        path = self.run_dir / "config.json"
        path.write_text(json.dumps({k: str(v) for k, v in config.items()}, indent=2))

    def log_figure(self, step: int, tag: str, fig):
        """Save a matplotlib figure as `figures/<tag>_<step>.png` (the
        reference's validation grids)."""
        figs = self.run_dir / "figures"
        figs.mkdir(exist_ok=True)
        fig.savefig(figs / f"{tag.replace('/', '_')}_{step:08d}.png", dpi=100)

    def close(self):
        self._jsonl.close()
