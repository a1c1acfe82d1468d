"""Nothing the runner loads is JAX or the JAX package, compared by whole
top-level names; the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from bench_port import run as bench

from .conftest import HERE

LOAD_ALL = """
import json, sys
from bench_port import run as bench, control, trace, counts, inputs, weights, port
from bench_port.reference import diffroll
spec = bench.load_json(bench.ROOT / 'BENCHMARK.json')
for f in sorted((bench.HERE / 'runners').glob('*.py')):
    bench.load_module(f, 'bench_port.runners.' + f.stem)
for f in sorted((bench.HERE / 'metrics').glob('*.py')):
    bench.load_module(f, 'bench_port.metrics.' + f.stem)
import diffroll_tpu_torch.tasks.transcribe, diffroll_tpu_torch.eval.notes
import diffroll_tpu_torch.train.step, diffroll_tpu_torch.train.state
import diffroll_tpu_torch.ops.sampler_kernel, diffroll_tpu_torch.ops.gated_stack_train
print(json.dumps(bench.forbidden_modules()))
"""


def test_forbidden_names_compare_whole_top_level_names():
    got = bench.forbidden_modules(["diffroll_tpu_torch", "diffroll_tpu_torch.ops",
                                   "diffroll_tpu", "diffroll_tpu.nn", "jax", "jax.numpy",
                                   "jaxlib", "jaxtyping", "flax", "flaxen", "numpy"])
    assert got == ["diffroll_tpu", "diffroll_tpu.nn", "flax", "jax", "jax.numpy", "jaxlib"]


def test_runner_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL], cwd=bench.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names if n}
        assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, (path, tops)


def test_no_card_prints_no_result_and_fails(capsys):
    import torch

    if torch.cuda.is_available():
        return
    rc = bench.main(["--workload", "cfdr-transcribe", "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
