"""The readings that a cell's limits are set from, many seeds in one process.

    python3 -m bench_port.control --workload <name> --seeds <n> [<n> ...] --seconds <s>

For each seed: one run of the cell with a window of `--seconds` (at the
cell's own load and sizes), then its check, and beside the program's
readings the two controls' (the reference in the program's place, in fp8,
and in bf16 with the heads, skip sums and sampler state in bf16 too) and,
for a training cell, the half-batch fault's. Prints one JSON line a seed.
The benchmark's own runs do not run this. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench.cache_bytecode()
    import torch

    if not torch.cuda.is_available():
        print("bench_port.control: needs a CUDA card", file=sys.stderr)
        return 1
    spec = bench.load_json(bench.ROOT / "BENCHMARK.json")
    print(f"bench_port.control: {args.workload} on {bench.card_line()}", file=sys.stderr)
    for seed in args.seeds:
        run = bench.Run(spec, args.workload, seed, torch.device("cuda"))
        out = bench.execute(run, args.seconds, False, control=True)
        print(json.dumps(bench.finite({"seed": seed, "correct": out["correct"],
                                       "checks": out["checks"],
                                       "readings": out["readings"],
                                       "metrics": out["metrics"]})),
              flush=True)
        del run, out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
