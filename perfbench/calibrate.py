"""Readings for the limits of `correct`: one cell's comparison numbers on
many seeds, for the program or for the control (the reference in the
program's place, computed in the precision below the configuration's), in
one process so that set-up is paid once.

    python3 perfbench/calibrate.py --workload <name> --system program|control \\
        --seeds 1,2,3 --seconds 3

Prints one JSON line per seed: the seed, `correct` and the numbers. Not
part of a benchmark run; `PERF.md` lists the readings each limit was set from.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", choices=("program", "control"), default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                             system=args.system)
        print(json.dumps({"workload": cell.name, "system": args.system, "seed": seed,
                          "correct": r["correct"], "metrics": r["metrics"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
