"""The faults a one-card cell can have, planted in the timed path underneath
a whole run, to see `correct` come out false: a step that returns its state
unchanged; half of each slice's events left out; an answer altered where it
is produced (a count, a coordinate). There is no exchange between cards.

    python3 perfbench/faults.py --workload <name> --seeds 1,2,3 --seconds 3

runs each fault on each seed at the cell's own size on the card and prints
one JSON line per run: the fault, the seed, `correct` and the numbers
compared. Not part of a benchmark run; `tests/test_bench_faults.py` plants
the same faults at a CPU size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

KINDS = ("state_unchanged", "half_batch", "count_altered", "coordinate_altered")
# per path: the program's entry point, its state arguments, the index of the
# valid mask among its arguments
ENTRIES = {"full_scan": ("full_scan", 2, 5),
           "cluster_flow_scan_exact": ("cluster_flow_scan_exact", 1, 4)}


def _altered(outs, entry, kind):
    """One answer changed where the step produces it: on the track path a
    corner count or a track's position (the cluster chain is compared as
    multisets, with room for f32 order), on the exact path a member count
    or a centroid."""
    if entry == "full_scan":
        cl, co = outs
        if kind == "count_altered":
            v = co.num_corners.clone()
            v[0] += 1
            return cl, co._replace(num_corners=v)
        v = co.track_pos.clone()
        v[0, 0, 0] += 2.0
        return cl, co._replace(track_pos=v)
    if kind == "count_altered":
        v = outs.n.clone()
        v[0, 0] += 1
        return outs._replace(n=v)
    v = outs.centroid.clone()
    v[0, 0, 0] += 2.0
    return outs._replace(centroid=v)


def broken(kind: str, path: str, orig):
    """`orig`, the program's entry point of `path`, with the fault `kind`."""
    entry, n_state, valid_at = ENTRIES[path]

    def step(*args):
        args = list(args)
        if kind == "half_batch":
            v = args[valid_at].clone()
            v[:, v.shape[1] // 2:] = False
            args[valid_at] = v
        state, outs = orig(*args)
        if kind == "state_unchanged":
            state = tuple(args[:n_state]) if n_state > 1 else args[0]
        if kind in ("count_altered", "coordinate_altered"):
            outs = _altered(outs, entry, kind)
        return state, outs
    return step


def plant(kind: str, path: str):
    """Put the fault into the program's pipeline module; returns a function
    that takes it out again."""
    from evflow_tpu_torch.models import pipeline
    entry = ENTRIES[path][0]
    orig = getattr(pipeline, entry)
    setattr(pipeline, entry, broken(kind, path, orig))
    return lambda: setattr(pipeline, entry, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for kind in KINDS:
        for seed in (int(s) for s in args.seeds.split(",")):
            unplant = plant(kind, cell.config["path"])
            try:
                r = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0))
            finally:
                unplant()
            print(json.dumps({"workload": cell.name, "fault": kind, "seed": seed,
                              "correct": r["correct"],
                              "checks": {k: v["value"] for k, v in r["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
