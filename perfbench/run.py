"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It measures `evflow_tpu_torch` on the card and
nowhere else: without CUDA, or with fewer cards than the cell asks for, it
exits with an error and prints no result. Caches of the build stay inside
the checkout (`build/`). The last line of standard output is the result's
JSON; the numbers compared with the reference, each beside its limit, are
the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder: no file here may shadow a module
sys.path[0] = str(ROOT)


def _process_start_offset() -> float:
    """Seconds this process has run before now, from /proc where there is
    one (the interpreter's own start included), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_start_offset()

for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)


def card_line(chips: int) -> str:
    import torch
    names = {torch.cuda.get_device_name(i) for i in range(chips)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi not available"
    return (f"card: {', '.join(sorted(names))}; {torch.cuda.device_count()} visible, "
            f"{chips} used; power limit (nvidia-smi): {smi}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 3
    print(card_line(cell.chips), file=sys.stderr, flush=True)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start=T_START,
                              out_dir=ROOT / "perfbench_out")
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {found}; the benchmark may load neither "
              "JAX nor the JAX package", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
