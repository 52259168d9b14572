"""Shared pieces of the benchmark's own tests: the checkout's root on the
import path, and each cell cut to a size the CPU runs in seconds (a smaller
slice and sensor, smaller capacities, a short recording), for tests that
drive a whole run without a card."""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import spec  # noqa: E402

# coordinates above 256 px, where bfloat16 no longer holds a pixel exactly
SMALL_SCENES = {
    "blobs": {"centers": [[300.0, 200.0], [500.0, 300.0], [420.0, 120.0]],
              "velocities": [[3.0, 1.0], [-2.0, 1.5], [1.0, -1.2]], "sigma": 4.0},
    "textured": {"num_objects": 8, "noise_frac": 0.5},
}


def small_cell(name: str, traffic: str = None) -> spec.Cell:
    """The cell `name` at a CPU size; everything else as committed. With
    `traffic`, its configuration under that traffic mix of `traffic/`,
    reporting the metrics of the first cell whose mix has the same loop."""
    cell = copy.deepcopy(spec.load_cell(name))
    if traffic is not None:
        cell.traffic_name = traffic
        cell.traffic = spec.read_json(spec.HERE / "traffic" / f"{traffic}.json")
        bench = spec.read_json(ROOT / "BENCHMARK.json")
        donor = next(spec.load_cell(w["name"]) for w in bench["workloads"]
                     if spec.read_json(spec.HERE / "traffic" / f"{w['traffic']}.json")["loop"]
                     == cell.traffic["loop"])
        cell.end_to_end, cell.per_layer = donor.end_to_end, donor.per_layer
    cfg, tr = cell.config, cell.traffic
    cfg["sensor"] = {"width": 640, "height": 400}
    cfg["slicing"]["n_events"] = 2048
    cfg["dedup"]["num_buckets"] = 1024
    cfg["cluster"]["max_clusters"] = 32
    if "max_members" in cfg["cluster"]:
        cfg["cluster"]["max_members"] = 256
        cfg["cluster"]["sz_buffer"] = 200
    if "efast" in cfg:
        cfg["efast"]["max_candidates"] = 1024
        cfg["nms"]["max_corners"] = 64
        cfg["tracker"]["max_tracks"] = 32
    tr["slices"] = 16
    if tr["loop"] == "replay":
        tr["slices_per_call"] = 4
    else:
        tr["rate_events_per_s"] = 2048 / 0.02
    tr["scene_params"] = copy.deepcopy(SMALL_SCENES[tr["scene"]])
    cell.check = {"first": 6, "slices": 4, "chunks": 2}
    return cell
