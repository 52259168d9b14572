"""Bytes and operations of `csrc/assign_manhattan.cu` on one slice: x, y
read and label and distance written for every event, the means and alive
flags read once; each event's L1 distance to every cluster alive at the
slice's start, 6 fp32 operations each (sub, abs, sub, abs, add, compare)."""

TRACE_NAME = "assign_manhattan_kernel"


def work(counts: dict, config: dict):
    n, c = counts["n_events"], config["cluster"]["max_clusters"]
    return 16 * n + 9 * c, 6 * n * counts["alive_at_start"], 0
