"""Bytes and operations of `csrc/cluster_stats.cu` on one slice: label, x, y
read for every event and the (C, 5) rows written; 20 fp32 operations per
event (rank, weight, five sums)."""

TRACE_NAME = "cluster_stats_kernel"


def work(counts: dict, config: dict):
    n, c = counts["n_events"], config["cluster"]["max_clusters"]
    return 12 * n + 20 * c, 20 * n, 0
