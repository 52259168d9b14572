"""Bytes and operations of `csrc/aeclustering_exact.cu` on one slice: the
valid lanes as 16-byte rows, the member ring (2 rows in, 3 out) and the
cluster state; each valid event tested against every cluster alive before
it, 6 fp32 operations (sub, abs, sub, abs, add, radius compare) and 2 int32
(alive, count > 0) per test."""

TRACE_NAME = "aeclustering_exact_kernel"


def work(counts: dict, config: dict):
    cl = config["cluster"]
    tests = counts["exact_tests"]
    return (16 * counts["exact_lanes"] + 20 * cl["max_members"] + 48 * cl["max_clusters"],
            6 * tests, 2 * tests)
