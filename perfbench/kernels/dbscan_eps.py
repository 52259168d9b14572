"""Bytes and operations of one launch of `csrc/dbscan_eps.cu`: every
(row, point) pair of one slice's n = slicing.n_events lanes tested, in
either mode (the core counts, a propagation round's lowest core label, the
border attachment). Each test is 7 fp32 operations (mul, mul, add for the
cross term, the squared norms' add, the x2, the sub, the compare); the
bytes are the rows' x, y read and one int32 written, and the points' x, y
and flag or label read: 12 per row and 12 per point. Every launch tests
every pair, so launch i of the stretch pairs with slice i and its work is
one launch's, not a slice's (7-8 launches)."""

TRACE_NAME = "dbscan_eps_kernel"

OPS_PER_PAIR = 7


def work(counts: dict, config: dict):
    n = config["slicing"]["n_events"]
    return 12 * n + 12 * n, OPS_PER_PAIR * n * n, 0
