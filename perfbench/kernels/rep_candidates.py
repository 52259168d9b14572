"""Bytes and operations of one launch of `csrc/rep_candidates.cu`: the
representative candidates of all q sub-slices of one slice, one row of
nsub = slicing.n_events // q lanes per sub-slice into m_sub =
max(max_candidates // q, 64) slots. Per row: x, y and valid read (9 bytes a
lane), cx, cy and cvalid written (9 bytes a slot), and its n_dropped (4
bytes). No operations are counted: the hash table's probes depend on the
data. One launch a slice, so launch i of the stretch pairs with slice i."""

TRACE_NAME = "rep_candidates_kernel"


def work(counts: dict, config: dict):
    e = config["efast"]
    q = e["micro_slices"]
    nsub = config["slicing"]["n_events"] // q
    m_sub = max(e["max_candidates"] // q, 64)
    return q * (9 * nsub + 9 * m_sub + 4), 0, 0
