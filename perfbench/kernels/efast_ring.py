"""Bytes and operations of one launch of `csrc/efast_ring.cu`: the ring test
of one q=8 sub-slice's candidate lanes, max(max_candidates // micro_slices,
64) of them (the cap binds in every cell that runs it, and the kernel runs
every lane of its grid). Per lane x, y and valid read, 36 int32 ring samples
gathered, the mask written: 154 bytes. No operations are counted: the scan
stops on data the reference gives no count of. The roofline pairs launch i
of the stretch with slice i, so this is one launch's work, not a slice's
(eight launches)."""

TRACE_NAME = "efast_ring_kernel"

BYTES_PER_LANE = 4 + 4 + 1 + 36 * 4 + 1


def work(counts: dict, config: dict):
    e = config["efast"]
    lanes = max(e["max_candidates"] // e["micro_slices"], 64)
    return BYTES_PER_LANE * lanes, 0, 0
