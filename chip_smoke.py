#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (evflow_tpu_torch) on one NVIDIA GPU.

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the nvcc build of the
     kernels in evflow_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and on real inputs (a few slices into the stream below):
     the eFAST stencil, the eFAST ring test (the q=8 path's first
     sub-slice of 2048 events, 1024 candidate lanes), the two fastcluster
     kernels (cluster_stats also bit-equal to itself over two calls), and
     the exact AEClustering engine (2 DEFAULT slices from the same state,
     every AEState field equal);
  3. the port's main path, pipeline.full_scan at the DEFAULT configuration
     (1280x720 SAE, 16384 events per slice, 128 clusters, 8192 eFAST
     candidates, NMS capacity 512, 256 tracks, q=1) over a 32-slice
     three-blob moving stream: every kernel of the path must be launched in
     that run, corners must appear from slice 1 on and clusters be reported,
     and for 4 slices the card's step is held against a plain step on the
     CPU from the same input state;
  4. the exact path, cluster_flow_scan_exact at DEFAULT (hash dedup to 8192
     lanes, M=1024, C=128, sz_buffer 800) over the same 32 slices: the exact
     kernel launched once per slice, clusters reported, slices 1-2 held
     against a plain CPU step;
  5. full_scan at q=8 (the bench.py headline's micro slices) over the same
     slices: launches, corners from slice 1 on, slices 1-4 against a plain
     CPU step;
  6. the corner agreement of q=8 and q=1 with per-event-exact detection
     (bench.py's measure_agreement, on the card) beside the JAX package's;
  7. ms/slice of full_scan at q=1 and q=8 with the kernels and with their
     plain versions, of the exact path with the kernel and with its plain
     version (2 slices), and each kernel's time beside its plain version's:
     `ms`, the wrapper's time per eager call by CUDA events around
     back-to-back calls, host included (the median of 5 rounds of 20
     calls), and `device_ms`, its device time
     per call from a CUDA-graph replay of the wrapper. The plain versions
     are timed as `ms` is, the exact engine's over 2 slices. Beside each
     kernel, its launch floor: the graph-replay device time of an empty
     kernel (csrc/launch_floor.cu) at the kernel's grid. The stencil is
     also timed, and bounded, on the all-ones activity map (every tile);
  8. full_scan at q=8 with the snapshot-stack corner path (micro_stack)
     over the same slices: launches (one `efast_ring` a slice), every
     state and output leaf bit-equal to phase 5's serial q=8 run, slices
     1-4 against a plain CPU step, its corner agreement equal to the JAX
     package's q=8 value; ms/slice of serial and stack in the order
     serial, stack, stack, serial;
 8b. the representative candidates' kernel (`rep_candidates_phase`,
     csrc/rep_candidates.cu) on slice 3, in the q=8 path's 8 rows of 2,048
     lanes into 1,024 slots and the q=1 path's one row of 16,384 into
     8,192, bit-equal to its plain version on the card, with its eager,
     device, launch-floor and plain times beside its bound, and a JSON entry
     in the per-kernel line (`launches`: phase 5's, one a slice; phases 3 and
     8 also launch it once a slice);
  9. k-means (`kmeans_phase`), 10. DBSCAN dense and grid (`dbscan_phase`),
     11. app C's point-cloud chain (`pointcloud_phase`): each against its
     CPU run, with ms per call; 10b. DBSCAN's eps kernel
     (`dbscan_eps_phase`, csrc/dbscan_eps.cu): its launches in
     `pipeline.dbscan_scan` on the DEFAULT slices and on 4 slices of the
     benchmark's textured scene, rounds + 2 per slice; both modes
     (the core counts; a propagation round's lowest core label) bit-equal
     to one pass of the plain panels on the card at D = 3 (app C's cloud)
     and on slice 3's 16384 events, with its eager, device, launch-floor
     and plain times beside its bound, and a JSON entry in the per-kernel
     line (`launches`: those of the two scans);
 12. OPTICS, app B (`optics_phase`, a line per case):
     compute_reachability_dists through method "auto" in four cases: slice 3's unique pixels at the
     reference driver's eps 10, min_pts 2 (then the threshold-10 split),
     and the reference benchmark's uniform clouds of 100,000 points in a
     1000-wide volume at d = 2, 3 and 6 (min_pts 10, eps estimated, K 64).
     Each prints the backends that built its table, K after the auto-raise,
     the widest row, and ms per call (median of 3) split into the table,
     its move to the host and the sweep. Checks: the pixels' table, order,
     reach and clusters equal to the CPU run's, as are the d = 2 and d = 3
     clouds' (their CPU runs take seconds); every 97th row of each cloud
     against a float64 difference-form oracle; the native sweep equal to
     the Python loop on the card's table, and their xi clusters (chi 0.05)
     equal.
 13. the CLI (`cli_phase`): evflow_tpu_torch.run.main at DEFAULT on the card,
     over the phase-3 stream written as a 1280x720 EVT3 file (524,288 events;
     the native decoder reads it back equal to the numpy decoder and to the
     stream, its rate printed), app C's cloud written as a PCD, and slice 3
     as a CSV: cluster-flow, cluster-flow --exact, corner-track,
     track-estimate --decimate 512, async-cluster --decimate 256 and
     sampling on the stream; kmeans --n 2048; dbscan on the cloud (voxel
     0.01, plane removal, eps 0.05, min_pts 10, PCD export); optics on slice
     3 at eps 10. kmeans, dbscan and optics also run sharded, inside a real
     NCCL group of one rank (its collectives counted), and must equal their
     plain runs. Checks: each run's kernel launches, counted from 0 just
     before it (the fastcluster kernels once per slice, the exact kernel
     once per slice and once for async-cluster, the stencil); corners from
     slice 1 on and clusters every slice; corner-track and cluster-flow
     --exact split into two halves with --checkpoint / --resume print the
     unbroken runs' slices; each subcommand's card run equals its CPU run
     on a 4-slice prefix (optics on 1024 events of slice 3), as
     tests/test_torch_cli.py compares them. Prints each run's wall ms and
     sampling's events/s.
 14. the spatio-temporal layer (`temporal_phase`) on the same 32 slices:
     (a) inside a NCCL group of one rank, run_temporal on a 1 x 1 grid
     (warm-up 0) equal to cluster_flow_scan (cluster streams), then the
     CLI's `temporal --windows 1 --tiles 1` and `temporal --exact --windows
     1`, their launches counted; (b) four Gloo ranks spawned on card 0
     (Gloo stages the card's tensors through the host; NCCL will not put
     two ranks on one card), run_temporal on a (2 windows x 2 tiles) grid,
     warm-up 8: every rank's output bit-equal, each window's cluster streams
     equal to update_slice over its slices in tile-major order from a fresh
     state, each slice's num_filtered equal to filter_corners on the
     gathered tile-major candidates (tile_local_nms recorded), and the grid
     over a 12-slice prefix (warm-up 2) equal to its run on the CPU; (c)
     two Gloo ranks, run_temporal_exact over 2 windows, warm-up 4: each
     window bit-equal to the sequential exact run over its slices from a
     fresh state (t0 pinned), and how many post-warm-up slices equal the
     stream-long sequential run's cluster sets printed. Per rank, timed
     after a warm-up run in the rank: ms per slice of the window loop (the
     fusion left out), fusion ms, collective calls and launches per kernel (one
     assign_manhattan and one cluster_stats per slice scanned, warm-up
     included: 24 in (b); 20 exact launches in (c)).
Every phase's line carries the card's name and power limit beside its
times. Then one JSON line of per-kernel results and, last, the status line
{"ok": true, "device": {...}}. A kernel's `launches` is its count over the
path it belongs to (full_scan at q=1, or the exact path). Its `bound_ms` is
the least time the card could take for the function's work on the phase-2
input: the larger of its bytes (each input read once, each output written
once) over the HBM rate and its operations over the peak rate of their
type, both counted from this run's shapes and data (`kernel_bounds`). Its
`launch_floor_ms` is the launch floor above: below it no kernel at that
grid can go, however small its bound. The exact engine is serial, so it
also gets `latency_floor_ms`: its events times the shortest dependent
chain per event. Its `library_ms` is null: no
single PyTorch call computes any of the kernels' functions. The last two
entries are rep_candidates', from phase 8b, and dbscan_eps's, from phase
10b (its `min_label_*` keys: the second mode). cluster_stats' entry also
has `max_abs_err_k_after`, `k_after_ms`, `k_after_plain_ms` and
`k_after_device_ms`: the same against its plain version with a
nonzero k_after (the later tiles' counts of the tiled update). The stencil's
entry also has `all_tiles_ms`, `all_tiles_device_ms`, `all_tiles_bound_ms`
and `all_tiles_launch_floor_ms`, the same on the all-ones map.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It exits nonzero on any failure, and at once when no CUDA device is found.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_SLICES = 32
SEED = 42
EXACT_PLAIN_SLICES = 2

# H100 SXM peaks at 700 W: HBM bytes/s and fp32 ops/s from NVIDIA's data
# sheet; int32 ops/s = 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
SM_CLOCK_HZ = 1.98e9
INT32_OPS_S = 132 * 64 * SM_CLOCK_HZ
# the exact engine's loop-carried chain per event, at its shortest: the
# distance to the target's mean (sub, add; abs folds into its operand), the
# radius compare and the EWMA's FMA, dependent fp32 instructions at 4
# cycles each (Hopper's FP32 pipe latency)
EXACT_CHAIN_CYCLES = 4 * 4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20, warm: int = 3, rounds: int = 5) -> float:
    """Time of fn() per call over `reps` back-to-back calls after `warm`
    warm-up calls, by CUDA events, host included where the calls are
    host-bound: the median of `rounds` such rounds, so one round slowed by
    the host's other work does not decide it."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of fn() per call, without the host's time per call:
    `calls` back-to-back calls are captured in one CUDA graph (after
    warm-up calls on a side stream, as capture requires) and the graph is
    replayed `reps` times between CUDA events. One graph of many calls
    leaves out the graph's own launch, which a graph of one call pays per
    call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def timed(fn, plain) -> dict:
    """A kernel wrapper's and its plain version's times per eager call,
    host included (CUDA events around back-to-back calls), and the
    wrapper's device time per call (CUDA graph replay)."""
    return dict(ms=cuda_ms(fn), plain_ms=cuda_ms(plain), device_ms=device_ms(fn))


# cluster floats: fp order of the weighted sums; tracker floats: order of
# norms and small sums (the CPU parity tests state the same tolerances)
CLUSTER_TOL = dict(rtol=1e-5, atol=1e-3)
TRACK_TOL = dict(rtol=1e-5, atol=1e-4)
# exact engine and exact path: every field bit-equal, mu included (the
# kernel spells out each f32 rounding of its plain version)
EXACT_TOL = dict(rtol=0, atol=0)


def bound(nbytes: float, fp32_ops: float, int32_ops: float, basis: str) -> dict:
    """The larger of the bytes' time and the operations' time; fp32 and
    int32 operations run on separate pipes, each at its own peak, so the
    operations take the longer of the two."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(fp32_ops / FP32_OPS_S, int32_ops / INT32_OPS_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_basis=f"{nbytes:.0f} bytes, {fp32_ops:.0f} fp32 and "
                            f"{int32_ops:.0f} int32 ops: {basis}")


def streak_ops(r: int, lo: int, hi: int) -> tuple:
    """(reject, scan) int32 operations of the streak test on one ring of r
    samples over the lengths [lo, hi] the configuration asks for: the early
    reject (min, compare, count), then the doubling off-arc maximum, the arc
    minima, the shrinking off-arc maxima, and per (start, length) a compare
    and an or."""
    levels = (r - hi).bit_length() - 1
    return 3 * r - 1, r * (levels + 1) + r * (hi - 1) + r * (hi - lo) + 2 * r * (hi - lo + 1)


def alive_per_event(state, lanes, cfg) -> int:
    """The alive clusters each event of a slice is tested against, summed
    over the slice's events: the plain engine's loop (`update_slice`), run
    on the CPU from `state`, reading the alive mask before each event."""
    from evflow_tpu_torch.models import aeclustering as ae
    state, lanes = to_host(state), [a.cpu() for a in lanes]
    x, y, tr, p, *_, tmin, _tbuf, _thead = ae._slice_prep(state, *lanes, cfg)
    evs = torch.stack([x, y, tr, p, tmin], 1)
    vflag = torch.ones((), dtype=torch.bool)
    carry, total = ae._carry0(state), 0
    for i in lanes[4].nonzero().flatten().tolist():
        total += int(carry[0].sum())
        xi, yi, ti, pi, tmini = evs[i].unbind(0)
        carry = ae._event_body(carry, (xi, yi, ti, pi, vflag, tmini), cfg)
    return total


def stencil_bound(new_sae, act, band, cfg) -> dict:
    """bound_ms of the eFAST stencil on the surface and activity map: the
    rings of the active tiles that reach each stage of its test."""
    from evflow_tpu_torch.ops import efast
    h, w = new_sae.shape
    e = cfg.efast
    n_tiles = int(act.sum())
    tiles = act.repeat_interleave(band, 0).repeat_interleave(efast.WTILE, 1)[:h, :w]
    ys, xs = torch.nonzero(tiles & efast._in_border(h, w, e, cfg.sensor, new_sae.device),
                           as_tuple=True)
    dy, dx = efast._ring_offsets(e)
    rings = new_sae[ys[:, None] + torch.tensor(dy, device=ys.device),
                    xs[:, None] + torch.tensor(dx, device=xs.device)]
    r3, r4 = rings[:, :16], rings[:, 16:]

    def above(r, smin):
        return (r > r.amin(1, keepdim=True)).sum(1) >= smin

    scan3 = above(r3, e.streak3_min)
    pass3 = scan3 & efast._streak_any(r3, e.streak3_min, e.streak3_max)
    scan4 = pass3 & above(r4, e.streak4_min)
    rej3, sc3 = streak_ops(16, e.streak3_min, e.streak3_max)
    rej4, sc4 = streak_ops(20, e.streak4_min, e.streak4_max)
    counts = [len(ys), int(scan3.sum()), int(pass3.sum()), int(scan4.sum())]
    stencil_ops = counts[0] * rej3 + counts[1] * sc3 + counts[2] * rej4 + counts[3] * sc4
    stencil_bytes = n_tiles * (band + 8) * (efast.WTILE + 8) * 4 + h * w + act.numel()
    return bound(stencil_bytes, 0, stencil_ops,
                 f"{n_tiles} active tiles' halos read, the mask written; rings tested, "
                 f"scanned, passing circle3, scanned on circle4: {counts}")


def kernel_bounds(new_sae, act, band, cfg, x, alive, ae_state, lanes, n_clusters) -> dict:
    """bound_ms of each kernel on the inputs phase 2 hands it (see the
    module docstring): the stencil's by `stencil_bound`; the assignment
    tests each event against the clusters alive at the slice's start; the
    exact engine tests each valid lane against the clusters alive at that
    event."""
    n, c = x.shape[0], n_clusters
    n_alive = int(alive.sum())
    m = cfg.cluster.max_members
    n_ev = int(lanes[4].sum())
    tests = alive_per_event(ae_state, lanes, cfg.cluster)
    exact = bound(
        16 * n_ev + 20 * m + 48 * c, 6 * tests, 2 * tests,
        f"{n_ev} 16-byte event rows, the ring (2 rows in, 3 out) and cluster "
        f"state; {tests} tests of an event against an alive cluster "
        f"({tests / max(n_ev, 1):.2f} per event), each 6 fp32 ops (sub, abs, sub, "
        f"abs, add, radius compare) and 2 int32 (alive, count > 0)")
    exact["latency_floor_ms"] = n_ev * EXACT_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3
    return {
        "efast_stencil": stencil_bound(new_sae, act, band, cfg),
        "assign_manhattan": bound(
            16 * n + 9 * c, 6 * n * n_alive, 0,
            f"x, y read, label and distance written for {n} events; "
            f"{n} x {n_alive} distances to the alive means, 6 ops each"),
        "cluster_stats": bound(
            12 * n + 20 * c, 20 * n, 0,
            f"label, x, y read for {n} events, (C, 5) written; 20 ops per event"),
        "aeclustering_exact": exact,
    }


def launch_grids(h, w, band, n, lanes) -> dict:
    """(blocks, threads, cluster size) of each kernel's launch at phase 2's
    shapes, as its source's host entry point computes them."""
    from evflow_tpu_torch.ops import efast
    return {
        # efast_stencil.cu: (tile columns, bands, row groups of 2 rows) x 256
        "efast_stencil": (-(-w // efast.WTILE) * -(-h // band) * -(-band // 2), 256, 1),
        # efast_ring.cu: one thread per candidate lane, 64 per CTA
        "efast_ring": (-(-lanes // 64), 64, 1),
        # assign_manhattan.cu: one warp per CTA, 2 events per thread
        "assign_manhattan": (-(-n // 64), 32, 1),
        # cluster_stats.cu: one thread-block cluster of 8 CTAs x 512
        "cluster_stats": (8, 512, 8),
        # aeclustering_exact.cu: one warp
        "aeclustering_exact": (1, 32, 1),
    }


def to_host(tree):
    """A state or output tree of tensors, copied to the CPU."""
    if isinstance(tree, tuple):
        parts = [to_host(t) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree.cpu()


def few_ms(fn) -> float:
    """cuda_ms for calls that take milliseconds and sync the host each
    round of their loops: the median of 3 rounds of 3 calls."""
    return cuda_ms(fn, reps=3, warm=1, rounds=3)


def same_partition(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two labelings (-1 = none) put the same points together: the label
    pairs are a bijection that maps -1 to -1 only."""
    pairs = set(zip(a.cpu().tolist(), b.cpu().tolist()))
    left, right = {p[0] for p in pairs}, {p[1] for p in pairs}
    return (len(pairs) == len(left) == len(right)
            and all((p == -1) == (q == -1) for p, q in pairs))


@contextlib.contextmanager
def no_dense_fallback():
    """Within it, dbscan_grid raises instead of falling back to dense
    dbscan: the run must take the grid path."""
    from evflow_tpu_torch.models import dbscan
    saved = dbscan.dbscan

    def refuse(*args, **kwargs):
        raise AssertionError("dbscan_grid fell back to dense dbscan")

    dbscan.dbscan = refuse
    try:
        yield
    finally:
        dbscan.dbscan = saved


def kmeans_phase(dev, card, x, y, valid) -> str:
    """Phase 9: k-means on app D's ramp (2048 points, its 8 initial
    centroids) and on one DEFAULT slice's events (K = 8, initial centroids
    the events at lanes 0, 2048, ..): against the CPU run of the same call
    (counts and iters equal, centroids within 1e-4, labels equal except
    where the two nearest centroids are within 1e-3), two calls on the card
    bit-equal, ms per call."""
    from evflow_tpu_torch import interop
    from evflow_tpu_torch.io import synthetic
    from evflow_tpu_torch.models import kmeans
    ev = torch.stack([x, y], 1).to(torch.float32)
    cases = {"app D ramp": (torch.as_tensor(synthetic.kmeans_ramp_data(2048), device=dev),
                            torch.as_tensor(synthetic.kmeans_initial_centroids(), device=dev),
                            None),
             "slice 3 events": (ev, ev[::2048].clone(), valid)}
    parts = []
    for label, (pts, init, v) in cases.items():
        def call():
            return kmeans.kmeans(pts, init, v)

        got, again = call(), call()
        torch.cuda.synchronize()
        interop.assert_trees_close(got, again, **EXACT_TOL, what=f"k-means {label}, two calls")
        ref = kmeans.kmeans(pts.cpu(), init.cpu(), None if v is None else v.cpu())
        assert torch.equal(got.counts.cpu(), ref.counts), (label, got.counts, ref.counts)
        assert int(got.iters) == int(ref.iters), (label, int(got.iters), int(ref.iters))
        err = float((got.centroids.cpu() - ref.centroids).abs().max())
        assert err <= 1e-4, (label, err)
        differ = got.labels.cpu() != ref.labels
        if bool(differ.any()):
            d = torch.cdist(pts.cpu().double(), ref.centroids.double()).sort(1).values
            assert bool((d[differ, 1] - d[differ, 0] < 1e-3).all()), label
        parts.append(f"{label}: {pts.shape[0]} points, K={init.shape[0]}, iters "
                     f"{int(got.iters)}, counts {got.counts.tolist()}, centroids within "
                     f"{err:.3g} of the CPU run, {int(differ.sum())} labels differ (near-ties), "
                     f"two calls bit-equal, {few_ms(call):.3f} ms per call")
    return f"k-means on {card}: " + "; ".join(parts)


def dbscan_phase(dev, card, x, y, valid, cfg) -> str:
    """Phase 10: dense dbscan on one DEFAULT slice's events at
    DBSCANConfig's defaults, and dbscan_grid (max_neighbors 2048) on the
    slice's unique pixels from hash_dedup.dedup_mask: the grid table exists
    and no row overflows it (no fall-back), both runs bit-equal to their
    CPU runs, and the grid's partition equal to dense dbscan's on the same
    pixels."""
    from evflow_tpu_torch import interop
    from evflow_tpu_torch.config import DBSCANConfig
    from evflow_tpu_torch.models import dbscan, optics
    from evflow_tpu_torch.ops import hash_dedup
    dcfg = DBSCANConfig()
    ev = torch.stack([x, y], 1).to(torch.float32)

    def dense():
        return dbscan.dbscan(ev, valid, cfg=dcfg)

    got = dense()
    interop.assert_trees_close(got, dbscan.dbscan(ev.cpu(), valid.cpu(), cfg=dcfg),
                               **EXACT_TOL, what="dense dbscan vs the CPU")
    ded = hash_dedup.dedup_mask(x, y, valid, cfg.dedup, cfg.sensor)
    upts = ev[ded.unique_mask].cpu().numpy()
    table = optics.compute_neighbors_grid(upts, dcfg.eps, dcfg.core_min_pts,
                                          max_neighbors=2048, device=dev)
    assert table is not None, "no grid table"
    widest = int(table.count.max())
    assert widest <= table.idx.shape[1], (widest, tuple(table.idx.shape))

    def grid():
        with no_dense_fallback():
            return dbscan.dbscan_grid(upts, dcfg, max_neighbors=2048, device=dev)

    g = grid()
    interop.assert_trees_close(g, dbscan.dbscan_grid(upts, dcfg, max_neighbors=2048,
                                                     device="cpu"),
                               **EXACT_TOL, what="dbscan_grid vs the CPU")
    du = dbscan.dbscan(torch.as_tensor(upts, device=dev), cfg=dcfg)
    assert same_partition(g.labels, du.labels), "grid and dense partitions differ"
    return (f"DBSCAN on {card}: dense on {ev.shape[0]} events: {int(got.num_clusters)} clusters, "
            f"{int(got.iterations)} iterations, bit-equal to the CPU, {few_ms(dense):.3f} ms per "
            f"call; grid on {len(upts)} unique pixels: table {tuple(table.idx.shape)}, widest "
            f"row {widest}, no fall-back, {int(g.num_clusters)} clusters, "
            f"{int(g.iterations)} iterations, bit-equal to the CPU, partition equal to dense "
            f"dbscan's, {few_ms(grid):.3f} ms per call")


# every (row, point) pair of dbscan_eps.cu at D = 2: mul, mul, add for the
# cross term, the squared norms' add, the x2, the sub, the compare
DBSCAN_EPS_OPS_PER_PAIR = 7
DBSCAN_TEXTURED_SLICES = 4    # slices of the benchmark's textured scene in phase 10b


@contextlib.contextmanager
def recorded_dense(rounds: list):
    """Within it, each dense dbscan call (one per dbscan_slice) appends its
    propagation rounds to `rounds`."""
    from evflow_tpu_torch.models import dbscan
    saved = dbscan.dbscan

    def dense(*args, **kwargs):
        res = saved(*args, **kwargs)
        rounds.append(int(res.iterations))
        return res

    dbscan.dbscan = dense
    try:
        yield
    finally:
        dbscan.dbscan = saved


def counted_dbscan_scan(dev, xs, ys, ts, vs, cfg) -> tuple:
    """pipeline.dbscan_scan, the benchmark cell's path, on (S, N) slices on
    the card with the launch counts zeroed: (dbscan_eps launches, the
    slices' rounds). Every slice is dense and launches the kernel rounds + 2
    times (the core counts, one per round, the border attachment)."""
    from evflow_tpu_torch import kernels
    from evflow_tpu_torch.models import pipeline
    rounds = []
    kernels.reset_launches()
    with recorded_dense(rounds):
        _, out = pipeline.dbscan_scan(torch.zeros((), dtype=torch.int32, device=dev),
                                      xs, ys, ts, vs, cfg)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["dbscan_eps"]
    assert launches == sum(r + 2 for r in rounds), (launches, rounds)
    assert rounds == out.iterations.tolist(), (rounds, out.iterations)
    return launches, rounds


def dbscan_eps_phase(dev, card, xs, ys, ts, vs, cfg) -> dict:
    """Phase 10b: csrc/dbscan_eps.cu. Its launches on the main path:
    pipeline.dbscan_scan on the DEFAULT slices and on slices of the
    benchmark's textured scene, rounds + 2 per slice. Then on slice
    3's events, parked and flagged as dense dbscan hands them over, count
    mode (the core counts) and min-label mode (a propagation round from the
    first labels), each bit-equal to the plain (2048, N) panels on the
    card, and both modes at D = 3 on app C's cloud. Times per call at D =
    2: eager (CUDA events around back-to-back calls), device (CUDA graph
    replay), the launch floor at the kernel's grid, and the plain panels'
    one pass; the bound is 7 fp32 operations per pair at 67 TFLOP/s.
    Returns the kernel's entry for the per-kernel JSON line."""
    from evflow_tpu_torch import kernels
    from evflow_tpu_torch.io import slice_by_count, synthetic
    from evflow_tpu_torch.models import dbscan
    from evflow_tpu_torch.ops import distance
    dcfg = cfg.dbscan
    eps, n = dcfg.eps, xs.shape[1]
    tex = slice_by_count(synthetic.textured_field_stream(
        num_slices=DBSCAN_TEXTURED_SLICES, events_per_slice=n, seed=SEED), n, drop_partial=True)
    txs, tys, tts, tvs = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                          for a in (tex.x, tex.y, (tex.t - int(tex.t.min())).astype(np.int32),
                                    tex.valid_mask()))
    scans = {"DEFAULT": counted_dbscan_scan(dev, xs, ys, ts, vs, cfg),
             "textured": counted_dbscan_scan(dev, txs, tys, tts, tvs, cfg)}
    launches = sum(k for k, _ in scans.values())

    def cases(pts, valid):
        counts = distance.eps_counts(pts, pts, eps, valid, valid)
        core = valid & (counts >= dcfg.core_min_pts)
        labels = torch.where(core, torch.arange(pts.shape[0], dtype=torch.int32, device=dev),
                             distance.NO_LABEL)
        return {"count": ((pts, pts, eps, valid, valid), distance.eps_counts,
                          distance.eps_counts_plain),
                "min-label": ((pts, pts, eps, labels, core, labels, core),
                              distance.eps_min_label, distance.eps_min_label_plain)}, core

    cloud = pointcloud_scene()
    cloud = torch.as_tensor(cloud[cloud[:, 2] > 0.35], device=dev)
    cloud_cases, _ = cases(cloud, torch.ones(cloud.shape[0], dtype=torch.bool, device=dev))
    for mode, (args, fn, plain) in cloud_cases.items():
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"dbscan_eps 3-D {mode}: {int((got != want).sum())} differ"

    x, y, valid = xs[3], ys[3], vs[3]
    pts = torch.where(valid[:, None], torch.stack([x, y], 1).to(torch.float32), dbscan._FAR)
    modes, core = cases(pts, valid)
    rows_per_cta, threads = 64, 256
    grid = (-(-n // rows_per_cta), threads, 1)
    floor = device_ms(lambda: kernels.launch_floor(*grid))
    b = bound(24 * n, DBSCAN_EPS_OPS_PER_PAIR * n * n, 0,
              f"{n} x {n} pairs x {DBSCAN_EPS_OPS_PER_PAIR} fp32 ops; x, y and a flag or "
              "label in per row and per point, one int32 out per row")
    entry, parts = None, []
    for mode, (args, fn, plain) in modes.items():
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"dbscan_eps {mode}: {int((got != want).sum())} rows differ"
        r = dict(ms=cuda_ms(lambda: fn(*args)), device_ms=device_ms(lambda: fn(*args)),
                 plain_ms=few_ms(lambda: plain(*args)))
        parts.append(f"{mode}: {r['ms']:.4f} ms eager, {r['device_ms']:.5f} device "
                     f"({100 * b['bound_ms'] / r['device_ms']:.1f} % of the bound), plain "
                     f"panels {r['plain_ms']:.3f} ms per pass")
        if entry is None:
            entry = dict(name="dbscan_eps", route="cuda",
                         source="evflow_tpu_torch/csrc/dbscan_eps.cu",
                         replaces="none (evflow_tpu/models/dbscan.py is plain XLA)",
                         max_abs_err=0.0, launches=launches, bound_ms=b["bound_ms"],
                         bound_by=b["bound_by"], library_ms=None, launch_floor_ms=floor, **r)
        else:
            entry.update({f"min_label_{k}": v for k, v in r.items()})
    print(f"dbscan_eps on {card}: launches in dbscan_scan, rounds + 2 per slice: " + "; ".join(
        f"{name} {xs_.shape[0]} slices (rounds {r}), {k} launches"
        for (name, (k, r)), xs_ in zip(scans.items(), (xs, txs)))
        + f"; both modes bit-equal to the panels at D = 3 on app C's {cloud.shape[0]} blob "
        f"points and at D = 2 on slice 3's {n} events ({int(valid.sum())} valid, "
        f"{int(core.sum())} core); " + "; ".join(parts)
        + f"; launch floor {floor:.5f} ms at grid {grid}; bound {b['bound_ms']:.5f} ms by "
        f"{b['bound_by']} ({b['bound_basis']})", flush=True)
    return entry


REP_THREADS = 512   # csrc/rep_candidates.cu: one CTA of 512 threads per row


def rep_candidates_phase(dev, card, x, y, valid, cfg, path_launches) -> dict:
    """Phase 8b: csrc/rep_candidates.cu on slice 3's events, as the q=8
    path hands them over (8 rows of 2,048 lanes into 1,024 slots) and as
    the q=1 path does (one row of 16,384 into 8,192): every output
    bit-equal to the plain version (`_representative_candidates` row by
    row) on the card. Times of the q=8 form: eager (CUDA events around
    back-to-back calls), device (CUDA graph replay), the launch floor at its
    grid and the plain version's eager time; the bound is its bytes, 9 per
    lane in and 9 per slot out. `path_launches` is its count in phase 5's
    q=8 run. Returns the kernel's entry for the per-kernel JSON line."""
    from evflow_tpu_torch import kernels
    from evflow_tpu_torch.models import pipeline
    q = 8
    n = x.shape[0]
    nsub, m_sub = n // q, max(cfg.efast.max_candidates // q, 64)
    forms = {"q=8": ((x.view(q, nsub), y.view(q, nsub), valid.view(q, nsub)), m_sub),
             "q=1": ((x[None], y[None], valid[None]), cfg.efast.max_candidates)}
    parts = []
    for label, ((xr, yr, vr), m) in forms.items():
        got = pipeline.representative_candidates(xr, yr, vr, m, cfg)
        want = pipeline.representative_candidates_plain(xr, yr, vr, m, cfg)
        torch.cuda.synchronize()
        for name, g, w in zip(("cx", "cy", "cvalid", "n_dropped"), got, want):
            assert torch.equal(g, w), f"rep_candidates {label} {name}: {int((g != w).sum())} differ"
        parts.append(f"{label} bit-equal ({xr.shape[0]} x {xr.shape[1]} lanes into {m}: "
                     f"{int(want[2].sum())} kept, {int(want[3].sum())} dropped)")
    (xr, yr, vr), m = forms["q=8"]
    r = dict(ms=cuda_ms(lambda: pipeline.representative_candidates(xr, yr, vr, m, cfg)),
             device_ms=device_ms(lambda: pipeline.representative_candidates(xr, yr, vr, m, cfg)),
             plain_ms=cuda_ms(lambda: pipeline.representative_candidates_plain(xr, yr, vr, m, cfg)))
    grid = (q, REP_THREADS, 1)
    floor = device_ms(lambda: kernels.launch_floor(*grid))
    b = bound(q * (9 * nsub + 9 * m + 4), 0, 0,
              f"{q} rows: x, y, valid in for {nsub} lanes, cx, cy, cvalid out for {m} slots, "
              "n_dropped; the table's probes depend on the data")
    print(f"rep_candidates on {card}: {'; '.join(parts)}; q=8 form {r['ms']:.4f} ms eager, "
          f"{r['device_ms']:.5f} device ({100 * b['bound_ms'] / r['device_ms']:.2f} % of the "
          f"bound), plain {r['plain_ms']:.4f} ms; launch floor {floor:.5f} ms at grid {grid}; "
          f"bound {b['bound_ms']:.6f} ms by {b['bound_by']} ({b['bound_basis']}); "
          f"{path_launches} launches in phase 5's {N_SLICES} q=8 slices", flush=True)
    return dict(name="rep_candidates", route="cuda",
                source="evflow_tpu_torch/csrc/rep_candidates.cu",
                replaces="none (evflow_tpu/models/pipeline.py:_representative_candidates "
                         "is plain XLA)",
                max_abs_err=0.0, launches=path_launches, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], library_ms=None, launch_floor_ms=floor, **r)


# app C's scene: 2^17 points, a plane z = 0.3 (3/4 of them, 1 x 1 m, noise
# sigma 0.005) and four blobs (sigma 0.03) above it. Its ~35,000 occupied
# 1 cm voxels share the default 2^16 hash buckets with many collisions,
# whose merged centroids can bridge the blobs (phase 11 prints what the
# chain finds there); 2^20 buckets keep the four apart.
PC_POINTS = 1 << 17
PC_BLOBS = ((0.25, 0.25, 0.5), (0.75, 0.25, 0.6), (0.25, 0.75, 0.45), (0.75, 0.75, 0.55))
VOXEL_BUCKETS = 1 << 20


def pointcloud_scene(seed: int = SEED) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_plane = 3 * PC_POINTS // 4
    n_blob = (PC_POINTS - n_plane) // len(PC_BLOBS)
    plane = np.stack([rng.uniform(0, 1, n_plane), rng.uniform(0, 1, n_plane),
                      0.3 + rng.normal(0, 0.005, n_plane)], 1)
    return np.concatenate([plane] + [rng.normal(c, 0.03, (n_blob, 3)) for c in PC_BLOBS]
                          ).astype(np.float32)


def pointcloud_phase(dev, card) -> str:
    """Phase 11, app C's chain as its CLI runs it: voxel_downsample (leaf
    0.01), the occupied voxels compacted, ransac_plane (100 hypotheses,
    threshold 0.02), remove_plane, dbscan_grid (eps 0.05, core 10, min size
    100, max_neighbors 2048). Checks: voxel counts equal to the CPU run's,
    centroids within 1e-6, two voxel calls bit-equal; RANSAC's plane and
    inliers equal to the CPU run's, |n_z| > 0.95; the grid path taken; the
    four blobs found. ms per stage."""
    from evflow_tpu_torch import interop
    from evflow_tpu_torch.config import DBSCANConfig
    from evflow_tpu_torch.models import dbscan, optics, pointcloud
    pts_np = pointcloud_scene()
    pts = torch.as_tensor(pts_np, device=dev)

    def voxel(p=pts):
        return pointcloud.voxel_downsample(p, 0.01, num_buckets=VOXEL_BUCKETS)

    vox, again = voxel(), voxel()
    torch.cuda.synchronize()
    interop.assert_trees_close(vox, again, **EXACT_TOL, what="voxel, two calls")
    ref = voxel(torch.as_tensor(pts_np))
    assert int(vox.count) == int(ref.count) and torch.equal(vox.valid.cpu(), ref.valid)
    verr = float((vox.points.cpu() - ref.points).abs().max())
    assert verr <= 1e-6, verr
    vpts = vox.points[vox.valid]

    def ransac(p=vpts):
        return pointcloud.ransac_plane(p, threshold=0.02, iters=100)

    plane = ransac()
    pref = ransac(vpts.cpu())
    assert torch.equal(plane.inliers.cpu(), pref.inliers)
    assert int(plane.num_inliers) == int(pref.num_inliers)
    perr = float((plane.coeffs.cpu() - pref.coeffs).abs().max())
    assert perr <= 1e-6, perr
    assert abs(float(plane.coeffs[2])) > 0.95, plane.coeffs.tolist()
    ones = torch.ones(vpts.shape[0], dtype=torch.bool, device=dev)

    def remove():
        return pointcloud.remove_plane(vpts, ones, plane)

    rest = vpts[remove()].cpu().numpy()
    dcfg = DBSCANConfig(eps=0.05, core_min_pts=10, min_cluster_size=100)
    table = optics.compute_neighbors_grid(rest, dcfg.eps, dcfg.core_min_pts,
                                          max_neighbors=2048, device=dev)
    assert table is not None and int(table.count.max()) <= table.idx.shape[1]

    def grid():
        with no_dense_fallback():
            return dbscan.dbscan_grid(rest, dcfg, max_neighbors=2048, device=dev)

    res = grid()
    sizes = torch.bincount(res.labels[res.labels >= 0].long()).tolist()
    assert int(res.num_clusters) == len(PC_BLOBS), sizes
    # the same chain at the default 2^16 buckets, for the record
    v16 = pointcloud.voxel_downsample(pts, 0.01)
    p16 = v16.points[v16.valid]
    pl16 = pointcloud.ransac_plane(p16, threshold=0.02, iters=100)
    keep16 = pointcloud.remove_plane(
        p16, torch.ones(p16.shape[0], dtype=torch.bool, device=dev), pl16)
    c16 = dbscan.dbscan_grid(p16[keep16].cpu().numpy(), dcfg, max_neighbors=2048, device=dev)
    return (f"point cloud on {card}: {PC_POINTS} points -> {int(vox.count)} voxels "
            f"({VOXEL_BUCKETS} buckets; counts equal to the CPU's, centroids within "
            f"{verr:.3g}, two calls bit-equal) -> plane {plane.coeffs.tolist()} with "
            f"{int(plane.num_inliers)} inliers (equal to the CPU's, coeffs within {perr:.3g}) "
            f"-> {len(rest)} points -> dbscan_grid table {tuple(table.idx.shape)}, widest row "
            f"{int(table.count.max())}, no fall-back, {int(res.num_clusters)} clusters of "
            f"{sizes}, {int(res.iterations)} iterations; ms per stage: voxel "
            f"{few_ms(voxel):.3f}, ransac {few_ms(ransac):.3f}, remove_plane "
            f"{few_ms(remove):.4f}, dbscan_grid {few_ms(grid):.3f}; at the default "
            f"{1 << 16} buckets the chain finds {int(v16.count)} voxels and "
            f"{int(c16.num_clusters)} clusters")


# phase 12: optics_bench.py's clouds (benchmark.cpp:62-103) and app B's
# driver parameters (cluster_event_data.cpp:429-541)
OPTICS_N = 100_000
OPTICS_DIMS = (2, 3, 6)
OPTICS_MIN_PTS = 10
OPTICS_K = 64
OPTICS_CPU_DIMS = (2, 3)      # dense d = 6 on the CPU would take many minutes
OPTICS_ORACLE_STRIDE = 97
OPTICS_EDGE = 0.02            # oracle pairs this close to eps are left out
OPTICS_CHI = 0.05
APP_B_MIN_PTS, APP_B_EPS, APP_B_THRESHOLD = 2, 10.0, 10.0


@contextlib.contextmanager
def optics_backends():
    """Within it, the names of the neighbor tables built, in call order
    ("declined" where a backend returned None), gather in the yielded list."""
    from evflow_tpu_torch.models import optics
    names = {"compute_neighbors_cellpair": "cellpair", "compute_neighbors_grid": "grid",
             "compute_neighbors": "dense"}
    saved = {name: getattr(optics, name) for name in names}
    used = []

    def recorded(name):
        def call(*args, **kwargs):
            table = saved[name](*args, **kwargs)
            used.append(names[name] + ("" if table is not None else " declined"))
            return table
        return call

    for name in names:
        setattr(optics, name, recorded(name))
    try:
        yield used
    finally:
        for name, fn in saved.items():
            setattr(optics, name, fn)


def optics_call(pts, min_pts, eps, k, dev):
    """One compute_reachability_dists call in its three parts: the table
    on `dev` (ending in a synchronize), its move to the host, the sweep.
    Returns the table, the host table, the reachability list, the
    RuntimeWarnings and the parts' ms."""
    import warnings
    from evflow_tpu_torch.models import optics
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always", RuntimeWarning)
        table = optics.neighbor_table(pts, min_pts, eps, max_neighbors=k, device=dev)
    if table.idx.is_cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = optics.table_to_host(table)
    t2 = time.perf_counter()
    rd = optics.sweep(*host)
    t3 = time.perf_counter()
    warned = [str(w.message) for w in rec if issubclass(w.category, RuntimeWarning)]
    return table, host, rd, warned, [
        (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3]


def oracle_rows(pts, eps, min_pts, table, host) -> int:
    """Every OPTICS_ORACLE_STRIDE-th row of `table` against a float64
    difference-form oracle on the same float32 coordinates: the neighbor
    set, leaving out pairs within OPTICS_EDGE of eps, and where no pair is
    that close, the count and the core distance (within 1e-5). Returns the
    rows checked."""
    idx, dist, core = host
    count = table.count.cpu().numpy()
    p = np.asarray(pts, np.float32).astype(np.float64)
    rows = np.arange(0, len(p), OPTICS_ORACLE_STRIDE)
    for chunk in np.array_split(rows, -(-len(rows) // 32)):
        d = np.sqrt(((p[chunk, None, :] - p[None, :, :]) ** 2).sum(-1))
        for r, row in zip(chunk.tolist(), d):
            edge = np.abs(row - eps) <= OPTICS_EDGE
            want = set(np.nonzero((row <= eps) & ~edge)[0].tolist())
            got = set(idx[r][np.isfinite(dist[r])].tolist()) - set(np.nonzero(edge)[0].tolist())
            assert got == want, (r, sorted(got ^ want)[:8])
            if not edge.any():
                within = np.sort(row[row <= eps])
                assert count[r] == len(within), (r, count[r], len(within))
                want_core = within[min_pts - 1] if len(within) >= min_pts else np.inf
                assert np.isclose(core[r], want_core, rtol=1e-5, atol=0), (r, core[r], want_core)
    return len(rows)


def compare_cpu_run(label, table, rd, warned, ref, ref_rd, ref_warned, exact) -> str:
    """The card's table and sweep against the CPU run's: indices, counts
    and warnings equal; distances bit-equal where `exact` (integer
    coordinates: every term exact), else within one float32 ulp (the
    card's sqrt against the CPU's, as phase 10's grid table); then the
    order equal and reach within rtol 1e-6, or, where a one-ulp distance
    reorders a tie, the JAX tests' criteria: the same unreached points and
    at least 0.995 of reaches within rtol 1e-6."""
    for name in ("idx", "count"):
        assert torch.equal(getattr(table, name).cpu(), getattr(ref, name)), (label, name)
    assert warned == ref_warned, (warned, ref_warned)
    ulps = 0.0
    for name in ("dist", "core_dist"):
        got, want = getattr(table, name).cpu(), getattr(ref, name)
        if exact:
            assert torch.equal(got, want), (label, name)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin), (label, name)
        rel = ((got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(1e-30)).max()
        ulps = max(ulps, float(rel) / 2.0 ** -24)
        assert ulps <= 2.0, (label, name, ulps)
    n = len(rd)
    a, b = np.full(n, -2.0), np.full(n, -2.0)
    for r in rd:
        a[r.point_index] = r.reach_dist
    for r in ref_rd:
        b[r.point_index] = r.reach_dist
    moved = sum(p.point_index != q.point_index for p, q in zip(rd, ref_rd))
    assert ((a < 0) == (b < 0)).all(), label
    close = np.isclose(a[a >= 0], b[b >= 0], rtol=1e-6, atol=0)
    assert (moved == 0 and close.all()) if exact else close.mean() >= 0.995, (label, moved)
    return (f"table {'bit-equal' if exact else 'indices and counts equal, distances within '
                       f'{ulps:.2f} x 2^-24 relative'} to the CPU run's, {moved} of {n} "
            f"visits in another place, {int((~close).sum())} reaches off by more than 1e-6")


def optics_phase(dev, card, x, y, valid, cfg) -> None:
    """Phase 12 (see the module docstring), one line per case."""
    from evflow_tpu_torch.io import synthetic
    from evflow_tpu_torch.models import optics
    from evflow_tpu_torch.ops import hash_dedup
    ded = hash_dedup.dedup_mask(x, y, valid, cfg.dedup, cfg.sensor)
    # (label, points, min_pts, eps, K, pixels: integer coordinates)
    cases = [("app B, slice 3's unique pixels",
              torch.stack([x, y], 1)[ded.unique_mask].cpu().numpy().astype(np.float64),
              APP_B_MIN_PTS, APP_B_EPS, 256, True)]
    for d in OPTICS_DIMS:
        pts = synthetic.uniform_cloud(OPTICS_N, d, 1000.0, seed=1)
        cases.append((f"uniform cloud d={d}", pts, OPTICS_MIN_PTS,
                      optics.epsilon_estimation(pts, OPTICS_MIN_PTS), OPTICS_K, False))
    for label, pts, min_pts, eps, k, pixels in cases:
        t_case = time.perf_counter()
        with optics_backends() as used:
            table, host, rd, warned, _ = optics_call(pts, min_pts, eps, k, dev)
        widest = int(table.count.max())
        assert widest <= table.idx.shape[1], (label, widest, tuple(table.idx.shape))
        checks = []
        if pixels or pts.shape[1] in OPTICS_CPU_DIMS:
            ref, _, ref_rd, ref_warned, cpu_ms = optics_call(pts, min_pts, eps, k, "cpu")
            checks.append(compare_cpu_run(label, table, rd, warned, ref, ref_rd, ref_warned,
                                          exact=pixels)
                          + f" (the CPU run took {sum(cpu_ms):.0f} ms)")
        if pixels:
            clusters = optics.get_cluster_indices(rd, APP_B_THRESHOLD)
            assert clusters == optics.get_cluster_indices(ref_rd, APP_B_THRESHOLD), label
            checks.append(f"{len(clusters)} clusters at threshold {APP_B_THRESHOLD:g} "
                          f"({sum(len(c) > 1 for c in clusters)} of more than one point), "
                          "equal to the CPU run's")
        else:
            checks.append(f"{oracle_rows(pts, eps, min_pts, table, host)} rows equal to the "
                          "float64 oracle")
        rd_py = optics.sweep(*host, use_native=False)
        assert rd_py == rd, f"{label}: native and Python sweeps differ"
        flat = optics.get_chi_clusters_flat(rd, OPTICS_CHI, min_pts)
        assert flat == optics.get_chi_clusters_flat(rd_py, OPTICS_CHI, min_pts), label
        checks.append(f"native sweep equal to the Python loop, {len(flat)} xi clusters "
                      f"(chi {OPTICS_CHI}) equal")
        rounds = [optics_call(pts, min_pts, eps, k, dev)[4] for _ in range(3)]
        total = [sum(r) for r in rounds]
        med = rounds[int(np.argsort(total)[1])]
        print(f"OPTICS on {card}: {label}: n {len(pts)}, d {pts.shape[1]}, eps {eps:.6g}, "
              f"min_pts {min_pts}, tables {used}, K {table.idx.shape[1]} after the auto-raise "
              f"({warned or 'none'}), widest row {widest}; {'; '.join(checks)}; ms per call "
              f"{sum(med):.3f} (table {med[0]:.3f}, host {med[1]:.3f}, sweep {med[2]:.3f}; "
              f"rounds {[round(t, 3) for t in total]}); case "
              f"{time.perf_counter() - t_case:.1f} s", flush=True)


# phase 13: the CLI at DEFAULT on the card
CLI_PREFIX_SLICES = 4         # the prefix each subcommand's CPU run repeats
OPTICS_CPU_EVENTS = 1024      # optics' CPU run: this prefix of slice 3 (the CPU
                              # cell-pair table's time grows fast with the density)
PRINT_TOL = 0.01              # a last printed digit at a rounding boundary
_NUMBER = r"(-?\d+(?:\.\d*)?(?:e[-+]?\d+)?)"


def lines_match(got: str, want: str, rtol: float = 1e-5, atol: float = 1e-3) -> bool:
    """Two CLI outputs line by line, parsed as the tier-1 tests parse them
    (tests/test_torch_cli.py): the text between numbers equal, integers
    equal, floats within PRINT_TOL + atol + rtol * |want|; `Total time`
    lines left out."""
    import re
    keep = [[ln for ln in out.splitlines() if not ln.startswith("Total time")]
            for out in (got, want)]
    if len(keep[0]) != len(keep[1]):
        return False
    for a, b in zip(*keep):
        pa, pb = re.split(_NUMBER, a), re.split(_NUMBER, b)
        if len(pa) != len(pb) or pa[::2] != pb[::2]:
            return False
        for x, y in zip(pa[1::2], pb[1::2]):
            if "." in x + y or "e" in x + y:
                if abs(float(x) - float(y)) > PRINT_TOL + atol + rtol * abs(float(y)):
                    return False
            elif int(x) != int(y):
                return False
    return True


def run_cli(argv) -> tuple:
    """evflow_tpu_torch.run.main(argv): (its standard output, the kernel
    launches of the run, counted from 0 just before it, its wall ms)."""
    from io import StringIO
    from evflow_tpu_torch import kernels, run
    buf = StringIO()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run.main(list(argv))
    torch.cuda.synchronize()
    return buf.getvalue(), dict(kernels.LAUNCHES), (time.perf_counter() - t) * 1e3


def slice_blocks(out: str) -> list:
    """Per-slice report blocks of a CLI output, the slice index stripped
    (a resumed run numbers its slices from 0)."""
    blocks = []
    for line in out.splitlines():
        if line.startswith("slice "):
            blocks.append([line.split(":", 1)[1]])
        elif line.startswith("  ") and blocks:
            blocks[-1].append(line)
    return blocks


def slice_field(out: str, name: str) -> list:
    """The integer `name=` of each `slice i:` line."""
    import re
    return [int(re.search(rf"{name}=(\d+)", ln).group(1))
            for ln in out.splitlines() if ln.startswith("slice ")]


@contextlib.contextmanager
def nccl_world_of_one():
    """A real NCCL process group of one rank on card 0 (a HashStore), so
    the sharded paths' collectives run; yields the count of collective
    calls made within it."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    # the communicator is set up at the first collective: not in a timed run
    dist.all_reduce(torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()
    saved = dist.all_gather, dist.all_reduce
    calls = {"all_gather": 0, "all_reduce": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    dist.all_gather, dist.all_reduce = (counted("all_gather", saved[0]),
                                        counted("all_reduce", saved[1]))
    try:
        yield calls
    finally:
        dist.all_gather, dist.all_reduce = saved
        dist.destroy_process_group()


def cli_phase(card, stream, n) -> None:
    """Phase 13 (see the module docstring), a line per part."""
    import os
    import re
    import tempfile
    from evflow_tpu_torch.io import evt3, save_csv
    from evflow_tpu_torch.utils import pcd
    n_slices = len(stream) // n
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        # ---- the inputs. Single-event words: vector words pack the events
        # of one (t, y, p) and merge exact duplicates, so such a file would
        # not read back as the stream
        raw = path("stream.raw")
        evt3.save_evt3(stream, raw, vectorize=False)
        read_s = []
        for _ in range(3):
            t = time.perf_counter()
            got = evt3.load_evt3(raw)
            read_s.append(time.perf_counter() - t)
        ref = evt3.load_evt3(raw, use_native=False)
        for f in ("x", "y", "t", "p"):
            assert np.array_equal(getattr(got, f), getattr(ref, f)), f"native decode: {f}"
            assert np.array_equal(getattr(got, f), getattr(stream, f)), f"decode: {f}"
        rate = len(stream) / float(np.median(read_s))
        half = n_slices // 2 * n
        for name, part in (("head.raw", stream[:half]), ("tail.raw", stream[half:]),
                           ("prefix.raw", stream[:CLI_PREFIX_SLICES * n])):
            evt3.save_evt3(part, path(name), vectorize=False)
        save_csv(stream[3 * n:4 * n], path("slice3.csv"))
        save_csv(stream[3 * n:3 * n + OPTICS_CPU_EVENTS], path("slice3_prefix.csv"))
        pcd.save_pcd(path("cloud.pcd"), pointcloud_scene(), binary=True)
        print(f"CLI inputs: {len(stream)} events as a 1280x720 EVT3 file of "
              f"{os.path.getsize(raw)} bytes, read back by the native decoder equal to "
              f"the numpy decoder and to the stream at {rate:.0f} events/s (median of 3 "
              f"reads); app C's {PC_POINTS}-point cloud as a binary PCD", flush=True)

        def subcommands(stream_file, optics_csv):
            """argv of each run on these inputs; the dbscan runs export."""
            pc = ["dbscan", "--input", path("cloud.pcd"), "--voxel", "0.01",
                  "--remove-plane", "--eps", "0.05", "--min-pts", "10"]
            optics = ["optics", "--input", optics_csv, "--eps", "10"]
            return {
                "cluster-flow": ["cluster-flow", "--input", stream_file],
                "cluster-flow --exact": ["cluster-flow", "--input", stream_file, "--exact"],
                "corner-track": ["corner-track", "--input", stream_file],
                "track-estimate": ["track-estimate", "--input", stream_file,
                                   "--decimate", "512"],
                "async-cluster": ["async-cluster", "--input", stream_file, "--decimate", "256"],
                "sampling": ["sampling", "--input", stream_file],
                "kmeans": ["kmeans", "--n", "2048"],
                "kmeans --sharded": ["kmeans", "--n", "2048", "--sharded"],
                "dbscan": pc + ["--export", path("plain.pcd")],
                "dbscan --sharded": pc + ["--sharded", "--export", path("sharded.pcd")],
                "optics": optics,
                "optics --method sharded": optics + ["--method", "sharded"],
            }

        cuda = ["--device", "cuda"]
        runs = subcommands(raw, path("slice3.csv"))
        outs, launches, ms = {}, {}, {}
        with nccl_world_of_one() as collectives:
            for name, argv in runs.items():
                outs[name], launches[name], ms[name] = run_cli(argv + cuda)

        # ---- the kernels each run launched, and what it reported
        for name in ("cluster-flow", "track-estimate"):
            k = sum(ln.startswith("slice ") for ln in outs[name].splitlines())
            assert k > 0 and launches[name]["assign_manhattan"] == k \
                == launches[name]["cluster_stats"], (name, k, launches[name])
        for name in ("cluster-flow", "cluster-flow --exact"):
            reported = slice_field(outs[name], "clusters")
            assert len(reported) == n_slices and min(reported) > 0, (name, reported)
        assert launches["cluster-flow --exact"]["aeclustering_exact"] == n_slices, \
            launches["cluster-flow --exact"]
        assert launches["async-cluster"]["aeclustering_exact"] == 1, launches["async-cluster"]
        assert outs["async-cluster"].startswith(f"events={len(stream) // 256} clusters=")
        corners = slice_field(outs["corner-track"], "corners")
        assert len(corners) == n_slices and corners[0] == 0 and min(corners[1:]) > 0, corners
        assert launches["corner-track"]["efast_stencil"] >= n_slices - 1, launches["corner-track"]
        assert len(slice_field(outs["sampling"], "unique")) == n_slices
        events_s = float(re.search(r"\((\d+) events/s\)", outs["sampling"]).group(1))

        # ---- the sharded runs (one rank of a real NCCL group) equal the plain
        assert collectives["all_gather"] > 0 and collectives["all_reduce"] > 0, collectives
        assert lines_match(outs["kmeans --sharded"], outs["kmeans"]), \
            (outs["kmeans --sharded"], outs["kmeans"])
        assert outs["dbscan --sharded"] == outs["dbscan"], (outs["dbscan --sharded"],
                                                            outs["dbscan"])
        with open(path("plain.pcd"), "rb") as a, open(path("sharded.pcd"), "rb") as b:
            assert a.read() == b.read(), "dbscan --sharded exported other clusters"
        assert outs["optics --method sharded"] == outs["optics"]
        # the CLI voxelizes at the default 2^16 buckets, where colliding
        # voxels can bridge the blobs (phase 11)
        n_dbscan = int(re.search(r"clusters=(\d+)", outs["dbscan"]).group(1))
        assert n_dbscan > 0, outs["dbscan"]
        print(f"CLI on {card} at DEFAULT: launches " + "; ".join(
            f"{name} {({k: v for k, v in launches[name].items() if v})}" for name in runs)
            + f"; corners/slice {corners}; kmeans, dbscan and optics sharded over one NCCL "
            f"rank ({collectives}) equal to their plain runs; dbscan finds {n_dbscan} "
            f"clusters: {outs['dbscan'].strip()!r}", flush=True)

        # ---- split resumes: the first half, a checkpoint, the second half
        for name in ("corner-track", "cluster-flow --exact"):
            argv = runs[name][:1] + runs[name][3:]    # without --input
            ck = path(f"{argv[0]}.npz")
            head = run_cli(argv + ["--input", path("head.raw"), "--checkpoint", ck] + cuda)[0]
            assert "checkpoint saved" in head
            tail = run_cli(argv + ["--input", path("tail.raw"), "--resume", ck] + cuda)[0]
            assert slice_blocks(head) + slice_blocks(tail) == slice_blocks(outs[name]), \
                f"{name}: the split resume differs from the unbroken run"

        # ---- each subcommand's card run against its CPU run, on the prefix
        cpu_ms = {}
        for name, argv in subcommands(path("prefix.raw"), path("slice3_prefix.csv")).items():
            if "sharded" in name:
                continue          # equal to the plain run, above
            if name == "dbscan":
                argv = argv[:-2]  # no export
            got = run_cli(argv + cuda)[0]
            t = time.perf_counter()
            want = run_cli(argv + ["--device", "cpu"])[0]
            cpu_ms[name] = round((time.perf_counter() - t) * 1e3)
            assert lines_match(got, want), (name, got, want)

        print(f"CLI checks on {card}: corner-track and cluster-flow --exact split into "
              f"{n_slices // 2} + {n_slices // 2} slices with --checkpoint / --resume print "
              f"the unbroken runs' slices; each subcommand's card run equals its CPU run on "
              f"the {CLI_PREFIX_SLICES}-slice prefix (optics on {OPTICS_CPU_EVENTS} events of "
              f"slice 3; the CPU runs' ms {cpu_ms})",
              flush=True)
    print(f"CLI wall ms on {card}: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
          + f"; sampling {events_s:.0f} events/s (dedup_batched over {n_slices} slices, its "
          f"own timer); EVT3 native decode {rate:.0f} events/s; phase 13 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 14: the spatio-temporal layer at DEFAULT
GRID_WINDOWS, GRID_TILES, GRID_WARMUP = 2, 2, 8
GRID_CPU_SLICES, GRID_CPU_WARMUP = 12, 2   # the prefix the CPU run repeats
EXACT_WINDOWS, EXACT_WARMUP = 2, 4
RANK_TIMEOUT_S = 300


def phase3_stream(n):
    """The 32-slice stream of phases 2-13, made again from its seed (a
    spawned rank makes its own)."""
    from evflow_tpu_torch import io
    return io.synthetic.moving_blob_stream(
        num_slices=N_SLICES, events_per_slice=n,
        blob_centers=((200.0, 200.0), (900.0, 500.0), (600.0, 150.0)),
        velocities=((30.0, 10.0), (-20.0, 15.0), (5.0, -12.0)),
        sigma=12.0, seed=SEED)


def spawn_ranks(target, size: int) -> list:
    """target(rank, size, store, out) on `size` spawned ranks joined by a
    FileStore; each rank's saved arrays. A rank that has not ended within
    RANK_TIMEOUT_S fails the phase; every rank is stopped before return."""
    import multiprocessing as mp
    import tempfile
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store, out = f"{tmp}/store", f"{tmp}/out"
        procs = [ctx.Process(target=target, args=(r, size, store, out)) for r in range(size)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(RANK_TIMEOUT_S)
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            assert not hung, f"ranks {hung} did not end within {RANK_TIMEOUT_S} s"
            assert [p.exitcode for p in procs] == [0] * size, [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [dict(np.load(f"{out}.{r}.npz")) for r in range(size)]


@contextlib.contextmanager
def counted_collectives():
    """Counts of dist.all_gather and dist.all_reduce calls made within."""
    import torch.distributed as dist
    saved = dist.all_gather, dist.all_reduce
    calls = {"all_gather": 0, "all_reduce": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    dist.all_gather, dist.all_reduce = (counted("all_gather", saved[0]),
                                        counted("all_reduce", saved[1]))
    try:
        yield calls
    finally:
        dist.all_gather, dist.all_reduce = saved


@contextlib.contextmanager
def timed_fusion():
    """Wall ms of the fusion calls made within (fuse_tracklets,
    fuse_clusters), each ended by a synchronize."""
    from evflow_tpu_torch.parallel import temporal
    saved = temporal.fuse_tracklets, temporal.fuse_clusters
    spent = [0.0]

    def timed(fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            r = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += (time.perf_counter() - t) * 1e3
            return r
        return call

    temporal.fuse_tracklets, temporal.fuse_clusters = map(timed, saved)
    try:
        yield spent
    finally:
        temporal.fuse_tracklets, temporal.fuse_clusters = saved


@contextlib.contextmanager
def recorded_nms():
    """Each tile_local_nms call's candidates and survivor count, in call
    order: (x, y, valid, count) numpy arrays."""
    from evflow_tpu_torch.parallel import tiling
    saved = tiling.tile_local_nms
    calls = []

    def record(cx, cy, cvalid, *args, **kwargs):
        filt = saved(cx, cy, cvalid, *args, **kwargs)
        calls.append([a.cpu().numpy() for a in (cx, cy, cvalid, filt.count)])
        return filt

    tiling.tile_local_nms = record
    try:
        yield calls
    finally:
        tiling.tile_local_nms = saved


def _gloo_on_card(rank, size, store):
    import os
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # the ranks share one host
    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, 8 // size))
    dist.init_process_group("gloo", store=dist.FileStore(store, size), rank=rank,
                            world_size=size)


def _leaves(prefix, tree) -> dict:
    from evflow_tpu_torch import interop
    return {prefix + name: leaf for name, leaf in interop.named_leaves(tree)}


def grid_rank(rank, size, store, out):
    """Phase 14 (b), one of four Gloo ranks on card 0: run_temporal on the
    (2 x 2) grid over the 12-slice prefix on the card (also the process'
    warm-up), over the 32 slices, counted (launches, collectives, NMS
    candidates, fusion ms), and over the prefix on the CPU."""
    import torch.distributed as dist
    from evflow_tpu_torch import DEFAULT, io, kernels
    from evflow_tpu_torch.parallel import mesh, temporal
    _gloo_on_card(rank, size, store)
    try:
        cfg, n = DEFAULT, DEFAULT.slicing.n_events
        sl = io.slice_by_count(phase3_stream(n), n, drop_partial=True)
        grid = mesh.make_grid_mesh(GRID_WINDOWS, GRID_TILES, cfg.parallel)
        prefix = io.slice_by_count(phase3_stream(n)[:GRID_CPU_SLICES * n], n, drop_partial=True)
        res = _leaves("prefix_cuda", temporal.run_temporal(
            prefix, grid, GRID_WINDOWS, GRID_TILES, GRID_CPU_WARMUP, cfg))
        torch.cuda.synchronize()
        kernels.reset_launches()
        with counted_collectives() as calls, timed_fusion() as fusion, \
                recorded_nms() as cands:
            t = time.perf_counter()
            o = temporal.run_temporal(sl, grid, GRID_WINDOWS, GRID_TILES, GRID_WARMUP, cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        res.update(_leaves("run", o))
        res.update({f"launches.{k}": v for k, v in kernels.LAUNCHES.items()})
        res.update({f"calls.{k}": v for k, v in calls.items()})
        res.update(wall_ms=wall, fusion_ms=fusion[0],
                   nms=np.stack([np.stack(c[:3]) for c in cands]),
                   nms_count=np.array([int(c[3]) for c in cands]))
        res.update(_leaves("prefix_cpu", temporal.run_temporal(
            prefix, grid, GRID_WINDOWS, GRID_TILES, GRID_CPU_WARMUP, cfg, device="cpu")))
        np.savez(f"{out}.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def exact_rank(rank, size, store, out):
    """Phase 14 (c), one of two Gloo ranks on card 0: run_temporal_exact
    over 2 windows of the 32 slices, counted, after a warm-up run over a
    4-slice prefix."""
    import torch.distributed as dist
    from evflow_tpu_torch import DEFAULT, io, kernels
    from evflow_tpu_torch.parallel import mesh, temporal
    _gloo_on_card(rank, size, store)
    try:
        cfg, n = DEFAULT, DEFAULT.slicing.n_events
        sl = io.slice_by_count(phase3_stream(n), n, drop_partial=True)
        data = mesh.make_data_mesh(EXACT_WINDOWS, cfg.parallel)
        temporal.run_temporal_exact(io.slice_by_count(phase3_stream(n)[:4 * n], n), data,
                                    EXACT_WINDOWS, 1, cfg)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with counted_collectives() as calls, timed_fusion() as fusion:
            t = time.perf_counter()
            o = temporal.run_temporal_exact(sl, data, EXACT_WINDOWS, EXACT_WARMUP, cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        res = _leaves("run", o)
        res.update({f"launches.{k}": v for k, v in kernels.LAUNCHES.items()})
        res.update({f"calls.{k}": v for k, v in calls.items()})
        res.update(wall_ms=wall, fusion_ms=fusion[0])
        np.savez(f"{out}.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def determined(n_obs, n_windows, boundary_ok) -> np.ndarray:
    """(K, W+1) refined boundaries that two runs must agree on: supported,
    on a chain whose observations determine its system (2 unknowns per
    window plus 1; with fewer, only the 1e-6 regularization decides the
    solve, and f32 rounding moves it: tests/test_torch_temporal.py)."""
    return boundary_ok & (n_obs >= 2 * n_windows + 1)[:, None]


def temporal_close(got: dict, want: dict, what: str) -> None:
    """Two runs' TemporalOutput leaves by name (".cl_n", ...): discrete
    leaves equal, cluster floats within CLUSTER_TOL, track floats within
    TRACK_TOL, boundary positions where `determined` within rtol 1e-4,
    atol 1e-3."""
    keep = determined(want[".refined.n_obs"], want[".refined.n_windows"],
                      want[".refined.boundary_ok"])
    assert sorted(got) == sorted(want), what
    for name, b in want.items():
        a, where = got[name], f"{what}{name}"
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if name.endswith("boundary_pos"):
            np.testing.assert_allclose(a[keep], b[keep], rtol=1e-4, atol=1e-3, err_msg=where)
        elif a.dtype.kind == "f":
            tol = TRACK_TOL if ".track_" in name else CLUSTER_TOL
            np.testing.assert_allclose(a, b, **tol, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)


def temporal_phase(card, stream, n) -> None:
    """Phase 14 (see the module docstring), a line per part."""
    import os
    import tempfile
    from evflow_tpu_torch import DEFAULT, interop, io, kernels
    from evflow_tpu_torch.io import evt3
    from evflow_tpu_torch.models import aeclustering as ae, fastcluster, pipeline
    from evflow_tpu_torch.ops import hash_dedup, nms
    from evflow_tpu_torch.parallel import mesh, temporal
    cfg = DEFAULT
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    sl = io.slice_by_count(stream, n, drop_partial=True)
    n_slices = sl.num_slices
    xs, ys, vs = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                  for a in (sl.x, sl.y, sl.valid_mask()))

    # ---- (a) one rank of a NCCL group: run_temporal on a 1 x 1 grid against
    # cluster_flow_scan, then the CLI's temporal and temporal --exact
    with tempfile.TemporaryDirectory() as tmp, nccl_world_of_one() as calls:
        grid = mesh.make_grid_mesh(1, 1, cfg.parallel)
        for ax in grid.axes:          # NCCL sets a group up at its first collective
            mesh.psum(torch.zeros(1, device=dev), ax)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        out = temporal.run_temporal(sl, grid, 1, 1, 0, cfg)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t) * 1e3 / n_slices
        one_launches = dict(kernels.LAUNCHES)
        for name in ("assign_manhattan", "cluster_stats"):
            assert one_launches[name] == n_slices, one_launches
        _, scan = pipeline.cluster_flow_scan(fastcluster.init_state(cfg.cluster, device=dev),
                                             xs, ys, vs, cfg)
        interop.assert_trees_close(
            (out.cl_reported[0], out.cl_cid[0], out.cl_n[0], out.cl_centroid[0],
             out.cl_flow[0] * cfg.flow.extrapolation),
            (scan.reported, scan.cid, scan.n, scan.centroid, scan.flow), **CLUSTER_TOL,
            what="1 x 1 grid vs cluster_flow_scan")
        assert int(out.num_corners[0, 0]) == 0 and bool((out.num_corners[0, 1:] > 0).all())
        raw = os.path.join(tmp, "stream.raw")
        evt3.save_evt3(stream, raw, vectorize=False)
        cli = {}
        for label, argv in (("temporal", ["--windows", "1", "--tiles", "1"]),
                            ("temporal --exact", ["--exact", "--windows", "1"])):
            text, launches, ms = run_cli(["temporal", "--input", raw, *argv, "--device", "cuda"])
            lines = [ln for ln in text.splitlines() if ln.startswith("window 0 slice ")]
            assert len(lines) == n_slices, text
            scanned = n_slices + 8         # the CLI's default warm-up of 8 slices
            kernels_run = ("aeclustering_exact",) if "exact" in label else (
                "assign_manhattan", "cluster_stats")
            for name in kernels_run:
                assert launches[name] == scanned, (label, launches)
            assert ("cross-window cluster chains:" if "exact" in label
                    else "refined track chains:") in text
            cli[label] = (ms, {k: v for k, v in launches.items() if v}, text.splitlines()[-1])
    print(f"temporal on {card}, one rank of a NCCL group: run_temporal on a 1 x 1 grid over "
          f"{n_slices} DEFAULT slices (warm-up 0) equals cluster_flow_scan (cluster streams; "
          f"discrete exact, floats within rtol 1e-5, atol 1e-3); {one_ms:.3f} ms/slice; launches "
          f"{ {k: v for k, v in one_launches.items() if v} }; collectives {calls}; CLI "
          + "; ".join(f"{k}: {v[0]:.1f} ms, launches {v[1]}, last line {v[2]!r}"
                      for k, v in cli.items()), flush=True)

    # ---- (b) four Gloo ranks on card 0: the (2 x 2) grid
    t = time.perf_counter()
    ranks = spawn_ranks(grid_rank, GRID_WINDOWS * GRID_TILES)
    spawn_s = time.perf_counter() - t
    for r in ranks[1:]:
        for name in ranks[0]:
            if name.startswith(("run.", "prefix_")):
                assert np.array_equal(r[name], ranks[0][name]), f"rank outputs differ: {name}"
    got = ranks[0]
    s_win = GRID_WARMUP + n_slices // GRID_WINDOWS
    for r in ranks:
        assert r["launches.assign_manhattan"] == r["launches.cluster_stats"] == s_win, r
    # each window's cluster streams: update_slice over the window's slices in
    # tile-major order, with the tiles' own dedup masks, from a fresh state
    x, y, _t, valid, emit, _armed = temporal.window_tile_events(
        sl, GRID_WINDOWS, GRID_TILES, GRID_WARMUP, cfg)
    n_emit = emit.shape[1] - GRID_WARMUP
    for w in range(GRID_WINDOWS):
        st = fastcluster.init_state(cfg.cluster, device=dev)
        for s in range(s_win):
            tx, ty, tv = (torch.as_tensor(a[w, :, s], device=dev) for a in (x, y, valid))
            mask = torch.cat([hash_dedup.dedup_mask(tx[k], ty[k], tv[k], cfg.dedup,
                                                    cfg.sensor).unique_mask
                              for k in range(GRID_TILES)])
            st, o = fastcluster.update_slice(st, tx.reshape(-1), ty.reshape(-1), mask,
                                             cfg.cluster, cfg.sensor)
            if s >= GRID_WARMUP:
                e = s - GRID_WARMUP
                interop.assert_trees_close(
                    (got["run.cl_reported"][w, e], got["run.cl_cid"][w, e], got["run.cl_n"][w, e],
                     got["run.cl_centroid"][w, e], got["run.cl_flow"][w, e]),
                    (o.reported, o.cid, o.n, o.centroid, o.flow), **CLUSTER_TOL,
                    what=f"window {w} slice {e} vs update_slice")
    # num_filtered: the tiles' survivors against filter_corners on the
    # gathered tile-major candidates (2 exchange rounds are the fixpoint at
    # 2 tiles); rank w * 2 + k recorded its tile's calls, slice by slice
    filtered = []
    for w in range(GRID_WINDOWS):
        tiles = [ranks[w * GRID_TILES + k] for k in range(GRID_TILES)]
        for s in range(s_win):
            cand = np.concatenate([r["nms"][s] for r in tiles], axis=1)
            ref = nms.filter_corners(*(torch.as_tensor(a, device=dev) for a in
                                       (cand[0], cand[1], cand[2].astype(bool))), cfg.nms)
            n_tiles_sum = sum(int(r["nms_count"][s]) for r in tiles)
            assert int(ref.count) == n_tiles_sum, (w, s, int(ref.count), n_tiles_sum)
            if s >= GRID_WARMUP:
                filtered.append(n_tiles_sum)
    assert sum(filtered) > 0
    refined_ok = int(got["run.refined.valid"].sum())
    chains = int((got["run.cluster_chain"] >= 0).sum())
    # the 12-slice prefix: the card against the CPU
    temporal_close(*({k[len(p):]: v for k, v in got.items() if k.startswith(p)}
                     for p in ("prefix_cuda", "prefix_cpu")), "12-slice prefix, card vs CPU")
    print(f"temporal on {card}, (2 x 2) grid of four Gloo ranks on one card, warm-up "
          f"{GRID_WARMUP}, {n_emit} emitted slices per window, tile width "
          f"{-(-cfg.sensor.width // GRID_TILES)}: every rank's streams and fusion products "
          f"bit-equal; each window's cluster streams equal update_slice over its slices in "
          f"tile-major order from a fresh state; num_filtered equals filter_corners on the "
          f"gathered candidates at every slice (post-warm-up {filtered}); {refined_ok} refined "
          f"chains, {chains} chained cluster slots; the 12-slice prefix (warm-up "
          f"{GRID_CPU_WARMUP}) equals the CPU run; per rank ms/slice of the window loop "
          f"{[round((float(r['wall_ms']) - float(r['fusion_ms'])) / s_win, 3) for r in ranks]}"
          f", fusion ms "
          f"{[round(float(r['fusion_ms']), 3) for r in ranks]}, collective calls "
          f"{[(int(r['calls.all_gather']), int(r['calls.all_reduce'])) for r in ranks]} "
          f"(all_gather, all_reduce), launches per rank "
          f"{[(int(r['launches.assign_manhattan']), int(r['launches.cluster_stats'])) for r in ranks]}"
          f" (assign_manhattan, cluster_stats); spawn and run {spawn_s:.1f} s", flush=True)

    # ---- (c) two Gloo ranks on card 0: the exact engine over 2 windows
    t = time.perf_counter()
    ranks = spawn_ranks(exact_rank, EXACT_WINDOWS)
    spawn_s = time.perf_counter() - t
    for r in ranks[1:]:
        for name in ranks[0]:
            if name.startswith("run."):
                assert np.array_equal(r[name], ranks[0][name]), f"rank outputs differ: {name}"
    got = ranks[0]
    x, y, tt, valid, emit = temporal.window_events(sl, EXACT_WINDOWS, EXACT_WARMUP)
    s_win = x.shape[1]
    for r in ranks:
        assert r["launches.aeclustering_exact"] == s_win, r
    fields = ("alive", "cid", "n", "mu", "centroid", "digest")

    def sequential(xw, yw, tw, vw, em):
        """The exact path over these slices from a fresh state, t0 pinned:
        the snapshot fields per slice (alive masked by emit)."""
        st = ae.init_state(cfg.cluster, device=dev)._replace(
            has_t0=torch.ones((), dtype=torch.bool, device=dev))
        cum, snaps = torch.zeros((), dtype=torch.int32, device=dev), []
        for s in range(xw.shape[0]):
            a = [torch.as_tensor(np.ascontiguousarray(v[s]), device=dev)
                 for v in (xw, yw, tw, vw)]
            st, view, cum = pipeline.cluster_flow_step_exact(st, *a, cfg, cum)
            snaps.append([view.alive & bool(em[s]), view.cid, view.n, view.mu,
                          view.centroid, ae.membership_digest(st, cfg.cluster)])
        return [torch.stack(f).cpu().numpy() for f in zip(*snaps)]

    for w in range(EXACT_WINDOWS):
        want = sequential(x[w], y[w], tt[w], valid[w], emit[w])
        for f, a in zip(fields, want):
            assert np.array_equal(got[f"run.{f}"][w], a[EXACT_WARMUP:]), (w, f)
    # the stream-long sequential run's canonical cluster sets, slice by slice
    t_all = (sl.t - int(sl.t[0, 0])).astype(np.int32)
    whole = sequential(sl.x, sl.y, t_all, sl.valid_mask(), np.ones(n_slices, bool))

    def canon(alive, nn, mu, cen, dig):
        return sorted((int(nn[i]), *cen[i].tolist(), *mu[i].tolist(), int(dig[i]))
                      for i in np.where(alive)[0])

    n_emit = got["run.alive"].shape[1]
    same = sum(canon(*(got[f"run.{f}"][w, s] for f in ("alive", "n", "mu", "centroid",
                                                        "digest")))
               == canon(*(whole[i][w * n_emit + s] for i in (0, 2, 3, 4, 5)))
               for w in range(EXACT_WINDOWS) for s in range(n_emit))
    print(f"temporal --exact on {card}, two Gloo ranks on one card, {EXACT_WINDOWS} windows, "
          f"warm-up {EXACT_WARMUP}: every rank's output bit-equal; each window bit-equal to "
          f"the sequential exact run over its slices from a fresh state (t0 pinned); "
          f"{same} of {EXACT_WINDOWS * n_emit} post-warm-up slices equal the stream-long "
          f"sequential run's canonical cluster sets (a finding at DEFAULT, not a check); "
          f"{int((got['run.cluster_chain'] >= 0).sum())} chained slots; per rank ms/slice of "
          f"the window loop "
          f"{[round((float(r['wall_ms']) - float(r['fusion_ms'])) / s_win, 3) for r in ranks]}"
          f", fusion ms "
          f"{[round(float(r['fusion_ms']), 3) for r in ranks]}, collective calls "
          f"{[(int(r['calls.all_gather']), int(r['calls.all_reduce'])) for r in ranks]}, "
          f"exact launches per rank {[int(r['launches.aeclustering_exact']) for r in ranks]}; "
          f"spawn and run {spawn_s:.1f} s; phase 14 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from evflow_tpu_torch import DEFAULT, fidelity, interop, io, kernels
    from evflow_tpu_torch.models import aeclustering as ae, aeclustering_kernel as aek
    from evflow_tpu_torch.models import fastcluster, pipeline
    from evflow_tpu_torch.ops import cluster_kernels as ck, efast, sae as sae_ops

    dev = torch.device("cuda")
    cfg = DEFAULT
    cfg_q8 = dataclasses.replace(cfg, efast=dataclasses.replace(cfg.efast, micro_slices=8))
    cfg_plain_exact = dataclasses.replace(
        cfg, cluster=dataclasses.replace(cfg.cluster, exact_pallas=False))
    n = cfg.slicing.n_events
    h, w = cfg.sensor.height, cfg.sensor.width

    # ---- 1. card and build
    card = card_line()
    print(card, flush=True)
    t = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    build_s = time.perf_counter() - t
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    print(f"build: {so.name} in {build_s:.1f} s; ptxas: {' | '.join(ptxas)}", flush=True)

    stream = io.synthetic.moving_blob_stream(
        num_slices=N_SLICES, events_per_slice=n,
        blob_centers=((200.0, 200.0), (900.0, 500.0), (600.0, 150.0)),
        velocities=((30.0, 10.0), (-20.0, 15.0), (5.0, -12.0)),
        sigma=12.0, seed=SEED)
    sl = io.slice_by_count(stream, n, drop_partial=True)
    ts_np = (sl.t - int(stream.t[0])).astype(np.int32)
    xs, ys, ts, vs = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                      for a in (sl.x, sl.y, ts_np, sl.valid_mask()))

    # ---- 2. each kernel against its plain version, on real inputs
    cl = fastcluster.init_state(cfg.cluster, device=dev)
    co = pipeline.init_corner_state(cfg, device=dev)
    for s in range(3):
        cl, _ = pipeline.cluster_flow_step(cl, xs[s], ys[s], vs[s], cfg)
        co, _ = pipeline.corner_track_step(co, xs[s], ys[s], ts[s], vs[s], cfg)
    s = 3
    x, y, tt, v = xs[s], ys[s], ts[s], vs[s]
    new_sae = sae_ops.update_sae(co.sae, x, y, tt, v)
    cx, cy, cvalid, _ = (a[0] for a in pipeline.representative_candidates(
        x[None], y[None], v[None], cfg.efast.max_candidates, cfg))
    band = efast._pick_band(h)
    act = efast.tile_activity(cy, cvalid, h, w, band, cx)
    ones = torch.ones_like(act)
    results = {}
    for label, a in (("activity", act), ("all-ones", ones)):
        got = efast.corner_mask_stencil(new_sae, a, cfg.efast, cfg.sensor, band)
        want = efast.corner_mask_stencil_plain(new_sae, a, cfg.efast, cfg.sensor, band)
        torch.cuda.synchronize()
        err = (got.to(torch.int32) - want.to(torch.int32)).abs().max()
        assert int(err) == 0, f"efast_stencil ({label}): {int((got != want).sum())} pixels differ"
    corners_full = int(want.sum())
    results["efast_stencil"] = dict(max_abs_err=float(err), **timed(
        lambda: efast.corner_mask_stencil(new_sae, act, cfg.efast, cfg.sensor, band),
        lambda: efast.corner_mask_stencil_plain(new_sae, act, cfg.efast, cfg.sensor, band)))

    def all_tiles():
        return efast.corner_mask_stencil(new_sae, ones, cfg.efast, cfg.sensor, band)

    results["efast_stencil"].update(all_tiles_ms=cuda_ms(all_tiles),
                                    all_tiles_device_ms=device_ms(all_tiles))

    # the ring test on the q=8 path's first sub-slice of slice 3: its
    # surface and its max(cap // 8, 64) representative candidates
    nsub, m_sub = n // 8, max(cfg.efast.max_candidates // 8, 64)
    sub_sae = sae_ops.update_sae(co.sae, x[:nsub], y[:nsub], tt[:nsub], v[:nsub])
    rcx, rcy, rcv, _ = (a[0] for a in pipeline.representative_candidates(
        x[None, :nsub], y[None, :nsub], v[None, :nsub], m_sub, cfg))
    ring_args = (sub_sae[None], rcx[None], rcy[None], rcv[None], cfg.efast, cfg.sensor)
    got = efast._ring_test(*ring_args)
    want = efast._ring_test_plain(*ring_args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"efast_ring: {int((got != want).sum())} lanes differ"
    ring_corners = int(want.sum())
    results["efast_ring"] = dict(max_abs_err=0.0, **timed(
        lambda: efast._ring_test(*ring_args), lambda: efast._ring_test_plain(*ring_args)))

    radius = cfg.cluster.radius
    lab_k, dist_k = ck.assign_manhattan(x, y, cl.mu, cl.alive, radius)
    lab_p, dist_p = ck.assign_manhattan_plain(x, y, cl.mu, cl.alive, radius)
    torch.cuda.synchronize()
    assert int(cl.alive.sum()) > 0, "no live clusters to assign to"
    assert torch.equal(lab_k, lab_p), "assign_manhattan: labels differ"
    assert torch.equal(dist_k, dist_p), "assign_manhattan: distances differ"
    finite = torch.isfinite(dist_p)
    results["assign_manhattan"] = dict(
        max_abs_err=float((dist_k[finite] - dist_p[finite]).abs().max()), **timed(
            lambda: ck.assign_manhattan(x, y, cl.mu, cl.alive, radius),
            lambda: ck.assign_manhattan_plain(x, y, cl.mu, cl.alive, radius)))

    labels = torch.where(v, lab_k, -1)
    px, py = x.to(torch.float32), y.to(torch.float32)
    c, alpha = cfg.cluster.max_clusters, cfg.cluster.alpha
    st_k = ck.cluster_stats(labels, px, py, alpha, c)
    st_p = ck.cluster_stats_plain(labels, px, py, alpha, c)
    torch.cuda.synchronize()
    assert torch.equal(st_k[:, 0], st_p[:, 0]), "cluster_stats: counts differ"
    torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=1e-3)
    st_again = ck.cluster_stats(labels, px, py, alpha, c)
    torch.cuda.synchronize()
    assert torch.equal(st_k, st_again), "cluster_stats: two calls differ"
    results["cluster_stats"] = dict(max_abs_err=float((st_k - st_p).abs().max()), **timed(
        lambda: ck.cluster_stats(labels, px, py, alpha, c),
        lambda: ck.cluster_stats_plain(labels, px, py, alpha, c)))
    # the tiled update's form: ranks continue into later tiles' members (up
    # to 40 of them, so a cluster's newest members keep weights above the
    # clamp at exponent 80)
    k_after = torch.as_tensor(np.random.default_rng(SEED).integers(0, 40, c).astype(np.int32),
                              device=dev)
    st_ka = ck.cluster_stats(labels, px, py, alpha, c, k_after)
    st_pa = ck.cluster_stats_plain(labels, px, py, alpha, c, k_after)
    torch.cuda.synchronize()
    assert torch.equal(st_ka[:, 0], st_pa[:, 0]), "cluster_stats (k_after): counts differ"
    torch.testing.assert_close(st_ka, st_pa, rtol=1e-5, atol=1e-3)
    results["cluster_stats"].update(max_abs_err_k_after=float((st_ka - st_pa).abs().max()), **{
        f"k_after_{k}": v for k, v in timed(
            lambda: ck.cluster_stats(labels, px, py, alpha, c, k_after),
            lambda: ck.cluster_stats_plain(labels, px, py, alpha, c, k_after)).items()})
    print(f"kernels vs plain: efast mask bit-equal ({corners_full} corner pixels, "
          f"{int(act.sum())}/{act.numel()} tiles active), efast_ring bit-equal "
          f"({ring_corners} corners of {int(rcv.sum())} candidates of {m_sub} lanes), "
          f"assign_manhattan "
          f"bit-equal ({int((lab_k >= 0).sum())} assigned, {int(cl.alive.sum())} clusters "
          f"alive), cluster_stats counts exact, max |err| "
          f"{results['cluster_stats']['max_abs_err']:.3g} (with k_after "
          f"{results['cluster_stats']['max_abs_err_k_after']:.3g}), bit-equal over two calls "
          f"({int((st_k[:, 0] > 0).sum())} clusters with members)", flush=True)

    # the exact engine: 3 slices with the kernel, then 2 more from that state
    # once with the kernel and once with the plain version, both on the card
    lanes, cum = [], None
    for s in range(3 + EXACT_PLAIN_SLICES):
        ln, cum = pipeline.exact_engine_lanes(xs[s], ys[s], ts[s], vs[s], cfg, cum)
        lanes.append(ln)
    ae0 = ae.init_state(cfg.cluster, device=dev)
    for s in range(3):
        ae0 = aek.update_slice_kernel(ae0, *lanes[s], cfg.cluster)
    ae_k = ae_p = ae0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for s in range(3, 3 + EXACT_PLAIN_SLICES):
        ae_p = ae.update_slice(ae_p, *lanes[s], cfg.cluster)
    end.record()
    torch.cuda.synchronize()
    plain_exact_ms = start.elapsed_time(end) / EXACT_PLAIN_SLICES
    for s in range(3, 3 + EXACT_PLAIN_SLICES):
        ae_k = aek.update_slice_kernel(ae_k, *lanes[s], cfg.cluster)
    torch.cuda.synchronize()
    interop.assert_trees_close(ae_k, ae_p, **EXACT_TOL, what="aeclustering_exact")
    mu_err = float((ae_k.mu - ae_p.mu).abs().max())
    n_lanes = [int(ln[4].sum()) for ln in lanes]
    def exact_call():
        return aek.update_slice_kernel(ae0, *lanes[3], cfg.cluster)

    results["aeclustering_exact"] = dict(
        max_abs_err=mu_err, ms=cuda_ms(exact_call), plain_ms=plain_exact_ms,
        device_ms=device_ms(exact_call))
    bounds = kernel_bounds(new_sae, act, band, cfg, x, cl.alive, ae0, lanes[3], c)
    bounds["efast_ring"] = bound(
        154 * m_sub, 0, 0, f"{m_sub} lanes: x, y, valid read, 36 int32 ring samples "
        "gathered, the mask written; the scan's operations depend on the data")
    for name, (blocks, threads, size) in launch_grids(h, w, band, n, m_sub).items():
        bounds[name]["grid"] = (blocks, threads, size)
        bounds[name]["launch_floor_ms"] = device_ms(
            lambda: kernels.launch_floor(blocks, threads, size))
    # the all-ones map launches the same grid, so its floor is the same
    all_tiles_bound = stencil_bound(new_sae, ones, band, cfg)
    print(f"exact engine vs plain, slices 3-4 from the same state: every AEState "
          f"field bit-equal, mu included; unique lanes per slice {n_lanes}; live clusters "
          f"{int(ae_k.alive.sum())}, overflow {int(ae_k.overflow)}, members "
          f"{int((ae_k.mcid >= 0).sum())}", flush=True)

    def teacher_forced(c, slices):
        """The card's full_scan step against a plain CPU step from the same
        input state, slice by slice."""
        cl = fastcluster.init_state(c.cluster, device=dev)
        co = pipeline.init_corner_state(c, device=dev)
        for s in range(max(slices) + 1):
            cl_n, clo_s = pipeline.cluster_flow_step(cl, xs[s], ys[s], vs[s], c)
            co_n, coo_s = pipeline.corner_track_step(co, xs[s], ys[s], ts[s], vs[s], c)
            if s in slices:
                cpu = [t.cpu() for t in (xs[s], ys[s], ts[s], vs[s])]
                cl_cn, clo_c = pipeline.cluster_flow_step(to_host(cl), cpu[0], cpu[1],
                                                          cpu[3], c)
                co_cn, coo_c = pipeline.corner_track_step(to_host(co), *cpu, c)
                interop.assert_trees_close((cl_n, clo_s), (cl_cn, clo_c), **CLUSTER_TOL,
                                           what=f"slice {s} cluster")
                interop.assert_trees_close((co_n, coo_s), (co_cn, coo_c), **TRACK_TOL,
                                           what=f"slice {s} corner")
            cl, co = cl_n, co_n

    def counted_full_scan(c, path_kernels):
        """full_scan over all slices with the launch counts zeroed just
        before and read just after; each kernel of the path must run."""
        cl0 = fastcluster.init_state(c.cluster, device=dev)
        co0 = pipeline.init_corner_state(c, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        (cl, co), (clo, coo) = pipeline.full_scan(cl0, co0, xs, ys, ts, vs, c)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        for name in path_kernels:
            assert launches[name] >= N_SLICES, f"{name}: {launches[name]} launches"
        corners = coo.num_corners.cpu()
        assert int(corners[0]) == 0 and bool((corners[1:] > 0).all()), corners.tolist()
        n_reported = clo.reported.sum(1).cpu()
        assert bool((n_reported > 0).all()), n_reported.tolist()
        for name, leaf in interop.named_leaves(((cl, co), (clo, coo))):
            assert leaf.dtype.kind != "f" or np.isfinite(leaf).all(), f"non-finite {name}"
        assert bool((coo.num_filtered <= coo.num_corners).all())
        return launches, corners, coo.num_filtered.cpu(), n_reported, ((cl, co), (clo, coo))

    # ---- 3. the main path, counted
    launches, corners, filtered, n_reported, _ = counted_full_scan(
        cfg, ("efast_stencil", "assign_manhattan", "cluster_stats", "rep_candidates"))
    assert launches["rep_candidates"] == N_SLICES, launches
    teacher_forced(cfg, range(1, 5))
    print(f"main path: launches {launches} over {N_SLICES} slices; corners/slice "
          f"{corners.tolist()}; filtered {filtered.tolist()}; "
          f"clusters reported {n_reported.tolist()}; slices 1-4 match a plain CPU "
          f"step", flush=True)

    # ---- 4. the exact path, counted
    ex0 = pipeline.ClusterFlowPipeline(cfg, mode="exact", device=dev).init_state()
    torch.cuda.synchronize()
    kernels.reset_launches()
    ex_final, exo = pipeline.cluster_flow_scan_exact(ex0, xs, ys, ts, vs, cfg)
    torch.cuda.synchronize()
    launches_exact = dict(kernels.LAUNCHES)
    assert launches_exact["aeclustering_exact"] >= N_SLICES, launches_exact
    ex_reported = exo.reported.sum(1).cpu()
    assert bool((ex_reported > 0).all()), ex_reported.tolist()
    for name, leaf in interop.named_leaves((ex_final, exo)):
        assert leaf.dtype.kind != "f" or np.isfinite(leaf).all(), f"non-finite {name}"
    st = ex0
    for s in range(3):
        one = [a[s:s + 1] for a in (xs, ys, ts, vs)]
        st_n, out = pipeline.cluster_flow_scan_exact(st, *one, cfg)
        if s >= 1:
            want = pipeline.cluster_flow_scan_exact(to_host(st), *[a.cpu() for a in one], cfg)
            interop.assert_trees_close((st_n, out), want, **EXACT_TOL,
                                       what=f"exact slice {s}")
        st = st_n
    print(f"exact path: launches {launches_exact} over {N_SLICES} slices; clusters "
          f"reported {ex_reported.tolist()}; unique/slice "
          f"{exo.unique_count.cpu().tolist()}; overflow {int(ex_final[0].overflow)}; "
          f"slices 1-2 match a plain CPU step", flush=True)

    # ---- 5. full_scan at q=8, counted
    launches_q8, corners_q8, filtered_q8, reported_q8, scan_q8 = counted_full_scan(
        cfg_q8, ("efast_ring", "assign_manhattan", "cluster_stats", "rep_candidates"))
    assert launches_q8["efast_ring"] == 8 * N_SLICES, launches_q8
    assert launches_q8["rep_candidates"] == N_SLICES, launches_q8
    teacher_forced(cfg_q8, range(1, 5))
    print(f"q=8 path: launches {launches_q8} over {N_SLICES} slices; corners/slice "
          f"{corners_q8.tolist()}; filtered {filtered_q8.tolist()}; clusters "
          f"reported {reported_q8.tolist()}; slices 1-4 match a plain CPU step",
          flush=True)

    # ---- 6. corner agreement with per-event-exact detection
    agreement = {q: fidelity.corner_agreement(q, device=dev) for q in (8, 1)}
    for q, a in agreement.items():
        assert a == fidelity.JAX_AGREEMENT[q], (q, a, fidelity.JAX_AGREEMENT[q])
    print("corner agreement with per-event-exact detection: " + ", ".join(
        f"q={q} {a!r} (JAX package {fidelity.JAX_AGREEMENT[q]!r})"
        for q, a in agreement.items()), flush=True)

    # ---- 7. times
    def run_ms(c) -> float:
        cl0 = fastcluster.init_state(c.cluster, device=dev)
        co0 = pipeline.init_corner_state(c, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipeline.full_scan(cl0, co0, xs, ys, ts, vs, c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / N_SLICES

    @contextlib.contextmanager
    def plain_versions():
        saved = (efast.corner_mask_stencil, efast._ring_test, ck.assign_manhattan,
                 ck.cluster_stats, pipeline.representative_candidates)
        efast.corner_mask_stencil = efast.corner_mask_stencil_plain
        efast._ring_test = efast._ring_test_plain
        ck.assign_manhattan = ck.assign_manhattan_plain
        ck.cluster_stats = ck.cluster_stats_plain
        pipeline.representative_candidates = pipeline.representative_candidates_plain
        try:
            yield
        finally:
            (efast.corner_mask_stencil, efast._ring_test, ck.assign_manhattan,
             ck.cluster_stats, pipeline.representative_candidates) = saved

    scan_ms = {}
    for label, c in (("q=1", cfg), ("q=8", cfg_q8)):
        times = {"kernels": [], "plain": []}
        for mode in ("plain", "kernels", "kernels", "plain"):
            with plain_versions() if mode == "plain" else contextlib.nullcontext():
                run_ms(c)   # warm-up of this mode
                times[mode].append(run_ms(c))
        scan_ms[label] = (np.mean(times["kernels"]), np.mean(times["plain"]), times)

    def exact_ms(c, k: int) -> float:
        st = pipeline.ClusterFlowPipeline(c, mode="exact", device=dev).init_state()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipeline.cluster_flow_scan_exact(st, xs[:k], ys[:k], ts[:k], vs[:k], c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / k

    exact_kernel_ms = [exact_ms(cfg, N_SLICES) for _ in range(2)]
    exact_plain_ms = exact_ms(cfg_plain_exact, EXACT_PLAIN_SLICES)
    print(f"ms/slice on {card}: " + "; ".join(
        f"full_scan {label} kernels {k:.3f} ({t['kernels']}), plain {p:.3f} "
        f"({t['plain']}), {n / k * 1e3:.0f} events/s with kernels"
        for label, (k, p, t) in scan_ms.items())
        + f"; exact path kernel {exact_kernel_ms} over {N_SLICES} slices, plain "
        f"{exact_plain_ms:.3f} over {EXACT_PLAIN_SLICES}; per kernel ms per eager call "
        "(plain; device ms by graph replay; host ms = eager - device): "
        + ", ".join(f"{k} {r['ms']:.4f} ({r['plain_ms']:.4f}; {r['device_ms']:.4f}; "
                    f"{r['ms'] - r['device_ms']:.4f})" for k, r in results.items()),
        flush=True)
    ka = results["cluster_stats"]
    print(f"cluster_stats with a nonzero k_after on {card}: {ka['k_after_ms']:.4f} ms per eager "
          f"call, {ka['k_after_device_ms']:.4f} device (without: {ka['ms']:.4f}, "
          f"{ka['device_ms']:.4f}), plain {ka['k_after_plain_ms']:.4f}", flush=True)
    print("bounds: " + "; ".join(f"{k} {b['bound_ms']:.6f} ms by {b['bound_by']} "
                                 f"({b['bound_basis']}), launch floor "
                                 f"{b['launch_floor_ms']:.6f} ms at grid {b['grid']}"
                                 for k, b in bounds.items())
          + f"; aeclustering_exact latency floor "
          f"{bounds['aeclustering_exact']['latency_floor_ms']:.6f} ms ({n_lanes[3]} events x "
          f"{EXACT_CHAIN_CYCLES} cycles at {SM_CLOCK_HZ / 1e9:.2f} GHz); efast_stencil on "
          f"the all-ones map: {results['efast_stencil']['all_tiles_ms']:.4f} ms eager, "
          f"{results['efast_stencil']['all_tiles_device_ms']:.5f} device, bound "
          f"{all_tiles_bound['bound_ms']:.6f} ms by {all_tiles_bound['bound_by']} "
          f"({all_tiles_bound['bound_basis']})", flush=True)

    # ---- 8. the snapshot-stack q=8 path, counted
    cfg_stack = dataclasses.replace(cfg_q8, efast=dataclasses.replace(cfg_q8.efast,
                                                                      micro_stack=True))
    launches_st, corners_st, _, reported_st, scan_st = counted_full_scan(
        cfg_stack, ("efast_ring", "assign_manhattan", "cluster_stats", "rep_candidates"))
    assert launches_st["efast_ring"] == launches_st["rep_candidates"] == N_SLICES, launches_st
    interop.assert_trees_close(scan_st, scan_q8, **EXACT_TOL, what="stack vs serial q=8")
    teacher_forced(cfg_stack, range(1, 5))
    agreement_st = fidelity.corner_agreement(8, device=dev, stack=True)
    assert agreement_st == fidelity.JAX_AGREEMENT[8], (agreement_st, fidelity.JAX_AGREEMENT[8])
    stack_ms = {"serial": [], "stack": []}
    for label, c in (("serial", cfg_q8), ("stack", cfg_stack), ("stack", cfg_stack),
                     ("serial", cfg_q8)):
        run_ms(c)   # warm-up
        stack_ms[label].append(run_ms(c))
    print(f"micro_stack q=8 on {card}: launches {launches_st} over {N_SLICES} slices; "
          f"corners/slice {corners_st.tolist()}; clusters reported {reported_st.tolist()}; "
          f"every state and output leaf bit-equal to the serial q=8 run; slices 1-4 match a "
          f"plain CPU step; corner agreement {agreement_st!r} (JAX package "
          f"{fidelity.JAX_AGREEMENT[8]!r}); ms/slice in the order serial, stack, stack, "
          f"serial: serial {stack_ms['serial']}, stack {stack_ms['stack']}", flush=True)

    # ---- 8b. the representative candidates' kernel on slice 3
    rep_candidates_entry = rep_candidates_phase(
        dev, card, xs[3], ys[3], vs[3], cfg, path_launches=launches_q8["rep_candidates"])

    # ---- 9-12. k-means, DBSCAN, the point-cloud chain, OPTICS
    print(kmeans_phase(dev, card, xs[3], ys[3], vs[3]), flush=True)
    print(dbscan_phase(dev, card, xs[3], ys[3], vs[3], cfg), flush=True)
    dbscan_eps_entry = dbscan_eps_phase(dev, card, xs, ys, ts, vs, cfg)
    print(pointcloud_phase(dev, card), flush=True)
    optics_phase(dev, card, xs[3], ys[3], vs[3], cfg)

    # ---- 13. the CLI
    cli_phase(card, stream, n)

    # ---- 14. the spatio-temporal layer
    temporal_phase(card, stream, n)

    sources = {"efast_stencil": ("evflow_tpu_torch/csrc/efast_stencil.cu",
                                 "evflow_tpu/ops/efast.py:397"),
               "efast_ring": ("evflow_tpu_torch/csrc/efast_ring.cu",
                              "none (evflow_tpu/ops/efast.py:detect_corners is plain XLA)"),
               "assign_manhattan": ("evflow_tpu_torch/csrc/assign_manhattan.cu",
                                    "evflow_tpu/ops/pallas_kernels.py:52"),
               "cluster_stats": ("evflow_tpu_torch/csrc/cluster_stats.cu",
                                 "evflow_tpu/ops/pallas_kernels.py:170"),
               "aeclustering_exact": ("evflow_tpu_torch/csrc/aeclustering_exact.cu",
                                      "evflow_tpu/models/aeclustering_pallas.py:221")}
    path_launches = dict(launches, aeclustering_exact=launches_exact["aeclustering_exact"],
                         efast_ring=launches_q8["efast_ring"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": path_launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "device_ms": r["device_ms"], "bound_ms": bounds[name]["bound_ms"],
         "bound_by": bounds[name]["bound_by"], "library_ms": None,
         "launch_floor_ms": bounds[name]["launch_floor_ms"],
         **({"latency_floor_ms": bounds[name]["latency_floor_ms"]}
            if "latency_floor_ms" in bounds[name] else {}),
         **({"all_tiles_ms": r["all_tiles_ms"], "all_tiles_device_ms": r["all_tiles_device_ms"],
             "all_tiles_bound_ms": all_tiles_bound["bound_ms"],
             "all_tiles_launch_floor_ms": bounds[name]["launch_floor_ms"]}
            if name == "efast_stencil" else {}),
         **{k: v for k, v in r.items() if k.startswith(("k_after_", "max_abs_err_k"))}}
        for name, r in results.items()] + [rep_candidates_entry, dbscan_eps_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
