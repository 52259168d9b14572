#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (evflow_tpu_torch) on one NVIDIA GPU.

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the nvcc build of the
     kernels in evflow_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and on real inputs (a few slices into the stream below):
     the eFAST stencil, the two fastcluster kernels, and the exact
     AEClustering engine (2 DEFAULT slices from the same state, every
     AEState field equal);
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
     version (2 slices), and each kernel's time beside its plain version's.
Then one JSON line of per-kernel results and, last, the status line
{"ok": true, "device": {...}}. A kernel's `launches` is its count over the
path it belongs to (full_scan at q=1, or the exact path).

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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() over `reps` calls after `warm` warm-up
    calls, by CUDA events."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# cluster floats: fp order of the weighted sums; tracker floats: order of
# norms and small sums (the CPU parity tests state the same tolerances)
CLUSTER_TOL = dict(rtol=1e-5, atol=1e-3)
TRACK_TOL = dict(rtol=1e-5, atol=1e-4)
# exact engine and exact path: every field bit-equal, mu included (the
# kernel spells out each f32 rounding of its plain version)
EXACT_TOL = dict(rtol=0, atol=0)


def to_host(tree):
    """A state or output tree of tensors, copied to the CPU."""
    if isinstance(tree, tuple):
        parts = [to_host(t) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree.cpu()


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
             if "registers" in ln or "Compiling entry" in ln]
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
    cx, cy, cvalid, _ = pipeline._representative_candidates(
        x, y, v, cfg.efast.max_candidates, cfg)
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
    results["efast_stencil"] = dict(
        max_abs_err=float(err),
        ms=cuda_ms(lambda: efast.corner_mask_stencil(new_sae, act, cfg.efast, cfg.sensor, band)),
        plain_ms=cuda_ms(lambda: efast.corner_mask_stencil_plain(new_sae, act, cfg.efast, cfg.sensor, band)))

    radius = cfg.cluster.radius
    lab_k, dist_k = ck.assign_manhattan(x, y, cl.mu, cl.alive, radius)
    lab_p, dist_p = ck.assign_manhattan_plain(x, y, cl.mu, cl.alive, radius)
    torch.cuda.synchronize()
    assert int(cl.alive.sum()) > 0, "no live clusters to assign to"
    assert torch.equal(lab_k, lab_p), "assign_manhattan: labels differ"
    assert torch.equal(dist_k, dist_p), "assign_manhattan: distances differ"
    finite = torch.isfinite(dist_p)
    results["assign_manhattan"] = dict(
        max_abs_err=float((dist_k[finite] - dist_p[finite]).abs().max()),
        ms=cuda_ms(lambda: ck.assign_manhattan(x, y, cl.mu, cl.alive, radius)),
        plain_ms=cuda_ms(lambda: ck.assign_manhattan_plain(x, y, cl.mu, cl.alive, radius)))

    labels = torch.where(v, lab_k, -1)
    px, py = x.to(torch.float32), y.to(torch.float32)
    c, alpha = cfg.cluster.max_clusters, cfg.cluster.alpha
    st_k = ck.cluster_stats(labels, px, py, alpha, c)
    st_p = ck.cluster_stats_plain(labels, px, py, alpha, c)
    torch.cuda.synchronize()
    assert torch.equal(st_k[:, 0], st_p[:, 0]), "cluster_stats: counts differ"
    torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=1e-3)
    results["cluster_stats"] = dict(
        max_abs_err=float((st_k - st_p).abs().max()),
        ms=cuda_ms(lambda: ck.cluster_stats(labels, px, py, alpha, c)),
        plain_ms=cuda_ms(lambda: ck.cluster_stats_plain(labels, px, py, alpha, c)))
    print(f"kernels vs plain: efast mask bit-equal ({corners_full} corner pixels, "
          f"{int(act.sum())}/{act.numel()} tiles active), assign_manhattan "
          f"bit-equal ({int((lab_k >= 0).sum())} assigned), cluster_stats counts "
          f"exact, max |err| {results['cluster_stats']['max_abs_err']:.3g}", flush=True)

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
    results["aeclustering_exact"] = dict(
        max_abs_err=mu_err,
        ms=cuda_ms(lambda: aek.update_slice_kernel(ae0, *lanes[3], cfg.cluster)),
        plain_ms=plain_exact_ms)
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
        return launches, corners, coo.num_filtered.cpu(), n_reported

    # ---- 3. the main path, counted
    launches, corners, filtered, n_reported = counted_full_scan(
        cfg, ("efast_stencil", "assign_manhattan", "cluster_stats"))
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
    launches_q8, corners_q8, filtered_q8, reported_q8 = counted_full_scan(
        cfg_q8, ("assign_manhattan", "cluster_stats"))
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
        saved = efast.corner_mask_stencil, ck.assign_manhattan, ck.cluster_stats
        efast.corner_mask_stencil = efast.corner_mask_stencil_plain
        ck.assign_manhattan = ck.assign_manhattan_plain
        ck.cluster_stats = ck.cluster_stats_plain
        try:
            yield
        finally:
            efast.corner_mask_stencil, ck.assign_manhattan, ck.cluster_stats = saved

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
        f"{exact_plain_ms:.3f} over {EXACT_PLAIN_SLICES}; per kernel ms (plain ms): "
        + ", ".join(f"{k} {r['ms']:.4f} ({r['plain_ms']:.4f})" for k, r in results.items()),
        flush=True)

    sources = {"efast_stencil": ("evflow_tpu_torch/csrc/efast_stencil.cu",
                                 "evflow_tpu/ops/efast.py:397"),
               "assign_manhattan": ("evflow_tpu_torch/csrc/assign_manhattan.cu",
                                    "evflow_tpu/ops/pallas_kernels.py:52"),
               "cluster_stats": ("evflow_tpu_torch/csrc/cluster_stats.cu",
                                 "evflow_tpu/ops/pallas_kernels.py:170"),
               "aeclustering_exact": ("evflow_tpu_torch/csrc/aeclustering_exact.cu",
                                      "evflow_tpu/models/aeclustering_pallas.py:221")}
    path_launches = dict(launches, aeclustering_exact=launches_exact["aeclustering_exact"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": path_launches[name], **r}
        for name, r in results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
