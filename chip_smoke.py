#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (evflow_tpu_torch) on one NVIDIA GPU.

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the nvcc build of the
     kernels in evflow_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and on real inputs (a few slices into the stream below);
  3. the port's main path, pipeline.full_scan at the DEFAULT configuration
     (1280x720 SAE, 16384 events per slice, 128 clusters, 8192 eFAST
     candidates, NMS capacity 512, 256 tracks) over a 32-slice three-blob
     moving stream: every kernel's launch count must rise on that run,
     corners must appear from slice 1 on and clusters be reported, and for
     4 slices the card's step is held against a plain step on the CPU from
     the same input state;
  4. ms/slice of the main path with the kernels and with their plain
     versions on the card, each kernel's time beside its plain version's.
Then one JSON line of per-kernel results and, last, the status line
{"ok": true, "device": {...}}.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It exits nonzero on any failure, and at once when no CUDA device is found.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_SLICES = 32
SEED = 42


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` calls after a warm-up, by CUDA
    events."""
    for _ in range(3):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from evflow_tpu_torch import DEFAULT, interop, io, kernels
    from evflow_tpu_torch.models import fastcluster, pipeline
    from evflow_tpu_torch.ops import cluster_kernels as ck, efast, sae as sae_ops

    dev = torch.device("cuda")
    cfg = DEFAULT
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

    # ---- 3. the main path, counted
    cl0 = fastcluster.init_state(cfg.cluster, device=dev)
    co0 = pipeline.init_corner_state(cfg, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    (cl, co), (clo, coo) = pipeline.full_scan(cl0, co0, xs, ys, ts, vs, cfg)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name, count in launches.items():
        assert count >= N_SLICES, f"{name}: {count} launches over {N_SLICES} slices"
    corners = coo.num_corners.cpu()
    assert int(corners[0]) == 0 and bool((corners[1:] > 0).all()), corners.tolist()
    n_reported = clo.reported.sum(1).cpu()
    assert bool((n_reported > 0).all()), n_reported.tolist()
    for name, leaf in interop.named_leaves(((cl, co), (clo, coo))):
        assert leaf.dtype.kind != "f" or np.isfinite(leaf).all(), f"non-finite {name}"
    assert bool((coo.num_filtered <= coo.num_corners).all())

    # teacher-forced: the card's step against a plain CPU step from the
    # same input state, slice by slice
    cl, co = cl0, co0
    for s in range(5):
        cl_n, clo_s = pipeline.cluster_flow_step(cl, xs[s], ys[s], vs[s], cfg)
        co_n, coo_s = pipeline.corner_track_step(co, xs[s], ys[s], ts[s], vs[s], cfg)
        if s >= 1:
            cpu = [t.cpu() for t in (xs[s], ys[s], ts[s], vs[s])]
            cl_c = type(cl)(*[t.cpu() for t in cl])
            co_c = pipeline.CornerTrackState(
                co.sae.cpu(), type(co.tracks)(*[t.cpu() for t in co.tracks]),
                co.slice_idx.cpu())
            cl_cn, clo_c = pipeline.cluster_flow_step(cl_c, cpu[0], cpu[1], cpu[3], cfg)
            co_cn, coo_c = pipeline.corner_track_step(co_c, *cpu, cfg)
            interop.assert_trees_close((cl_n, clo_s), (cl_cn, clo_c), **CLUSTER_TOL,
                                       what=f"slice {s} cluster")
            interop.assert_trees_close((co_n, coo_s), (co_cn, coo_c), **TRACK_TOL,
                                       what=f"slice {s} corner")
        cl, co = cl_n, co_n
    print(f"main path: launches {launches} over {N_SLICES} slices; corners/slice "
          f"{corners.tolist()}; filtered {coo.num_filtered.cpu().tolist()}; "
          f"clusters reported {n_reported.tolist()}; slices 1-4 match a plain CPU "
          f"step", flush=True)

    # ---- 4. times
    def run_ms() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipeline.full_scan(cl0, co0, xs, ys, ts, vs, cfg)
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

    times = {"kernels": [], "plain": []}
    for mode in ("plain", "kernels", "kernels", "plain"):
        with plain_versions() if mode == "plain" else contextlib.nullcontext():
            run_ms()   # warm-up of this mode
            times[mode].append(run_ms())
    ms_k, ms_p = np.mean(times["kernels"]), np.mean(times["plain"])
    print(f"full_scan ms/slice on {card}: kernels {ms_k:.3f} "
          f"({times['kernels']}), plain {ms_p:.3f} ({times['plain']}); "
          f"{n / ms_k * 1e3:.0f} events/s with kernels; per kernel ms (plain ms): "
          + ", ".join(f"{k} {r['ms']:.4f} ({r['plain_ms']:.4f})" for k, r in results.items()),
          flush=True)

    sources = {"efast_stencil": ("evflow_tpu_torch/csrc/efast_stencil.cu",
                                 "evflow_tpu/ops/efast.py:397"),
               "assign_manhattan": ("evflow_tpu_torch/csrc/assign_manhattan.cu",
                                    "evflow_tpu/ops/pallas_kernels.py:52"),
               "cluster_stats": ("evflow_tpu_torch/csrc/cluster_stats.cu",
                                 "evflow_tpu/ops/pallas_kernels.py:170")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name], **r}
        for name, r in results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
