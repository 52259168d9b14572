"""CLI of the port — one engine, eight reference apps as subcommands
(counterpart of evflow_tpu/run.py, line for line the same output).

Usage:
  python -m evflow_tpu_torch.run cluster-flow   --input ev.csv [--out frames/]   # app E
  python -m evflow_tpu_torch.run async-cluster  --input ev.csv --decimate 256    # app A
  python -m evflow_tpu_torch.run track-estimate --input ev.csv --decimate 512    # app H
  python -m evflow_tpu_torch.run corner-track   --input ev.csv [--out frames/]   # app G
  python -m evflow_tpu_torch.run kmeans         [--n 2048]                       # app D
  python -m evflow_tpu_torch.run sampling       --input ev.csv                   # app F
  python -m evflow_tpu_torch.run optics         --input ev.csv [--eps 10] [--slice-events N]  # app B
  python -m evflow_tpu_torch.run dbscan         --input ev.csv [--eps 20] [--per-slice]  # app C
  python -m evflow_tpu_torch.run temporal       --input ev.csv [--windows 2 --tiles 4 | --exact]

Every subcommand runs on the card (`--device cuda`, the default) unless
`--device cpu` is given, before or after the subcommand; with no card,
`--device cuda` exits with an error. Under torchrun (WORLD_SIZE > 1) the
process group is initialized from the environment (NCCL on the card, Gloo
on the CPU), each rank takes the card of its LOCAL_RANK, the `--sharded`
paths split their rows over the ranks, and only rank 0 prints. `temporal`
runs one rank per window and tile (per window with --exact): under
torchrun the world must be windows x tiles, and outside it only a 1 x 1
grid runs.

The per-slice subcommands (cluster-flow, track-estimate, corner-track,
temporal, dbscan --per-slice, optics --slice-events) take `--trace DIR`:
the run is recorded with torch.profiler and written to DIR/trace.json as a
Chrome trace, with the program's spans (each slice, module and fixpoint
round, `utils/profiling.py`) on the card's clock.
Under torchrun rank 0 writes DIR/trace.json and rank r DIR/rank<r>/trace.json.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch


def _load(args):
    from .io import load, decimate
    s = load(args.input)
    if getattr(args, "decimate", 0) and args.decimate > 1:
        s = decimate(s, args.decimate)
    return s


def _tensor(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def cmd_cluster_flow(args):
    """App E: hash dedup → clustering → centroid flow (accel …store.cpp)."""
    import dataclasses
    from .config import DEFAULT
    from .models.pipeline import ClusterFlowPipeline
    from .utils import checkpoint as ckpt
    from .utils.plots import render_cluster_frame
    cfg = DEFAULT
    mode = "fast"
    if getattr(args, "exact", False):
        mode = "exact"
        if getattr(args, "fabricated_ts", False):
            cfg = dataclasses.replace(cfg, dedup=dataclasses.replace(
                cfg.dedup, compat_fabricated_ts=True))
    pipe = ClusterFlowPipeline(cfg, mode=mode, device=args.device)
    state = t0 = None
    if args.resume:
        state = ckpt.restore_npz(args.resume, pipe.init_state())
        if mode == "exact":
            meta = ckpt.load_meta(args.resume)
            if "t0" not in meta:
                sys.exit("error: checkpoint was not saved in exact mode "
                         "(missing t0 meta) — resume it without --exact, or "
                         "re-save the checkpoint from an exact-mode run")
            t0 = int(meta["t0"])
    outs = pipe.run(_load(args), state=state, t0=t0)
    if args.checkpoint:
        meta = {"t0": pipe.t0} if mode == "exact" else None
        ckpt.save_npz(args.checkpoint, pipe.final_state, meta=meta)
        print(f"checkpoint saved: {args.checkpoint}")
    for i, out in enumerate(outs):
        rep = np.asarray(out.reported)
        print(f"slice {i}: unique={int(out.unique_count)} "
              f"clusters={int(rep.sum())}")
        for c in np.where(rep)[0]:
            cen = np.asarray(out.centroid)[c]
            fl = np.asarray(out.flow)[c]
            print(f"  cid={int(np.asarray(out.cid)[c])} n={int(np.asarray(out.n)[c])} "
                  f"centroid=({cen[0]:.2f},{cen[1]:.2f}) flow=({fl[0]:.2f},{fl[1]:.2f})")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            img = render_cluster_frame(cfg.sensor.width, cfg.sensor.height, out)
            img.save(os.path.join(args.out, f"cluster_frame_combined{i}"))


def cmd_async_cluster(args):
    """App A: decimated stream → AEClustering (exact engine), the whole
    stream as one slice: on the card, one launch of the exact kernel."""
    from .config import ClusterConfig
    from .models import aeclustering as ae
    from .models.aeclustering_kernel import update_slice_kernel
    s = _load(args)
    cfg = ClusterConfig.async_app()
    dev = args.device
    st = ae.init_state(cfg, device=dev)
    n = len(s)
    t = (s.t - s.t[0]).astype(np.int32)
    st = update_slice_kernel(st, _tensor(s.x, dev), _tensor(s.y, dev), _tensor(t, dev),
                             _tensor(s.p, dev), torch.ones(n, dtype=torch.bool, device=dev),
                             cfg)
    view = ae.snapshot(st, cfg)
    alive = view.alive.cpu().numpy()
    vn, vcid, vcent = view.n.cpu().numpy(), view.cid.cpu().numpy(), view.centroid.cpu().numpy()
    print(f"events={n} clusters={int(alive.sum())}")
    for i in np.where(alive)[0]:
        if int(vn[i]) >= cfg.min_n:
            c = vcent[i]
            print(f"  cid={int(vcid[i])} n={int(vn[i])} "
                  f"centroid=({c[0]:.2f},{c[1]:.2f})")


def cmd_track_estimate(args):
    """App H: 1/512 decimation → clustering → ×3 extrapolated flow arrows."""
    import dataclasses
    from .config import DEFAULT, ClusterConfig, FlowConfig
    from .models.pipeline import ClusterFlowPipeline
    cfg = dataclasses.replace(DEFAULT, cluster=ClusterConfig.tracking_app(),
                              flow=FlowConfig(extrapolation=3.0))
    pipe = ClusterFlowPipeline(cfg, device=args.device)
    outs = pipe.run(_load(args))
    for i, out in enumerate(outs):
        rep = np.asarray(out.reported)
        arrows = [(np.asarray(out.centroid)[c].tolist(),
                   np.asarray(out.flow)[c].tolist()) for c in np.where(rep)[0]]
        print(f"slice {i}: {len(arrows)} velocity arrows "
              + " ".join(f"({a[0][0]:.0f},{a[0][1]:.0f})→+({a[1][0]:.1f},{a[1][1]:.1f})"
                         for a in arrows))


def cmd_corner_track(args):
    """App G: SAE → eFAST → NMS → tracker with groups."""
    from .config import DEFAULT
    from .models.pipeline import CornerTrackPipeline, init_corner_state
    from .utils import checkpoint as ckpt
    cfg = DEFAULT
    pipe = CornerTrackPipeline(cfg, device=args.device)
    state = t0 = None
    if args.resume:
        state = ckpt.restore_npz(args.resume, init_corner_state(cfg, device=args.device))
        t0 = int(ckpt.load_meta(args.resume)["t0"])
    outs = pipe.run(_load(args), state=state, t0=t0)
    if args.checkpoint:
        ckpt.save_npz(args.checkpoint, pipe.final_state, meta={"t0": pipe.t0})
        print(f"checkpoint saved: {args.checkpoint}")
    for i, out in enumerate(outs):
        act = np.asarray(out.track_active)
        ng = int(np.asarray(out.groups.exists).sum())
        print(f"slice {i}: corners={int(out.num_corners)} "
              f"filtered={int(out.num_filtered)} tracks={int(act.sum())} groups={ng}")
        if args.out:
            from .utils.plots import render_track_frame
            os.makedirs(args.out, exist_ok=True)
            img = render_track_frame(cfg.sensor.width, cfg.sensor.height, out)
            img.save(os.path.join(args.out, f"tracked_corners{i}"))


def cmd_kmeans(args):
    """App D: OpenCL k-means on the i%100 synthetic ramp."""
    from .config import KMeansConfig
    from .io import synthetic
    from .models.kmeans import kmeans
    pts = _tensor(synthetic.kmeans_ramp_data(args.n), args.device)
    init = _tensor(synthetic.kmeans_initial_centroids(), args.device)
    if getattr(args, "sharded", False):
        from .parallel.batch import kmeans_sharded
        res = kmeans_sharded(pts, init, cfg=KMeansConfig(), device=args.device)
    else:
        res = kmeans(pts, init, cfg=KMeansConfig())
    print(f"iters={int(res.iters)} error_max={float(res.error_max):.3f}")
    for c, n in zip(res.centroids.cpu().numpy(), res.counts.cpu().numpy()):
        print(f"  ({c[0]:.4f}, {c[1]:.4f}, {int(n)})")


def cmd_sampling(args):
    """App F: standalone downsampling benchmark (per-slice dedup stats)."""
    import time
    from .config import DEFAULT
    from .io import slice_by_count
    from .ops.hash_dedup import dedup_batched
    cfg = DEFAULT
    s = _load(args)
    sl = slice_by_count(s, cfg.slicing.n_events)
    dev = torch.device(args.device)
    x, y, v = (_tensor(a, dev) for a in (sl.x, sl.y, sl.valid_mask()))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res = dedup_batched(x, y, v, cfg.dedup, cfg.sensor)
    sync()
    t0 = time.perf_counter()
    res = dedup_batched(x, y, v, cfg.dedup, cfg.sensor)
    sync()
    dt = time.perf_counter() - t0
    unique, repeated = res.unique_count.cpu().numpy(), res.repeated_count.cpu().numpy()
    for i in range(sl.num_slices):
        print(f"slice {i}: events={int(sl.count[i])} "
              f"unique={int(unique[i])} repeated={int(repeated[i])}")
    total = int(sl.count.sum())
    print(f"Total time = {dt*1e9:.0f} ns  ({total/dt:.0f} events/s)")


def cmd_optics(args):
    """App B: OPTICS reachability clustering + centroid report. With
    --slice-events N: OPTICS of each N-event slice (`pipeline.optics_scan`),
    the report once per slice."""
    from .models import optics
    if args.slice_events:
        if (args.chi > 0 or args.export or args.out or args.method != "auto"
                or args.full_window):
            sys.exit("error: --slice-events splits at --threshold with the table "
                     "optics_slice chooses; it takes no --chi, --export, --out, --method "
                     "or --full-window")
        return _optics_per_slice(args)
    s = _load(args)
    pts = np.stack([s.x, s.y], axis=1).astype(np.float64)
    rd = optics.compute_reachability_dists(
        pts, args.min_pts, args.eps, method=args.method,
        max_neighbors=args.max_neighbors, full_window=args.full_window,
        proj_dims=args.proj_dims, device=args.device)
    if args.chi > 0:
        flat = optics.get_chi_clusters_flat(rd, args.chi, args.min_pts)
        clusters = optics.get_cluster_indices_chi(rd, flat)
    else:
        clusters = optics.get_cluster_indices(rd, args.threshold)
    print(f"Cluster size : {len(clusters)}")
    for j, c in enumerate(clusters):
        p = pts[np.asarray(c, int)]
        print(f"{j},{len(c)},{p[:,0].mean():g},{p[:,1].mean():g},"
              f"{p[:,0].var():g},{p[:,1].var():g}")
    if args.export:
        optics.export_reachability_dists(rd, args.export)
    if args.out:
        # reference app B artifacts: reachability plot (with chi extents when
        # chi extraction ran) + colored 2-D cluster render, as binary PPM
        from .utils import plots
        os.makedirs(args.out, exist_ok=True)
        if args.chi > 0:
            img = plots.draw_reachability_plot_with_chi_clusters(
                rd, args.chi, args.min_pts)
        else:
            img = plots.draw_reachability_plot(rd)
        img.save(os.path.join(args.out, "reachability_plot"))
        pts_per_cluster = [pts[np.asarray(c, int)] for c in clusters]
        plots.draw_2d_clusters(pts_per_cluster).save(
            os.path.join(args.out, "clusters_2d"))


def _optics_per_slice(args):
    from .config import DEFAULT, OpticsConfig
    from .io import slice_by_count
    from .models.pipeline import optics_scan
    dev = args.device
    sl = slice_by_count(_load(args), args.slice_events)
    xs, ys, vs = (_tensor(a, dev) for a in (sl.x, sl.y, sl.valid_mask()))
    cfg = DEFAULT.replace(optics=OpticsConfig(min_pts=args.min_pts, epsilon=args.eps,
                                              max_neighbors=args.max_neighbors))
    state = torch.zeros((), dtype=torch.int32, device=dev)
    _, out = optics_scan(state, xs, ys, None, vs, cfg, args.threshold)
    k, size = out.num_clusters.cpu().numpy(), out.size.cpu().numpy()
    cen, var = out.centroid.cpu().numpy(), out.variance.cpu().numpy()
    for i in range(sl.num_slices):
        print(f"slice {i}: events={int(sl.count[i])}")
        print(f"Cluster size : {int(k[i])}")
        for j in range(int(k[i])):
            print(f"{j},{int(size[i, j])},{cen[i, j, 0]:g},{cen[i, j, 1]:g},"
                  f"{var[i, j, 0]:g},{var[i, j, 1]:g}")


def cmd_dbscan(args):
    """App C: [PCD read → voxel grid → RANSAC plane removal →] DBSCAN →
    CSV/PCD export with per-cluster intensity (pcl_cluster.cpp pipeline).
    With --per-slice, on event input: DBSCAN of each slicing.n_events slice
    (`pipeline.dbscan_scan`), one line per slice and one per cluster."""
    from .config import DBSCANConfig
    from .models.dbscan import dbscan_grid
    from .models.pointcloud import voxel_downsample, ransac_plane, remove_plane
    from .utils import pcd as pcdio
    dev = args.device
    cfg = DBSCANConfig(eps=args.eps, core_min_pts=args.min_pts,
                       min_cluster_size=args.min_cluster_size)
    if args.per_slice:
        if args.input.endswith(".pcd") or args.sharded or args.export:
            sys.exit("error: --per-slice clusters the slices of an event stream on one "
                     "device; it takes no .pcd input, --sharded or --export")
        return _dbscan_per_slice(args, cfg)

    if args.input.endswith(".pcd"):
        pts3, _ = pcdio.load_pcd(args.input)
        if args.voxel > 0:
            vres = voxel_downsample(_tensor(pts3, dev), leaf=args.voxel)
            pts3 = vres.points[vres.valid].cpu().numpy()
            print(f"voxel grid: {len(pts3)} points")
        if args.remove_plane:
            p3 = _tensor(pts3, dev)
            pl = ransac_plane(p3, threshold=args.plane_threshold)
            keep = remove_plane(p3, torch.ones(len(pts3), dtype=torch.bool, device=dev), pl)
            pts3 = pts3[keep.cpu().numpy()]
            print(f"plane removed ({int(pl.num_inliers)} inliers): "
                  f"{len(pts3)} points remain")
        pts = pts3
    else:
        s = _load(args)
        pts = np.stack([s.x, s.y], axis=1).astype(np.float32)
    if getattr(args, "sharded", False):
        # dense row panels split over the process group's ranks
        # (parallel/batch.py; one rank outside torchrun)
        from .parallel.batch import dbscan_sharded
        res = dbscan_sharded(pts, cfg=cfg, device=dev)
    else:
        # grid-bucketed neighbors when they apply (d<=3), dense otherwise
        res = dbscan_grid(pts, cfg=cfg, device=dev)
    labels = res.labels.cpu().numpy()
    print(f"clusters={int(res.num_clusters)}")
    if args.export:
        if args.export.endswith(".pcd"):
            keep = labels >= 0
            p3 = pts[keep] if pts.shape[1] == 3 else np.concatenate(
                [pts[keep], np.zeros((keep.sum(), 1), np.float32)], axis=1)
            pcdio.save_pcd(args.export, p3,
                           (labels[keep] % 8).astype(np.float32))
        else:
            with open(args.export, "w") as f:
                for row, l in zip(pts, labels):
                    f.write(",".join(f"{v}" for v in row) + f",{l}\n")


def _dbscan_per_slice(args, cfg):
    from .config import DEFAULT
    from .io import slice_by_count
    from .models.pipeline import dbscan_scan
    dev = args.device
    sl = slice_by_count(_load(args), DEFAULT.slicing.n_events)
    xs, ys, vs = (_tensor(a, dev) for a in (sl.x, sl.y, sl.valid_mask()))
    state = torch.zeros((), dtype=torch.int32, device=dev)
    _, out = dbscan_scan(state, xs, ys, None, vs, DEFAULT.replace(dbscan=cfg))
    k, it = out.num_clusters.cpu().numpy(), out.iterations.cpu().numpy()
    size, cen = out.size.cpu().numpy(), out.centroid.cpu().numpy()
    for i in range(sl.num_slices):
        print(f"slice {i}: events={int(sl.count[i])} clusters={int(k[i])} "
              f"iterations={int(it[i])}")
        for c in range(int(k[i])):
            print(f"  cluster {c}: size={int(size[i, c])} "
                  f"centroid=({cen[i, c, 0]:.2f},{cen[i, c, 1]:.2f})")


def cmd_temporal(args):
    """Spatio-temporal distributed run: time windows over the mesh's data
    axis, spatial tiles over its tile axis, one rank each; per-slice
    cluster+corner outputs plus the Schur-refined cross-window track chains
    (parallel/temporal.py). With --exact, the exact engine over windows
    only."""
    from .config import DEFAULT
    from .io import slice_by_count
    from .parallel import mesh as mesh_mod, temporal
    cfg = DEFAULT
    n_windows, n_tiles = args.windows, args.tiles
    exact = args.exact
    if exact and n_tiles > 1:
        print(f"warning: --exact distributes over windows only; "
              f"--tiles {n_tiles} ignored (the exact engine is sequential "
              f"per window)", file=sys.stderr)
    need = n_windows if exact else n_windows * n_tiles
    have = mesh_mod.world_size()
    if need != have:
        sys.exit(f"error: {'windows' if exact else f'grid ({n_windows}x{n_tiles})'}"
                 f" needs {need} ranks, have {have} (hint: run it under torchrun "
                 f"--nproc-per-node {need})")
    slices = slice_by_count(_load(args), cfg.slicing.n_events)
    dev = args.device
    if exact:
        # windows over the data axis only (the engine is sequential per
        # window), bit for bit the sequential exact run after the warm-up
        m = mesh_mod.make_data_mesh(n_windows, cfg.parallel)
        out = temporal.run_temporal_exact(slices, m, n_windows, args.warmup, cfg, device=dev)
        alive, n = out.alive.cpu().numpy(), out.n.cpu().numpy()
        for w in range(n_windows):
            for s in range(alive.shape[1]):
                big = alive[w, s] & (n[w, s] >= cfg.cluster.min_n)
                print(f"window {w} slice {s}: clusters={int(big.sum())}")
        chained = int((out.cluster_chain >= 0).sum())
        print(f"cross-window cluster chains: {chained} reported slots")
        return
    grid = mesh_mod.make_grid_mesh(n_windows, n_tiles, cfg.parallel)
    out = temporal.run_temporal(slices, grid, n_windows, n_tiles, args.warmup, cfg,
                                device=dev)
    rep, ncor = out.cl_reported.cpu().numpy(), out.num_corners.cpu().numpy()
    act = out.track_active.cpu().numpy()
    for w in range(n_windows):
        for s in range(ncor.shape[1]):
            print(f"window {w} slice {s}: clusters={int(rep[w, s].sum())} "
                  f"corners={int(ncor[w, s])} tracks={int(act[w, s].sum())}")
    r = [a.cpu().numpy() for a in out.refined]
    valid, n_win, n_obs, _, bpos, bok = r
    ks = np.where(valid)[0]
    print(f"refined track chains: {len(ks)}")
    for k in ks:
        pts = " -> ".join(f"({bpos[k, j][0]:.1f},{bpos[k, j][1]:.1f})"
                          for j in range(bok.shape[1]) if bok[k, j])
        print(f"  chain {int(k)}: windows={int(n_win[k])} "
              f"obs={int(n_obs[k])} boundary {pts}")


def _device_arg(p, default):
    p.add_argument("--device", choices=("cuda", "cpu"), default=default,
                   help="where the engine runs: the CUDA card (default; with "
                        "no card the run stops with an error) or the CPU")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="evflow_tpu_torch.run")
    _device_arg(ap, "cuda")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **extra):
        p = sub.add_parser(name, help=fn.__doc__)
        p.set_defaults(fn=fn)
        # after the subcommand too; it overrides the top-level flag only
        # when given
        _device_arg(p, argparse.SUPPRESS)
        if extra.get("input", True):
            p.add_argument("--input", required=extra.get("input_required", True))
        p.add_argument("--out", default="")
        p.add_argument("--decimate", type=int, default=extra.get("decimate", 0))
        return p

    def add_ckpt(p):
        p.add_argument("--checkpoint", default="",
                       help="save engine state (npz) after the run")
        p.add_argument("--resume", default="",
                       help="restore engine state (npz) before the run; a "
                            "stream split at the boundary is bit-identical "
                            "to an unbroken run")
        return p

    def add_trace(p):
        p.add_argument("--trace", default="", metavar="DIR",
                       help="record the run with torch.profiler and write "
                            "DIR/trace.json (Chrome trace), with a span per "
                            "slice, module and fixpoint round")
        return p

    p = add_trace(add_ckpt(add("cluster-flow", cmd_cluster_flow)))
    p.add_argument("--exact", action="store_true",
                   help="bit-parity per-event engine (AEClustering.cpp:47-118 "
                        "semantics) instead of the slice-vectorized fast path")
    p.add_argument("--fabricated-ts", action="store_true",
                   help="with --exact: reproduce the reference's fabricated "
                        "uniqueCount/1000 clock (accel …store.cpp:439)")
    add("async-cluster", cmd_async_cluster, decimate=256)
    add_trace(add("track-estimate", cmd_track_estimate, decimate=512))
    add_trace(add_ckpt(add("corner-track", cmd_corner_track)))
    p = sub.add_parser("kmeans", help=cmd_kmeans.__doc__)
    _device_arg(p, argparse.SUPPRESS)
    p.add_argument("--sharded", action="store_true",
                   help="assignment row-split over the process group's ranks")
    p.set_defaults(fn=cmd_kmeans)
    p.add_argument("--n", type=int, default=2048)
    add("sampling", cmd_sampling)
    p = add_trace(add("optics", cmd_optics))
    p.add_argument("--slice-events", type=int, default=0, metavar="N",
                   help="on event input, cluster each N-event slice "
                        "(pipeline.optics_scan) and print the report per slice")
    p.add_argument("--method", default="auto",
                   choices=("auto", "cellpair", "grid", "dense", "certified",
                            "sharded"),
                   help="neighbor backend (auto: cellpair at d<=2, else "
                        "grid up to d=4, else the dense table; dense = "
                        "O(N^2) panels; certified = the dense table here; "
                        "sharded = dense panels row-split over the process "
                        "group's ranks, parallel/batch.py)")
    p.add_argument("--max-neighbors", type=int, default=256)

    def _proj_dims(v):
        iv = int(v)
        if not 3 <= iv <= 4:
            raise argparse.ArgumentTypeError(
                "--proj-dims must be 3 or 4 (supported projected-grid "
                "dimensionalities; see models/optics.py)")
        return iv
    p.add_argument("--proj-dims", type=_proj_dims, default=3,
                   help="projected-grid dimensionality for d>4 with "
                        "--method grid (supported: 3 or 4)")
    p.add_argument("--full-window", action="store_true",
                   help="grid skips nearest-k selection and returns masked "
                        "3^g*B windows (wider table)")
    p.add_argument("--eps", type=float, default=10.0)
    p.add_argument("--min-pts", type=int, default=2)
    p.add_argument("--threshold", type=float, default=10.0)
    p.add_argument("--chi", type=float, default=0.0,
                   help="use xi steep-area extraction with this chi instead "
                        "of the reachability threshold")
    p.add_argument("--export", default="")
    p = add_trace(add("dbscan", cmd_dbscan))
    p.add_argument("--per-slice", action="store_true",
                   help="on event input, cluster each slicing.n_events slice "
                        "(pipeline.dbscan_scan) and print one line per slice")
    p.add_argument("--sharded", action="store_true",
                   help="O(N^2) panels row-split over the process group's ranks")
    p.add_argument("--eps", type=float, default=20.0)
    p.add_argument("--min-pts", type=int, default=20)
    p.add_argument("--min-cluster-size", type=int, default=100)
    p.add_argument("--export", default="")
    p.add_argument("--voxel", type=float, default=0.0,
                   help="voxel-grid leaf size for .pcd inputs (reference: 0.01)")
    p.add_argument("--remove-plane", action="store_true")
    p.add_argument("--plane-threshold", type=float, default=0.02)
    p = add_trace(add("temporal", cmd_temporal))
    p.add_argument("--windows", type=int, default=2,
                   help="time windows (data-axis shards)")
    p.add_argument("--tiles", type=int, default=4,
                   help="spatial tiles (tile-axis shards)")
    p.add_argument("--warmup", type=int, default=8,
                   help="overlap slices consumed from the previous window")
    p.add_argument("--exact", action="store_true",
                   help="distribute the bit-parity exact engine over the "
                        "window axis")
    return ap


@contextlib.contextmanager
def _process_group(args):
    """Under torchrun (WORLD_SIZE > 1): the process group from the
    environment, the rank's own card, and stdout kept for rank 0."""
    import torch.distributed as dist
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield
        return
    if args.device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
    dist.init_process_group("nccl" if args.device.startswith("cuda") else "gloo")
    try:
        with open(os.devnull, "w") as null, contextlib.ExitStack() as stack:
            if dist.get_rank() != 0:
                stack.enter_context(contextlib.redirect_stdout(null))
            yield
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("error: --device cuda requested but no CUDA device is "
                 "available (pass --device cpu to run on the CPU)")
    with _process_group(args), contextlib.ExitStack() as stack:
        if getattr(args, "trace", ""):
            from .utils import profiling
            rank = int(os.environ.get("RANK", "0"))
            d = os.path.join(args.trace, f"rank{rank}") if rank else args.trace
            stack.enter_context(profiling.trace(d))
        args.fn(args)


if __name__ == "__main__":
    main()
