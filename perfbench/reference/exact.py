"""Plain NumPy reference of the exact clustering path (`hd_exact_cluster`).

Per slice: hash dedup (first occupant of each `(x*1619 + y*31) % 8192`
bucket in stream order, inclusive range check), the unique coordinates
compacted in stream order and cut at the bucket count, each stamped with the
slice's latest time; then AEClustering event by event on fixed-capacity
state (C cluster slots, a ring of M members, a window of the last sz_buffer
update times, AEClustering.cpp:47-118 with the capacities the program
states); then the per-cluster member mean and the flow keyed by cluster id.

Written from the semantics alone: it imports nothing of the program. The
state is a dict of NumPy arrays under the program's field names, so a run
can start from the program's state where it must (PERF.md says where).
`float_round` rounds every stored mean; the control passes a rounding to
bfloat16.
"""

from __future__ import annotations

import math
import struct

import numpy as np

BIG = 2**31 - 1
I32_MIN = -(2**31)
STATE_FIELDS = ("t0", "has_t0", "tbuf", "thead", "mx", "my", "mt", "mp", "mcid",
                "alive", "corder", "cid", "mu", "next_order", "next_cid",
                "event_id", "last_updated", "overflow")


def bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def bf16_scalar(v: float) -> float:
    return float(bf16_round(np.float32(v)).reshape(-1)[0])


def init_state(cfg: dict) -> dict:
    cl = cfg["cluster"]
    w, m, c = cl["sz_buffer"], cl["max_members"], cl["max_clusters"]
    z = lambda n, v=0: np.full(n, v, dtype=np.int32)
    return dict(t0=0, has_t0=False, tbuf=z(w), thead=0, mx=z(m), my=z(m), mt=z(m),
                mp=z(m), mcid=z(m, -1), alive=np.zeros(c, bool), corder=z(c, BIG),
                cid=z(c, -1), mu=np.zeros((c, 2), np.float32), next_order=0,
                next_cid=0, event_id=0, last_updated=-1, overflow=0)


def dedup_lanes(x, y, valid, cfg: dict):
    """(unique x, unique y in stream order, unique count, lanes kept). The
    lanes are cut at the bucket count in hash mode."""
    d, s = cfg["dedup"], cfg["sensor"]
    if d["exact"]:
        key = y.astype(np.int64) * (s["width"] + 1) + x
    else:
        key = (x.astype(np.int64) * d["hash_mul_x"] + y.astype(np.int64) * d["hash_mul_y"]) \
            % d["num_buckets"]
    ok = valid & (x >= 0) & (x <= s["width"]) & (y >= 0) & (y <= s["height"])
    lanes = np.flatnonzero(ok)
    _, first = np.unique(key[lanes], return_index=True)
    uniq = np.sort(lanes[first])
    n_lanes = x.shape[0]
    if not d["exact"] and d["num_buckets"] < n_lanes:
        n_lanes = d["num_buckets"]
    return x[uniq].astype(np.int32), y[uniq].astype(np.int32), len(uniq), n_lanes


def _fma_f32(a: float, b: float, c: float) -> float:
    """f32 a*b + c rounded once (a, b, c float32 values): a*b is exact in
    float64; where the float64 sum is inexact its error decides a
    round-to-odd step, so the one rounding to f32 (on the store) is right."""
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0 and (int.from_bytes(struct.pack("<d", s), "little") & 1) == 0:
        s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return s


def update_slice(st: dict, x, y, t, valid, cfg: dict, float_round=None,
                 tests: list | None = None) -> dict:
    """One slice of lanes through the engine, event by event; `tests`, if
    given, gets the alive clusters each valid event is tested against.
    `float_round`, if given, rounds every stored mean (a float -> float)."""
    cl = cfg["cluster"]
    w, m, c = cl["sz_buffer"], cl["max_members"], cl["max_clusters"]
    radius = np.float32(cl["radius"])
    alpha = float(np.float32(cl["alpha"]))
    one_m = float(np.float32(1.0 - cl["alpha"]))
    vidx = np.flatnonzero(valid)
    has_any = len(vidx) > 0
    t0 = st["t0"] if st["has_t0"] else int(t[vidx[0]] if has_any else t[0])
    tr = (t.astype(np.int64) - t0).astype(np.int32)
    thead = st["thead"]
    prev = st["tbuf"][(thead - w + np.arange(w)) % w]
    timeline = np.concatenate([prev, tr[vidx]]).astype(np.int64)
    upd = np.arange(len(vidx))
    tmin = timeline[np.clip(np.maximum(thead + upd - w + 1, 0) - thead + w,
                            0, w + len(vidx) - 1)]
    tbuf = st["tbuf"].copy()
    n_push = len(vidx)
    for u in range(max(0, n_push - w), n_push):
        tbuf[(thead + u) % w] = tr[vidx[u]]

    mx, my, mt, mcid = st["mx"].copy(), st["my"].copy(), st["mt"].copy(), st["mcid"].copy()
    mp = st["mp"].copy()
    alive, corder, cid = st["alive"].copy(), st["corder"].copy(), st["cid"].copy()
    mu0 = np.ascontiguousarray(st["mu"][:, 0])
    mu1 = np.ascontiguousarray(st["mu"][:, 1])
    next_order, next_cid, event_id = st["next_order"], st["next_cid"], st["event_id"]
    last_updated, overflow = st["last_updated"], st["overflow"]
    cids = np.arange(c)
    n_alive = int(alive.sum())
    d0, d1 = np.empty(c, np.float32), np.empty(c, np.float32)
    near = np.empty(c, bool)
    xs, ys, trs, tms = x[vidx].tolist(), y[vidx].tolist(), tr[vidx].tolist(), tmin.tolist()
    cur_tmin, n_c, live, empty = None, None, None, []
    for u in range(len(vidx)):
        xi, yi, ti, tmi = xs[u], ys[u], trs[u], tms[u]
        if tmi != cur_tmin or n_c is None:
            # live members: in a slot and not older than the window's tMin;
            # between changes of tMin the counts follow each write
            cur_tmin = tmi
            n_c = np.bincount(mcid[(mcid >= 0) & (mt >= tmi)], minlength=c)
            live = (n_c > 0) & alive
            empty = np.flatnonzero(alive & (n_c == 0)).tolist()
        if tests is not None:
            tests.append(n_alive)
        px, py = np.float32(xi), np.float32(yi)
        np.subtract(mu0, px, out=d0)
        np.abs(d0, out=d0)
        np.subtract(mu1, py, out=d1)
        np.abs(d1, out=d1)
        np.add(d0, d1, out=d0)
        np.less_equal(d0, radius, out=near)
        np.logical_and(near, live, out=near)
        n_assigned = int(np.count_nonzero(near))
        make_new = False
        if n_assigned == 1:
            target = int(near.argmax())
        elif n_assigned:
            target = int(np.where(near, corder, BIG).argmin())
        else:
            target = int((~alive).argmax())
            make_new = n_alive < c
            if not make_new:
                overflow += 1
        do_add = n_assigned > 0 or make_new
        mcid_old = mcid.copy() if n_assigned >= 2 else None
        old, old_live = -1, False
        became_empty = []
        if do_add:
            slot = event_id % m
            old = int(mcid[slot])
            old_live = old >= 0 and mt[slot] >= tmi
            if old_live:
                n_c[old] -= 1
                if n_c[old] == 0:
                    live[old] = False
                    became_empty.append(old)
            mx[slot], my[slot], mt[slot], mp[slot], mcid[slot] = xi, yi, ti, 0, target
            n_c[target] += 1
            live[target] = True
            event_id += 1
            if n_assigned == 0:
                v0, v1 = float(xi), float(yi)
            else:
                v0 = _fma_f32(one_m, float(mu0[target]), float(np.float32(alpha * xi)))
                v1 = _fma_f32(one_m, float(mu1[target]), float(np.float32(alpha * yi)))
            if float_round is not None:
                v0, v1 = float_round(v0), float_round(v1)
            mu0[target], mu1[target] = v0, v1
        if make_new:
            alive[target] = True
            n_alive += 1
            corder[target] = next_order
            cid[target] = next_cid
            next_order += 1
            next_cid += 1
        if n_assigned >= 2:
            # weights: the counts before the write, plus the new member
            n_post = n_c.copy()
            if old_live:
                n_post[old] += 1
            wgt = np.where(near, n_post.astype(np.float32), np.float32(0))
            num = np.stack([(wgt * mu0).sum(dtype=np.float32),
                            (wgt * mu1).sum(dtype=np.float32)])
            v = num / np.maximum(wgt.sum(dtype=np.float32), np.float32(1))
            v0, v1 = float(v[0]), float(v[1])
            if float_round is not None:
                v0, v1 = float_round(v0), float_round(v1)
            mu0[target], mu1[target] = v0, v1
            moved = (mcid >= 0) & (mcid_old >= 0) & near[np.clip(mcid_old, 0, c - 1)]
            mcid[moved] = target
            died = np.flatnonzero(near & (cids != target))
            alive[died] = False
            n_c = None
        else:
            # clusters empty at the event's start die; one whose last
            # member this write overwrote still holds it until the next event
            died = [k for k in empty if alive[k] and n_c[k] == 0]
            alive[died] = False
            empty = became_empty
        if len(died):
            n_alive -= len(died)
            corder[died] = BIG
            if n_c is not None:
                live[died] = False
        last_updated = target if do_add else -1

    mu = np.stack([mu0, mu1], 1)
    final_tmin = int(tmin[-1]) if has_any else I32_MIN
    mcid = np.where((mcid >= 0) & (mt >= final_tmin), mcid, -1)
    mcid = np.where((mcid >= 0) & ~alive[np.clip(mcid, 0, c - 1)], -1, mcid).astype(np.int32)
    return dict(t0=t0, has_t0=st["has_t0"] or has_any, tbuf=tbuf, thead=thead + n_push,
                mx=mx, my=my, mt=mt, mp=mp, mcid=mcid, alive=alive, corder=corder,
                cid=cid, mu=mu, next_order=next_order, next_cid=next_cid,
                event_id=event_id, last_updated=last_updated, overflow=overflow)


def snapshot(st: dict, c: int):
    """(member count, member mean) per cluster slot."""
    member = st["mcid"] >= 0
    ids = st["mcid"][member]
    n = np.bincount(ids, minlength=c)
    sx = np.bincount(ids, weights=st["mx"][member], minlength=c).astype(np.float32)
    sy = np.bincount(ids, weights=st["my"][member], minlength=c).astype(np.float32)
    den = np.maximum(n, 1).astype(np.float32)
    return n.astype(np.int32), np.stack([sx / den, sy / den], 1)


class ExactPath:
    """The exact path's slice loop: engine state, the cumulative unique
    count, and the flow memory keyed by cluster id."""

    def __init__(self, cfg: dict, float_round=None):
        self.cfg, self.float_round = cfg, float_round
        c = cfg["cluster"]["max_clusters"]
        self.state = (init_state(cfg), 0, np.full(c, -1, np.int32),
                      np.zeros((c, 2), np.float32))

    def step(self, x, y, t, valid, counts: dict | None = None) -> dict:
        cfg = self.cfg
        c = cfg["cluster"]["max_clusters"]
        ae, cum, prev_cid, prev_cent = self.state
        ux, uy, uniq, n_lanes = dedup_lanes(x, y, valid, cfg)
        tmax = int(np.where(valid, t, 0).max()) if len(t) else 0
        lx = np.zeros(n_lanes, np.int32)
        ly = np.zeros(n_lanes, np.int32)
        k = min(uniq, n_lanes)
        lx[:k], ly[:k] = ux[:k], uy[:k]
        lvalid = np.arange(n_lanes) < uniq
        lt = np.where(lvalid, tmax, 0).astype(np.int32)
        tests = [] if counts is not None else None
        ae = update_slice(ae, lx, ly, lt, lvalid, cfg, self.float_round, tests)
        n, cent = snapshot(ae, c)
        reported = ae["alive"] & (n >= cfg["cluster"]["min_n"])
        same = reported & (prev_cid == ae["cid"]) & (prev_cid >= 0)
        extrap = np.float32(cfg["flow"]["extrapolation"])
        flow = np.where(same[:, None], (cent - prev_cent) * extrap, np.float32(0))
        prev_cent = np.where(reported[:, None], cent, prev_cent)
        prev_cid = np.where(reported, ae["cid"], np.where(ae["alive"], prev_cid, -1))
        self.state = (ae, cum + uniq, prev_cid.astype(np.int32), prev_cent)
        if counts is not None:
            counts.setdefault("exact_lanes", []).append(int(lvalid.sum()))
            counts.setdefault("exact_tests", []).append(int(sum(tests)))
            counts.setdefault("unique_pixels", []).append(uniq)
            counts.setdefault("live_clusters", []).append(int(ae["alive"].sum()))
        return dict(unique_count=np.int32(uniq),
                    repeated_count=np.int32(int(valid.sum()) - uniq),
                    reported=reported, cid=ae["cid"].copy(), n=n, centroid=cent,
                    flow=flow.astype(np.float32))
