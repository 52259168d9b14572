"""App C per slice (`pipeline.dbscan_scan`, `dbscan.dbscan_slice`) on the
CPU: 2048-event slices of seeded textured and blobs streams at 640x400
(`io/synthetic.py`), with a short last slice, so that some slices fit
`dbscan_grid`'s table and some overflow it.

- Each slice equals `dbscan_grid` and dense `dbscan` on its valid pixels,
  field by field, and its sizes and centroids are its labels' own.
- The plain reference of the benchmark (`perfbench/reference/dbscan.py`,
  breadth-first expansion, no label propagation) gives the same labels,
  core mask and counts, and centroids within 1e-4 px.
- The reference is right on hand-built cases: a border point between two
  clusters, both size bounds, equal sizes.
- The spans: one `slice`, `dbscan` and `dbscan.dense` per slice, no
  `dbscan.table`, one `dbscan.round` per propagation round (the sum of
  `iterations`), as tests/test_torch_spans.py reads them."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from evflow_tpu_torch.config import DEFAULT, DBSCANConfig
from evflow_tpu_torch.io import synthetic
from evflow_tpu_torch.io.slicing import slice_by_count
from evflow_tpu_torch.models import dbscan, optics, pipeline
from perfbench.reference import dbscan as ref_dbscan

torch.set_num_threads(2)

N = 2048
# (scene, seed, the slices that take the grid): the blobs overflow the
# table on every slice, textured slices mostly fit it, the short last one
# always does
SCENES = [("textured", 3, [True, False, True, True]),
          ("textured", 4, [False, False, True, True]),
          ("blobs", 5, [False, False, False, False])]
REF_CFG = {"dbscan": dataclasses.asdict(DBSCANConfig())}


def _slices(scene, seed, _grid=None, num_slices=3, tail=1900):
    """(S, N) x, y, valid of a stream of num_slices full slices and a last
    one of `tail` events."""
    kw = dict(num_slices=num_slices + 1, events_per_slice=N, width=640, height=400, seed=seed)
    if scene == "textured":
        st = synthetic.textured_field_stream(num_objects=8, **kw)
    else:
        st = synthetic.moving_blob_stream(blob_centers=((300.0, 200.0), (500.0, 300.0)),
                                          velocities=((3.0, 1.0), (-2.0, 1.5)), sigma=4.0, **kw)
    st = type(st)(*(a[:num_slices * N + tail] for a in (st.x, st.y, st.t, st.p)))
    sl = slice_by_count(st, N)
    return tuple(torch.as_tensor(a) for a in (sl.x, sl.y, sl.valid_mask()))


def _scan(xs, ys, vs):
    state = torch.zeros((), dtype=torch.int32)
    return pipeline.dbscan_scan(state, xs, ys, None, vs, DEFAULT)


def _takes_grid(pts):
    table = optics.compute_neighbors_grid(pts, 20.0, 20, device="cpu")
    return table is not None and int(table.count.max()) <= table.idx.shape[1]


def _id(scene):
    return f"{scene[0]}-{scene[1]}"


@pytest.fixture(scope="module", params=SCENES, ids=_id)
def scanned(request):
    xs, ys, vs = _slices(*request.param)
    state, out = _scan(xs, ys, vs)
    return request.param, (xs, ys, vs), state, out


def test_each_slice_is_dbscan_grid_and_dense(scanned):
    (_, _, want_grid), (xs, ys, vs), state, out = scanned
    assert int(state) == xs.shape[0]
    grid = []
    for s in range(xs.shape[0]):
        v = vs[s]
        pts = torch.stack([xs[s], ys[s]], 1)[v].to(torch.float32)
        grid.append(_takes_grid(pts.numpy()))
        want = dbscan.dbscan_grid(pts.numpy(), device="cpu")
        dense = dbscan.dbscan(torch.stack([xs[s], ys[s]], 1).to(torch.float32), v)
        for got_f, want_f in (("labels", "labels"), ("core", "core_mask"),
                              ("num_clusters", "num_clusters"), ("iterations", "iterations")):
            got = getattr(out, got_f)[s]
            if got.dim():
                assert torch.equal(got[v], getattr(want, want_f)), (s, got_f)
                assert torch.equal(got[~v], torch.full_like(got[~v], -1 if got_f == "labels"
                                                            else False)), (s, got_f)
            else:
                assert torch.equal(got, getattr(want, want_f)), (s, got_f)
            assert torch.equal(got, getattr(dense, want_f)), (s, got_f)
        k = int(out.num_clusters[s])
        sizes = torch.bincount(out.labels[s][out.labels[s] >= 0].long(), minlength=k)
        assert out.size[s].tolist() == sizes.tolist() + [0] * (out.size.shape[1] - k)
        assert out.size.shape[1] == N // 100 and k > 0
        assert (out.centroid[s][k:] == 0).all()
    assert grid == want_grid


def test_the_reference_agrees(scanned):
    _, (xs, ys, vs), _, out = scanned
    for s in range(xs.shape[0]):
        ref = ref_dbscan.cluster_slice(xs[s], ys[s], vs[s], REF_CFG)
        np.testing.assert_array_equal(out.labels[s].numpy(), ref["labels"])
        np.testing.assert_array_equal(out.core[s].numpy(), ref["core"])
        assert int(out.num_clusters[s]) == int(ref["num_clusters"])
        np.testing.assert_array_equal(out.size[s].numpy(), ref["size"])
        np.testing.assert_allclose(out.centroid[s].numpy(), ref["centroid"], rtol=0, atol=1e-4)


def _ref(points, eps=2.0, min_pts=4, lo=3, hi=100):
    """The reference on hand-placed pixels, checked against the program."""
    p = torch.as_tensor(np.asarray(points, np.int32))
    v = torch.ones(len(p), dtype=torch.bool)
    cfg = {"dbscan": {"eps": eps, "core_min_pts": min_pts, "min_cluster_size": lo,
                      "max_cluster_size": hi}}
    out = ref_dbscan.cluster_slice(p[:, 0], p[:, 1], v, cfg)
    prog = dbscan.dbscan(p.to(torch.float32), v, DBSCANConfig(eps=eps, core_min_pts=min_pts,
                                                               min_cluster_size=lo,
                                                               max_cluster_size=hi))
    np.testing.assert_array_equal(prog.labels.numpy(), out["labels"])
    np.testing.assert_array_equal(prog.core_mask.numpy(), out["core"])
    return out


SQUARE = [(0, 0), (1, 0), (0, 1), (1, 1)]


def _group(x0, y0):
    return [(x0 + a, y0 + b) for a, b in SQUARE]


@pytest.mark.parametrize("first", ["left", "right"])
def test_reference_border_point_joins_the_first_cluster(first):
    """Two squares of four core points, 4 px apart, and a border point at
    2 px from a corner of each (3 points within eps: not core). It joins the
    cluster expanded first, the one whose seed comes first in index order,
    which is then the larger and numbered 0."""
    left, right, border = _group(0, 0), _group(5, 0), [(3, 0)]
    pts = (left + right if first == "left" else right + left) + border
    out = _ref(pts)
    assert not out["core"][-1] and out["core"][:-1].all()
    assert int(out["num_clusters"]) == 2 and out["size"][:2].tolist() == [5, 4]
    assert out["labels"].tolist() == [0] * 4 + [1] * 4 + [0]
    want = (1.0, 0.4) if first == "left" else (5.0, 0.4)
    np.testing.assert_allclose(out["centroid"][0], want, rtol=0, atol=1e-6)


def test_reference_size_bounds():
    """Clusters of 3, 4, 6 and 7 points with sizes held to [4, 6]: the ones
    of 3 and 7 are noise, 6 and 4 are numbered 0 and 1, both bounds kept."""
    groups = [[(x, 0) for x in range(k)] for k in (3, 4, 6, 7)]
    pts = [(x + 20 * i, y) for i, g in enumerate(groups) for x, y in g]
    out = _ref(pts, eps=1.0, min_pts=2, lo=4, hi=6)
    labels = out["labels"].tolist()
    assert labels == [-1] * 3 + [1] * 4 + [0] * 6 + [-1] * 7
    assert int(out["num_clusters"]) == 2 and out["size"][:2].tolist() == [6, 4]
    assert out["core"].all()


def test_reference_equal_sizes_go_by_seed_index():
    """Three squares of four, the far one first in index order: equal
    sizes are numbered by their seeds' indices, not by position."""
    pts = _group(40, 0) + _group(0, 0) + _group(20, 0)
    out = _ref(pts, eps=1.5, min_pts=3)
    assert out["labels"].tolist() == [0] * 4 + [1] * 4 + [2] * 4
    np.testing.assert_allclose(out["centroid"][:3, 0], [40.5, 0.5, 20.5], rtol=0, atol=0)


def _spans(tmp_path, fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X")


@pytest.mark.parametrize("scene", SCENES[::2], ids=_id)
def test_spans_count_slices_rounds_and_dense(tmp_path, scene):
    xs, ys, vs = _slices(*scene)
    got = {}
    spans = _spans(tmp_path, lambda: got.update(out=_scan(xs, ys, vs)[1]))
    out = got["out"]
    count = {name: sum(s[0] == name for s in spans)
             for name in ("slice", "dbscan", "dbscan.table", "dbscan.dense", "dbscan.round")}
    assert count["slice"] == count["dbscan"] == count["dbscan.dense"] == xs.shape[0]
    assert count["dbscan.table"] == 0
    assert count["dbscan.round"] == int(out.iterations.sum())
    slices = [(a, b) for n, a, b in spans if n == "slice"]
    assert all(any(a <= s and e <= b for a, b in slices) for n, s, e in spans if n != "slice")
