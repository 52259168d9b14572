"""The OPTICS golden of tests/test_golden_optics.py through the port: the
committed event fixture (320 events) at the reference driver's parameters
(min_pts 2, eps 10, threshold 10), its report and both PPM renders byte for
byte against the committed golden files. Pixel coordinates are integers,
so every distance term is exact in fp32 and the output must be identical.

The golden's other half: the port's CLI (`optics --device cpu`) prints the
golden report, for the default method and for "sharded" (the dense table,
one rank outside a process group).
"""

import os

import numpy as np
import pytest

from evflow_tpu_torch.io import load_csv
from evflow_tpu_torch.models import optics
from evflow_tpu_torch.utils import plots

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA_DIR, "event_raw_data8.csv")
GOLDEN = os.path.join(DATA_DIR, "golden_optics_data8.txt")
GOLDEN_REACH = os.path.join(DATA_DIR, "golden_optics_data8_reachability.ppm")
GOLDEN_2D = os.path.join(DATA_DIR, "golden_optics_data8_clusters2d.ppm")

MIN_PTS = 2
EPS = 10.0
THRESHOLD = 10.0


def _run(use_native):
    s = load_csv(FIXTURE)
    pts = np.stack([s.x, s.y], axis=1).astype(np.float64)
    rd = optics.compute_reachability_dists(pts, MIN_PTS, EPS, use_native=use_native,
                                           device="cpu")
    clusters = optics.get_cluster_indices(rd, THRESHOLD)
    lines = [f"Cluster size : {len(clusters)}"]
    for j, c in enumerate(clusters):
        p = pts[np.asarray(c, int)]
        lines.append(f"{j},{len(c)},{p[:, 0].mean():g},{p[:, 1].mean():g},"
                     f"{p[:, 0].var():g},{p[:, 1].var():g}")
    reach_img = plots.draw_reachability_plot(rd)
    img2d = plots.draw_2d_clusters([pts[np.asarray(c, int)] for c in clusters])
    return "\n".join(lines) + "\n", reach_img, img2d


def _ppm_bytes(img, tmp_path, name):
    with open(img.save(str(tmp_path / name)), "rb") as f:
        return f.read()


def test_optics_end_to_end_matches_golden(tmp_path):
    for use_native in (True, False):
        report, reach_img, img2d = _run(use_native)
        with open(GOLDEN) as f:
            assert report == f.read()
        with open(GOLDEN_REACH, "rb") as f:
            assert _ppm_bytes(reach_img, tmp_path, "reach") == f.read()
        with open(GOLDEN_2D, "rb") as f:
            assert _ppm_bytes(img2d, tmp_path, "clusters2d") == f.read()


@pytest.mark.parametrize("method", ["auto", "sharded"])
def test_cli_optics_report_matches_golden(capsys, method):
    from evflow_tpu_torch.run import main
    main(["optics", "--input", FIXTURE, "--eps", str(EPS), "--min-pts", str(MIN_PTS),
          "--threshold", str(THRESHOLD), "--method", method, "--device", "cpu"])
    with open(GOLDEN) as f:
        assert capsys.readouterr().out == f.read()
