"""Minimal PCD (Point Cloud Data) I/O — ASCII and binary little-endian.

The reference's app C reads clouds with pcl::PCDReader and writes clustered
clouds with PCDWriter (point-cloud-clustering/pcl_cluster.cpp:38-48, 140-147;
fields x y z intensity, intensity = cluster j%8). This is the dependency-free
subset needed for parity: FIELDS x y z [intensity], FLOAT32, ascii or binary.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_pcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (points (N,3) float32, intensity (N,) float32 or None)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = [s.lower() for s in header.get("FIELDS", [])]
        n = int(header.get("POINTS", [0])[0])
        sizes = [int(s) for s in header.get("SIZE", ["4"] * len(fields))]
        mode = header["DATA"][0].lower()

        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float32, max_rows=n, ndmin=2)
        elif mode == "binary":
            row_bytes = sum(sizes)
            raw = f.read(n * row_bytes)
            assert all(s == 4 for s in sizes), "only 4-byte fields supported"
            data = np.frombuffer(raw, dtype="<f4").reshape(n, len(fields))
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    def col(name):
        return data[:, fields.index(name)] if name in fields else None

    pts = np.stack([col("x"), col("y"), col("z")], axis=1).astype(np.float32)
    inten = col("intensity")
    return pts, (inten.astype(np.float32) if inten is not None else None)


def save_pcd(path: str, points: np.ndarray,
             intensity: Optional[np.ndarray] = None,
             binary: bool = False) -> None:
    points = np.asarray(points, np.float32)
    n = len(points)
    fields = ["x", "y", "z"] + (["intensity"] if intensity is not None else [])
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float32))
    data = np.stack(cols, axis=1).astype("<f4")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")
