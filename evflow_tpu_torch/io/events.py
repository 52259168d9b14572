"""Event-stream I/O.

The reference ingests events through the Metavision SDK camera callbacks
(e.g. event-cam-clustering/async-incremental-clustering/
metavision_sdk_get_started2_events_clustering.cpp:106-133). We replace that with
recorded-event readers producing fixed-shape arrays: a structure-of-arrays
`EventStream` with int32 x/y/p and int64 t (µs).

Supported formats:
  - CSV `x,y,t,p` (optics-clustering/test/event_raw_data8.csv) or `x,y`
  - .npz with keys x,y,t,p
  - Metavision `.raw` recordings, all three public generations (the
    reference's actual camera input): '%'-header files dispatch by header to
    io/evt3.py (EVT3 — native + numpy decoders) or io/evt2.py (EVT2/EVT2.1)
  - raw binary little-endian int32 quads (our own compact format)
"""

from __future__ import annotations

import dataclasses
import io as _pyio
import os
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class EventStream:
    """Struct-of-arrays event stream, sorted by time.

    x, y: int32 pixel coords;  t: int64 microseconds;  p: int32 polarity {0,1}.
    """

    x: np.ndarray
    y: np.ndarray
    t: np.ndarray
    p: np.ndarray

    def __post_init__(self):
        n = len(self.x)
        assert len(self.y) == n and len(self.t) == n and len(self.p) == n
        self.x = np.asarray(self.x, dtype=np.int32)
        self.y = np.asarray(self.y, dtype=np.int32)
        self.t = np.asarray(self.t, dtype=np.int64)
        self.p = np.asarray(self.p, dtype=np.int32)

    def __len__(self) -> int:
        return int(len(self.x))

    def __getitem__(self, idx) -> "EventStream":
        return EventStream(self.x[idx], self.y[idx], self.t[idx], self.p[idx])

    def as_array(self) -> np.ndarray:
        """(N, 4) int64 array [x, y, t, p] (column order follows CSV)."""
        return np.stack(
            [self.x.astype(np.int64), self.y.astype(np.int64), self.t, self.p.astype(np.int64)],
            axis=1,
        )

    def sorted_by_time(self) -> "EventStream":
        order = np.argsort(self.t, kind="stable")
        return self[order]

    def concat(self, other: "EventStream") -> "EventStream":
        return EventStream(
            np.concatenate([self.x, other.x]),
            np.concatenate([self.y, other.y]),
            np.concatenate([self.t, other.t]),
            np.concatenate([self.p, other.p]),
        )

    @property
    def duration_us(self) -> int:
        if len(self) == 0:
            return 0
        return int(self.t[-1] - self.t[0])


def empty_stream() -> EventStream:
    z = np.zeros((0,), dtype=np.int32)
    return EventStream(z, z, z.astype(np.int64), z)


def load_csv(path_or_buf, has_header: bool = False) -> EventStream:
    """Load `x,y[,t[,p]]` CSV (optics test fixture format, event_raw_data8.csv)."""
    if isinstance(path_or_buf, (str, os.PathLike)):
        data = np.loadtxt(path_or_buf, delimiter=",", dtype=np.int64,
                          skiprows=1 if has_header else 0, ndmin=2)
    else:
        data = np.loadtxt(path_or_buf, delimiter=",", dtype=np.int64,
                          skiprows=1 if has_header else 0, ndmin=2)
    if data.size == 0:
        return empty_stream()
    n, c = data.shape
    x = data[:, 0]
    y = data[:, 1]
    t = data[:, 2] if c > 2 else np.arange(n, dtype=np.int64)
    p = data[:, 3] if c > 3 else np.zeros(n, dtype=np.int64)
    return EventStream(x, y, t, p)


def save_csv(stream: EventStream, path: str) -> None:
    arr = stream.as_array()
    np.savetxt(path, arr, delimiter=",", fmt="%d")


def load_npz(path: str) -> EventStream:
    with np.load(path) as z:
        return EventStream(z["x"], z["y"], z["t"], z["p"])


def save_npz(stream: EventStream, path: str) -> None:
    np.savez_compressed(path, x=stream.x, y=stream.y, t=stream.t, p=stream.p)


def load_raw_i32(path: str) -> EventStream:
    """Compact binary: little-endian int32 quads [x, y, t_us, p] * N."""
    flat = np.fromfile(path, dtype="<i4")
    assert flat.size % 4 == 0, f"raw file size not a multiple of 16 bytes: {path}"
    quads = flat.reshape(-1, 4)
    return EventStream(quads[:, 0], quads[:, 1], quads[:, 2].astype(np.int64), quads[:, 3])


def save_raw_i32(stream: EventStream, path: str) -> None:
    quads = np.stack(
        [stream.x, stream.y, stream.t.astype(np.int32), stream.p], axis=1
    ).astype("<i4")
    quads.tofile(path)


def load(path: str) -> EventStream:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".csv":
        return load_csv(path)
    if ext == ".npz":
        return load_npz(path)
    if ext in (".raw", ".bin", ".evi"):
        # Metavision recordings start with an ASCII '%' header; the repo's
        # compact int32-quad format never does (x is a pixel coordinate)
        with open(path, "rb") as f:
            magic = f.read(1)
        if magic == b"%":
            from .evt2 import load_metavision_raw
            return load_metavision_raw(path)
        return load_raw_i32(path)
    raise ValueError(f"unknown event file format: {path}")
