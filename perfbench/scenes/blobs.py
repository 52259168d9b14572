"""`blobs`: Gaussian blobs translating at fixed velocities, each event drawn
from a random blob (bench.py's scene). A frozen copy of the port's
`io/synthetic.py:moving_blob_stream` with one change: a blob that reaches
the border margin (5 sigma) turns back instead of being held there, so the
scene keeps moving however long the recording is. Until the first turn the
events equal the original's at the same generator."""

import numpy as np


def generate(rng: np.random.Generator, num_slices: int, events_per_slice: int,
             slice_us: int, width: int, height: int, centers, velocities,
             sigma: float):
    """(x, y, t) of shape (num_slices, events_per_slice); t in µs from 0,
    sorted within each slice."""
    k = len(centers)
    c = np.asarray(centers, dtype=np.float64).copy()
    vel = np.asarray(velocities, dtype=np.float64).copy()
    lo = np.array([5 * sigma, 5 * sigma])
    hi = np.array([width - 1 - 5 * sigma, height - 1 - 5 * sigma])
    xs = np.empty((num_slices, events_per_slice), np.int32)
    ys = np.empty_like(xs)
    ts = np.empty((num_slices, events_per_slice), np.int64)
    for s in range(num_slices):
        which = rng.integers(0, k, size=events_per_slice)
        pts = c[which] + rng.normal(0.0, sigma, size=(events_per_slice, 2))
        xs[s] = np.clip(np.round(pts[:, 0]), 0, width - 1)
        ys[s] = np.clip(np.round(pts[:, 1]), 0, height - 1)
        ts[s] = s * slice_us + np.sort(rng.integers(0, slice_us, size=events_per_slice))
        rng.integers(0, 2, size=events_per_slice)        # polarity, unused downstream
        c = c + vel
        below, above = c < lo, c > hi
        c = np.where(below, 2 * lo - c, np.where(above, 2 * hi - c, c))
        vel = np.where(below | above, -vel, vel)
    return xs, ys, ts
