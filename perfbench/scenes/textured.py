"""`textured`: many small fast objects (sigma 3 px) plus uniform noise that
touches mostly new pixels, so the touched-pixel count per slice approaches
the event count: the candidate cap binds, the cluster slots fill, NMS and the
tracker get many corners. A frozen copy of the port's
`io/synthetic.py:textured_field_stream`, equal to it at the same generator."""

import numpy as np


def generate(rng: np.random.Generator, num_slices: int, events_per_slice: int,
             slice_us: int, width: int, height: int, num_objects: int,
             noise_frac: float):
    """(x, y, t) of shape (num_slices, events_per_slice); t in µs from 0."""
    cx = rng.uniform(60, width - 60, num_objects)
    cy = rng.uniform(60, height - 60, num_objects)
    vx = rng.uniform(-25, 25, num_objects)
    vy = rng.uniform(-25, 25, num_objects)
    xs = np.empty((num_slices, events_per_slice), np.int32)
    ys = np.empty_like(xs)
    ts = np.empty((num_slices, events_per_slice), np.int64)
    for s in range(num_slices):
        n_noise = int(events_per_slice * noise_frac)
        n_obj = events_per_slice - n_noise
        which = rng.integers(0, num_objects, n_obj)
        ox = cx[which] + rng.normal(0, 3.0, n_obj)
        oy = cy[which] + rng.normal(0, 3.0, n_obj)
        nx = rng.uniform(0, width, n_noise)
        ny = rng.uniform(0, height, n_noise)
        x = np.clip(np.round(np.concatenate([ox, nx])), 0, width - 1)
        y = np.clip(np.round(np.concatenate([oy, ny])), 0, height - 1)
        ts[s] = s * slice_us + np.sort(rng.integers(0, slice_us, size=events_per_slice))
        order = rng.permutation(events_per_slice)
        xs[s] = x[order]
        ys[s] = y[order]
        rng.integers(0, 2, events_per_slice)             # polarity, unused downstream
        cx = (cx + vx) % width
        cy = (cy + vy) % height
    return xs, ys, ts
