"""The scene copies equal the port's generators at a seed."""

import numpy as np

from conftest import ROOT
from perfbench import spec

from evflow_tpu_torch.io import synthetic


def _scene(name):
    return spec.load_module(ROOT / "perfbench" / "scenes" / f"{name}.py")


def test_textured_equals_the_port():
    s = synthetic.textured_field_stream(num_slices=6, events_per_slice=4096, seed=5)
    x, y, t = _scene("textured").generate(np.random.default_rng(5), 6, 4096, 50_000,
                                          1280, 720, num_objects=40, noise_frac=0.5)
    assert np.array_equal(x.ravel(), s.x) and np.array_equal(y.ravel(), s.y)
    assert np.array_equal(t.ravel(), s.t)


def test_blobs_equal_the_port_until_the_first_turn():
    centers = ((200.0, 200.0), (900.0, 500.0), (600.0, 150.0))
    vel = ((30.0, 10.0), (-20.0, 15.0), (5.0, -12.0))
    s = synthetic.moving_blob_stream(num_slices=8, events_per_slice=4096,
                                     blob_centers=centers, velocities=vel, seed=9)
    x, y, t = _scene("blobs").generate(np.random.default_rng(9), 8, 4096, 50_000, 1280, 720,
                                       centers=centers, velocities=vel, sigma=12.0)
    # the third blob, from y = 150 at -12 px per slice, passes the upper
    # margin (5 sigma = 60) after 8 slices, where the port holds it and
    # the copy turns it back
    assert np.array_equal(x.ravel(), s.x) and np.array_equal(y.ravel(), s.y)
    assert np.array_equal(t.ravel(), s.t)


def test_blobs_turn_back_at_the_border():
    x, y, _ = _scene("blobs").generate(np.random.default_rng(1), 120, 512, 50_000, 1280, 720,
                                       centers=[[200.0, 200.0]], velocities=[[30.0, 10.0]],
                                       sigma=12.0)
    mx = x.mean(1)
    assert mx.max() < 1280 - 1 - 40 and mx[-1] < mx.max() - 100
