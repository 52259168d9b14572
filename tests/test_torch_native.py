"""The port's native event readers (evflow_tpu_torch/native/evio.cpp): the
CSV reader, the EVT3 / EVT2 / EVT2.1 payload decoders and the exact
coordinate analyzer, equal to the port's numpy readers and to the JAX
package's native bindings, array for array and dtype for dtype. Also: the
`.raw` loaders take the native path by default and equal their numpy path,
and a source g++ cannot build raises instead of falling back.
"""

import numpy as np
import pytest

from evflow_tpu import native as jnative
from evflow_tpu_torch import native
from evflow_tpu_torch.io import evt2, evt3, load, load_csv, synthetic
from evflow_tpu_torch.io.evt3 import split_header
from tests.conftest import DATA_DIR

FIXTURE = f"{DATA_DIR}/event_raw_data8.csv"


def _stream():
    return synthetic.moving_blob_stream(num_slices=2, events_per_slice=3000, seed=5)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _payload(path):
    blob = open(path, "rb").read()
    return blob[split_header(blob)[1]:]


def test_native_csv_matches_numpy_and_the_jax_package():
    ref = load_csv(FIXTURE)
    got = native.load_csv(FIXTURE)
    _same(got, (ref.x, ref.y, ref.t, ref.p))
    _same(got, jnative.load_csv(FIXTURE))
    with pytest.raises(FileNotFoundError):
        native.load_csv(f"{DATA_DIR}/no_such_file.csv")


def test_native_analyze_coordinates():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 50, 1000).astype(np.int32)
    ys = rng.integers(0, 50, 1000).astype(np.int32)
    ux, uy = native.analyze_coordinates(xs, ys)
    seen, want = set(), []
    for x, y in zip(xs.tolist(), ys.tolist()):
        if (x, y) not in seen:
            seen.add((x, y))
            want.append((x, y))
    assert list(zip(ux.tolist(), uy.tolist())) == want
    _same((ux, uy), jnative.analyze_coordinates(xs, ys))


@pytest.mark.parametrize("vectorize", [True, False])
def test_native_evt3_matches_numpy_and_the_jax_package(tmp_path, vectorize):
    s = _stream()
    path = str(tmp_path / "rec.raw")
    evt3.save_evt3(s, path, vectorize=vectorize)
    payload = _payload(path)
    got = native.decode_evt3(payload)
    _same(got, evt3.decode_evt3_numpy(payload))
    _same(got, jnative.decode_evt3(payload))
    _same(got, (s.x, s.y, s.t, s.p))


def test_native_evt3_time_high_wrap():
    words = [0x8000 | 0xFFF, 0x6000 | 0x001, 0x0000 | 100, 0x2000 | (1 << 11) | 7,
             0x8000 | 0x000, 0x6000 | 0x002, 0x2000 | 9]
    payload = np.asarray(words, "<u2").tobytes()
    x, y, t, p = native.decode_evt3(payload)
    assert t.tolist() == [(0xFFF << 12) + 1, (1 << 24) + 2]
    assert x.tolist() == [7, 9] and y.tolist() == [100, 100] and p.tolist() == [1, 0]


@pytest.mark.parametrize("fmt", ["evt2", "evt21", "evt21-swapped"])
def test_native_evt2_matches_numpy_and_the_jax_package(tmp_path, fmt):
    s = _stream()
    path = str(tmp_path / "rec.raw")
    swapped = fmt == "evt21-swapped"
    if fmt == "evt2":
        evt2.save_evt2(s, path)
    else:
        evt2.save_evt21(s, path, swapped_halves=swapped)
    payload = _payload(path)
    if fmt == "evt2":
        got, ref, theirs = (native.decode_evt2(payload), evt2.decode_evt2_numpy(payload),
                            jnative.decode_evt2(payload))
    else:
        got = native.decode_evt21(payload, swapped_halves=swapped)
        ref = evt2.decode_evt21_numpy(payload, swapped_halves=swapped)
        theirs = jnative.decode_evt21(payload, swapped_halves=swapped)
    _same(got, ref)
    _same(got, theirs)
    _same(got, (s.x, s.y, s.t, s.p))


@pytest.mark.parametrize("fmt", ["evt3", "evt2", "evt21", "evt21-swapped"])
def test_raw_loaders_take_the_native_path(tmp_path, fmt, monkeypatch):
    s = _stream()
    path = str(tmp_path / "rec.raw")
    {"evt3": lambda: evt3.save_evt3(s, path), "evt2": lambda: evt2.save_evt2(s, path),
     "evt21": lambda: evt2.save_evt21(s, path),
     "evt21-swapped": lambda: evt2.save_evt21(s, path, swapped_halves=True)}[fmt]()
    loader = evt3.load_evt3 if fmt == "evt3" else evt2.load_evt2
    numpy_path = loader(path, use_native=False)
    calls = []
    for name in ("decode_evt3", "decode_evt2", "decode_evt21"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k))
    for got in (loader(path), load(path)):
        _same((got.x, got.y, got.t, got.p), (numpy_path.x, numpy_path.y, numpy_path.t,
                                             numpy_path.p))
    assert len(calls) == 2


def test_evio_build_failure_raises(monkeypatch, tmp_path):
    """The readers need the build: a source g++ cannot compile raises."""
    bad = tmp_path / "evio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(bad)
