"""Event-stream I/O: the port's own copy of evflow_tpu/io (numpy, and the
native decoders of `native/evio.cpp` for `.raw` recordings)."""

from .events import EventStream, empty_stream, load, load_csv, load_npz, load_raw_i32, save_csv, save_npz, save_raw_i32
from .evt3 import load_evt3, save_evt3
from .slicing import EventSlices, slice_by_count, slice_by_time, decimate
from . import synthetic
