"""Metavision EVT3 `.raw` reader/writer.

The reference's actual camera input is a Prophesee recording replayed via
`Metavision::Camera::from_file` (accel …store.cpp:336). Those files are the
public EVT 3.0 format: an ASCII header of '%'-prefixed lines, then a stream
of little-endian 16-bit words with a 4-bit type tag (OpenEB
evt3_raw_format.h):

  0x0 EVT_ADDR_Y    bits 10:0 = y (bit 11 = master/slave camera, ignored)
  0x2 EVT_ADDR_X    bits 10:0 = x, bit 11 = polarity; emits one CD event
  0x3 VECT_BASE_X   bits 10:0 = x base, bit 11 = polarity for vector words
  0x4 VECT_12       bits 11:0 = validity mask -> <=12 events, base += 12
  0x5 VECT_8        bits  7:0 = validity mask -> <=8 events,  base += 8
  0x6 EVT_TIME_LOW  bits 11:0 = t[11:0]   (µs)
  0x8 EVT_TIME_HIGH bits 11:0 = t[23:12]; a wrap adds a 2^24 µs epoch
  0x7/0xA/0xE/0xF   CONTINUED_4 / EXT_TRIGGER / OTHERS / CONTINUED_12 (no CD)

Decoding is sequential-stateful in spirit (y / time / vector base persist
across words) but fully vectorizable: every per-word state is a forward fill
of the last setter word, and the vector base offset within a VECT_BASE_X run
is an exclusive prefix sum of the 12/8 increments. The numpy decoder below
does exactly that; the native path (evflow_tpu_torch/native/evio.cpp:
evio_decode_evt3) is a plain scalar loop for ingest-rate decoding. Both are
cross-checked in tests/test_torch_native.py.
"""

from __future__ import annotations

import io as _pyio
from typing import Tuple

import numpy as np

from .events import EventStream, empty_stream


def split_header(blob: bytes) -> Tuple[dict, int]:
    """Parse the ASCII '%' header. Returns (fields, payload byte offset).

    Header lines look like `% key value...`; known keys of interest:
    `evt 3.0` / `format EVT3;height=720;width=1280` / `geometry 1280x720`.
    The binary payload starts at the first line that does not begin with '%'.
    """
    fields: dict = {}
    off = 0
    while off < len(blob) and blob[off:off + 1] == b"%":
        nl = blob.find(b"\n", off)
        if nl < 0:
            nl = len(blob)
        line = blob[off:nl].decode("latin-1").lstrip("% ").strip()
        off = nl + 1
        if not line:
            continue
        key, _, val = line.partition(" ")
        fields[key] = val
        if key == "format":
            for part in val.split(";"):
                k, _, v = part.partition("=")
                if v:
                    fields[k] = v
        if key == "geometry" and "x" in val:
            w, _, h = val.partition("x")
            fields.setdefault("width", w)
            fields.setdefault("height", h)
        if key == "end":
            break
    return fields, off


def _ffill_idx(mask: np.ndarray) -> np.ndarray:
    """Index of the most recent True at or before each position (-1 if none)."""
    idx = np.where(mask, np.arange(len(mask)), -1)
    np.maximum.accumulate(idx, out=idx)
    return idx


def decode_evt3_numpy(payload: bytes) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]:
    """Vectorized EVT3 payload decode -> (x, y, t, p) in stream order."""
    if len(payload) % 2:
        payload = payload[:-1]  # truncated trailing byte
    w = np.frombuffer(payload, dtype="<u2")
    if len(w) == 0:
        return (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.int64),
                                               np.zeros(0, np.int32))
    typ = (w >> 12).astype(np.uint8)
    nw = len(w)

    # --- time: forward-fill TIME_HIGH (with wrap epochs) and TIME_LOW
    is_th = typ == 0x8
    th_pos = np.flatnonzero(is_th)
    t_high_at = np.zeros(nw, np.int64)
    if len(th_pos):
        th_vals = (w[th_pos] & 0xFFF).astype(np.int64)
        epochs = np.zeros(len(th_vals), np.int64)
        epochs[1:] = (th_vals[1:] < th_vals[:-1]).astype(np.int64)
        th_full = np.cumsum(epochs) * (1 << 24) + (th_vals << 12)
        fi = _ffill_idx(is_th)
        t_high_at = np.where(fi >= 0, th_full[np.searchsorted(th_pos, np.maximum(fi, 0))], 0)
    is_tl = typ == 0x6
    fi = _ffill_idx(is_tl)
    t_low_at = np.where(fi >= 0, (w[np.maximum(fi, 0)] & 0xFFF).astype(np.int64), 0)
    t_at = t_high_at + t_low_at

    # --- y: forward-fill ADDR_Y
    fi = _ffill_idx(typ == 0x0)
    y_at = np.where(fi >= 0, (w[np.maximum(fi, 0)] & 0x7FF).astype(np.int32), 0)

    # --- vector base x and polarity: forward-fill VECT_BASE_X, plus the
    # exclusive prefix of 12/8 increments since that base word
    is_base = typ == 0x3
    fi_base = _ffill_idx(is_base)
    base_at = np.where(fi_base >= 0,
                       (w[np.maximum(fi_base, 0)] & 0x7FF).astype(np.int32), 0)
    vpol_at = np.where(fi_base >= 0,
                       ((w[np.maximum(fi_base, 0)] >> 11) & 1).astype(np.int32), 0)
    inc = np.where(typ == 0x4, 12, np.where(typ == 0x5, 8, 0)).astype(np.int64)
    cum_ex = np.cumsum(inc) - inc                     # increments BEFORE this word
    cum_at_base = np.where(fi_base >= 0, cum_ex[np.maximum(fi_base, 0)], 0)
    vbase_at = base_at + (cum_ex - cum_at_base).astype(np.int32)

    out_x, out_y, out_t, out_p, out_key = [], [], [], [], []

    # --- single events (EVT_ADDR_X)
    sp = np.flatnonzero(typ == 0x2)
    if len(sp):
        out_x.append((w[sp] & 0x7FF).astype(np.int32))
        out_y.append(y_at[sp])
        out_t.append(t_at[sp])
        out_p.append(((w[sp] >> 11) & 1).astype(np.int32))
        out_key.append(sp.astype(np.int64) * 16)

    # --- vector events
    for t_code, nbits in ((0x4, 12), (0x5, 8)):
        vp = np.flatnonzero(typ == t_code)
        if not len(vp):
            continue
        bits = ((w[vp][:, None] >> np.arange(nbits)[None, :]) & 1).astype(bool)
        rows, cols = np.nonzero(bits)
        out_x.append(vbase_at[vp][rows] + cols.astype(np.int32))
        out_y.append(y_at[vp][rows])
        out_t.append(t_at[vp][rows])
        out_p.append(vpol_at[vp][rows])
        out_key.append(vp[rows].astype(np.int64) * 16 + cols)

    if not out_x:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int64), np.zeros(0, np.int32))
    x = np.concatenate(out_x)
    y = np.concatenate(out_y)
    t = np.concatenate(out_t)
    p = np.concatenate(out_p)
    order = np.argsort(np.concatenate(out_key), kind="stable")
    return x[order], y[order], t[order], p[order]


def load_evt3(path: str, use_native: bool = True) -> EventStream:
    """Read a Metavision EVT3 `.raw` recording into an EventStream."""
    with open(path, "rb") as f:
        blob = f.read()
    fields, off = split_header(blob)
    fmt = fields.get("format", fields.get("evt", ""))
    if "EVT3" not in fmt.upper() and "3.0" not in fmt and "3.1" not in fmt:
        raise ValueError(
            f"{path}: not an EVT3 recording (header format={fmt!r}); "
            "for EVT2/EVT2.1 use io/evt2.py (events.load dispatches all "
            "three generations by header)")
    payload = blob[off:]
    if use_native:
        from .. import native
        return EventStream(*native.decode_evt3(payload))
    return EventStream(*decode_evt3_numpy(payload))


def save_evt3(stream: EventStream, path: str, width: int = 1280,
              height: int = 720, vectorize: bool = True) -> None:
    """Encode an EventStream as an EVT3 `.raw` file.

    Emits TIME_HIGH/TIME_LOW/ADDR_Y words only on change; with `vectorize`,
    runs of events sharing (t, y, p) are packed into VECT_BASE_X + VECT_12
    words (each covering a 12-wide x window), exercising the decoder's vector
    path. Events must be time-sorted.
    """
    x = np.asarray(stream.x, np.int64)
    y = np.asarray(stream.y, np.int64)
    t = np.asarray(stream.t, np.int64)
    p = np.asarray(stream.p, np.int64)
    words = []
    last_th = last_tl = last_y = None
    i, n = 0, len(x)
    while i < n:
        th, tl = (t[i] >> 12) & 0xFFF, t[i] & 0xFFF
        # epoch wraps are encoded implicitly: TIME_HIGH simply wraps and the
        # decoder re-adds the 2^24 epoch on decrease
        if th != last_th:
            words.append(0x8000 | int(th)); last_th = th
        if tl != last_tl:
            words.append(0x6000 | int(tl)); last_tl = tl
        if y[i] != last_y:
            words.append(0x0000 | (int(y[i]) & 0x7FF)); last_y = y[i]
        # run of events sharing (t, y, p) with non-decreasing x
        j = i + 1
        while (vectorize and j < n and t[j] == t[i] and y[j] == y[i]
               and p[j] == p[i] and x[j] >= x[j - 1]):
            j += 1
        if vectorize and j - i >= 2:
            k = i
            while k < j:
                base = int(x[k])
                words.append(0x3000 | (int(p[i]) << 11) | (base & 0x7FF))
                mask = 0
                while k < j and x[k] < base + 12:
                    mask |= 1 << int(x[k] - base)
                    k += 1
                words.append(0x4000 | mask)
            i = j
        else:
            words.append(0x2000 | (int(p[i]) << 11) | (int(x[i]) & 0x7FF))
            i += 1
    header = ("% camera_integrator_name evflow-tpu\n"
              "% evt 3.0\n"
              f"% format EVT3;height={height};width={width}\n"
              f"% geometry {width}x{height}\n"
              "% end\n").encode()
    with open(path, "wb") as f:
        f.write(header)
        np.asarray(words, dtype="<u2").tofile(f)
