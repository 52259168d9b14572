"""Metavision EVT2 / EVT2.1 `.raw` readers/writers.

The reference replays Prophesee recordings via `Metavision::Camera::from_file`
(accel …store.cpp:336), which accepts every RAW generation — EVT2, EVT2.1 and
EVT3 (io/evt3.py covers EVT3). These are the other two public formats (OpenEB
evt2_raw_format.h / evt21_raw_format.h):

EVT 2.0 — little-endian 32-bit words, 4-bit type in bits [31:28]:
  0x0 CD_OFF / 0x1 CD_ON   bits [27:22] = t[5:0] (µs LSBs),
                           bits [21:11] = x, bits [10:0] = y; type = polarity
  0x8 EVT_TIME_HIGH        bits [27:0]  = t[33:6]; a wrap adds a 2^34 µs epoch
  0xA EXT_TRIGGER, 0xE OTHERS, 0xF CONTINUED — no CD events

EVT 2.1 — little-endian 64-bit words, 4-bit type in bits [63:60]:
  0x0 EVT_NEG / 0x1 EVT_POS  vector CD event: bits [59:54] = t[5:0],
                             bits [53:43] = x base, bits [42:32] = y,
                             bits [31:0] = validity mask — bit i set emits an
                             event at (x+i, y); type = polarity
  0x8 EVT_TIME_HIGH          bits [59:32] = t[33:6] (same epoch-wrap rule)
  0xA EXT_TRIGGER, 0xE OTHERS — no CD events

Early EVT2.1 recordings store each 64-bit word as two 32-bit little-endian
halves with the HIGH half first ("legacy"/word-swapped variant). The reader
auto-detects it: in the correct interpretation virtually every word's type
nibble is a known code, in the swapped one it is noise (`_detect_swapped`).

Decoding is the same forward-fill formulation as EVT3: per-word time state is
a forward fill of the last TIME_HIGH; everything else is carried by the event
word itself, so both decoders are pure vectorized numpy, with native C++
counterparts for ingest-rate decoding (native/evio.cpp:evio_decode_evt2/
evt21; cross-checked in tests/test_torch_native.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .events import EventStream


_EVT2_TYPES = (0x0, 0x1, 0x8, 0xA, 0xE, 0xF)
_EVT21_TYPES = (0x0, 0x1, 0x8, 0xA, 0xE, 0xF)


def _ffill_time_high(is_th: np.ndarray, th_vals: np.ndarray,
                     nw: int) -> np.ndarray:
    """Forward-filled full TIME_HIGH (t[33:6] + wrap epochs) per word."""
    th_pos = np.flatnonzero(is_th)
    out = np.zeros(nw, np.int64)
    if not len(th_pos):
        return out
    vals = th_vals[th_pos].astype(np.int64)
    epochs = np.zeros(len(vals), np.int64)
    epochs[1:] = (vals[1:] < vals[:-1]).astype(np.int64)
    full = np.cumsum(epochs) * (1 << 28) + vals
    idx = np.where(is_th, np.arange(nw), -1)
    np.maximum.accumulate(idx, out=idx)
    return np.where(idx >= 0, full[np.searchsorted(th_pos, np.maximum(idx, 0))], 0)


def decode_evt2_numpy(payload: bytes) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]:
    """Vectorized EVT2 payload decode -> (x, y, t, p) in stream order."""
    payload = payload[:len(payload) - len(payload) % 4]
    w = np.frombuffer(payload, dtype="<u4")
    if len(w) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int64), np.zeros(0, np.int32))
    typ = (w >> 28).astype(np.uint8)
    th_at = _ffill_time_high(typ == 0x8, w & 0x0FFFFFFF, len(w))
    cd = np.flatnonzero(typ <= 0x1)
    wc = w[cd]
    x = ((wc >> 11) & 0x7FF).astype(np.int32)
    y = (wc & 0x7FF).astype(np.int32)
    t = (th_at[cd] << 6) | ((wc >> 22) & 0x3F).astype(np.int64)
    p = typ[cd].astype(np.int32)
    return x, y, t, p


def decode_evt21_numpy(payload: bytes, swapped_halves: bool | None = None
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
    """Vectorized EVT2.1 payload decode -> (x, y, t, p) in stream order.

    swapped_halves=None auto-detects the legacy 32-bit-half-swapped layout.
    """
    payload = payload[:len(payload) - len(payload) % 8]
    w = np.frombuffer(payload, dtype="<u8")
    if len(w) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int64), np.zeros(0, np.int32))
    if swapped_halves is None:
        swapped_halves = _detect_swapped(w)
    if swapped_halves:
        w = (w << 32) | (w >> 32)
    typ = (w >> 60).astype(np.uint8)
    th_at = _ffill_time_high(typ == 0x8, (w >> 32) & 0x0FFFFFFF, len(w))
    cd = np.flatnonzero(typ <= 0x1)
    wc = w[cd]
    valid = (wc & 0xFFFFFFFF).astype(np.uint32)
    bits = ((valid[:, None] >> np.arange(32)[None, :]) & 1).astype(bool)
    rows, cols = np.nonzero(bits)
    x = ((wc >> 43) & 0x7FF).astype(np.int32)[rows] + cols.astype(np.int32)
    y = ((wc >> 32) & 0x7FF).astype(np.int32)[rows]
    t = ((th_at[cd] << 6) | ((wc >> 54) & 0x3F).astype(np.int64))[rows]
    p = typ[cd].astype(np.int32)[rows]
    return x, y, t, p


def _detect_swapped(w: np.ndarray, sample: int = 4096) -> bool:
    """True if the legacy half-swapped 64-bit layout fits the words better.

    Discriminator: TIME_HIGH words (type nibble 0x8) carry their 28-bit value
    in bits [59:32] and PAD ZEROS in bits [31:0] — and TH words recur every
    <=64 µs, so a real stream has many. Count words matching that signature
    under both interpretations; event words masquerading as TH under the
    wrong layout would need x = y = ts = 0 or an all-zero validity mask, so
    the correct layout wins decisively. (A plain known-type-nibble vote is
    NOT sufficient: sparse validity masks make a swapped word's top nibble
    0x0 — itself a valid type code.)
    """
    ws = w[:sample]
    sw = (ws << np.uint64(32)) | (ws >> np.uint64(32))

    def th_score(v):
        return int(np.sum(((v >> np.uint64(60)) == 0x8)
                          & ((v & np.uint64(0xFFFFFFFF)) == 0)))

    return th_score(sw) > th_score(ws)


def load_evt2(path: str, use_native: bool = True) -> EventStream:
    """Read a Metavision EVT2 or EVT2.1 `.raw` recording into an EventStream."""
    from .evt3 import split_header
    with open(path, "rb") as f:
        blob = f.read()
    fields, off = split_header(blob)
    fmt = _format_of(fields)
    payload = blob[off:]
    if fmt == "EVT2":
        if use_native:
            from .. import native
            return EventStream(*native.decode_evt2(payload))
        return EventStream(*decode_evt2_numpy(payload))
    if fmt == "EVT21":
        if use_native:
            from .. import native
            w = np.frombuffer(payload[:len(payload) - len(payload) % 8],
                              dtype="<u8")
            return EventStream(*native.decode_evt21(
                payload, swapped_halves=_detect_swapped(w)))
        return EventStream(*decode_evt21_numpy(payload))
    raise ValueError(f"{path}: not an EVT2/EVT2.1 recording "
                     f"(header format={fields.get('format', '')!r})")


def _format_of(fields: dict) -> str:
    """Normalize the header's format/evt fields to EVT2 | EVT21 | EVT3 | ''."""
    fmt = str(fields.get("format", "")).upper()
    evt = str(fields.get("evt", ""))
    if "EVT3" in fmt or evt.startswith("3"):
        return "EVT3"
    if "EVT21" in fmt or "EVT2.1" in fmt or evt.startswith("2.1"):
        return "EVT21"
    if "EVT2" in fmt or evt.startswith("2"):
        return "EVT2"
    return ""


def load_metavision_raw(path: str) -> EventStream:
    """Header-sniffing dispatch across all three RAW generations."""
    from .evt3 import split_header, load_evt3
    with open(path, "rb") as f:
        head = f.read(4096)
    fields, _ = split_header(head)
    fmt = _format_of(fields)
    if fmt == "EVT3":
        return load_evt3(path)
    if fmt in ("EVT2", "EVT21"):
        return load_evt2(path)
    raise ValueError(f"{path}: unrecognized Metavision RAW generation "
                     f"(header format={fields.get('format', '')!r}, "
                     f"evt={fields.get('evt', '')!r})")


def _header(fmt: str, width: int, height: int) -> bytes:
    evt = {"EVT2": "2.0", "EVT21": "2.1"}[fmt]
    return ("% camera_integrator_name evflow-tpu\n"
            f"% evt {evt}\n"
            f"% format {fmt};height={height};width={width}\n"
            f"% geometry {width}x{height}\n"
            "% end\n").encode()


def save_evt2(stream: EventStream, path: str, width: int = 1280,
              height: int = 720) -> None:
    """Encode an EventStream as an EVT2 `.raw` file (TIME_HIGH on change)."""
    x = np.asarray(stream.x, np.int64)
    y = np.asarray(stream.y, np.int64)
    t = np.asarray(stream.t, np.int64)
    p = np.asarray(stream.p, np.int64)
    words = []
    last_th = None
    for i in range(len(x)):
        th = (t[i] >> 6) & 0x0FFFFFFF
        if th != last_th:
            words.append((0x8 << 28) | int(th))
            last_th = th
        words.append((int(p[i] & 1) << 28) | ((int(t[i]) & 0x3F) << 22)
                     | ((int(x[i]) & 0x7FF) << 11) | (int(y[i]) & 0x7FF))
    with open(path, "wb") as f:
        f.write(_header("EVT2", width, height))
        np.asarray(words, dtype="<u4").tofile(f)


def save_evt21(stream: EventStream, path: str, width: int = 1280,
               height: int = 720, vectorize: bool = True,
               swapped_halves: bool = False) -> None:
    """Encode an EventStream as an EVT2.1 `.raw` file.

    With `vectorize`, runs of events sharing (t, y, p) with ascending x pack
    into one vector word per 32-wide x window (exercising the validity-mask
    path); `swapped_halves` writes the legacy half-swapped layout to test the
    reader's auto-detection. Events must be time-sorted.
    """
    x = np.asarray(stream.x, np.int64)
    y = np.asarray(stream.y, np.int64)
    t = np.asarray(stream.t, np.int64)
    p = np.asarray(stream.p, np.int64)
    words = []
    last_th = None
    i, n = 0, len(x)
    while i < n:
        th = (t[i] >> 6) & 0x0FFFFFFF
        if th != last_th:
            words.append((0x8 << 60) | (int(th) << 32))
            last_th = th
        j = i + 1
        while (vectorize and j < n and t[j] == t[i] and y[j] == y[i]
               and p[j] == p[i] and x[j] > x[j - 1]):
            j += 1
        k = i
        while k < j:
            base = int(x[k])
            mask = 0
            while k < j and x[k] < base + 32:
                mask |= 1 << int(x[k] - base)
                k += 1
            words.append((int(p[i] & 1) << 60) | ((int(t[i]) & 0x3F) << 54)
                         | ((base & 0x7FF) << 43) | ((int(y[i]) & 0x7FF) << 32)
                         | mask)
        i = j
    w = np.asarray(words, dtype="<u8")
    if swapped_halves:
        w = (w << np.uint64(32)) | (w >> np.uint64(32))
    with open(path, "wb") as f:
        f.write(_header("EVT21", width, height))
        w.tofile(f)
