"""Dependency-free raster image + PPM I/O + Bresenham drawing (a copy of
evflow_tpu/utils/ppm.py).

Replacement for optics-clustering/include/optics/bgr_image.hpp:
bgr_col (:19), img_pos (:49), binary-P6 save appending ".ppm" (:177-202),
plot_pixel/line_segment/circle (:283-317). numpy-backed; used by the
reachability/cluster plot renderers and the pipeline frame dumps (the
reference dumps cluster_frame_combinedN.jpg via OpenCV, accel …store.cpp:561).
"""

from __future__ import annotations

import numpy as np


class BGRImage:
    """(H, W, 3) uint8 image, channels BGR like the reference."""

    def __init__(self, width: int, height: int, fill=(255, 255, 255)):
        self.px = np.empty((height, width, 3), np.uint8)
        self.px[:] = np.asarray(fill, np.uint8)

    @property
    def width(self) -> int:
        return self.px.shape[1]

    @property
    def height(self) -> int:
        return self.px.shape[0]

    def in_bounds(self, x: int, y: int) -> bool:
        return 0 <= x < self.width and 0 <= y < self.height

    def set_pixel(self, x: int, y: int, col) -> None:
        if self.in_bounds(x, y):
            self.px[y, x] = col

    def get_pixel(self, x: int, y: int):
        return tuple(int(v) for v in self.px[y, x])

    def line(self, x0: int, y0: int, x1: int, y1: int, col) -> None:
        """Bresenham segment (bgr_image.hpp plot_line_segment)."""
        dx = abs(x1 - x0); sx = 1 if x0 < x1 else -1
        dy = -abs(y1 - y0); sy = 1 if y0 < y1 else -1
        err = dx + dy
        x, y = x0, y0
        while True:
            self.set_pixel(x, y, col)
            if x == x1 and y == y1:
                break
            e2 = 2 * err
            if e2 >= dy:
                err += dy; x += sx
            if e2 <= dx:
                err += dx; y += sy

    def line_antialiased(self, x0: int, y0: int, x1: int, y1: int, col) -> None:
        """Coverage-blended segment (parity with bgr_image.hpp's
        plot_line_segment_antialiased, :283-317): each step paints the two
        pixels straddling the ideal line, weighted by distance — Wu-style,
        implemented independently. Blends toward `col` over the existing
        background."""
        col = np.asarray(col, np.float32)

        def plot(x, y, a):
            if 0 <= x < self.width and 0 <= y < self.height:
                bg = self.px[y, x].astype(np.float32)
                self.px[y, x] = np.clip(bg * (1.0 - a) + col * a, 0, 255) \
                    .astype(np.uint8)

        steep = abs(y1 - y0) > abs(x1 - x0)
        if steep:
            x0, y0, x1, y1 = y0, x0, y1, x1
        if x0 > x1:
            x0, x1, y0, y1 = x1, x0, y1, y0
        dx = x1 - x0
        grad = (y1 - y0) / dx if dx else 0.0
        y = float(y0)
        for x in range(x0, x1 + 1):
            yi = int(np.floor(y))
            frac = y - yi
            if steep:
                plot(yi, x, 1.0 - frac)
                plot(yi + 1, x, frac)
            else:
                plot(x, yi, 1.0 - frac)
                plot(x, yi + 1, frac)
            y += grad

    def circle(self, cx: int, cy: int, r: int, col, filled: bool = False) -> None:
        if filled:
            for y in range(cy - r, cy + r + 1):
                for x in range(cx - r, cx + r + 1):
                    if (x - cx) ** 2 + (y - cy) ** 2 <= r * r:
                        self.set_pixel(x, y, col)
            return
        x, y, err = r, 0, 0   # midpoint circle
        while x >= y:
            for px, py in ((x, y), (y, x), (-y, x), (-x, y),
                           (-x, -y), (-y, -x), (y, -x), (x, -y)):
                self.set_pixel(cx + px, cy + py, col)
            y += 1
            err += 1 + 2 * y
            if 2 * (err - x) + 1 > 0:
                x -= 1
                err += 1 - 2 * x

    def arrow(self, x0, y0, x1, y1, col, head: int = 4) -> None:
        """arrowedLine equivalent for flow vectors."""
        self.line(x0, y0, x1, y1, col)
        v = np.array([x1 - x0, y1 - y0], float)
        n = np.linalg.norm(v)
        if n < 1e-6:
            return
        v /= n
        perp = np.array([-v[1], v[0]])
        for s in (+1, -1):
            tip = np.array([x1, y1]) - v * head + perp * head * 0.5 * s
            self.line(x1, y1, int(round(tip[0])), int(round(tip[1])), col)

    def text(self, x: int, y: int, s: str, col) -> None:
        """Tiny built-in 5×7 bitmap text (no font dependency) — parity with
        the reference's cv::putText labels (group_track.cpp:582-623: the
        "%.1f px/f" group-velocity magnitude and the "label(Gk)" corner
        tags). (x, y) is the text BASELINE-left like putText; glyphs render
        above it. Unknown characters advance without painting."""
        gx = x
        for ch in s:
            rows = _FONT5x7.get(ch)
            if rows is not None:
                for r, bits in enumerate(rows):
                    for c in range(5):
                        if bits & (0b10000 >> c):
                            self.set_pixel(gx + c, y - 7 + r, col)
            gx += 6

    def append_rows(self, other: "BGRImage") -> "BGRImage":
        assert other.width == self.width
        out = BGRImage(self.width, self.height + other.height)
        out.px[:self.height] = self.px
        out.px[self.height:] = other.px
        return out

    def save(self, path: str) -> str:
        """Binary PPM P6; appends '.ppm' like the reference (hpp:177-202)."""
        if not path.endswith(".ppm"):
            path = path + ".ppm"
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (self.width, self.height))
            # PPM is RGB; internal storage is BGR
            f.write(self.px[:, :, ::-1].tobytes())
        return path

    @staticmethod
    def load(path: str) -> "BGRImage":
        with open(path, "rb") as f:
            data = f.read()
        assert data[:2] == b"P6", "only binary P6 supported"
        parts = data.split(b"\n", 3)
        w, h = map(int, parts[1].split())
        px = np.frombuffer(parts[3], np.uint8)[: w * h * 3].reshape(h, w, 3)
        img = BGRImage(w, h)
        img.px[:] = px[:, :, ::-1]
        return img


# 5x7 glyphs (rows top->bottom, 5-bit masks, MSB = left column) covering the
# characters the reference's renderer emits: digits, "px/f", "(Gk)", minus,
# dot. Hand-authored standard matrix-display shapes.
_FONT5x7 = {
    "0": (0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110),
    "1": (0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "2": (0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0b01000, 0b11111),
    "3": (0b11111, 0b00010, 0b00100, 0b00010, 0b00001, 0b10001, 0b01110),
    "4": (0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010),
    "5": (0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110),
    "6": (0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110),
    "7": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000),
    "8": (0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110),
    "9": (0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100),
    ".": (0b00000, 0b00000, 0b00000, 0b00000, 0b00000, 0b01100, 0b01100),
    "-": (0b00000, 0b00000, 0b00000, 0b01110, 0b00000, 0b00000, 0b00000),
    "(": (0b00010, 0b00100, 0b01000, 0b01000, 0b01000, 0b00100, 0b00010),
    ")": (0b01000, 0b00100, 0b00010, 0b00010, 0b00010, 0b00100, 0b01000),
    "/": (0b00001, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0b10000),
    "G": (0b01110, 0b10001, 0b10000, 0b10111, 0b10001, 0b10001, 0b01111),
    "p": (0b00000, 0b00000, 0b11110, 0b10001, 0b11110, 0b10000, 0b10000),
    "x": (0b00000, 0b00000, 0b10001, 0b01010, 0b00100, 0b01010, 0b10001),
    "f": (0b00110, 0b01001, 0b01000, 0b11100, 0b01000, 0b01000, 0b01000),
    " ": (0b00000,) * 7,
}
