"""Rasterize the minidot EPS dialect to PNG — no external tools.

The reference emits EPS only (reference: src/minidot/eps.h; users need
ghostscript/ImageMagick to view it).  Our EPS writer (io.eps) produces a
small fixed operator set — L / LX / LY segments, C color, setgray,
setlinewidth, (…) LS/MS/RS text — so this module interprets exactly that
dialect and renders to PNG with a pure-zlib encoder.  Text labels are
drawn with a built-in 5x7 bitmap font (good enough for axis names in a
quick-look raster; the EPS remains the publication artifact).
"""

import struct
import zlib

import numpy as np

# 5x7 bitmap font: columns LSB=top row; covers the characters contig
# names and numbers use.  Unknown glyphs render as a faint box.
_FONT = {
    "0": (0x3E, 0x51, 0x49, 0x45, 0x3E), "1": (0x00, 0x42, 0x7F, 0x40, 0),
    "2": (0x42, 0x61, 0x51, 0x49, 0x46), "3": (0x21, 0x41, 0x45, 0x4B, 0x31),
    "4": (0x18, 0x14, 0x12, 0x7F, 0x10), "5": (0x27, 0x45, 0x45, 0x45, 0x39),
    "6": (0x3C, 0x4A, 0x49, 0x49, 0x30), "7": (0x01, 0x71, 0x09, 0x05, 0x03),
    "8": (0x36, 0x49, 0x49, 0x49, 0x36), "9": (0x06, 0x49, 0x49, 0x29, 0x1E),
    "a": (0x20, 0x54, 0x54, 0x54, 0x78), "b": (0x7F, 0x48, 0x44, 0x44, 0x38),
    "c": (0x38, 0x44, 0x44, 0x44, 0x20), "d": (0x38, 0x44, 0x44, 0x48, 0x7F),
    "e": (0x38, 0x54, 0x54, 0x54, 0x18), "f": (0x08, 0x7E, 0x09, 0x01, 0x02),
    "g": (0x0C, 0x52, 0x52, 0x52, 0x3E), "h": (0x7F, 0x08, 0x04, 0x04, 0x78),
    "i": (0x00, 0x44, 0x7D, 0x40, 0x00), "j": (0x20, 0x40, 0x44, 0x3D, 0),
    "k": (0x7F, 0x10, 0x28, 0x44, 0x00), "l": (0x00, 0x41, 0x7F, 0x40, 0),
    "m": (0x7C, 0x04, 0x18, 0x04, 0x78), "n": (0x7C, 0x08, 0x04, 0x04, 0x78),
    "o": (0x38, 0x44, 0x44, 0x44, 0x38), "p": (0x7C, 0x14, 0x14, 0x14, 0x08),
    "q": (0x08, 0x14, 0x14, 0x18, 0x7C), "r": (0x7C, 0x08, 0x04, 0x04, 0x08),
    "s": (0x48, 0x54, 0x54, 0x54, 0x20), "t": (0x04, 0x3F, 0x44, 0x40, 0x20),
    "u": (0x3C, 0x40, 0x40, 0x20, 0x7C), "v": (0x1C, 0x20, 0x40, 0x20, 0x1C),
    "w": (0x3C, 0x40, 0x30, 0x40, 0x3C), "x": (0x44, 0x28, 0x10, 0x28, 0x44),
    "y": (0x0C, 0x50, 0x50, 0x50, 0x3C), "z": (0x44, 0x64, 0x54, 0x4C, 0x44),
    "A": (0x7E, 0x11, 0x11, 0x11, 0x7E), "B": (0x7F, 0x49, 0x49, 0x49, 0x36),
    "C": (0x3E, 0x41, 0x41, 0x41, 0x22), "D": (0x7F, 0x41, 0x41, 0x22, 0x1C),
    "E": (0x7F, 0x49, 0x49, 0x49, 0x41), "F": (0x7F, 0x09, 0x09, 0x09, 0x01),
    "G": (0x3E, 0x41, 0x49, 0x49, 0x7A), "H": (0x7F, 0x08, 0x08, 0x08, 0x7F),
    "I": (0x00, 0x41, 0x7F, 0x41, 0x00), "J": (0x20, 0x40, 0x41, 0x3F, 0x01),
    "K": (0x7F, 0x08, 0x14, 0x22, 0x41), "L": (0x7F, 0x40, 0x40, 0x40, 0x40),
    "M": (0x7F, 0x02, 0x0C, 0x02, 0x7F), "N": (0x7F, 0x04, 0x08, 0x10, 0x7F),
    "O": (0x3E, 0x41, 0x41, 0x41, 0x3E), "P": (0x7F, 0x09, 0x09, 0x09, 0x06),
    "Q": (0x3E, 0x41, 0x51, 0x21, 0x5E), "R": (0x7F, 0x09, 0x19, 0x29, 0x46),
    "S": (0x46, 0x49, 0x49, 0x49, 0x31), "T": (0x01, 0x01, 0x7F, 0x01, 0x01),
    "U": (0x3F, 0x40, 0x40, 0x40, 0x3F), "V": (0x1F, 0x20, 0x40, 0x20, 0x1F),
    "W": (0x3F, 0x40, 0x38, 0x40, 0x3F), "X": (0x63, 0x14, 0x08, 0x14, 0x63),
    "Y": (0x07, 0x08, 0x70, 0x08, 0x07), "Z": (0x61, 0x51, 0x49, 0x45, 0x43),
    "_": (0x40, 0x40, 0x40, 0x40, 0x40), "-": (0x08, 0x08, 0x08, 0x08, 8),
    ".": (0x00, 0x60, 0x60, 0x00, 0x00), ":": (0x00, 0x36, 0x36, 0x00, 0),
    "#": (0x14, 0x7F, 0x14, 0x7F, 0x14), "/": (0x20, 0x10, 0x08, 0x04, 2),
    " ": (0, 0, 0, 0, 0),
}


class _Canvas:
    def __init__(self, w: int, h: int, scale: float):
        self.scale = scale
        self.w = max(int(round(w * scale)), 1)
        self.h = max(int(round(h * scale)), 1)
        self.img = np.full((self.h, self.w, 3), 255, dtype=np.uint8)
        self.rgb = (0, 0, 0)
        self.lw = 1.0

    def _put(self, xs, ys):
        s = self.scale
        xi = np.clip(np.round(np.asarray(xs) * s).astype(int),
                     0, self.w - 1)
        # PostScript origin is bottom-left; image rows grow downward
        yi = np.clip(self.h - 1 - np.round(np.asarray(ys) * s).astype(int),
                     0, self.h - 1)
        self.img[yi, xi] = self.rgb
        t = max(int(round(self.lw * s / 2)), 0)
        for d in range(1, t + 1):
            self.img[np.clip(yi + d, 0, self.h - 1), xi] = self.rgb
            self.img[np.clip(yi - d, 0, self.h - 1), xi] = self.rgb
            self.img[yi, np.clip(xi + d, 0, self.w - 1)] = self.rgb
            self.img[yi, np.clip(xi - d, 0, self.w - 1)] = self.rgb

    def seg(self, x1, y1, x2, y2):
        n = max(int(np.hypot((x2 - x1) * self.scale,
                             (y2 - y1) * self.scale) * 2), 1)
        t = np.linspace(0.0, 1.0, n + 1)
        self._put(x1 + (x2 - x1) * t, y1 + (y2 - y1) * t)

    def text(self, x, y, s, size, anchor):
        # 5x7 glyphs scaled to ~`size` points
        g = max(self.scale * size / 8.0, 1.0)
        width = len(s) * 6 * g / self.scale
        if anchor == "M":
            x -= width / 2
        elif anchor == "R":
            x -= width
        for ch in s:
            cols = _FONT.get(ch)
            if cols is None:
                cols = (0x7F, 0x41, 0x41, 0x41, 0x7F)
            for cx, bits in enumerate(cols):
                for cy in range(7):
                    if bits >> cy & 1:
                        px = x + cx * g / self.scale
                        py = y + (6 - cy) * g / self.scale
                        self._put([px], [py])
            x += 6 * g / self.scale


def rasterize_eps(eps_text: str, scale: float = 2.0) -> np.ndarray:
    """Interpret the io.eps dialect -> (H, W, 3) uint8 image."""
    cv = None
    font_size = 10
    for line in eps_text.splitlines():
        line = line.strip()
        if line.startswith("%%BoundingBox:"):
            p = line.split()
            cv = _Canvas(float(p[3]), float(p[4]), scale)
        elif cv is None or not line or line.startswith("%") \
                or line.endswith("def"):
            if line.startswith("/FS ") and line.endswith(" def"):
                font_size = int(line.split()[1])
            continue
        elif line.endswith(" setlinewidth"):
            cv.lw = float(line.split()[0])
        elif line.endswith(" setgray"):
            v = int(round(float(line.split()[0]) * 255))
            cv.rgb = (v, v, v)
        elif line.endswith(" C"):
            col = int(line.split()[-2])
            cv.rgb = ((col >> 16) & 255, (col >> 8) & 255, col & 255)
        elif line.endswith(" L"):
            x1, y1, x2, y2 = map(float, line.split()[:4])
            cv.seg(x1, y1, x2, y2)
        elif line.endswith(" LX"):
            x1, x2, y = map(float, line.split()[:3])
            cv.seg(x1, y, x2, y)
        elif line.endswith(" LY"):
            y1, y2, x = map(float, line.split()[:3])
            cv.seg(x, y1, x, y2)
        elif line.endswith(("LS", "MS", "RS")) and "(" in line:
            head, rest = line.split("(", 1)
            s = rest[:rest.rindex(")")]
            x, y = map(float, head.split()[:2])
            cv.text(x, y, s, font_size, line[-2])
    if cv is None:
        raise ValueError("no %%BoundingBox in EPS input")
    return cv.img


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG encoder (8-bit RGB, zlib, filter 0)."""
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8),
         img.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def eps_to_png(eps_path: str, png_path: str, scale: float = 2.0) -> None:
    with open(eps_path) as f:
        img = rasterize_eps(f.read(), scale=scale)
    write_png(png_path, img)
