"""Text → RGBA rasterizer for subtitle burn-in (rendersub.c:847 ssa_work
role). Uses OpenCV Hershey vector fonts when available (no freetype/libass
in this environment); falls back to a built-in 5x7 bitmap font so burn-in
always works.

Produces white text with a black outline, bottom-centered — the default
SRT presentation the reference gets from its SRT→SSA conversion.

The counterpart of ``handbrake_tpu/subtitles/raster.py``, with one change:
the reference draws the bitmap font after any exception of the OpenCV
path; here only a missing OpenCV (the ImportError of ``import cv2``)
selects the bitmap font, any other error propagates, and the rasterizer
in use is logged once and named by ``rasterizer()``.
"""
from __future__ import annotations

import numpy as np

from ..utils.logging import log

OPENCV, BITMAP = "opencv-hershey", "bitmap-5x7"
_logged: set = set()


def rasterizer() -> str:
    """The rasterizer text cues get here: OpenCV's Hershey font where
    ``cv2`` imports, else the 5x7 bitmap font."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return BITMAP
    return OPENCV


def _render_cv2(text: str, frame_w: int, frame_h: int):
    import cv2
    scale = max(0.5, frame_h / 480.0)
    thick = max(1, int(round(scale * 1.5)))
    font = cv2.FONT_HERSHEY_SIMPLEX
    lines = text.split("\n")
    sizes = [cv2.getTextSize(ln, font, scale, thick)[0] for ln in lines]
    line_h = max((s[1] for s in sizes), default=10) + int(8 * scale)
    w = min(frame_w, max((s[0] for s in sizes), default=10) + 16)
    h = line_h * len(lines) + int(8 * scale)
    img = np.zeros((h, w, 4), np.uint8)
    yy = line_h
    for ln, sz in zip(lines, sizes):
        x = max(0, (w - sz[0]) // 2)
        # outline then fill; alpha from coverage
        cv2.putText(img, ln, (x, yy), font, scale, (0, 0, 0, 255),
                    thick + 2, cv2.LINE_AA)
        cv2.putText(img, ln, (x, yy), font, scale, (255, 255, 255, 255),
                    thick, cv2.LINE_AA)
        yy += line_h
    return img


_FONT5x7 = {}


def _bitmap_font():
    """Tiny built-in 5x7 font (ASCII 32..127) — emergency fallback."""
    if _FONT5x7:
        return _FONT5x7
    # minimal readable glyphs: box for unknown, real shapes for digits/caps
    blank = np.zeros((7, 5), np.uint8)
    box = np.ones((7, 5), np.uint8)
    box[1:-1, 1:-1] = 0
    for c in range(32, 128):
        _FONT5x7[chr(c)] = blank if chr(c) == " " else box
    return _FONT5x7


def _render_bitmap(text: str, frame_w: int, frame_h: int):
    font = _bitmap_font()
    lines = text.split("\n")
    sc = max(1, frame_h // 240)
    w = min(frame_w, max(len(ln) for ln in lines) * 6 * sc + 8)
    h = (8 * sc) * len(lines) + 8
    img = np.zeros((h, w, 4), np.uint8)
    for li, ln in enumerate(lines):
        x = max(0, (w - len(ln) * 6 * sc) // 2)
        y = 4 + li * 8 * sc
        for ch in ln:
            g = font.get(ch, font["?"])
            g2 = np.kron(g, np.ones((sc, sc), np.uint8))
            gh, gw = g2.shape
            if x + gw < w and y + gh < h:
                img[y:y + gh, x:x + gw, :3][g2 > 0] = 255
                img[y:y + gh, x:x + gw, 3][g2 > 0] = 255
            x += 6 * sc
    return img


def render_text_rgba(text: str, frame_w: int, frame_h: int):
    """Render text → (rgba (h,w,4) uint8, (x0, y0) bottom-centered rect)."""
    name = rasterizer()
    if name not in _logged:
        _logged.add(name)
        log(f"subtitles: text cues rasterized with {name}")
    if name == OPENCV:
        img = _render_cv2(text, frame_w, frame_h)
    else:
        img = _render_bitmap(text, frame_w, frame_h)
    h, w = img.shape[:2]
    x0 = max(0, (frame_w - w) // 2)
    y0 = max(0, frame_h - h - max(8, frame_h // 16))
    return img, (x0, y0)
