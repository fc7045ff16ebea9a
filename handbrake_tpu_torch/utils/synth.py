"""Synthetic test clips: moving structured content + light noise, an
interlaced clip woven from it, and a y4m writer for such clips.

``make_clip`` is a copy of ``bench.py``'s, so the port's smoke script and
tests can make the same frames without importing the JAX package."""
from __future__ import annotations

import numpy as np


def write_y4m(path, frames, w, h, bar=0, rate=(30000, 1001),
              interlace="p"):
    """A 4:2:0 8-bit y4m of `frames` ((y, u, v) numpy planes of the
    picture, h - 2 * bar rows high) between `bar` black rows above and
    below (luma 16, chroma 128), as a letterboxed source holds them.
    interlace: the header's I flag ("p" progressive, "t" top field
    first, "b" bottom field first)."""
    yb = np.full((bar, w), 16, np.uint8)
    cb = np.full((bar // 2, w // 2), 128, np.uint8)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{rate[0]}:{rate[1]} I{interlace} "
                f"A1:1 C420\n".encode())
        for y, u, v in frames:
            f.write(b"FRAME\n")
            for plane, pad in ((y, yb), (u, cb), (v, cb)):
                f.write(pad.tobytes() + np.ascontiguousarray(plane).tobytes()
                        + pad.tobytes())
    return path


def make_clip(w, h, n, seed=0):
    """Moving structured content + light noise (realistic coded-MB mix)."""
    rng = np.random.default_rng(seed)
    bw, bh = w + 128, h + 128
    yy, xx = np.mgrid[0:bh, 0:bw]
    base = (96 + 60 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
            + 40 * ((xx // 64 + yy // 64) % 2)).astype(np.float32)
    base = np.clip(base + rng.normal(0, 3, base.shape), 0, 255)
    base = base.astype(np.uint8)
    cb = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31.0), 0, 255).astype(np.uint8)
    cr = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29.0), 0, 255).astype(np.uint8)
    frames = []
    for t in range(n):
        ox, oy = 8 + 3 * t, 8 + t
        frames.append((
            np.ascontiguousarray(base[oy:oy + h, ox:ox + w]),
            np.ascontiguousarray(cb[oy // 2:oy // 2 + h // 2,
                                    ox // 2:ox // 2 + w // 2]),
            np.ascontiguousarray(cr[oy // 2:oy // 2 + h // 2,
                                    ox // 2:ox // 2 + w // 2])))
    return frames


def make_interlaced_clip(w, h, n, seed=0):
    """An interlaced clip: frame i weaves the even rows of ``make_clip``
    frame i (the top field) with the odd rows of frame i + 1 (the bottom
    field, a frame's motion later), in every plane.  n + 1 source frames,
    so n is at most 39 (make_clip pans at most 40 frames)."""
    src = make_clip(w, h, n + 1, seed)
    frames = []
    for top, bot in zip(src[:-1], src[1:]):
        woven = []
        for t, b in zip(top, bot):
            p = t.copy()
            p[1::2] = b[1::2]
            woven.append(p)
        frames.append(tuple(woven))
    return frames
