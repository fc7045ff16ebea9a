"""Synthetic test clip: moving structured content + light noise.

A copy of ``bench.py``'s ``make_clip``, so the port's smoke script and
tests can make the same frames without importing the JAX package."""
from __future__ import annotations

import numpy as np


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
