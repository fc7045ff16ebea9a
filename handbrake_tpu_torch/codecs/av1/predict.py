"""AV1 intra predictors (DC / V / H / Paeth / Smooth).

The AV1 intra family per spec §7.11.2 (reference encodes these via
SVT-AV1, encsvtav1.c). Smooth uses the spec's quadratic weight table;
Paeth is the per-pixel base-gradient selector. Operates on whole blocks
given `above` (w,) and `left` (h,) uint8 edge arrays.
"""
from __future__ import annotations

import numpy as np

DC_PRED, V_PRED, H_PRED, PAETH_PRED, SMOOTH_PRED = range(5)
N_INTRA_MODES = 5

# AV1 sm_weight_arrays extract (block sizes 4..32)
_SM_W = {
    4: np.array([255, 149, 85, 64], dtype=np.int32),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32], dtype=np.int32),
    16: np.array([255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26,
                  20, 17, 16], dtype=np.int32),
    32: np.array([255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
                  101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14,
                  12, 10, 9, 8, 8], dtype=np.int32),
}


def predict(mode: int, above: np.ndarray, left: np.ndarray,
            top_left: int, h: int, w: int) -> np.ndarray:
    a = above.astype(np.int32)[:w]
    l = left.astype(np.int32)[:h]
    if mode == DC_PRED:
        s = int(a.sum()) + int(l.sum())
        dc = (s + ((w + h) >> 1)) // (w + h)
        return np.full((h, w), dc, dtype=np.int32)
    if mode == V_PRED:
        return np.tile(a, (h, 1))
    if mode == H_PRED:
        return np.tile(l[:, None], (1, w))
    if mode == PAETH_PRED:
        tl = int(top_left)
        base = a[None, :] + l[:, None] - tl
        pa = np.abs(base - a[None, :] * np.ones((h, 1), np.int32))
        pl = np.abs(base - l[:, None] * np.ones((1, w), np.int32))
        ptl = np.abs(base - tl)
        out = np.where((pl <= pa) & (pl <= ptl),
                       np.tile(l[:, None], (1, w)),
                       np.where(pa <= ptl, np.tile(a, (h, 1)), tl))
        return out.astype(np.int32)
    if mode == SMOOTH_PRED:
        wv = _SM_W[h][:, None]          # vertical weights (h,1)
        wh = _SM_W[w][None, :]          # horizontal weights (1,w)
        below = int(l[-1])
        right = int(a[-1])
        pv = wv * a[None, :] + (256 - wv) * below
        ph = wh * l[:, None] + (256 - wh) * right
        return ((pv + ph + 256) >> 9).astype(np.int32)
    raise ValueError(f"bad intra mode {mode}")


def edges(recon: np.ndarray, by: int, bx: int, h: int, w: int):
    """Above/left/topleft edge fetch with AV1 unavailable-edge defaults."""
    H, W = recon.shape
    if by > 0:
        above = recon[by - 1, bx:bx + w].astype(np.int32)
        if above.shape[0] < w:
            above = np.pad(above, (0, w - above.shape[0]), mode='edge')
    else:
        above = np.full(w, 127, dtype=np.int32)
    if bx > 0:
        left = recon[by:by + h, bx - 1].astype(np.int32)
        if left.shape[0] < h:
            left = np.pad(left, (0, h - left.shape[0]), mode='edge')
    else:
        left = np.full(h, 129, dtype=np.int32)
    tl = int(recon[by - 1, bx - 1]) if (by > 0 and bx > 0) else 128
    return above, left, tl
