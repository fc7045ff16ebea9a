"""HEVC intra prediction (8.4.4.2) and inter sub-pel interpolation (8.5.4).

Host reference arithmetic in numpy; the device path (encoder_tpu.py) mirrors
the same integer math batched over CTUs. 4:2:0, bit depth parameterized
(8/10/12 — one source, templates/*_template.c analog).
"""
from __future__ import annotations

import numpy as np

from .tables import CHROMA_FILTER, INTRA_PRED_ANGLE, INV_ANGLE, LUMA_FILTER

PLANAR, DC, HOR, VER = 0, 1, 10, 26


# ---------------------------------------------------------------------------
# Reference sample assembly: availability, substitution (8.4.4.2.2),
# filtering (8.4.4.2.3). Returns (left[2n], topleft, top[2n]) int32 arrays
# where left runs downward from y0 and top rightward from x0.
# ---------------------------------------------------------------------------
def ref_samples(plane, x0: int, y0: int, n: int, filt: bool,
                bd: int = 8):
    H, W = plane.shape
    # gather raw samples with availability; reconstruction is raster-scan
    # CTU order so: left column available if x0>0 (rows < H); top row if
    # y0>0 (cols < W); below-left available only for rows already decoded
    # (none below current CTU row start) -> treat rows >= y0+n as unavailable
    # unless they exist to the left in a prior CTU column (raster: not yet
    # decoded). We use the conservative rule: below-left unavailable,
    # above-right available only within the row above (x < W).
    avail_tl = x0 > 0 and y0 > 0
    left = np.full(2 * n, -1, np.int32)
    top = np.full(2 * n, -1, np.int32)
    tl = -1
    if avail_tl:
        tl = int(plane[y0 - 1, x0 - 1])
    if x0 > 0:
        m = min(n, H - y0)
        left[:m] = plane[y0:y0 + m, x0 - 1]
    if y0 > 0:
        m = min(2 * n, W - x0)
        top[:m] = plane[y0 - 1, x0:x0 + m]
    # substitution (8.4.4.2.2): scan order p[-1][2n-1..-1], p[0..2n-1][-1]
    scan = list(left[::-1]) + [tl] + list(top)
    if all(v < 0 for v in scan):
        scan = [1 << (bd - 1)] * len(scan)
    else:
        first = next(i for i, v in enumerate(scan) if v >= 0)
        for i in range(first - 1, -1, -1):
            scan[i] = scan[i + 1]
        for i in range(first + 1, len(scan)):
            if scan[i] < 0:
                scan[i] = scan[i - 1]
    left = np.array(scan[2 * n - 1::-1], np.int32)
    tl = int(scan[2 * n])
    top = np.array(scan[2 * n + 1:], np.int32)
    if filt:
        fl = np.empty_like(left)
        ft = np.empty_like(top)
        ftl = (left[0] + 2 * tl + top[0] + 2) >> 2
        fl[0] = (tl + 2 * left[0] + left[1] + 2) >> 2
        fl[1:-1] = (left[:-2] + 2 * left[1:-1] + left[2:] + 2) >> 2
        fl[-1] = left[-1]
        ft[0] = (tl + 2 * top[0] + top[1] + 2) >> 2
        ft[1:-1] = (top[:-2] + 2 * top[1:-1] + top[2:] + 2) >> 2
        ft[-1] = top[-1]
        return fl, ftl, ft
    return left, tl, top


def filter_flag(mode: int, n: int, cidx: int) -> bool:
    """8.4.4.2.3: [1 2 1] smoothing decision (strong smoothing off)."""
    if cidx != 0 or mode == DC or n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thresh = {8: 7, 16: 1, 32: 0}[n]
    return min_dist > thresh


def intra_pred(mode: int, left, tl, top, n: int, cidx: int = 0,
               bd: int = 8):
    """Predict an n x n block. left/top are the (possibly filtered)
    reference arrays of length 2n; returns (n, n) int32."""
    if mode == PLANAR:
        x = np.arange(n)
        y = np.arange(n)[:, None]
        hor = (n - 1 - x) * left[y.ravel()][:, None] + (x + 1) * top[n]
        ver = (n - 1 - y) * top[x] + (y + 1) * left[n]
        return (hor + ver + n) >> (int(np.log2(n)) + 1)
    if mode == DC:
        dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> \
            (int(np.log2(n)) + 1)
        p = np.full((n, n), dc, np.int32)
        if cidx == 0 and n < 32:
            p[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            p[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            p[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        return p
    # angular (8.4.4.2.6)
    ang = INTRA_PRED_ANGLE[mode]
    p = np.zeros((n, n), np.int32)
    if mode >= 18:  # vertical-ish: main ref = top
        ref = np.zeros(3 * n + 1, np.int32)  # ref[idx] = p[-1 + idx - n][-1]..
        ref[n:3 * n + 1] = np.concatenate(([tl], top[:2 * n]))
        if ang < 0:
            inv = INV_ANGLE[ang]
            lo = (n * ang) >> 5
            for x in range(-1, lo - 1, -1):
                ref[n + x] = left[min(2 * n - 1, ((x * inv + 128) >> 8) - 1)]
        for y in range(n):
            idx = ((y + 1) * ang) >> 5
            frac = ((y + 1) * ang) & 31
            base = n + 1 + idx
            if frac == 0:
                p[y, :] = ref[base:base + n]
            else:
                a = ref[base:base + n]
                b = ref[base + 1:base + n + 1]
                p[y, :] = ((32 - frac) * a + frac * b + 16) >> 5
        if mode == VER and cidx == 0 and n < 32:
            p[:, 0] = np.clip(top[0] + ((left[:n] - tl) >> 1), 0,
                              (1 << bd) - 1)
    else:  # horizontal-ish: main ref = left
        ref = np.zeros(3 * n + 1, np.int32)
        ref[n:3 * n + 1] = np.concatenate(([tl], left[:2 * n]))
        if ang < 0:
            inv = INV_ANGLE[ang]
            lo = (n * ang) >> 5
            for x in range(-1, lo - 1, -1):
                ref[n + x] = top[min(2 * n - 1, ((x * inv + 128) >> 8) - 1)]
        for x in range(n):
            idx = ((x + 1) * ang) >> 5
            frac = ((x + 1) * ang) & 31
            base = n + 1 + idx
            if frac == 0:
                p[:, x] = ref[base:base + n]
            else:
                a = ref[base:base + n]
                b = ref[base + 1:base + n + 1]
                p[:, x] = ((32 - frac) * a + frac * b + 16) >> 5
        if mode == HOR and cidx == 0 and n < 32:
            p[0, :] = np.clip(left[0] + ((top[:n] - tl) >> 1), 0,
                              (1 << bd) - 1)
    return np.clip(p, 0, (1 << bd) - 1)


# ---------------------------------------------------------------------------
# Inter: quarter-pel luma (8-tap) / eighth-pel chroma (4-tap) MC.
# ---------------------------------------------------------------------------
def pad_plane(plane, pad: int):
    return np.pad(plane.astype(np.int32), pad, mode="edge")


def mc_luma(ref_pad, pad: int, x0: int, y0: int, w: int, h: int,
            mvx: int, mvy: int, bd: int = 8):
    """Motion-compensate a w x h luma block; mv in quarter-pel units.
    Spec 8.5.4.2.2.1: horizontal stage truncates by (bd-8), vertical by 6,
    then weighted-pred rounding by (14-bd) — the combined single rounding
    shift is arithmetically identical at every depth."""
    ix, fx = mvx >> 2, mvx & 3
    iy, fy = mvy >> 2, mvy & 3
    xs = x0 + ix + pad
    ys = y0 + iy + pad
    maxv = (1 << bd) - 1
    if fx == 0 and fy == 0:
        return ref_pad[ys:ys + h, xs:xs + w].astype(np.int32)
    win = ref_pad[ys - 3:ys + h + 4, xs - 3:xs + w + 4].astype(np.int32)
    s1 = bd - 8
    if fx:
        f = LUMA_FILTER[fx]
        tmp = sum(int(f[k]) * win[:, k:k + w] for k in range(8)) >> s1
    else:
        tmp = win[:, 3:3 + w] << (6 - s1)
    if fy:
        f = LUMA_FILTER[fy]
        acc = sum(int(f[k]) * tmp[k:k + h, :] for k in range(8))
        out = (acc + (1 << (19 - bd))) >> (20 - bd)
    else:
        out = (tmp[3:3 + h, :] + (1 << (13 - bd))) >> (14 - bd)
    return np.clip(out, 0, maxv)


def mc_chroma(ref_pad, pad: int, x0: int, y0: int, w: int, h: int,
              mvx: int, mvy: int, bd: int = 8):
    """Chroma MC: same luma mv reinterpreted as eighth-pel chroma units."""
    ix, fx = mvx >> 3, mvx & 7
    iy, fy = mvy >> 3, mvy & 7
    xs = x0 + ix + pad
    ys = y0 + iy + pad
    maxv = (1 << bd) - 1
    if fx == 0 and fy == 0:
        return ref_pad[ys:ys + h, xs:xs + w].astype(np.int32)
    win = ref_pad[ys - 1:ys + h + 2, xs - 1:xs + w + 2].astype(np.int32)
    s1 = bd - 8
    if fx:
        f = CHROMA_FILTER[fx]
        tmp = sum(int(f[k]) * win[:, k:k + w] for k in range(4)) >> s1
    else:
        tmp = win[:, 1:1 + w] << (6 - s1)
    if fy:
        f = CHROMA_FILTER[fy]
        acc = sum(int(f[k]) * tmp[k:k + h, :] for k in range(4))
        out = (acc + (1 << (19 - bd))) >> (20 - bd)
    else:
        out = (tmp[1:1 + h, :] + (1 << (13 - bd))) >> (14 - bd)
    return np.clip(out, 0, maxv)
