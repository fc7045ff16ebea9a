"""H.264 prediction: Intra16x16 / chroma intra modes and sub-pel motion
compensation — spec-exact integer arithmetic (8.3, 8.4.2.2), numpy host
reference shared by the encoder-reference path and the decoder.
"""
from __future__ import annotations

import numpy as np

I16_V, I16_H, I16_DC, I16_PLANE = 0, 1, 2, 3
CHROMA_DC, CHROMA_H, CHROMA_V, CHROMA_PLANE = 0, 1, 2, 3


def intra16_pred(mode: int, top, left, topleft, bd: int = 8):
    """16x16 luma prediction. top/left: length-16 int arrays or None."""
    mid = 1 << (bd - 1)
    if mode == I16_V:
        assert top is not None
        return np.tile(top.astype(np.int32), (16, 1))
    if mode == I16_H:
        assert left is not None
        return np.tile(left.astype(np.int32).reshape(16, 1), (1, 16))
    if mode == I16_DC:
        if top is not None and left is not None:
            dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
        elif top is not None:
            dc = (int(top.sum()) + 8) >> 4
        elif left is not None:
            dc = (int(left.sum()) + 8) >> 4
        else:
            dc = mid
        return np.full((16, 16), dc, dtype=np.int32)
    if mode == I16_PLANE:
        assert top is not None and left is not None and topleft is not None
        t = top.astype(np.int64)
        l = left.astype(np.int64)
        tl = np.int64(topleft)
        h = sum((x + 1) * (int(t[8 + x]) - int(t[6 - x] if x < 7 else tl))
                for x in range(8))
        v = sum((y + 1) * (int(l[8 + y]) - int(l[6 - y] if y < 7 else tl))
                for y in range(8))
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        a = 16 * (int(l[15]) + int(t[15]))
        yy, xx = np.mgrid[0:16, 0:16]
        p = (a + b * (xx - 7) + c * (yy - 7) + 16) >> 5
        return np.clip(p, 0, (1 << bd) - 1).astype(np.int32)
    raise ValueError(mode)


def chroma_pred(mode: int, top, left, topleft, bd: int = 8):
    """8x8 chroma prediction (4:2:0). top/left length-8 or None."""
    mid = 1 << (bd - 1)
    if mode == CHROMA_V:
        assert top is not None
        return np.tile(top.astype(np.int32), (8, 1))
    if mode == CHROMA_H:
        assert left is not None
        return np.tile(left.astype(np.int32).reshape(8, 1), (1, 8))
    if mode == CHROMA_DC:
        out = np.empty((8, 8), dtype=np.int32)
        t, l = top, left

        def dc4(tseg, lseg, prefer_both=True):
            if tseg is not None and lseg is not None and prefer_both:
                return (int(tseg.sum()) + int(lseg.sum()) + 4) >> 3
            if tseg is not None:
                return (int(tseg.sum()) + 2) >> 2
            if lseg is not None:
                return (int(lseg.sum()) + 2) >> 2
            return mid

        # (0,0): both; (4,0): top[4:8] pref, else left[0:4]; (0,4): left[4:8]
        # pref, else top[0:4]; (4,4): both (top[4:8], left[4:8])
        out[0:4, 0:4] = dc4(t[0:4] if t is not None else None,
                            l[0:4] if l is not None else None)
        if t is not None:
            out[0:4, 4:8] = dc4(t[4:8], None)
        elif l is not None:
            out[0:4, 4:8] = dc4(None, l[0:4])
        else:
            out[0:4, 4:8] = mid
        if l is not None:
            out[4:8, 0:4] = dc4(None, l[4:8])
        elif t is not None:
            out[4:8, 0:4] = dc4(t[0:4], None)
        else:
            out[4:8, 0:4] = mid
        out[4:8, 4:8] = dc4(t[4:8] if t is not None else None,
                            l[4:8] if l is not None else None)
        return out
    if mode == CHROMA_PLANE:
        t = top.astype(np.int64)
        l = left.astype(np.int64)
        tl = np.int64(topleft)
        h = sum((x + 1) * (int(t[4 + x]) - int(t[2 - x] if x < 3 else tl))
                for x in range(4))
        v = sum((y + 1) * (int(l[4 + y]) - int(l[2 - y] if y < 3 else tl))
                for y in range(4))
        b = (17 * h + 16) >> 5
        c = (17 * v + 16) >> 5
        a = 16 * (int(l[7]) + int(t[7]))
        yy, xx = np.mgrid[0:8, 0:8]
        p = (a + b * (xx - 3) + c * (yy - 3) + 16) >> 5
        return np.clip(p, 0, (1 << bd) - 1).astype(np.int32)
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Motion compensation (8.4.2.2) — quarter-pel luma, eighth-pel chroma
# ---------------------------------------------------------------------------
def _clip_idx(i, lo, hi):
    return np.clip(i, lo, hi)


def pad_plane(plane: np.ndarray, pad: int = 32) -> np.ndarray:
    """Edge-replicate padding — MC clamps coordinates to the picture, which
    is equivalent to sampling an edge-padded plane."""
    return np.pad(plane, pad, mode="edge")


def _window(ref_pad: np.ndarray, pad: int, y: int, x: int, h: int,
            w: int) -> np.ndarray:
    """The h x w reference samples from picture coordinate (x, y), each
    read at its coordinate clamped to the picture (8.4.2.2.1), as int32.
    Inside the padded plane that is a plain slice of it."""
    r0, c0 = y + pad, x + pad
    if 0 <= r0 and r0 + h <= ref_pad.shape[0] \
            and 0 <= c0 and c0 + w <= ref_pad.shape[1]:
        return ref_pad[r0:r0 + h, c0:c0 + w].astype(np.int32)
    rows = np.clip(np.arange(y, y + h), 0, ref_pad.shape[0] - 2 * pad - 1)
    cols = np.clip(np.arange(x, x + w), 0, ref_pad.shape[1] - 2 * pad - 1)
    return ref_pad[(rows + pad)[:, None], (cols + pad)[None, :]].astype(
        np.int32)


def mc_luma_block(ref_pad: np.ndarray, pad: int, x0: int, y0: int,
                  w: int, h: int, mvx: int, mvy: int) -> np.ndarray:
    """Luma MC for a w×h block at (x0,y0) with quarter-pel mv (spec-exact).

    ref_pad is the reference plane padded by `pad` (>= 21) on all sides.
    """
    xi, yi = x0 + (mvx >> 2), y0 + (mvy >> 2)
    xf, yf = mvx & 3, mvy & 3
    # full-pel window with 6-tap margins: rows yi-2..yi+h+2, cols xi-2..xi+w+2
    win = _window(ref_pad, pad, yi - 2, xi - 2, h + 5, w + 5)

    def tap6_h(a):  # horizontal 6-tap at half position, input (H, W+5)
        return (a[:, 0:-5] - 5 * a[:, 1:-4] + 20 * a[:, 2:-3]
                + 20 * a[:, 3:-2] - 5 * a[:, 4:-1] + a[:, 5:])

    def tap6_v(a):
        return (a[0:-5, :] - 5 * a[1:-4, :] + 20 * a[2:-3, :]
                + 20 * a[3:-2, :] - 5 * a[4:-1, :] + a[5:, :])

    G = win[2:2 + h, 2:2 + w]                        # integer samples
    if xf == 0 and yf == 0:
        return G
    # half-pel b (horizontal): at rows 2.., intermediate for all needed rows
    b1 = tap6_h(win)                                  # (h+5, w)
    b = np.clip((b1[2:2 + h, :] + 16) >> 5, 0, 255)   # (h, w)
    # half-pel hh (vertical)
    h1 = tap6_v(win)                                  # (h, w+5)
    hv = np.clip((h1[:, 2:2 + w] + 16) >> 5, 0, 255)  # (h, w)
    # half-pel j (both): 6-tap vertical on b1 intermediates
    j1 = tap6_v(b1)                                   # (h, w)
    j = np.clip((j1 + 512) >> 10, 0, 255)

    if (xf, yf) == (2, 0):
        return b
    if (xf, yf) == (0, 2):
        return hv
    if (xf, yf) == (2, 2):
        return j
    # quarter positions: average of two nearest
    # neighbors at integer/half grid:
    G1 = win[2:2 + h, 3:3 + w]    # G shifted right
    G2 = win[3:3 + h, 2:2 + w]    # G shifted down
    b_down = np.clip((b1[3:3 + h, :] + 16) >> 5, 0, 255)   # b at row+1
    h_right = np.clip((h1[:, 3:3 + w] + 16) >> 5, 0, 255)  # h at col+1
    table = {
        (1, 0): (G, b), (3, 0): (b, G1),
        (0, 1): (G, hv), (0, 3): (hv, G2),
        (1, 1): (b, hv), (3, 1): (b, h_right),
        (1, 3): (hv, b_down), (3, 3): (h_right, b_down),
        (1, 2): (hv, j), (3, 2): (j, h_right),
        (2, 1): (b, j), (2, 3): (j, b_down),
    }
    p, q = table[(xf, yf)]
    return (p.astype(np.int32) + q.astype(np.int32) + 1) >> 1


def mc_chroma_block(ref_pad: np.ndarray, pad: int, x0: int, y0: int,
                    w: int, h: int, mvx: int, mvy: int) -> np.ndarray:
    """Chroma MC: mv in luma quarter-pel == chroma eighth-pel (4:2:0)."""
    xi, yi = x0 + (mvx >> 3), y0 + (mvy >> 3)
    xf, yf = mvx & 7, mvy & 7
    win = _window(ref_pad, pad, yi, xi, h + 1, w + 1)
    A = win[:h, :w]
    B = win[:h, 1:]
    C = win[1:, :w]
    D = win[1:, 1:]
    return ((8 - xf) * (8 - yf) * A + xf * (8 - yf) * B
            + (8 - xf) * yf * C + xf * yf * D + 32) >> 6


def median_mv(a, b, c):
    """Component-wise median of three MVs (tuples)."""
    return (int(np.median([a[0], b[0], c[0]])),
            int(np.median([a[1], b[1], c[1]])))


def predict_mv_16x16(mvs, refs, mb_x, mb_y, mb_w):
    """MV predictor for a P_L0_16x16 partition, single-ref (8.4.1.3).

    mvs: dict (mbx,mby) -> (mvx,mvy); refs: dict (mbx,mby) -> ref, -1 = intra.
    An intra neighbour is *available* (ref -1, mv (0,0)) — it participates in
    the median; only out-of-picture/not-yet-decoded MBs are unavailable.
    """
    def get(x, y):
        if x < 0 or y < 0 or x >= mb_w or (x, y) not in refs:
            return None  # MB not available
        if refs[(x, y)] != 0:
            return ((0, 0), -1)  # available but intra
        return (mvs[(x, y)], 0)

    A = get(mb_x - 1, mb_y)
    B = get(mb_x, mb_y - 1)
    C = get(mb_x + 1, mb_y - 1)
    if C is None:
        C = get(mb_x - 1, mb_y - 1)  # substitute D
    # If B and C (and D) are unavailable and A is available → mvA
    if B is None and C is None:
        return A[0] if A is not None else (0, 0)
    cand = [(n if n is not None else ((0, 0), -1)) for n in (A, B, C)]
    same = [c for c in cand if c[1] == 0]
    if len(same) == 1:
        return same[0][0]
    return median_mv(cand[0][0], cand[1][0], cand[2][0])


def skip_mv(mvs, refs, mb_x, mb_y, mb_w):
    """P_Skip motion vector (8.4.1.1). Intra neighbours count as available."""
    def avail(x, y):
        return not (x < 0 or y < 0 or x >= mb_w) and (x, y) in refs

    A, B = (mb_x - 1, mb_y), (mb_x, mb_y - 1)
    if not avail(*A) or not avail(*B):
        return (0, 0)
    if refs[A] == 0 and mvs[A] == (0, 0):
        return (0, 0)
    if refs[B] == 0 and mvs[B] == (0, 0):
        return (0, 0)
    return predict_mv_16x16(mvs, refs, mb_x, mb_y, mb_w)


def intra4_pred(mode: int, top, left, topleft, ha, hb, hc, hd,
                bd: int = 8):
    """4x4 intra prediction (spec 8.3.1.2): top: 8 samples (top-right
    replicated from top[3] when hc is False), left: 4, topleft scalar.
    Availability flags mirror the decoder's (hbdec264 intra4x4_pred)."""
    mid = 1 << (bd - 1)
    t = np.asarray(top, np.int32) if hb else np.zeros(8, np.int32)
    if hb and not hc:
        t = t.copy()
        t[4:] = t[3]
    lf = np.asarray(left, np.int32) if ha else np.zeros(4, np.int32)
    tl = int(topleft) if hd else 0
    p = np.zeros((4, 4), np.int32)
    if mode == 0:                          # vertical
        p[:] = t[:4][None, :]
    elif mode == 1:                        # horizontal
        p[:] = lf[:, None]
    elif mode == 2:                        # DC
        if ha and hb:
            v = (int(t[:4].sum()) + int(lf.sum()) + 4) >> 3
        elif hb:
            v = (int(t[:4].sum()) + 2) >> 2
        elif ha:
            v = (int(lf.sum()) + 2) >> 2
        else:
            v = mid
        p[:] = v
    elif mode == 3:                        # diagonal down-left
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    s = x + y
                    p[y, x] = (t[s] + 2 * t[s + 1] + t[s + 2] + 2) >> 2
    elif mode in (4, 5, 6):
        # sample accessor over the L-shaped neighborhood: P(-1,-1)=tl,
        # P(x,-1)=top row, P(-1,y)=left column (the index arithmetic in
        # these modes legitimately reaches -1, which must hit the corner,
        # never wrap)
        def smp(sx, sy):
            if sy == -1:
                return tl if sx == -1 else int(t[sx])
            return int(lf[sy])
        if mode == 4:                      # diagonal down-right
            for y in range(4):
                for x in range(4):
                    if x > y:
                        p[y, x] = (smp(x - y - 2, -1)
                                   + 2 * smp(x - y - 1, -1)
                                   + smp(x - y, -1) + 2) >> 2
                    elif x < y:
                        p[y, x] = (smp(-1, y - x - 2)
                                   + 2 * smp(-1, y - x - 1)
                                   + smp(-1, y - x) + 2) >> 2
                    else:
                        p[y, x] = (t[0] + 2 * tl + lf[0] + 2) >> 2
        elif mode == 5:                    # vertical right
            for y in range(4):
                for x in range(4):
                    z = 2 * x - y
                    if z >= 0 and z % 2 == 0:
                        p[y, x] = (smp(x - (y >> 1) - 1, -1)
                                   + smp(x - (y >> 1), -1) + 1) >> 1
                    elif z >= 0:
                        p[y, x] = (smp(x - (y >> 1) - 2, -1)
                                   + 2 * smp(x - (y >> 1) - 1, -1)
                                   + smp(x - (y >> 1), -1) + 2) >> 2
                    elif z == -1:
                        p[y, x] = (lf[0] + 2 * tl + t[0] + 2) >> 2
                    else:
                        p[y, x] = (smp(-1, y - 2 * x - 1)
                                   + 2 * smp(-1, y - 2 * x - 2)
                                   + smp(-1, y - 2 * x - 3) + 2) >> 2
        else:                              # 6: horizontal down
            for y in range(4):
                for x in range(4):
                    z = 2 * y - x
                    if z >= 0 and z % 2 == 0:
                        p[y, x] = (smp(-1, y - (x >> 1) - 1)
                                   + smp(-1, y - (x >> 1)) + 1) >> 1
                    elif z >= 0:
                        p[y, x] = (smp(-1, y - (x >> 1) - 2)
                                   + 2 * smp(-1, y - (x >> 1) - 1)
                                   + smp(-1, y - (x >> 1)) + 2) >> 2
                    elif z == -1:
                        p[y, x] = (lf[0] + 2 * tl + t[0] + 2) >> 2
                    else:
                        p[y, x] = (smp(x - 2 * y - 1, -1)
                                   + 2 * smp(x - 2 * y - 2, -1)
                                   + smp(x - 2 * y - 3, -1) + 2) >> 2
    elif mode == 7:                        # vertical left
        for y in range(4):
            for x in range(4):
                if y % 2 == 0:
                    p[y, x] = (t[x + (y >> 1)]
                               + t[x + (y >> 1) + 1] + 1) >> 1
                else:
                    p[y, x] = (t[x + (y >> 1)]
                               + 2 * t[x + (y >> 1) + 1]
                               + t[x + (y >> 1) + 2] + 2) >> 2
    else:                                  # 8: horizontal up
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z % 2 == 0 and z < 5:
                    p[y, x] = (lf[y + (x >> 1)]
                               + lf[y + (x >> 1) + 1] + 1) >> 1
                elif z < 5:
                    p[y, x] = (lf[y + (x >> 1)]
                               + 2 * lf[y + (x >> 1) + 1]
                               + lf[y + (x >> 1) + 2] + 2) >> 2
                elif z == 5:
                    p[y, x] = (lf[2] + 3 * lf[3] + 2) >> 2
                else:
                    p[y, x] = lf[3]
    return p


def intra8_pred(mode: int, top, left, topleft, ha, hb, hc, hd):
    """8x8 luma intra prediction (spec 8.3.2.2: reference filtering
    8.3.2.2.1 then 9 modes; decoder mirror hbdec264.cpp intra8x8_pred).
    top: 16 raw samples (top-right repeated from top[7] when hc False),
    left: 8 raw samples, topleft scalar. Returns (8,8) int32."""
    rt = np.zeros(17, np.int64)           # rt[0] = corner, rt[1..16] = top
    rl = np.zeros(9, np.int64)            # rl[0] = corner, rl[1..8] = left
    if hb:
        t = np.asarray(top, np.int64)
        rt[1:9] = t[:8]
        rt[9:17] = t[8:16] if hc else t[7]
    if hd:
        rt[0] = int(topleft)
    if ha:
        rl[1:9] = np.asarray(left, np.int64)
    rl[0] = rt[0]
    ft = np.zeros(17, np.int64)
    fl = np.zeros(9, np.int64)
    if hd:
        a = rt[1] if hb else rt[0]
        l = rl[1] if ha else rt[0]
        ft[0] = fl[0] = (a + 2 * rt[0] + l + 2) >> 2
    if hb:
        ft[1] = ((rt[0] + 2 * rt[1] + rt[2] + 2) >> 2) if hd \
            else ((3 * rt[1] + rt[2] + 2) >> 2)
        for x in range(2, 16):
            ft[x] = (rt[x - 1] + 2 * rt[x] + rt[x + 1] + 2) >> 2
        ft[16] = (rt[15] + 3 * rt[16] + 2) >> 2
    if ha:
        fl[1] = ((rt[0] + 2 * rl[1] + rl[2] + 2) >> 2) if hd \
            else ((3 * rl[1] + rl[2] + 2) >> 2)
        for y in range(2, 8):
            fl[y] = (rl[y - 1] + 2 * rl[y] + rl[y + 1] + 2) >> 2
        fl[8] = (rl[7] + 3 * rl[8] + 2) >> 2

    def smp(sx, sy):
        if sy == -1:
            return int(ft[0]) if sx == -1 else int(ft[1 + sx])
        return int(fl[1 + sy])

    p = np.zeros((8, 8), np.int64)
    if mode == 0:                          # vertical
        p[:] = ft[1:9][None, :]
    elif mode == 1:                        # horizontal
        p[:] = fl[1:9][:, None]
    elif mode == 2:                        # DC
        s = n = 0
        if hb:
            s += int(ft[1:9].sum())
            n += 8
        if ha:
            s += int(fl[1:9].sum())
            n += 8
        p[:] = (s + 8) >> 4 if n == 16 else ((s + 4) >> 3 if n == 8
                                             else 128)
    elif mode == 3:                        # diagonal down-left
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    p[y, x] = (smp(14, -1) + 3 * smp(15, -1) + 2) >> 2
                else:
                    p[y, x] = (smp(x + y, -1) + 2 * smp(x + y + 1, -1)
                               + smp(x + y + 2, -1) + 2) >> 2
    elif mode == 4:                        # diagonal down-right
        for y in range(8):
            for x in range(8):
                if x > y:
                    p[y, x] = (smp(x - y - 2, -1) + 2 * smp(x - y - 1, -1)
                               + smp(x - y, -1) + 2) >> 2
                elif x < y:
                    p[y, x] = (smp(-1, y - x - 2) + 2 * smp(-1, y - x - 1)
                               + smp(-1, y - x) + 2) >> 2
                else:
                    p[y, x] = (smp(0, -1) + 2 * smp(-1, -1)
                               + smp(-1, 0) + 2) >> 2
    elif mode == 5:                        # vertical right
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (smp(x - (y >> 1) - 1, -1)
                               + smp(x - (y >> 1), -1) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (smp(x - (y >> 1) - 2, -1)
                               + 2 * smp(x - (y >> 1) - 1, -1)
                               + smp(x - (y >> 1), -1) + 2) >> 2
                elif z == -1:
                    p[y, x] = (smp(-1, 0) + 2 * smp(-1, -1)
                               + smp(0, -1) + 2) >> 2
                else:
                    p[y, x] = (smp(-1, y - 2 * x - 1)
                               + 2 * smp(-1, y - 2 * x - 2)
                               + smp(-1, y - 2 * x - 3) + 2) >> 2
    elif mode == 6:                        # horizontal down
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (smp(-1, y - (x >> 1) - 1)
                               + smp(-1, y - (x >> 1)) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (smp(-1, y - (x >> 1) - 2)
                               + 2 * smp(-1, y - (x >> 1) - 1)
                               + smp(-1, y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    p[y, x] = (smp(-1, 0) + 2 * smp(-1, -1)
                               + smp(0, -1) + 2) >> 2
                else:
                    p[y, x] = (smp(x - 2 * y - 1, -1)
                               + 2 * smp(x - 2 * y - 2, -1)
                               + smp(x - 2 * y - 3, -1) + 2) >> 2
    elif mode == 7:                        # vertical left
        for y in range(8):
            for x in range(8):
                if y % 2 == 0:
                    p[y, x] = (smp(x + (y >> 1), -1)
                               + smp(x + (y >> 1) + 1, -1) + 1) >> 1
                else:
                    p[y, x] = (smp(x + (y >> 1), -1)
                               + 2 * smp(x + (y >> 1) + 1, -1)
                               + smp(x + (y >> 1) + 2, -1) + 2) >> 2
    else:                                  # 8: horizontal up
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z % 2 == 0 and z < 13:
                    p[y, x] = (smp(-1, y + (x >> 1))
                               + smp(-1, y + (x >> 1) + 1) + 1) >> 1
                elif z < 13:
                    p[y, x] = (smp(-1, y + (x >> 1))
                               + 2 * smp(-1, y + (x >> 1) + 1)
                               + smp(-1, y + (x >> 1) + 2) + 2) >> 2
                elif z == 13:
                    p[y, x] = (smp(-1, 6) + 3 * smp(-1, 7) + 2) >> 2
                else:
                    p[y, x] = smp(-1, 7)
    return p.astype(np.int32)
