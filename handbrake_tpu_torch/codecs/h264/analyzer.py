"""H.264 P-frame analysis as torch ops — the counterpart of
``handbrake_tpu/codecs/h264/encoder_tpu.py``.

Per P frame: coarse motion search on 4x-decimated planes, full-pel
refine around two centres (the coarse winner and mv 0), quarter-pel
refine on 6-tap sub-pel grids, 4x4 and (High profile) 8x8
transform/quant with a per-MB rate-distortion choice, recon, chroma MC
and residual, a compacted level payload, and optionally the in-loop
deblock chained on the recon.  The output dict has the reference's keys,
dtypes and shapes; ``packed_small`` is byte-identical, because the
encoder parses its layout.

The reference selects windows with one-hot matmuls and accumulations
because gathers are slow on a TPU; here they are plain indexing, which
selects the same samples.  All arithmetic is int32 except three f32
spots that must round as the reference's XLA CPU build does: the 8x8
forward transform (``_fquant8x8``), the RDO cost (``_fma32``) and the
exp2-derived per-qp constants (typed-in tables, held by the tests).

Functions run on the device of their input tensors; qp and qpc are
Python ints.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .deblock_torch import deblock
from .tables import MF4x4, QBITS_BASE, V4x4
from .transform import _G8_INV, V8x8, ZIG8

PAD = 32          # luma ref padding (matches encoder.PAD)
LOWRES_R = 4      # coarse search radius on 4x-decimated planes (= ±16 px)
REFINE_R = 3      # full-pel refine radius
WIN = 32          # luma window size (16 + 2*8 margin)
CWIN = 16         # chroma window size
MV_CLAMP = 22     # |full-pel mv| bound; keeps every access inside the pads
PAYLOAD_CHUNKS = 8        # compact-payload buckets fetched on demand

# Intra-fallback SAD threshold per qp: int(256 * max(20, 1.25 * qstep)),
# qstep = 0.625 * 2^(qp/6) — the values the reference's f32 exp2 gives
# (held against it for qp 0..51 by the tests).
INTRA_THRESH = (
    5120, 5120, 5120, 5120, 5120, 5120, 5120, 5120, 5120, 5120,
    5120, 5120, 5120, 5120, 5120, 5120, 5120, 5120, 5120, 5120,
    5120, 5120, 5120, 5120, 5120, 5120, 5120, 5120, 5120, 5701,
    6400, 7183, 8063, 9050, 10159, 11403, 12800, 14367, 16126, 18101,
    20318, 22807, 25600, 28735, 32253, 36203, 40637, 45614, 51200, 57470,
    64507, 72407)

# RDO lambda lam2 = 0.85 * 2^((qp-12)/3) as the reference's f32 exp2
# rounds it (torch.exp2 differs in the last bit at 23 of the 52 qps).
LAM2 = np.array([float.fromhex(h) for h in (
    '0x1.b333340000000p-5', '0x1.1228aa0000000p-4', '0x1.596b220000000p-4',
    '0x1.b333340000000p-4', '0x1.1228aa0000000p-3', '0x1.596b220000000p-3',
    '0x1.b333340000000p-3', '0x1.1228aa0000000p-2', '0x1.596b220000000p-2',
    '0x1.b333340000000p-2', '0x1.1228aa0000000p-1', '0x1.596b220000000p-1',
    '0x1.b333340000000p-1', '0x1.1228aa0000000p+0', '0x1.596b220000000p+0',
    '0x1.b333340000000p+0', '0x1.1228aa0000000p+1', '0x1.596b220000000p+1',
    '0x1.b333340000000p+1', '0x1.1228aa0000000p+2', '0x1.596b220000000p+2',
    '0x1.b333340000000p+2', '0x1.1228aa0000000p+3', '0x1.596b220000000p+3',
    '0x1.b333340000000p+3', '0x1.1228aa0000000p+4', '0x1.596b220000000p+4',
    '0x1.b333340000000p+4', '0x1.1228aa0000000p+5', '0x1.596b220000000p+5',
    '0x1.b333340000000p+5', '0x1.1228aa0000000p+6', '0x1.596b220000000p+6',
    '0x1.b333340000000p+6', '0x1.1228aa0000000p+7', '0x1.596b220000000p+7',
    '0x1.b333340000000p+7', '0x1.1228aa0000000p+8', '0x1.596b220000000p+8',
    '0x1.b333340000000p+8', '0x1.1228aa0000000p+9', '0x1.596b220000000p+9',
    '0x1.b333340000000p+9', '0x1.1228aa0000000p+10', '0x1.596b220000000p+10',
    '0x1.b333340000000p+10', '0x1.1228aa0000000p+11', '0x1.596b2e0000000p+11',
    '0x1.b333340000000p+11', '0x1.1228a00000000p+12', '0x1.596b220000000p+12',
    '0x1.b333420000000p+12')], np.float32)


def intra_thresh_for_qp(qp: int) -> int:
    """qp-scaled intra-fallback threshold (see INTRA_THRESH)."""
    return INTRA_THRESH[min(max(int(qp), 0), 51)]


def _payload_cap(n_mb: int) -> int:
    """Compact-payload capacity: half the MBs (rounded to whole chunks),
    but never below min(n_mb, 64)."""
    want = max(n_mb // 2, min(n_mb, 64))
    per = (want + PAYLOAD_CHUNKS - 1) // PAYLOAD_CHUNKS
    return per * PAYLOAD_CHUNKS


_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2],
                [1, -1, -1, 1], [1, -2, 2, -1]], np.int32)
_H2 = np.array([[1, 1], [1, -1]], np.int32)
_G8F = _G8_INV.astype(np.float32)
_QCANDS = [(dqx, dqy) for dqy in range(-2, 3) for dqx in range(-2, 3)]

_consts_cache: dict = {}


def _consts(dev):
    """Constant tensors on `dev`, made once per device."""
    c = _consts_cache.get(dev)
    if c is None:
        def t(a, dt=torch.int32):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        c = {"MF": t(MF4x4), "V": t(V4x4), "V8": t(V8x8),
             "CF": t(_CF), "H2": t(_H2), "G8": t(_G8F, torch.float32),
             "ZIG8": t(ZIG8, torch.long),
             "DQ": t(np.array(_QCANDS, np.int32)),
             "QUAD": t((np.arange(16) // 8) * 2 + (np.arange(16) % 4) // 2,
                       torch.long)}
        _consts_cache[dev] = c
    return c


# ---------------------------------------------------------------------------
# integer transform/quant (same arithmetic as encoder_tpu / transform.py)
# ---------------------------------------------------------------------------
def _quant4x4(w, qp, C):
    qbits = QBITS_BASE + qp // 6
    f = (1 << qbits) // 6                        # inter rounding
    lv = (w.abs() * C["MF"][qp % 6] + f) >> qbits
    return torch.where(w < 0, -lv, lv)


def _quant_dc(w, qp, C):
    qbits = QBITS_BASE + qp // 6
    f = (1 << qbits) // 6
    lv = (w.abs() * C["MF"][qp % 6, 0, 0] + 2 * f) >> (qbits + 1)
    return torch.where(w < 0, -lv, lv)


def _dequant4x4(lv, qp, C):
    return (lv * C["V"][qp % 6]) << (qp // 6)


def _dequant_chroma_dc(f, qp, C):
    ls = 16 * C["V"][qp % 6, 0, 0]
    return ((f * ls) << (qp // 6)) >> 5


def _sandwich(A, d):
    """A @ d @ A.T over the last two axes, in int32 (no integer matmul
    on CUDA, so as broadcast products and sums)."""
    t = (A[:, :, None] * d[..., None, :, :]).sum(-2, dtype=torch.int32)
    return (t[..., :, None, :] * A[None, :, :]).sum(-1, dtype=torch.int32)


def _idct(d):
    d0, d1, d2, d3 = d[..., :, 0], d[..., :, 1], d[..., :, 2], d[..., :, 3]
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    g0, g1 = f[..., 0, :] + f[..., 2, :], f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


def _to_blocks4(p):
    H, W = p.shape[-2], p.shape[-1]
    b = p.reshape(*p.shape[:-2], H // 4, 4, W // 4, 4).transpose(-3, -2)
    return b.reshape(*p.shape[:-2], (H // 4) * (W // 4), 4, 4)


def _from_blocks4(b, H, W):
    lead = b.shape[:-3]
    x = b.reshape(*lead, H // 4, W // 4, 4, 4).transpose(-3, -2)
    return x.reshape(*lead, H, W)


# ---------------------------------------------------------------------------
# 8x8 transform (High profile)
# ---------------------------------------------------------------------------
def _fma32(a, b, c):
    """float32 fused multiply-add a*b + c, rounded once (IEEE fma).

    Emulated in float64: a*b of two floats is exact there, TwoSum gives
    the exact error e of s = a*b + c, and where s falls exactly halfway
    between two floats the side of the exact sum decides."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.float()
    d = s - r.double()
    r2 = r.double() + 2.0 * d
    mid = (d != 0) & (r2.float().double() == r2)
    up = mid & (e != 0) & ((e > 0) == (d > 0))
    return torch.where(up, r2.float(), r)


def _dot8(xs, ys):
    """8-term f32 dot product in the reference's summation order (XLA's
    CPU dot): four fma accumulators over the terms j ≡ a (mod 4), then
    (acc0 + acc1) + (acc2 + acc3)."""
    acc = [_fma32(xs[a + 4], ys[a + 4], xs[a] * ys[a]) for a in range(4)]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _fquant8x8(res, qp, C):
    """res: (n, 4, 8, 8) int32 → inter levels (n, 4, 8, 8) int32.

    w = 64 * G r G^T in f32, G @ r first, each 8-term sum in the
    reference's order; then floor(|w| / step + 1/6)."""
    G = C["G8"]
    r = res.float()
    # stage 1: c[i, k] = sum_j G[i, j] r[j, k]
    c = _dot8([G[:, j, None] for j in range(8)],
              [r[..., j:j + 1, :] for j in range(8)])
    # stage 2: d[i, l] = sum_k c[i, k] G[l, k]
    d = _dot8([c[..., :, k:k + 1] for k in range(8)],
              [G[None, :, k] for k in range(8)])
    w = 64.0 * d
    step = 16.0 * C["V8"][qp % 6].float() * (2.0 ** (qp // 6 - 6))
    sixth = torch.tensor(1.0 / 6.0, dtype=torch.float32, device=res.device)
    q = torch.floor(w.abs() / step + sixth)
    return (torch.sign(w) * q).to(torch.int32)


def _dequant8x8(lv, qp, C):
    ls = C["V8"][qp % 6] * 16
    qp6 = qp // 6
    if qp6 >= 6:
        return (lv * ls) << (qp6 - 6)
    return (lv * ls + (1 << (5 - qp6))) >> (6 - qp6)


def _idct8_1d(a):
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    a4, a5, a6, a7 = a[..., 4], a[..., 5], a[..., 6], a[..., 7]
    e0 = a0 + a4
    e1 = -a3 + a5 - a7 - (a7 >> 1)
    e2 = a0 - a4
    e3 = a1 + a7 - a3 - (a3 >> 1)
    e4 = (a2 >> 1) - a6
    e5 = -a1 + a7 + a5 + (a5 >> 1)
    e6 = a2 + (a6 >> 1)
    e7 = a3 + a5 + a1 + (a1 >> 1)
    f0 = e0 + e6
    f1 = e1 + (e7 >> 2)
    f2 = e2 + e4
    f3 = e3 + (e5 >> 2)
    f4 = e2 - e4
    f5 = (e3 >> 2) - e5
    f6 = e0 - e6
    f7 = e7 - (e1 >> 2)
    return torch.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                        f6 - f1, f4 - f3, f2 - f5, f0 - f7], dim=-1)


def _idct8x8(d):
    t = _idct8_1d(d)
    g = _idct8_1d(t.transpose(-1, -2)).transpose(-1, -2)
    return (g + 32) >> 6


# ---------------------------------------------------------------------------
# sub-pel interpolation on batched windows (8.4.2.2 arithmetic)
# ---------------------------------------------------------------------------
def _tap6_h(a):
    """(…, H, W) → (…, H, W-5); out[.., c] is the half-sample between
    source cols c+2 and c+3."""
    return (a[..., 0:-5] - 5 * a[..., 1:-4] + 20 * a[..., 2:-3]
            + 20 * a[..., 3:-2] - 5 * a[..., 4:-1] + a[..., 5:])


def _tap6_v(a):
    return (a[..., 0:-5, :] - 5 * a[..., 1:-4, :] + 20 * a[..., 2:-3, :]
            + 20 * a[..., 3:-2, :] - 5 * a[..., 4:-1, :] + a[..., 5:, :])


def _subpel_preds(A):
    """A: (nMB, 24, 24) windows, A[:, 4, 4] = best full-pel block origin.
    Returns phase (xf, yf) → (nMB, 18, 18), element [r, c] at quarter
    position (c-1 + xf/4, r-1 + yf/4) relative to the block origin."""
    b1 = _tap6_h(A)
    h1 = _tap6_v(A)
    j1 = _tap6_v(b1)
    b = ((b1 + 16) >> 5).clamp(0, 255)
    h = ((h1 + 16) >> 5).clamp(0, 255)
    j = ((j1 + 512) >> 10).clamp(0, 255)
    G = A[:, 3:21, 3:21]
    B = b[:, 3:21, 1:19]
    Hh = h[:, 1:19, 3:21]
    J = j[:, 1:19, 1:19]

    def sx(p):
        return F.pad(p[:, :, 1:], (0, 1))

    def sy(p):
        return F.pad(p[:, 1:, :], (0, 0, 0, 1))

    def avg(p, q):
        return (p + q + 1) >> 1

    return {
        (0, 0): G, (1, 0): avg(G, B), (2, 0): B, (3, 0): avg(B, sx(G)),
        (0, 1): avg(G, Hh), (1, 1): avg(B, Hh), (2, 1): avg(B, J),
        (3, 1): avg(B, sx(Hh)),
        (0, 2): Hh, (1, 2): avg(Hh, J), (2, 2): J, (3, 2): avg(J, sx(Hh)),
        (0, 3): avg(Hh, sy(G)), (1, 3): avg(Hh, sy(B)),
        (2, 3): avg(J, sy(B)), (3, 3): avg(sx(Hh), sy(B)),
    }


# ---------------------------------------------------------------------------
# helpers: edge padding and per-MB window gathers
# ---------------------------------------------------------------------------
def _edge_pad(p, top, bottom, left, right):
    """jnp.pad(mode="edge") as a clamped-index gather."""
    H, W = p.shape
    dev = p.device
    ri = torch.arange(-top, H + bottom, device=dev).clamp(0, H - 1)
    ci = torch.arange(-left, W + right, device=dev).clamp(0, W - 1)
    return p[ri][:, ci]


def _windows(plane, r0, c0, h, w):
    """plane[r0[n] + i, c0[n] + j] for i < h, j < w → (n, h, w)."""
    dev = plane.device
    ri = r0[:, None] + torch.arange(h, device=dev)
    ci = c0[:, None] + torch.arange(w, device=dev)
    return plane[ri[:, :, None], ci[:, None, :]]


def _compact_idx(coded, cap):
    """Indices of the coded MBs in order, padded with 0 (or cut) to
    `cap` — jnp.nonzero(coded, size=cap, fill_value=0) without a host
    sync: a stable sort puts the coded MBs first."""
    n = coded.shape[0]
    order = torch.sort((~coded).to(torch.uint8), stable=True).indices
    if cap > n:
        order = F.pad(order, (0, cap - n))
    order = order[:cap]
    n_coded = coded.sum()
    keep = torch.arange(cap, device=coded.device) < n_coded
    return torch.where(keep, order, 0)


def _bytes(x):
    return x.contiguous().view(torch.uint8).reshape(-1)


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------
def build_p_analyzer_fn(mb_w: int, mb_h: int, deblock: bool = False,
                        transform8x8: bool = False):
    """Returns analyze(src_y, src_u, src_v, ref_y, ref_u, ref_v, qp, qpc)
    → dict, the counterpart of ``encoder_tpu.build_p_analyzer_fn``.

    deblock: chain the in-loop deblock (bS ≤ 2 variant; the CUDA kernel
    on a card) onto the recon; the unfiltered recon stays available as
    recon_y_nf/urec_nf/vrec_nf for the host intra-fallback path."""
    return lambda *a: _analyze(mb_w, mb_h, deblock, transform8x8, *a)


def _analyze(mb_w, mb_h, with_deblock, transform8x8,
             src_y, src_u, src_v, ref_y, ref_u, ref_v, qp, qpc):
    H, W = mb_h * 16, mb_w * 16
    n_mb = mb_w * mb_h
    r = REFINE_R
    side = 2 * r + 1
    qp, qpc = int(qp), int(qpc)
    dev = src_y.device
    C = _consts(dev)
    i32 = torch.int32
    ar = torch.arange(n_mb, device=dev)
    mb_row, mb_col = ar // mb_w, ar % mb_w

    src_y = src_y.to(i32)
    src_mb = (src_y.reshape(mb_h, 16, mb_w, 16)
              .permute(0, 2, 1, 3).reshape(n_mb, 16, 16))

    # --- coarse ME on 4x-decimated planes ---
    s4 = src_y.reshape(H // 4, 4, W // 4, 4).sum((1, 3), dtype=i32) >> 4
    r4 = (ref_y.to(i32).reshape(H // 4, 4, W // 4, 4)
          .sum((1, 3), dtype=i32) >> 4)
    R = LOWRES_R
    r4p = _edge_pad(r4, R, R, R, R)
    costs = []
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            sh = r4p[R + dy:R + dy + H // 4, R + dx:R + dx + W // 4]
            blk = ((s4 - sh).abs().reshape(mb_h, 4, mb_w, 4)
                   .sum((1, 3), dtype=i32))
            costs.append(blk + 2 * (abs(dx) + abs(dy)))
    best = torch.argmin(torch.stack(costs), dim=0).reshape(-1).to(i32)
    lim = MV_CLAMP - r
    mv_cy = ((best // (2 * R + 1) - R) * 4).clamp(-lim, lim)
    mv_cx = ((best % (2 * R + 1) - R) * 4).clamp(-lim, lim)

    # --- window fetch: plain per-MB slices of the edge-padded refs ---
    refp = _edge_pad(ref_y.to(i32), PAD, PAD + 16, PAD, PAD)
    rup = _edge_pad(ref_u.to(i32), 16, 32, 16, 24)
    rvp = _edge_pad(ref_v.to(i32), 16, 32, 16, 24)
    y0, x0 = mb_row * 16 + (PAD - 8), mb_col * 16 + (PAD - 8)
    wy = _windows(refp, y0 + mv_cy, x0 + mv_cx, WIN, WIN)
    wy0 = _windows(refp, y0, x0, WIN, WIN)
    cy0, cx0 = mb_row * 8, mb_col * 8
    croff = ((4 * mv_cy - 16) >> 3) + 16
    ccoff = ((4 * mv_cx - 16) >> 3) + 16
    wu = _windows(rup, cy0 + croff, cx0 + ccoff, CWIN, CWIN)
    wv = _windows(rvp, cy0 + croff, cx0 + ccoff, CWIN, CWIN)
    c0 = ((0 - 16) >> 3) + 16          # chroma origin for mv_c = 0
    wu0 = _windows(rup, cy0 + c0, cx0 + c0, CWIN, CWIN)
    wv0 = _windows(rvp, cy0 + c0, cx0 + c0, CWIN, CWIN)

    # --- full-pel refine ±r over the coarse winner and mv 0 ---
    cc = []
    for w_ in (wy, wy0):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                blk = w_[:, 8 + dy:24 + dy, 8 + dx:24 + dx]
                sad = (blk - src_mb).abs().sum((1, 2), dtype=i32)
                cc.append(sad + 3 * (abs(dx) + abs(dy)))
    fbi98 = torch.argmin(torch.stack(cc, 1), dim=1).to(i32)
    use0 = fbi98 >= side * side
    fbi = fbi98 % (side * side)
    fdy = fbi // side - r
    fdx = fbi % side - r
    mv_cy = torch.where(use0, 0, mv_cy)
    mv_cx = torch.where(use0, 0, mv_cx)
    wu = torch.where(use0[:, None, None], wu0, wu)
    wv = torch.where(use0[:, None, None], wv0, wv)

    # aligned 24x24 window around the best full-pel position
    wsel = torch.where(use0[:, None, None], wy0, wy)
    A = wsel[ar[:, None, None],
             (4 + fdy)[:, None, None] + torch.arange(24, device=dev)[:, None],
             (4 + fdx)[:, None, None] + torch.arange(24, device=dev)]

    # --- quarter-pel refine: 25 candidates on recomputed sub-pel grids
    phg = _subpel_preds(A)
    qsads, preds = [], []
    for dqx, dqy in _QCANDS:
        p = phg[(dqx & 3, dqy & 3)]
        oy, ox = 1 + (dqy >> 2), 1 + (dqx >> 2)
        pred = p[:, oy:oy + 16, ox:ox + 16]
        preds.append(pred)
        qsads.append((pred - src_mb).abs().sum((1, 2), dtype=i32))
    qsads = torch.stack(qsads, 1)                   # (nMB, 25)
    qbi = torch.argmin(qsads, dim=1)
    mvx = (mv_cx + fdx) * 4 + C["DQ"][qbi, 0]
    mvy = (mv_cy + fdy) * 4 + C["DQ"][qbi, 1]
    sad_best = qsads.min(dim=1).values
    pred_y = torch.stack(preds, 1)[ar, qbi]

    # --- luma residual transform/quant/recon ---
    res = src_mb - pred_y
    w = _sandwich(C["CF"], _to_blocks4(res))
    lv = _quant4x4(w, qp, C)
    nnz = (lv.reshape(-1, 16, 16) != 0).sum(-1, dtype=i32)
    quad = C["QUAD"]
    qmask = torch.stack([(nnz * (quad == q)).sum(-1) > 0 for q in range(4)],
                        1)
    shifts = torch.arange(4, device=dev, dtype=i32)
    cbp_luma = (qmask.to(i32) << shifts).sum(-1, dtype=i32)
    keep = qmask[:, quad]
    lv = torch.where(keep[..., None, None], lv, 0)
    nnz = torch.where(keep, nnz, 0)
    rec = _idct(_dequant4x4(lv, qp, C))
    recon_y = (pred_y + _from_blocks4(rec, 16, 16)).clamp(0, 255)

    t8_flags = torch.zeros((n_mb,), dtype=torch.bool, device=dev)
    if transform8x8:
        # --- 8x8 transform hypothesis (High profile) + per-MB RDO ---
        quads8 = (res.reshape(n_mb, 2, 8, 2, 8)
                  .permute(0, 1, 3, 2, 4).reshape(n_mb, 4, 8, 8))
        lv8 = _fquant8x8(quads8, qp, C)
        q8c = (lv8 != 0).any(dim=3).any(dim=2)          # (n, 4)
        cbp8 = (q8c.to(i32) << shifts).sum(-1, dtype=i32)
        lv8 = torch.where(q8c[:, :, None, None], lv8, 0)
        r8 = _idct8x8(_dequant8x8(lv8, qp, C))
        r8f = (r8.reshape(n_mb, 2, 2, 8, 8)
               .permute(0, 1, 3, 2, 4).reshape(n_mb, 16, 16))
        recon8 = (pred_y + r8f).clamp(0, 255)
        # true-recon RDO: SSD + lam2 * 6 * nnz, as one f32 fma
        lam6 = torch.tensor(LAM2[qp] * np.float32(6.0), device=dev)
        nnz8_tot = (lv8 != 0).sum((1, 2, 3), dtype=i32)
        ssd4 = ((src_mb - recon_y) ** 2).sum((1, 2), dtype=i32).float()
        ssd8 = ((src_mb - recon8) ** 2).sum((1, 2), dtype=i32).float()
        j4 = _fma32(lam6, nnz.sum(-1, dtype=i32).float(), ssd4)
        j8 = _fma32(lam6, nnz8_tot.float(), ssd8)
        t8_flags = (j8 < j4) & (cbp8 != 0)
        recon_y = torch.where(t8_flags[:, None, None], recon8, recon_y)
        cbp_luma = torch.where(t8_flags, cbp8, cbp_luma)
        # 8x8 sub-streams: zig-scan, then phase de-interleave —
        # sub-stream k = (quad k>>2, phase k&3), 16 coeffs each
        scan8 = lv8.reshape(n_mb, 4, 64)[:, :, C["ZIG8"]]
        subs = (scan8.reshape(n_mb, 4, 16, 4)
                .permute(0, 1, 3, 2).reshape(n_mb, 16, 16))
        lv = torch.where(t8_flags[:, None, None, None],
                         subs.reshape(n_mb, 16, 4, 4), lv)
        # per-4x4-cell coded-ness for the loop filter
        cells8 = (q8c.reshape(n_mb, 2, 2).repeat_interleave(2, dim=1)
                  .repeat_interleave(2, dim=2).reshape(n_mb, 16).to(i32)
                  * 16)
        nnz = torch.where(t8_flags[:, None], cells8, nnz)

    # --- chroma: 9x9 window at the final-mv offset, bilinear MC ---
    def chroma(srcp, wc):
        offx = (mvx >> 3) - ((mv_cx * 4 - 16) >> 3)     # ∈ [0, 4]
        offy = (mvy >> 3) - ((mv_cy * 4 - 16) >> 3)
        w9 = wc[ar[:, None, None],
                offy[:, None, None] + torch.arange(9, device=dev)[:, None],
                offx[:, None, None] + torch.arange(9, device=dev)]
        xf = (mvx & 7)[:, None, None]
        yf = (mvy & 7)[:, None, None]
        Aq = w9[:, 0:8, 0:8]
        Bq = w9[:, 0:8, 1:9]
        Cq = w9[:, 1:9, 0:8]
        Dq = w9[:, 1:9, 1:9]
        pred = ((8 - xf) * (8 - yf) * Aq + xf * (8 - yf) * Bq
                + (8 - xf) * yf * Cq + xf * yf * Dq + 32) >> 6
        smb = (srcp.to(i32).reshape(mb_h, 8, mb_w, 8).permute(0, 2, 1, 3)
               .reshape(n_mb, 8, 8))
        cw = _sandwich(C["CF"], _to_blocks4(smb - pred))
        dc = cw[:, :, 0, 0].reshape(-1, 2, 2)
        dclv = _quant_dc(_sandwich(C["H2"], dc), qpc, C)
        ac = cw.clone()
        ac[:, :, 0, 0] = 0
        aclv = _quant4x4(ac, qpc, C)
        dcq = _dequant_chroma_dc(_sandwich(C["H2"], dclv), qpc, C)
        dqc = _dequant4x4(aclv, qpc, C)
        dqc[:, :, 0, 0] = dcq.reshape(-1, 4)
        rc = _idct(dqc)
        reconc = (pred + _from_blocks4(rc, 8, 8)).clamp(0, 255)
        cnnz = (aclv.reshape(-1, 4, 16) != 0).sum(-1, dtype=i32)
        return dclv.reshape(-1, 4), aclv, reconc, cnnz

    udc, uac, urec, unnz = chroma(src_u, wu)
    vdc, vac, vrec, vnnz = chroma(src_v, wv)

    # --- compact entropy payload: int8 / nibble levels of coded MBs ---
    coded = ((cbp_luma > 0) | (udc != 0).any(-1) | (unnz > 0).any(-1)
             | (vdc != 0).any(-1) | (vnnz > 0).any(-1))
    n_coded = coded.sum(dtype=i32)
    payload16 = torch.cat([
        lv.reshape(n_mb, 256), udc, uac.reshape(n_mb, 64),
        vdc, vac.reshape(n_mb, 64)], dim=1)              # (nMB, 392)
    overflow = (payload16.abs().max() > 127).to(i32)
    cap = _payload_cap(n_mb)
    per = cap // PAYLOAD_CHUNKS
    coded_idx = _compact_idx(coded, cap)
    payload8 = (payload16.clamp(-128, 127).to(torch.int8)[coded_idx]
                .reshape(PAYLOAD_CHUNKS, per, 392))
    nib_ok = ((payload16 >= -8) & (payload16 <= 7)).all(dim=1)
    taken4 = (payload16 & 15)[coded_idx]                 # (cap, 392)
    payload_nib = ((taken4[:, 0::2] | (taken4[:, 1::2] << 4))
                   .to(torch.uint8).reshape(PAYLOAD_CHUNKS, per, 196))

    def plane(blocks, bs):
        return (blocks.reshape(mb_h, mb_w, bs, bs).permute(0, 2, 1, 3)
                .reshape(mb_h * bs, mb_w * bs).to(torch.uint8))

    n_intra = (sad_best > intra_thresh_for_qp(qp)).sum(dtype=i32)
    mv16 = torch.stack([mvx, mvy], 1).to(torch.int16)
    packed_small = torch.cat([
        _bytes(torch.stack([n_intra, n_coded, overflow]).to(i32)),
        _bytes(mv16),
        _bytes(sad_best.to(i32)),
        _bytes(cbp_luma.to(torch.int8)),
        _bytes(t8_flags.to(torch.int8)),
        _bytes(unnz.to(torch.int8)),
        _bytes(vnnz.to(torch.int8)),
        _bytes(coded_idx.to(torch.int16 if n_mb <= 32767 else i32)),
        _bytes(nib_ok.to(torch.int8)),
    ])

    rec_y_p = plane(recon_y, 16)
    rec_u_p = plane(urec, 8)
    rec_v_p = plane(vrec, 8)
    extra = {}
    if with_deblock:
        dby, dbu, dbv = deblock(
            rec_y_p, rec_u_p, rec_v_p, mv16, nnz,
            torch.zeros((n_mb,), dtype=torch.bool, device=dev),  # all inter
            t8_flags, qp, qpc, with_strong=False)
        extra = {"recon_y_nf": rec_y_p, "urec_nf": rec_u_p,
                 "vrec_nf": rec_v_p}
        rec_y_p, rec_u_p, rec_v_p = dby, dbu, dbv

    return {
        **extra,
        "packed_small": packed_small,
        "mv": mv16,
        "sad": sad_best.to(i32),
        "n_intra": n_intra,
        "n_coded": n_coded,
        "overflow": overflow,
        "coded_idx": coded_idx.to(i32),
        "payload": [payload8[c] for c in range(PAYLOAD_CHUNKS)],
        "payload_nib": [payload_nib[c] for c in range(PAYLOAD_CHUNKS)],
        "luma_lv": lv.to(torch.int16),
        "luma_nnz": nnz.to(torch.int8),
        "cbp_luma": cbp_luma.to(torch.int8),
        "t8": t8_flags.to(torch.int8),
        "recon_y": rec_y_p,
        "udc": udc.to(torch.int16), "uac": uac.to(torch.int16),
        "urec": rec_u_p, "unnz": unnz.to(torch.int8),
        "vdc": vdc.to(torch.int16), "vac": vac.to(torch.int16),
        "vrec": rec_v_p, "vnnz": vnnz.to(torch.int8),
    }


def build_p_analyzer(mb_w: int, mb_h: int, deblock: bool = False,
                     transform8x8: bool = False):
    """Returns analyze(src_packed, ref_y, ref_u, ref_v, qp, qpc) → dict,
    where src_packed is the three source planes concatenated into one
    flat uint8 tensor (y | u | v), uploaded in one copy per frame."""
    fn = build_p_analyzer_fn(mb_w, mb_h, deblock=deblock,
                             transform8x8=transform8x8)
    H, W = mb_h * 16, mb_w * 16
    ny, nc = H * W, (H // 2) * (W // 2)

    def analyze_packed(src, ref_y, ref_u, ref_v, qp, qpc):
        y = src[:ny].reshape(H, W)
        u = src[ny:ny + nc].reshape(H // 2, W // 2)
        v = src[ny + nc:ny + 2 * nc].reshape(H // 2, W // 2)
        return fn(y, u, v, ref_y, ref_u, ref_v, qp, qpc)

    return analyze_packed


def build_p_analyzer_batch(mb_w: int, mb_h: int, n_frames: int,
                           deblock: bool = False,
                           transform8x8: bool = False):
    """Batched analyzer of up to n_frames frames: a loop of the
    per-frame analyzer that chains the recon references on the device.
    The batch shares one qp (rate control quantizes per batch).  A
    partial batch runs only its own frames (the reference pads it with
    repeats of the last frame, whose outputs nothing reads).

    Returns fn(srcs, ref_y, ref_u, ref_v, qp, qpc) where srcs is
    (N, ny + 2nc) uint8; output fields are stacked (N, ...), "payload"
    (N, chunks, per, 392) and "payload_nib" (N, chunks, per, 196); the
    final recon planes ride in "carry_y/u/v"."""
    fn = build_p_analyzer(mb_w, mb_h, deblock=deblock,
                          transform8x8=transform8x8)

    def analyze_batch(srcs, ref_y, ref_u, ref_v, qp, qpc):
        if not 1 <= srcs.shape[0] <= n_frames:
            raise ValueError(f"batch of {srcs.shape[0]} frames, "
                             f"built for up to {n_frames}")
        refs = (ref_y, ref_u, ref_v)
        per_frame = []
        for src in srcs:
            d = fn(src, *refs, qp, qpc)
            d["payload"] = torch.stack(d["payload"])
            d["payload_nib"] = torch.stack(d["payload_nib"])
            per_frame.append(d)
            refs = (d["recon_y"], d["urec"], d["vrec"])
        outs = {k: torch.stack([d[k] for d in per_frame])
                for k in per_frame[0]}
        outs["carry_y"], outs["carry_u"], outs["carry_v"] = refs
        return outs

    return analyze_batch
