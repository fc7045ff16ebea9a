"""H.264 integer transforms and quantization — exact spec arithmetic.

All functions are array-module agnostic (pass numpy or jax.numpy as ``xp``) and
operate on batches of 4x4 blocks shaped (..., 4, 4) in int32, so the same code
is the host reference and the TPU device path (jitted). Batched 4x4 transforms
become (N,4,4)x(4,4) einsums → MXU-friendly on TPU.

Spec refs: fwd core transform + quant = JM/x264 style (compatible with 8.5.9
dequant); inverse transform 8.5.10-8.5.12; DC Hadamard 8.5.6/8.5.8.
"""
from __future__ import annotations

import numpy as np

from .tables import MF4x4, V4x4, QBITS_BASE, CHROMA_QP

# Core transform matrices
_CF = np.array([[1, 1, 1, 1],
                [2, 1, -1, -2],
                [1, -1, -1, 1],
                [1, -2, 2, -1]], dtype=np.int32)
_CF_T = _CF.T.copy()
_H4 = np.array([[1, 1, 1, 1],
                [1, 1, -1, -1],
                [1, -1, -1, 1],
                [1, -1, 1, -1]], dtype=np.int32)
_H2 = np.array([[1, 1], [1, -1]], dtype=np.int32)


def _mm(xp, a, b):
    """Integer matmul on the trailing 2 dims."""
    return xp.einsum("...ij,jk->...ik", a, b)


def _mml(xp, a, b):
    return xp.einsum("ij,...jk->...ik", a, b)


def fdct4x4(xp, d):
    """Forward 4x4 core transform: W = C d C^T.  d: (...,4,4) int32."""
    cf = xp.asarray(_CF)
    cft = xp.asarray(_CF_T)
    return _mm(xp, _mml(xp, cf, d.astype(xp.int32)), cft)


def hadamard4x4(xp, dc):
    """4x4 Hadamard for Intra16x16 luma DC (encoder side, unscaled).

    The /2 normalization is folded into quant_dc's (qbits+1) shift, keeping the
    encoder compatible with the 8.5.10 decoder-side dequant.
    """
    h = xp.asarray(_H4)
    return _mm(xp, _mml(xp, h, dc.astype(xp.int32)), h)


def ihadamard4x4(xp, f):
    """Inverse 4x4 Hadamard (no scaling)."""
    h = xp.asarray(_H4)
    return _mm(xp, _mml(xp, h, f.astype(xp.int32)), h)


def hadamard2x2(xp, dc):
    """2x2 Hadamard for chroma DC (both directions, no scale)."""
    h = xp.asarray(_H2)
    return _mm(xp, _mml(xp, h, dc.astype(xp.int32)), h)


def quant4x4(xp, w, qp: int, intra: bool, dc_only_scale: bool = False):
    """Quantize 4x4 coefficients. w: (...,4,4) int32 → levels int32.

    level = sign(w) * ((|w| * MF[qp%6][i,j] + f) >> qbits)
    f = (1<<qbits)/3 intra, /6 inter.
    """
    qbits = QBITS_BASE + qp // 6
    mf = xp.asarray(MF4x4[qp % 6])
    if dc_only_scale:
        mf = xp.full_like(mf, int(MF4x4[qp % 6][0, 0]))
    f = ((1 << qbits) // 3) if intra else ((1 << qbits) // 6)
    aw = xp.abs(w).astype(xp.int64)
    lv = ((aw * mf + f) >> qbits).astype(xp.int32)
    return xp.where(w < 0, -lv, lv)


def quant_dc(xp, w, qp: int, intra: bool):
    """Quantize DC-transformed coefficients (luma I16x16 DC / chroma DC):
    uses MF(0,0), qbits+1, 2f."""
    qbits = QBITS_BASE + qp // 6
    mf00 = int(MF4x4[qp % 6][0, 0])
    f = ((1 << qbits) // 3) if intra else ((1 << qbits) // 6)
    aw = xp.abs(w).astype(xp.int64)
    lv = ((aw * mf00 + 2 * f) >> (qbits + 1)).astype(xp.int32)
    return xp.where(w < 0, -lv, lv)


def dequant4x4(xp, levels, qp: int):
    """AC dequant (8.5.9): d = level * V[qp%6][i,j] << (qp//6)."""
    v = xp.asarray(V4x4[qp % 6])
    return (levels.astype(xp.int32) * v.astype(xp.int32)) << (qp // 6)


def dequant_luma_dc(xp, f, qp: int):
    """Intra16x16 luma DC dequant (8.5.10). f: inverse-Hadamard output.

    LevelScale4x4 = weightScale * normAdjust = 16 * V for the flat default
    scaling list; the 16 does NOT cancel here (unlike the AC path where the
    spec's >>4 absorbs it). Validated against FFmpeg decode of our streams.
    """
    ls = 16 * int(V4x4[qp % 6][0, 0])
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    rnd = 1 << (5 - qp // 6)
    return (f * ls + rnd) >> (6 - qp // 6)


def dequant_chroma_dc(xp, f, qp: int):
    """Chroma DC dequant (8.5.11, 4:2:0): ((f * 16*V00) << (qp//6)) >> 5."""
    ls = 16 * int(V4x4[qp % 6][0, 0])
    return ((f * ls) << (qp // 6)) >> 5


def idct4x4(xp, d):
    """Inverse 4x4 core transform (8.5.12): returns residual BEFORE the
    final (x+32)>>6 rounding IS included here — output is the spec's r_ij."""
    d = d.astype(xp.int32)
    # horizontal (rows): e/f per spec
    d0 = d[..., :, 0]
    d1 = d[..., :, 1]
    d2 = d[..., :, 2]
    d3 = d[..., :, 3]
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f0 = e0 + e3
    f1 = e1 + e2
    f2 = e1 - e2
    f3 = e0 - e3
    f = xp.stack([f0, f1, f2, f3], axis=-1)
    # vertical (cols)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h0 = g0 + g3
    h1 = g1 + g2
    h2 = g1 - g2
    h3 = g0 - g3
    h = xp.stack([h0, h1, h2, h3], axis=-2)
    return (h + 32) >> 6


def chroma_qp(qp: int, offset: int = 0) -> int:
    qpi = min(max(qp + offset, 0), 51)
    return int(CHROMA_QP[qpi])


# ---------------------------------------------------------------------------
# Block (de)composition helpers: image plane <-> (N,4,4) batches
# ---------------------------------------------------------------------------
def to_blocks4(xp, plane):
    """(H,W) → (H/4*W/4, 4, 4) in raster block order."""
    H, W = plane.shape[-2], plane.shape[-1]
    b = plane.reshape(*plane.shape[:-2], H // 4, 4, W // 4, 4)
    b = xp.swapaxes(b, -3, -2)
    return b.reshape(*plane.shape[:-2], (H // 4) * (W // 4), 4, 4)


def from_blocks4(xp, blocks, H, W):
    """(N,4,4) raster block order → (H,W)."""
    lead = blocks.shape[:-3]
    b = blocks.reshape(*lead, H // 4, W // 4, 4, 4)
    b = xp.swapaxes(b, -3, -2)
    return b.reshape(*lead, H, W)


def mb_block_order(mb_w: int, mb_h: int):
    """Raster 4x4-block index → H.264 luma coded block order within the frame.

    H.264 codes a MB's 16 luma 4x4 blocks in 'zig' order: 4 8x8 quadrants in
    raster order, 4 blocks raster within each quadrant. Returns an index array
    `order` such that blocks_raster[order] is coded order, and its inverse.
    """
    W4 = mb_w * 4
    idx = np.arange(mb_w * mb_h * 16)
    mb = idx // 16
    k = idx % 16
    mby, mbx = mb // mb_w, mb % mb_w
    q = k // 4          # quadrant 0..3
    r = k % 4           # block in quadrant
    by = mby * 4 + (q // 2) * 2 + (r // 2)
    bx = mbx * 4 + (q % 2) * 2 + (r % 2)
    order = by * W4 + bx
    inv = np.argsort(order)
    return order.astype(np.int32), inv.astype(np.int32)


def mb_block_order_chroma(mb_w: int, mb_h: int):
    """Chroma: each MB has 4 4x4 blocks (8x8 plane area), raster within MB."""
    W4 = mb_w * 2
    idx = np.arange(mb_w * mb_h * 4)
    mb = idx // 4
    k = idx % 4
    mby, mbx = mb // mb_w, mb % mb_w
    by = mby * 2 + k // 2
    bx = mbx * 2 + k % 2
    order = by * W4 + bx
    inv = np.argsort(order)
    return order.astype(np.int32), inv.astype(np.int32)


# ---------------------------------------------------------------------------
# 8x8 transform (High profile; spec 8.5.12.3 inverse, Table 8-15 normAdjust).
# The inverse (idct8x8/dequant8x8) is exact spec integer arithmetic and must
# match the native decoder bit-for-bit (hbdec264.cpp idct8_add/dequant8_block);
# the forward is derived numerically from the inverse basis (encoder-only —
# any forward approximation is conformant, only RD depends on it).
# ---------------------------------------------------------------------------
_V8 = np.array([[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26],
                [26, 23, 42, 24, 33, 31], [28, 25, 45, 26, 35, 33],
                [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]],
               dtype=np.int64)


def _v8_class() -> np.ndarray:
    cls = np.zeros((8, 8), np.int64)
    for i in range(64):
        r, c = i >> 3, i & 7
        rm, cm = r & 3, c & 3
        if rm == 0 and cm == 0:
            v = 0
        elif (r & 1) == 1 and (c & 1) == 1:
            v = 1
        elif rm == 2 and cm == 2:
            v = 2
        elif (rm == 0 and (c & 1) == 1) or ((r & 1) == 1 and cm == 0):
            v = 3
        elif (rm == 0 and cm == 2) or (rm == 2 and cm == 0):
            v = 4
        else:
            v = 5
        cls[r, c] = v
    return cls


_V8_CLASS = _v8_class()
V8x8 = _V8[:, _V8_CLASS]              # (6, 8, 8) per-position normAdjust8x8

ZIG8 = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
                 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                 54, 47, 55, 62, 63], dtype=np.int32)


def _idct8_1d_int(a):
    """Spec 8.5.12.3 1D inverse butterfly (integer, >> = floor shift).
    a: (..., 8) int array (numpy)."""
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
    return np.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                     f6 - f1, f4 - f3, f2 - f5, f0 - f7], axis=-1)


def idct8x8(xp, d):
    """Inverse 8x8 transform on dequantized coefficients d (...,8,8) →
    residual including the final (x+32)>>6 rounding (spec 8.5.12.3)."""
    d = np.asarray(d, np.int64)
    t = _idct8_1d_int(d)                       # horizontal (rows)
    g = _idct8_1d_int(np.swapaxes(t, -1, -2))  # vertical (cols)
    g = np.swapaxes(g, -1, -2)
    return ((g + 32) >> 6).astype(np.int32)


def dequant8x8(xp, levels, qp: int):
    """8x8 dequant (spec 8.5.13.1, flat weight 16): per-position
    LevelScale8x8 = 16 * normAdjust8x8[qp%6]."""
    lv = np.asarray(levels, np.int64)
    ls = 16 * V8x8[qp % 6]
    qp6 = qp // 6
    if qp6 >= 6:
        return ((lv * ls) << (qp6 - 6)).astype(np.int32)
    return ((lv * ls + (1 << (5 - qp6))) >> (6 - qp6)).astype(np.int32)


def _fwd8_basis() -> np.ndarray:
    """64x64 forward map derived from the float inverse basis: the 1D
    inverse (>>1 → /2) is a linear map G; the 2D inverse is G W G^T / 64,
    so forward W = 64 * G^-1 r G^-T.  Returns G^-1 (float64, 8x8)."""
    G = np.zeros((8, 8))
    for i in range(8):
        a = np.zeros(8)
        a[i] = 1.0
        a0, a1, a2, a3, a4, a5, a6, a7 = a
        e0 = a0 + a4
        e1 = -a3 + a5 - a7 - a7 / 2
        e2 = a0 - a4
        e3 = a1 + a7 - a3 - a3 / 2
        e4 = a2 / 2 - a6
        e5 = -a1 + a7 + a5 + a5 / 2
        e6 = a2 + a6 / 2
        e7 = a3 + a5 + a1 + a1 / 2
        f0, f1 = e0 + e6, e1 + e7 / 4
        f2, f3 = e2 + e4, e3 + e5 / 4
        f4, f5 = e2 - e4, e3 / 4 - e5
        f6, f7 = e0 - e6, e7 - e1 / 4
        G[:, i] = [f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                   f6 - f1, f4 - f3, f2 - f5, f0 - f7]
    return np.linalg.inv(G)


_G8_INV = _fwd8_basis()


def fquant8x8(xp, res, qp: int, intra: bool):
    """Forward 8x8 transform + quantization in one step (encoder side):
    res (...,8,8) int → levels (...,8,8) int32 such that
    idct8x8(dequant8x8(levels)) ≈ res."""
    r = np.asarray(res, np.float64)
    w = 64.0 * np.einsum("ij,...jk,lk->...il", _G8_INV, r, _G8_INV)
    step = (16.0 * V8x8[qp % 6].astype(np.float64)) * 2.0 ** (qp // 6 - 6)
    dz = (1.0 / 3.0) if intra else (1.0 / 6.0)
    q = np.floor(np.abs(w) / step + dz)
    return (np.sign(w) * q).astype(np.int32)
