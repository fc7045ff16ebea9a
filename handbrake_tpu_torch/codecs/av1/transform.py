"""AV1-family integer transforms & quantization (8x8 DCT).

Same construction as libaom's av1_fwd_txfm 8-point integer DCT family
(64-scaled cosine basis, staged right-shifts); reference encoder entry is
SVT-AV1 (encsvtav1.c) which we replace wholesale per SURVEY.md §2.5.
Forward/inverse are integer-deterministic so encoder reconstruction and
decoder output agree bit-exactly.

All functions are batched: blocks has shape (n, 8, 8) int32.
"""
from __future__ import annotations

import numpy as np

# 64-scaled 8-point DCT-II basis (integer, orthogonal family)
M8 = np.array([
    [64,  64,  64,  64,  64,  64,  64,  64],
    [89,  75,  50,  18, -18, -50, -75, -89],
    [83,  36, -36, -83, -83, -36,  36,  83],
    [75, -18, -89, -50,  50,  89,  18, -75],
    [64, -64, -64,  64,  64, -64, -64,  64],
    [50, -89,  18,  75, -75, -18,  89, -50],
    [36, -83,  83, -36, -36,  83, -83,  36],
    [18, -50,  75, -89,  89, -75,  50, -18],
], dtype=np.int64)

_S1F, _S2F = 2, 9        # forward stage shifts (8-bit depth)
_S1I, _S2I = 7, 12       # inverse stage shifts


def fdct8x8(blocks: np.ndarray) -> np.ndarray:
    x = blocks.astype(np.int64)
    t = (np.einsum('ij,njk->nik', M8, x) + (1 << (_S1F - 1))) >> _S1F
    y = (np.einsum('nik,jk->nij', t, M8) + (1 << (_S2F - 1))) >> _S2F
    return y.astype(np.int32)


def idct8x8(coeffs: np.ndarray) -> np.ndarray:
    y = coeffs.astype(np.int64)
    t = (np.einsum('ji,njk->nik', M8, y) + (1 << (_S1I - 1))) >> _S1I
    x = (np.einsum('nik,kj->nij', t, M8) + (1 << (_S2I - 1))) >> _S2I
    return x.astype(np.int32)


# ---------------------------------------------------------------------------
# quantization — AV1-style qindex in [0, 255]
# ---------------------------------------------------------------------------
def ac_qstep(qindex: int) -> int:
    """Monotone exponential qstep table (AV1 ac_qlookup shape, 8-bit)."""
    return max(4, int(round(4.0 * 2.0 ** (qindex / 40.0))))


def dc_qstep(qindex: int) -> int:
    return max(4, (ac_qstep(qindex) * 7 + 4) // 8)


def quantize(coeffs: np.ndarray, qindex: int, intra: bool) -> np.ndarray:
    """Deadzone quant; intra gets the larger rounding bias (like x264/aom)."""
    qac, qdc = ac_qstep(qindex), dc_qstep(qindex)
    q = np.full((8, 8), qac, dtype=np.int64)
    q[0, 0] = qdc
    bias = q // (3 if intra else 6) * 2
    c = coeffs.astype(np.int64)
    lv = (np.abs(c) * 4 + bias) // (q * 4)
    return (np.sign(c) * lv).astype(np.int32)


def dequantize(levels: np.ndarray, qindex: int) -> np.ndarray:
    qac, qdc = ac_qstep(qindex), dc_qstep(qindex)
    q = np.full((8, 8), qac, dtype=np.int64)
    q[0, 0] = qdc
    return (levels.astype(np.int64) * q).astype(np.int32)


# zigzag scan order for 8x8 (AV1 default scan)
def _zigzag8() -> np.ndarray:
    order = sorted(((i + j, (j if (i + j) % 2 else i), i, j)
                    for i in range(8) for j in range(8)))
    return np.array([[o[2], o[3]] for o in order], dtype=np.int32)

ZIGZAG8 = _zigzag8()
ZZ_FLAT = ZIGZAG8[:, 0] * 8 + ZIGZAG8[:, 1]
