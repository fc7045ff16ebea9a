"""HEVC (H.265) constant tables: transform matrices, quant scales, CABAC
engine tables, context-model init values, scan orders.

Role of the reference's x265 constant layer (replaced wholesale per
SURVEY.md §2.5 — HandBrake's libhb/encx265.c wraps x265; we implement
the codec natively).  Values transcribed from ITU-T H.265 (Tables 9-46,
9-47, 8-5..8-10) and the HM reference software context-init tables; the
round-trip tests (tests/test_hevc_codec.py) validate encoder/decoder
consistency over every table.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Transform matrices (8.6.4). Built from the canonical 32-point value list:
# V[p] ~ quantized 64*sqrt(2)*cos(p*pi/64), norm-tuned per the spec.
# T32[k][j] = fold(V, k*(2j+1) mod 128); smaller sizes are even-row subsets.
# ---------------------------------------------------------------------------
_V32 = np.array([64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70,
                 67, 64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13,
                 9, 4], dtype=np.int32)


def _fold(p: int) -> int:
    """cos(p*pi/64) with magnitude from _V32, p taken mod 128."""
    p %= 128
    sign = 1
    if p > 64:
        p = 128 - p        # cos(-x) = cos(x)
    if p > 32:
        p = 64 - p         # cos(pi - x) = -cos(x)
        sign = -1
    if p == 32:
        return 0
    return sign * int(_V32[p])


def dct_matrix(n: int) -> np.ndarray:
    """HEVC integer DCT matrix, n in {4, 8, 16, 32}."""
    step = 32 // n
    m = np.zeros((n, n), dtype=np.int32)
    for k in range(n):
        for j in range(n):
            m[k, j] = _fold((k * step) * (2 * j + 1))
    return m


# 4x4 DST-VII for 4x4 intra luma (8.6.4.2) — kept for completeness; the
# encoder's minimum TU is 16 so it is unused on the hot path.
DST4 = np.array([[29, 55, 74, 84],
                 [74, 74, 0, -74],
                 [84, -29, -74, 55],
                 [55, -84, 74, -29]], dtype=np.int32)

# Quantization (8.6.3 + HM xQuant): f(qp%6) pairs satisfy q*l ~= 2^20.
QUANT_SCALE = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                       dtype=np.int64)
LEV_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

# Chroma QP mapping (Table 8-10, 4:2:0).
_CHROMA_QP_MAP = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34,
                  37: 34, 38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qp(qp_y: int, offset: int = 0) -> int:
    qpi = min(max(qp_y + offset, 0), 57)
    if qpi < 30:
        return qpi
    if qpi > 43:
        return qpi - 6
    return _CHROMA_QP_MAP[qpi]


# ---------------------------------------------------------------------------
# CABAC arithmetic engine tables (9.3.4.3): identical to H.264's.
# ---------------------------------------------------------------------------
RANGE_TAB_LPS = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int32)

TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27,
    27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35,
    35, 36, 36, 36, 37, 37, 37, 38, 38, 63], dtype=np.int32)


def ctx_init_state(init_value: int, qp: int) -> tuple:
    """(pStateIdx, valMps) from an 8-bit initValue (9.3.2.2)."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(((slope * min(max(qp, 0), 51)) >> 4) + offset, 1), 126)
    if pre <= 63:
        return 63 - pre, 0
    return pre - 64, 1


# ---------------------------------------------------------------------------
# Context-model init values, indexed [initType][ctxIdx]; initType 0=I, 1=P,
# 2=B (cabac_init_flag is never set). CNU = 154 ("context not used").
# ---------------------------------------------------------------------------
CNU = 154

CTX_INIT = {
    "cu_skip": [[CNU] * 3, [197, 185, 201], [197, 185, 201]],
    "merge_flag": [[CNU], [110], [154]],
    "merge_idx": [[CNU], [122], [137]],
    "part_mode": [[184, CNU, CNU, CNU], [154, 139, 154, 154],
                  [154, 139, 154, 154]],
    "pred_mode": [[CNU], [149], [134]],
    "prev_intra": [[184], [154], [183]],
    "chroma_pred": [[63], [152], [152]],
    "mvd": [[CNU, CNU], [140, 198], [169, 198]],       # [greater0, greater1]
    "ref_idx": [[CNU, CNU], [153, 153], [153, 153]],
    "mvp_idx": [[CNU], [168], [168]],
    "rqt_root_cbf": [[CNU], [79], [79]],
    "cbf_luma": [[111, 141], [153, 111], [153, 111]],
    "cbf_chroma": [[94, 138], [149, 107], [149, 92]],
    # last_sig_coeff_{x,y}_prefix: 15 luma + 3 chroma, same table for x and y
    "last_x": [[110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143,
                127, 111, 79, 108, 123, 63],
               [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111,
                95, 94, 108, 123, 108],
               [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
                111, 79, 108, 123, 93]],
    "sig_cg": [[91, 171, 134, 141], [121, 140, 61, 154],
               [121, 140, 61, 154]],
    # sig_coeff_flag: 27 luma + 15 chroma = 42
    "sig": [[111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
             153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
             125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
             136, 139, 111],
            [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136,
             153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
             154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140,
             151, 183, 140],
            [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136,
             153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
             154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140,
             151, 183, 140]],
    # coeff_abs_level_greater1: 16 luma + 8 chroma = 24
    "gt1": [[140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139,
             107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
            [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
             121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
            [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
             121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182]],
    # coeff_abs_level_greater2: 4 luma + 2 chroma = 6
    "gt2": [[138, 153, 136, 167, 152, 152], [107, 167, 91, 122, 107, 167],
            [107, 167, 91, 107, 107, 167]],
}
CTX_INIT["last_y"] = CTX_INIT["last_x"]  # separate ctx set, same init values

# sig_coeff_flag 4x4 ctx map (9.3.4.2.5, log2TrafoSize==2)
SIG_CTX_4x4 = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8],
                       dtype=np.int32)


# ---------------------------------------------------------------------------
# Scan orders (6.5.3): up-right diagonal, as (pos -> (x, y)) index arrays.
# ---------------------------------------------------------------------------
def diag_scan(n: int) -> np.ndarray:
    """Up-right diagonal scan of an n x n block: array of (x, y), DC first.
    Within each anti-diagonal s = x + y the scan moves up-right (x asc)."""
    out = []
    for s in range(2 * n - 1):
        for x in range(max(0, s - n + 1), min(s, n - 1) + 1):
            out.append((x, s - x))
    return np.array(out, dtype=np.int32)


DIAG4 = diag_scan(4)

# Intra angular prediction (8.4.4.2.6)
INTRA_PRED_ANGLE = {m: a for m, a in zip(
    range(2, 35),
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32])}
INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
             -21: -390, -26: -315, -32: -256}

# Inter sub-pel interpolation filters (8.5.4.2.2)
LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], dtype=np.int32)
CHROMA_FILTER = np.array([
    [0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2], [-6, 46, 28, -4],
    [-4, 36, 36, -4], [-4, 28, 46, -6], [-2, 16, 54, -4], [-2, 10, 58, -2]],
    dtype=np.int32)
