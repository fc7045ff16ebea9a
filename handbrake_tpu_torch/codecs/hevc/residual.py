"""HEVC residual_coding() — transform-coefficient CABAC (7.3.8.11, 9.3.4.2-3).

Diagonal scan only (all our TUs are 16x16 or 32x32, for which HEVC mandates
the up-right diagonal scan; mode-dependent scans exist only for 4x4/8x8).
Sign-data-hiding and transform-skip are disabled in the PPS, so every
significant coefficient carries an explicit bypass sign bit.

Encoder and decoder are exact mirrors; tests round-trip random and real
coefficient fields through both.
"""
from __future__ import annotations

import numpy as np

from .tables import DIAG4, diag_scan

_SCAN_SB = {n: diag_scan(n // 4) for n in (8, 16, 32)}
_SCAN_SB[4] = np.array([[0, 0]], dtype=np.int32)

# last_sig_coeff prefix group tables (9.3.3.1 TR + suffix)
_GROUP_IDX = [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
              8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9]
_MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24]


def _last_ctx_params(log2n: int, cidx: int):
    if cidx == 0:
        return 3 * (log2n - 2) + ((log2n - 1) >> 2), (log2n + 1) >> 2
    return 15, log2n - 2


def _encode_last_prefix(enc, v: int, log2n: int, cidx: int, name: str):
    off, shift = _last_ctx_params(log2n, cidx)
    cmax = (log2n << 1) - 1
    prefix = _GROUP_IDX[v]
    for b in range(prefix):
        enc.bin(name, (b >> shift) + off, 1)
    if prefix < cmax:
        enc.bin(name, (prefix >> shift) + off, 0)
    return prefix


def _encode_last_suffix(enc, v: int, prefix: int):
    if prefix > 3:
        nbits = (prefix >> 1) - 1
        enc.bypass_bits(v - _MIN_IN_GROUP[prefix], nbits)


def _decode_last_prefix(dec, log2n: int, cidx: int, name: str) -> int:
    off, shift = _last_ctx_params(log2n, cidx)
    cmax = (log2n << 1) - 1
    prefix = 0
    while prefix < cmax and dec.bin(name, (prefix >> shift) + off):
        prefix += 1
    return prefix


def _decode_last_suffix(dec, prefix: int) -> int:
    if prefix > 3:
        nbits = (prefix >> 1) - 1
        return _MIN_IN_GROUP[prefix] + dec.bypass_bits(nbits)
    return prefix


def _sig_ctx(xc: int, yc: int, log2n: int, cidx: int, csbf_r: int,
             csbf_b: int) -> int:
    """9.3.4.2.5 (TU >= 8x8 diagonal-scan case)."""
    if xc + yc == 0:
        sig = 0
    else:
        prev = csbf_r + 2 * csbf_b
        xp, yp = xc & 3, yc & 3
        if prev == 0:
            sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
        elif prev == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if cidx == 0:
            if (xc >> 2) + (yc >> 2) > 0:
                sig += 3
            sig += 9 if log2n == 3 else 21   # diag scan; 8x8 base 9
        else:
            sig += 9 if log2n == 3 else 12
    return sig + (27 if cidx else 0)


def _rice_update(rice: int, abs_level: int) -> int:
    if abs_level > (3 << rice):
        return min(rice + 1, 4)
    return rice


def _encode_remaining(enc, value: int, rice: int):
    """coeff_abs_level_remaining binarization (9.3.3.9), all bypass."""
    if (value >> rice) < 3:
        q = value >> rice
        for _ in range(q):
            enc.bypass(1)
        enc.bypass(0)
        if rice:
            enc.bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        length = rice
        v = value - (3 << rice)
        while v >= (1 << length):
            v -= 1 << length
            length += 1
        for _ in range(3 + length - rice):
            enc.bypass(1)
        enc.bypass(0)
        enc.bypass_bits(v, length)


def _decode_remaining(dec, rice: int) -> int:
    prefix = 0
    while prefix < 32 and dec.bypass():
        prefix += 1
    if prefix < 3:
        return (prefix << rice) + (dec.bypass_bits(rice) if rice else 0)
    length = rice + prefix - 3
    base = 3 << rice
    for bitlen in range(rice, length):
        base += 1 << bitlen
    return base + dec.bypass_bits(length)


def encode_residual(enc, coeffs: np.ndarray, log2n: int, cidx: int):
    """Entropy-code one TU's coefficients (n x n int array, at least one
    nonzero). cidx 0 = luma, 1/2 = chroma."""
    n = 1 << log2n
    scan_sb = _SCAN_SB[n]
    nsb_side = max(1, n // 4)
    # full scan position list
    flat = []
    for sx, sy in scan_sb:
        for kx, ky in DIAG4:
            flat.append((sx * 4 + kx, sy * 4 + ky))
    vals = [int(coeffs[y, x]) for (x, y) in flat]
    last = max(i for i, v in enumerate(vals) if v != 0)
    xl, yl = flat[last]
    # both prefixes first, then both suffixes (7.3.8.11)
    px = _encode_last_prefix(enc, xl, log2n, cidx, "last_x")
    py = _encode_last_prefix(enc, yl, log2n, cidx, "last_y")
    _encode_last_suffix(enc, xl, px)
    _encode_last_suffix(enc, yl, py)
    last_sb, last_k = last >> 4, last & 15

    csbf = np.zeros((nsb_side, nsb_side), np.int32)
    for i in range(last_sb + 1):
        sx, sy = scan_sb[i]
        block = [vals[i * 16 + k] for k in range(16)]
        csbf[sy, sx] = int(any(block))

    prev_gt1ctx = None
    for i in range(last_sb, -1, -1):
        sx, sy = int(scan_sb[i][0]), int(scan_sb[i][1])
        csbf_r = int(csbf[sy, sx + 1]) if sx + 1 < nsb_side else 0
        csbf_b = int(csbf[sy + 1, sx]) if sy + 1 < nsb_side else 0
        sb_coded = int(csbf[sy, sx])
        explicit_sb = 0 < i < last_sb
        if explicit_sb:
            ctx = (1 if (csbf_r or csbf_b) else 0) + (2 if cidx else 0)
            enc.bin("sig_cg", ctx, sb_coded)
        else:
            sb_coded = 1  # inferred for first and last sub-blocks
        if not sb_coded:
            continue
        block = vals[i * 16:i * 16 + 16]
        start_k = last_k - 1 if i == last_sb else 15
        sig_positions = []  # k indices of significant coeffs, desc order
        if i == last_sb:
            sig_positions.append(last_k)
        coded_any = i == last_sb  # last coeff counts as significant
        for k in range(start_k, -1, -1):
            sig = 1 if block[k] != 0 else 0
            infer_dc = (explicit_sb and k == 0 and not coded_any)
            if infer_dc:
                sig = 1  # inferred significant, not coded
            else:
                xc = sx * 4 + int(DIAG4[k][0])
                yc = sy * 4 + int(DIAG4[k][1])
                ctx = _sig_ctx(xc, yc, log2n, cidx, csbf_r, csbf_b)
                enc.bin("sig", ctx, sig)
            if sig:
                sig_positions.append(k)
                coded_any = True

        # greater1 / greater2 / signs / remaining
        ctx_set = (0 if (i == 0 or cidx > 0) else 2)
        if prev_gt1ctx == 0:
            ctx_set += 1
        gt1ctx = 1
        g1 = {}
        g2k = None
        for idx, k in enumerate(sig_positions):
            a = abs(block[k])
            if idx < 8:
                flag = 1 if a > 1 else 0
                cinc = ctx_set * 4 + min(gt1ctx, 3) + (16 if cidx else 0)
                enc.bin("gt1", cinc, flag)
                g1[k] = flag
                if flag:
                    if g2k is None:
                        g2k = k
                    gt1ctx = 0
                elif gt1ctx > 0:
                    gt1ctx += 1
        if g2k is not None:
            flag2 = 1 if abs(block[g2k]) > 2 else 0
            enc.bin("gt2", ctx_set + (4 if cidx else 0), flag2)
        prev_gt1ctx = gt1ctx
        for k in sig_positions:
            enc.bypass(1 if block[k] < 0 else 0)
        rice = 0
        for idx, k in enumerate(sig_positions):
            a = abs(block[k])
            if idx < 8:
                base = 3 if k == g2k else 2
            else:
                base = 1
            if a >= base:
                _encode_remaining(enc, a - base, rice)
                rice = _rice_update(rice, a)


def decode_residual(dec, log2n: int, cidx: int) -> np.ndarray:
    n = 1 << log2n
    scan_sb = _SCAN_SB[n]
    nsb_side = max(1, n // 4)
    px = _decode_last_prefix(dec, log2n, cidx, "last_x")
    py = _decode_last_prefix(dec, log2n, cidx, "last_y")
    xl = _decode_last_suffix(dec, px)
    yl = _decode_last_suffix(dec, py)
    # locate last scan index
    flat = []
    for sx, sy in scan_sb:
        for kx, ky in DIAG4:
            flat.append((sx * 4 + kx, sy * 4 + ky))
    last = flat.index((xl, yl))
    last_sb, last_k = last >> 4, last & 15

    coeffs = np.zeros((n, n), np.int32)
    csbf = np.zeros((nsb_side, nsb_side), np.int32)
    csbf[scan_sb[last_sb][1], scan_sb[last_sb][0]] = 1
    csbf[scan_sb[0][1], scan_sb[0][0]] = 1

    prev_gt1ctx = None
    for i in range(last_sb, -1, -1):
        sx, sy = int(scan_sb[i][0]), int(scan_sb[i][1])
        csbf_r = int(csbf[sy, sx + 1]) if sx + 1 < nsb_side else 0
        csbf_b = int(csbf[sy + 1, sx]) if sy + 1 < nsb_side else 0
        explicit_sb = 0 < i < last_sb
        if explicit_sb:
            ctx = (1 if (csbf_r or csbf_b) else 0) + (2 if cidx else 0)
            sb_coded = dec.bin("sig_cg", ctx)
            csbf[sy, sx] = sb_coded
        else:
            sb_coded = 1
        if not sb_coded:
            continue
        start_k = last_k - 1 if i == last_sb else 15
        sig_positions = []
        if i == last_sb:
            sig_positions.append(last_k)
        coded_any = i == last_sb
        for k in range(start_k, -1, -1):
            infer_dc = (explicit_sb and k == 0 and not coded_any)
            if infer_dc:
                sig = 1
            else:
                xc = sx * 4 + int(DIAG4[k][0])
                yc = sy * 4 + int(DIAG4[k][1])
                ctx = _sig_ctx(xc, yc, log2n, cidx, csbf_r, csbf_b)
                sig = dec.bin("sig", ctx)
            if sig:
                sig_positions.append(k)
                coded_any = True

        ctx_set = (0 if (i == 0 or cidx > 0) else 2)
        if prev_gt1ctx == 0:
            ctx_set += 1
        gt1ctx = 1
        g1 = {}
        g2k = None
        for idx, k in enumerate(sig_positions):
            if idx < 8:
                cinc = ctx_set * 4 + min(gt1ctx, 3) + (16 if cidx else 0)
                flag = dec.bin("gt1", cinc)
                g1[k] = flag
                if flag:
                    if g2k is None:
                        g2k = k
                    gt1ctx = 0
                elif gt1ctx > 0:
                    gt1ctx += 1
        g2val = 0
        if g2k is not None:
            g2val = dec.bin("gt2", ctx_set + (4 if cidx else 0))
        prev_gt1ctx = gt1ctx
        signs = {k: dec.bypass() for k in sig_positions}
        rice = 0
        for idx, k in enumerate(sig_positions):
            if idx < 8:
                # value implied by flags; remaining coded iff it equals base
                if g1.get(k, 0) == 0:
                    a = 1
                elif k == g2k:
                    a = 2 + g2val
                else:
                    a = 2
                base = 3 if k == g2k else 2
                if a == base:
                    a += _decode_remaining(dec, rice)
                    rice = _rice_update(rice, a)
            else:
                a = 1 + _decode_remaining(dec, rice)
                rice = _rice_update(rice, a)
            xc = sx * 4 + int(DIAG4[k][0])
            yc = sy * 4 + int(DIAG4[k][1])
            coeffs[yc, xc] = -a if signs[k] else a
    return coeffs
