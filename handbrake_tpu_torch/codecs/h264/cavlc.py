"""CAVLC residual coding (spec 9.2) — encoder and decoder.

The encoder consumes levels already in zigzag scan order (DC→high freq).
This host-side Python path is the reference; the production path packs bits in
C++ (native/entropy.cpp) from the same device-produced level arrays.
"""
from __future__ import annotations

from .bits import BitReader, BitWriter
from .tables import (RUN_BEFORE, TOTAL_ZEROS_4x4, TOTAL_ZEROS_CHROMA_DC,
                     coeff_token_flc, coeff_token_table)


def nc_context(na: int, nb: int, avail_a: bool, avail_b: bool) -> int:
    if avail_a and avail_b:
        return (na + nb + 1) >> 1
    if avail_a:
        return na
    if avail_b:
        return nb
    return 0


def encode_residual(bw: BitWriter, coeffs, nc: int, max_coeff: int) -> int:
    """Encode one block's levels (scan order, len == max_coeff).

    Returns TotalCoeff (for neighbor nC bookkeeping).
    """
    nz = [(i, int(c)) for i, c in enumerate(coeffs) if c != 0]
    total_coeff = len(nz)
    assert total_coeff <= max_coeff

    # trailing ones: up to 3 |1|s at the high-frequency end
    trailing = 0
    for i in range(len(nz) - 1, -1, -1):
        if abs(nz[i][1]) == 1 and trailing < 3:
            trailing += 1
        else:
            break

    tbl = coeff_token_table(nc)
    if tbl is None:
        ln, bits = coeff_token_flc(total_coeff, trailing)
    else:
        ln, bits = tbl[(total_coeff, trailing)]
    bw.put(bits, ln)
    if total_coeff == 0:
        return 0

    # trailing-one signs, reverse scan order
    for i in range(total_coeff - 1, total_coeff - 1 - trailing, -1):
        bw.put_bit(1 if nz[i][1] < 0 else 0)

    # levels, reverse scan order
    suffix_len = 1 if (total_coeff > 10 and trailing < 3) else 0
    first = True
    for i in range(total_coeff - 1 - trailing, -1, -1):
        lvl = nz[i][1]
        level_code = 2 * (abs(lvl) - 1) + (1 if lvl < 0 else 0)
        if first and trailing < 3:
            level_code -= 2
        first = False
        if suffix_len == 0:
            if level_code < 14:
                bw.put(1, level_code + 1)            # level_code zeros + 1
            elif level_code < 30:
                bw.put(1, 15)                        # prefix 14
                bw.put(level_code - 14, 4)
            else:
                bw.put(1, 16)                        # prefix 15
                assert level_code - 30 < (1 << 12), "level too large"
                bw.put(level_code - 30, 12)
        else:
            if (level_code >> suffix_len) < 15:
                prefix = level_code >> suffix_len
                bw.put(1, prefix + 1)
                bw.put(level_code & ((1 << suffix_len) - 1), suffix_len)
            else:
                bw.put(1, 16)                        # prefix 15 escape
                rem = level_code - (15 << suffix_len)
                assert rem < (1 << 12), "level too large"
                bw.put(rem, 12)
        if suffix_len == 0:
            suffix_len = 1
        if abs(lvl) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # total_zeros
    last_pos = nz[-1][0]
    total_zeros = last_pos + 1 - total_coeff
    if total_coeff < max_coeff:
        if max_coeff == 4:  # chroma DC 4:2:0
            ln, bits = TOTAL_ZEROS_CHROMA_DC[total_coeff][total_zeros]
        else:
            ln, bits = TOTAL_ZEROS_4x4[total_coeff][total_zeros]
        bw.put(bits, ln)

    # run_before, reverse scan order, except the scan-first coefficient
    zeros_left = total_zeros
    for i in range(total_coeff - 1, 0, -1):
        if zeros_left <= 0:
            break
        run = nz[i][0] - nz[i - 1][0] - 1
        ln, bits = RUN_BEFORE[min(zeros_left, 7)][run]
        bw.put(bits, ln)
        zeros_left -= run
    return total_coeff


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _read_vlc(br: BitReader, table: dict) -> tuple:
    """Read one code from a {(a,b): (len,bits)} table (short tables; linear)."""
    # build longest length
    maxlen = max(l for l, _ in table.values())
    acc = 0
    for n in range(1, maxlen + 1):
        acc = (acc << 1) | br.u(1)
        for key, (l, bits) in table.items():
            if l == n and bits == acc:
                return key
    raise ValueError("invalid VLC code")


def decode_residual(br: BitReader, nc: int, max_coeff: int):
    """Decode one block. Returns list of levels in scan order (len max_coeff)."""
    tbl = coeff_token_table(nc)
    if tbl is None:
        code = br.u(6)
        if code == 0b000011:
            total_coeff, trailing = 0, 0
        else:
            total_coeff, trailing = (code >> 2) + 1, code & 3
    else:
        total_coeff, trailing = _read_vlc(br, tbl)
    out = [0] * max_coeff
    if total_coeff == 0:
        return out, 0

    levels = []
    for _ in range(trailing):
        levels.append(-1 if br.u(1) else 1)

    suffix_len = 1 if (total_coeff > 10 and trailing < 3) else 0
    for i in range(total_coeff - trailing):
        # level_prefix: count zeros
        prefix = 0
        while br.u(1) == 0:
            prefix += 1
            if prefix > 32:
                raise ValueError("bad level_prefix")
        if suffix_len == 0:
            if prefix < 14:
                level_code = prefix
            elif prefix == 14:
                level_code = 14 + br.u(4)
            else:
                level_code = 30 + br.u(12)
        else:
            if prefix < 15:
                level_code = (prefix << suffix_len) + br.u(suffix_len)
            else:
                level_code = (15 << suffix_len) + br.u(12)
        if i == 0 and trailing < 3:
            level_code += 2
        lvl = (level_code + 2) >> 1 if (level_code & 1) == 0 else -((level_code + 1) >> 1)
        levels.append(lvl)
        if suffix_len == 0:
            suffix_len = 1
        if abs(lvl) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # total_zeros
    if total_coeff < max_coeff:
        if max_coeff == 4:
            tz_tbl = {i: v for i, v in
                      enumerate(TOTAL_ZEROS_CHROMA_DC[total_coeff])}
        else:
            tz_tbl = {i: v for i, v in
                      enumerate(TOTAL_ZEROS_4x4[total_coeff])}
        total_zeros = _read_vlc(br, {(k,): v for k, v in tz_tbl.items()})[0]
    else:
        total_zeros = 0

    # place coefficients: walk reverse (levels[0] is highest-frequency coeff)
    zeros_left = total_zeros
    pos = total_coeff - 1 + total_zeros  # scan position of last (hi-freq) coeff
    for i in range(total_coeff):
        out[pos] = levels[i]
        if i == total_coeff - 1:
            break
        if zeros_left > 0:
            key = _read_vlc(br, {(r,): v for r, v in
                                 enumerate(RUN_BEFORE[min(zeros_left, 7)])})
            run = key[0]
        else:
            run = 0
        zeros_left -= run
        pos -= run + 1
    return out, total_coeff
