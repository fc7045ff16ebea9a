"""Generate cavlc_tables.h for the native slice coder from the Python
tables (codecs/h264/tables.py) — single source of truth for both paths.

Role of the reference's in-tree VLC tables consumed by encx264's bundled
x264; here the tables feed our own C++ entropy stage (SURVEY.md §7
"Hard parts #1": sequential entropy coding belongs on the host, in native
code).
"""
from __future__ import annotations

import numpy as np

from ..codecs.h264 import tables as T


def _vlc_array(dic, n_a, n_b):
    """dict[(a,b)] = (len,bits) → flat int arrays len/bits, -1 = invalid."""
    ln = np.full((n_a, n_b), -1, np.int32)
    bits = np.zeros((n_a, n_b), np.int32)
    for (a, b), (l, v) in dic.items():
        ln[a, b] = l
        bits[a, b] = v
    return ln, bits


def _fmt(name, arr):
    arr = np.asarray(arr, np.int32).reshape(-1)
    vals = ",".join(str(int(v)) for v in arr)
    return f"static const int32_t {name}[{arr.size}] = {{{vals}}};\n"


def generate() -> str:
    out = ["// Auto-generated by gen_tables.py — do not edit.\n",
           "#pragma once\n#include <stdint.h>\n"]
    # coeff_token: 4 tables (nc 0-1, 2-3, 4-7, chroma dc) [17][4]
    for name, tbl in (("CT_NC0", T.CT_NC0), ("CT_NC2", T.CT_NC2),
                      ("CT_NC4", T.CT_NC4), ("CT_CDC", T.CT_CHROMA_DC)):
        ln, bits = _vlc_array(tbl, 17, 4)
        out.append(_fmt(name + "_LEN", ln))
        out.append(_fmt(name + "_BITS", bits))
    # total_zeros (luma 4x4): [tc 1..15][tz 0..15]
    ln = np.full((16, 16), -1, np.int32)
    bits = np.zeros((16, 16), np.int32)
    for tc, row in T.TOTAL_ZEROS_4x4.items():
        for tz, (l, v) in enumerate(row):
            ln[tc, tz] = l
            bits[tc, tz] = v
    out.append(_fmt("TZ_LEN", ln))
    out.append(_fmt("TZ_BITS", bits))
    # total_zeros chroma dc: [tc 1..3][tz 0..3]
    ln = np.full((4, 4), -1, np.int32)
    bits = np.zeros((4, 4), np.int32)
    for tc, row in T.TOTAL_ZEROS_CHROMA_DC.items():
        for tz, (l, v) in enumerate(row):
            ln[tc, tz] = l
            bits[tc, tz] = v
    out.append(_fmt("TZC_LEN", ln))
    out.append(_fmt("TZC_BITS", bits))
    # run_before: [zeros_left 1..7][run 0..14]
    ln = np.full((8, 15), -1, np.int32)
    bits = np.zeros((8, 15), np.int32)
    for zl, row in T.RUN_BEFORE.items():
        for run, (l, v) in enumerate(row):
            ln[zl, run] = l
            bits[zl, run] = v
    out.append(_fmt("RB_LEN", ln))
    out.append(_fmt("RB_BITS", bits))
    # CBP inter inverse: cbp value (0..47) → coded index
    inv = np.zeros(48, np.int32)
    for v, i in T.CBP_INTER_INV.items():
        inv[v] = i
    out.append(_fmt("CBP_INTER_INV", inv))
    # decode direction: coded index → cbp (me tables, spec 9.1.2)
    out.append(_fmt("CBP_INTER_DEC", np.asarray(T.CBP_INTER, np.int32)))
    out.append(_fmt("CBP_INTRA_DEC", np.asarray(T.CBP_INTRA4x4, np.int32)))
    out.append(_fmt("ZIGZAG_4x4", np.asarray(T.ZIGZAG_4x4)))
    out.append(_fmt("MF4x4", T.MF4x4))     # (6,4,4)
    out.append(_fmt("V4x4", T.V4x4))       # (6,4,4)
    out.append(f"static const int QBITS_BASE = {int(T.QBITS_BASE)};\n")
    return "".join(out)
