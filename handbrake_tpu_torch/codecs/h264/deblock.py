"""H.264 in-loop deblocking constants (spec 8.7, Tables 8-16/8-17) and
the host-side parameter lookup the filter kernels take.

ALPHA/BETA/TC0 are copies of ``handbrake_tpu/codecs/h264/deblock.py``'s
tables; ``deblock_scal`` is the lookup of ``deblock_pallas.deblock_scal``.
"""
from __future__ import annotations

import numpy as np

ALPHA = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
       40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
       226, 255, 255], np.int32)

BETA = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
       11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18], np.int32)

# TC0[indexA] = (tc0 for bS=1, bS=2, bS=3); first nonzero row at indexA=17
TC0 = np.array(
    [(0, 0, 0)] * 17
    + [(0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 1, 1), (0, 1, 1),
       (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 2), (1, 1, 2),
       (1, 1, 2), (1, 1, 2), (1, 2, 3), (1, 2, 3), (2, 2, 3), (2, 2, 4),
       (2, 3, 4), (2, 3, 4), (3, 3, 5), (3, 4, 6), (3, 4, 6), (4, 5, 7),
       (4, 5, 8), (4, 6, 9), (5, 7, 10), (6, 8, 11), (6, 8, 13),
       (7, 10, 14), (8, 11, 16), (9, 12, 18), (10, 13, 20), (11, 15, 23),
       (13, 17, 25)], np.int32)


def deblock_scal(qp: int, qpc: int) -> np.ndarray:
    """alpha/beta/tc0 for concrete qp and chroma qp: int32[10] =
    [alpha, beta, tc0(bS=1,2,3)] for luma, then the same for chroma."""
    a, b, t = ALPHA, BETA, TC0
    i, ic = min(max(int(qp), 0), 51), min(max(int(qpc), 0), 51)
    return np.concatenate([
        [a[i], b[i]], t[i], [a[ic], b[ic]], t[ic]]).astype(np.int32)
