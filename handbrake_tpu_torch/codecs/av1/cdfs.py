"""Per-frame adaptive CDF set (AV1 default-CDF reset semantics).

AV1 resets entropy contexts to defaults at keyframes and optionally
inherits them across inter frames (refresh_frame_context); round 1 resets
per frame on both sides, which is always legal for a conformant pair.
"""
from __future__ import annotations

from .predict import N_INTRA_MODES
from .rangecoder import uniform_cdf


class CdfSet:
    def __init__(self):
        self.skip = uniform_cdf(2)
        self.is_inter = uniform_cdf(2)
        self.ymode = uniform_cdf(N_INTRA_MODES)
        self.token_y = uniform_cdf(4)     # level classes 0,1,2,3+
        self.token_uv = uniform_cdf(4)
        self.eob_y = uniform_cdf(5)       # eob classes 0,1,2-4,5-16,17-64
        self.eob_uv = uniform_cdf(5)


EOB_CLASS_LO = (0, 1, 2, 5, 17)     # inclusive lower bound per class
EOB_CLASS_BITS = (0, 0, 2, 4, 6)    # bypass literal bits per class


def eob_class(eob: int) -> int:
    for c in range(len(EOB_CLASS_LO) - 1, -1, -1):
        if eob >= EOB_CLASS_LO[c]:
            return c
    return 0
