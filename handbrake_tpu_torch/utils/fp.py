"""Float32 arithmetic the reference's XLA CPU backend performs and
PyTorch has no operation for."""
from __future__ import annotations

import torch


def fma32(a, b, c):
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
