"""HEVC integer transforms and quantization — exact spec arithmetic.

Array-module agnostic (pass numpy or jax.numpy as ``xp``), batched over
leading dims so the same code is the host reference and the TPU device path:
NxN transforms are integer matmuls -> MXU-friendly einsums under jit.

Spec refs: scaling 8.6.3 (levScale, bdShift = BitDepth + log2N - 5),
inverse transform 8.6.4 (shift 7 then 20-BitDepth with 16-bit clamp);
forward transform/quant use the HM-compatible shifts
(shift1 = log2N + BitDepth - 9, shift2 = log2N + 6;
qbits = 14 + qp/6 + 15 - BitDepth - log2N) so dequant lands on the spec
scale. Bit depth is a parameter — one source for 8/10/12-bit (the
templates/*_template.c analog, encx265.c multi-depth role).
"""
from __future__ import annotations

import numpy as np

from .tables import LEV_SCALE, QUANT_SCALE, dct_matrix

_T = {n: dct_matrix(n) for n in (4, 8, 16, 32)}


def fwd_transform(xp, d, log2n: int, bd: int = 8):
    """Forward 2D DCT: d (..., N, N) int32 residual -> coeffs int32."""
    n = 1 << log2n
    t = xp.asarray(_T[n])
    s1 = log2n + bd - 9
    s2 = log2n + 6
    e = (xp.einsum("ij,...jk->...ik", t, d.astype(xp.int32))
         + (1 << (s1 - 1))) >> s1
    c = (xp.einsum("...ij,kj->...ik", e, t) + (1 << (s2 - 1))) >> s2
    return c


def inv_transform(xp, c, log2n: int, bd: int = 8):
    """Inverse 2D DCT (8.6.4): coeffs -> residual, 16-bit clamps."""
    n = 1 << log2n
    t = xp.asarray(_T[n])
    s2 = 20 - bd
    e = (xp.einsum("ji,...jk->...ik", t, c.astype(xp.int32)) + 64) >> 7
    e = xp.clip(e, -32768, 32767)
    r = (xp.einsum("...ij,jk->...ik", e, t) + (1 << (s2 - 1))) >> s2
    return xp.clip(r, -32768, 32767)


def quant(xp, c, qp: int, log2n: int, intra: bool, bd: int = 8):
    """Forward quant (HM xQuant, flat scaling list). qbits is depth-
    independent, mirroring the depth-independent dequant shift: the bit
    depth lives only in the forward-transform stage-1 shift and the
    inverse-transform output shift (validated vs libavcodec at 8/10-bit)."""
    del bd
    qbits = 14 + qp // 6 + (7 - log2n)
    scale = int(QUANT_SCALE[qp % 6])
    f = (171 if intra else 85) << (qbits - 9)
    a = xp.abs(c).astype(xp.int64)
    lv = ((a * scale + f) >> qbits).astype(xp.int32)
    lv = xp.clip(lv, 0, 32767)
    return xp.where(c < 0, -lv, lv)


def dequant(xp, lv, qp: int, log2n: int, bd: int = 8):
    """Scaling process (8.6.3): m=16 flat, bdShift = log2N + 3.

    The dequant shift is depth-INdependent (the BitDepth term lives in the
    inverse-transform output stage, 20-BitDepth); validated bit-exactly
    against libavcodec at 8- and 10-bit. `bd` kept for signature symmetry.
    """
    del bd
    bd_shift = log2n + 3
    scale = 16 * int(LEV_SCALE[qp % 6]) << (qp // 6)
    d = (lv.astype(xp.int64) * scale + (1 << (bd_shift - 1))) >> bd_shift
    return xp.clip(d, -32768, 32767).astype(xp.int32)


def to_blocks(xp, plane, n: int):
    """(H, W) -> (H/n * W/n, n, n) raster block order."""
    H, W = plane.shape[-2], plane.shape[-1]
    b = plane.reshape(*plane.shape[:-2], H // n, n, W // n, n)
    b = xp.swapaxes(b, -3, -2)
    return b.reshape(*plane.shape[:-2], (H // n) * (W // n), n, n)


def from_blocks(xp, blocks, H: int, W: int):
    n = blocks.shape[-1]
    lead = blocks.shape[:-3]
    b = blocks.reshape(*lead, H // n, W // n, n, n)
    b = xp.swapaxes(b, -3, -2)
    return b.reshape(*lead, H, W)
