"""BM3D denoise (reference: bm3d.c, avfilter alias) — the counterpart of
``handbrake_tpu/filters/bm3d.py``, the hard-thresholding step of BM3D:

  * 8x8 blocks on a half-overlapping grid (step 4) — four phase-shifted
    full-frame block decompositions, all reshapes.
  * Block matching: for each candidate offset in a small window, the
    per-block SSD against the reference block.  The best ``group_size``
    candidates form the 3D group; on equal SSDs the lower offset index
    wins, as ``jax.lax.top_k`` orders them (a stable sort here).
  * 2D DCT over each block + 1D Haar across the group, hard threshold at
    sigma*lambda, inverse, aggregate with per-block weights
    1/(1+N_retained).

At 8 bits the SSDs are integers below 2^24, exact in f32 in any order, so
the groups equal the reference's.  The DCT products sum in another order
than XLA's, so a coefficient within an ulp of the threshold can be kept
by one and dropped by the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import div, out_dtype, shift2, to_tensor

B = 8  # block size


def _dct() -> np.ndarray:
    """The reference's orthonormal DCT-II matrix, f32."""
    n = B
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


_D = _dct()
_SQRT2 = float(np.sqrt(2.0))


def _to_blocks(x, oy, ox):
    """(..., h, w) → (..., nh, nw, B, B) blocks of the grid at (oy, ox)."""
    h, w = x.shape[-2:]
    nh = (h - oy) // B
    nw = (w - ox) // B
    v = x[..., oy:oy + nh * B, ox:ox + nw * B]
    v = v.reshape(*x.shape[:-2], nh, B, nw, B).transpose(-3, -2)
    return v, nh, nw


def bm3d_plane(plane: torch.Tensor, sigma: float = 4.0, maxval: int = 255,
               bm_range: int = 4, group_size: int = 4) -> torch.Tensor:
    """plane: (H, W) integer tensor; the result on its device."""
    x = plane.to(torch.float32)
    dev = x.device
    lam = 2.7 * sigma
    acc = torch.zeros_like(x)
    wgt = torch.zeros_like(x)
    offsets = [(dy, dx) for dy in range(-bm_range, bm_range + 1, 2)
               for dx in range(-bm_range, bm_range + 1, 2)]
    k = min(group_size, len(offsets))
    if k not in (1, 2, 4):
        raise ValueError(f"bm3d: a group of {k} blocks (the Haar transform "
                         f"takes 1, 2 or 4)")
    D = torch.from_numpy(_D).to(dev)
    for oy in (0, B // 2):
        for ox in (0, B // 2):
            ref, nh, nw = _to_blocks(x, oy, ox)
            n = nh * nw
            # block matching over the candidate offsets
            cs = torch.stack([_to_blocks(shift2(x, dy, dx), oy, ox)[0]
                              for dy, dx in offsets])   # (C, nh, nw, B, B)
            ssds = ((cs - ref) ** 2).sum((-1, -2)).reshape(len(offsets), n)
            top = torch.sort(ssds.T, dim=-1, stable=True).indices[:, :k]
            grp = cs.reshape(len(offsets), n, B, B)[
                top.T, torch.arange(n, device=dev)]    # (k, n, B, B)
            # 2D DCT per block
            t = D @ grp @ D.T
            # 1D Haar across the group (k=4: two levels; k=2: one)
            if k >= 2:
                s0 = div(t[0::2] + t[1::2], _SQRT2)
                d0 = div(t[0::2] - t[1::2], _SQRT2)
                if k == 4:
                    coeffs = torch.stack([div(s0[0] + s0[1], _SQRT2),
                                          div(s0[0] - s0[1], _SQRT2),
                                          d0[0], d0[1]])
                else:
                    coeffs = torch.cat([s0, d0])
            else:
                coeffs = t
            kept = torch.abs(coeffs) > lam
            coeffs = torch.where(kept, coeffs, 0.0)
            # keep every group's DC path intact: the mean of the group's
            # DC terms, summed in order
            dc = t[0, :, 0, 0]
            for j in range(1, k):
                dc = dc + t[j, :, 0, 0]
            coeffs[0, :, 0, 0] = div(dc, float(k)) * float(np.sqrt(k))
            nret = kept.sum((0, 2, 3)) + 1
            # inverse Haar: only the reference position's block is used
            if k == 4:
                s0a = div(coeffs[0] + coeffs[1], _SQRT2)
                t2 = div(s0a + coeffs[2], _SQRT2)
            elif k == 2:
                t2 = div(coeffs[0] + coeffs[1], _SQRT2)
            else:
                t2 = coeffs[0]
            est = (D.T @ t2 @ D).reshape(nh, nw, B, B)
            wb = (1.0 / nret.to(torch.float32)).reshape(nh, nw, 1, 1)
            est_img = (est * wb).transpose(1, 2).reshape(nh * B, nw * B)
            w_img = wb.expand(nh, nw, B, B).transpose(1, 2) \
                .reshape(nh * B, nw * B)
            acc[oy:oy + nh * B, ox:ox + nw * B] += est_img
            wgt[oy:oy + nh * B, ox:ox + nw * B] += w_img
    out = torch.where(wgt > 0, acc / torch.clamp_min(wgt, 1e-6), x)
    return torch.clamp(torch.round(out), 0, maxval).to(out_dtype(maxval))


@register
class BM3DFilter(Filter):
    id = S.FILTER_BM3D
    name = "bm3d"
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.sigma = float(s.get("sigma", 4.0))
        self.bm_range = int(s.get("bm_range", 4))
        self.group_size = int(s.get("group_size", 4))
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        sc = 1 << (buf.pix_fmt.bit_depth - 8)
        planes = [bm3d_plane(to_tensor(p, self.device), sigma=self.sigma * sc,
                             maxval=self.maxval, bm_range=self.bm_range,
                             group_size=self.group_size)
                  for p in buf.planes]
        return [Buffer(planes=planes, pix_fmt=buf.pix_fmt).copy_props(buf)]
