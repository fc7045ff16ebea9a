"""Deblocking (reference: deblock.c, avfilter alias of FFmpeg deblock) —
the counterpart of ``handbrake_tpu/filters/deblock.py`` (the filter, not
the H.264 in-loop deblock).

H.264-style weak/strong boundary smoothing on a fixed block grid: at each
vertical/horizontal block edge, if the local gradient is below ``thresh``
(a real edge otherwise), the boundary samples are pulled toward each other
(weak: p0/q0 only; strong: p1/q1 too).  Integer arithmetic in int32.

The reference filters the edges of an axis one after another.  With
``bs >= 4`` an edge reads and writes only the columns edge-2 .. edge+1,
which no other edge of that axis touches, so every edge of the axis runs
in one vectorized pass with the same result; ``bs < 4`` keeps the loop.
"""
from __future__ import annotations

import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import out_dtype, to_int32


def _edge(p1, p0, q0, q1, thresh: int, strong: bool, maxval: int):
    """The filtered (p1, p0, q0, q1) of one edge (or a stack of them)."""
    gate = (torch.abs(p0 - q0) < thresh) \
        & (torch.abs(p1 - p0) < thresh) \
        & (torch.abs(q1 - q0) < thresh)
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3,
                        -thresh, thresh)
    np0 = torch.where(gate, torch.clamp(p0 + delta, 0, maxval), p0)
    nq0 = torch.where(gate, torch.clamp(q0 - delta, 0, maxval), q0)
    if strong:
        np1 = torch.where(gate, (p1 + np0 + 1) >> 1, p1)
        nq1 = torch.where(gate, (q1 + nq0 + 1) >> 1, q1)
    else:
        np1, nq1 = p1, q1
    return np1, np0, nq0, nq1


def _filter_cols(a: torch.Tensor, bs: int, thresh: int, strong: bool,
                 maxval: int) -> torch.Tensor:
    """Every vertical block edge of `a` (int32), left to right."""
    edges = list(range(bs, a.shape[1] - 1, bs))
    if not edges:
        return a
    out = a.clone()
    if bs >= 4:
        e = torch.tensor(edges, device=a.device)
        cols = [e - 2, e - 1, e, e + 1]
        new = _edge(*(a[:, c] for c in cols), thresh, strong, maxval)
        for c, v in zip(cols, new):
            out[:, c] = v
        return out
    for edge in edges:
        new = _edge(*(out[:, edge + j] for j in (-2, -1, 0, 1)), thresh,
                    strong, maxval)
        for j, v in zip((-2, -1, 0, 1), new):
            out[:, edge + j] = v
    return out


def deblock_plane(plane: torch.Tensor, bs: int = 8, thresh: int = 20,
                  strong: bool = False, maxval: int = 255) -> torch.Tensor:
    """plane: (H, W) integer tensor; vertical edges, then horizontal."""
    x = plane.to(torch.int32)
    x = _filter_cols(x, bs, thresh, strong, maxval)
    x = _filter_cols(x.T, bs, thresh, strong, maxval).T
    return torch.clamp(x, 0, maxval).to(out_dtype(maxval))


@register
class DeblockFilter(Filter):
    id = S.FILTER_DEBLOCK
    name = "deblock"
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.bs = max(4, int(s.get("blocksize", 8)))
        self.thresh = int(s.get("thresh", 20))
        self.strong = s.get("strength", "weak") == "strong"
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        sc = 1 << (buf.pix_fmt.bit_depth - 8)
        planes = [deblock_plane(to_int32(p, self.device), bs=self.bs,
                                thresh=self.thresh * sc, strong=self.strong,
                                maxval=self.maxval)
                  for p in buf.planes]
        return [Buffer(planes=planes, pix_fmt=buf.pix_fmt).copy_props(buf)]
