"""Debanding (reference: deband.c, avfilter alias of FFmpeg deband) — the
counterpart of ``handbrake_tpu/filters/deband.py``.

For each pixel, four reference samples at pseudo-random offsets within
``range`` are averaged; if every reference is within ``thresh`` of the
pixel, the pixel is replaced by the average. The per-pixel offsets come
from a position hash (deterministic, no host RNG), realized as a select
over eight candidate shifts.  Integer arithmetic in int32.
"""
from __future__ import annotations

import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import out_dtype, shift2 as _shift2, to_int32


def deband_plane(plane: torch.Tensor, rng: int = 16, thresh: int = 12,
                 maxval: int = 255) -> torch.Tensor:
    """plane: (H, W) integer tensor; the result on its device."""
    x = plane.to(torch.int32)
    h, w = x.shape
    # position hash → one of 8 candidate offset quadruples
    yy = torch.arange(h, device=x.device)[:, None]
    xx = torch.arange(w, device=x.device)[None, :]
    sel = ((yy * 7 + xx * 13 + (yy >> 3) * 31) % 8)
    out = x
    for k in range(8):
        r1 = 1 + (k * 5 + 3) % rng
        r2 = 1 + (k * 11 + 7) % rng
        refs = [_shift2(x, -r1, 0), _shift2(x, r1, 0),
                _shift2(x, 0, -r2), _shift2(x, 0, r2)]
        avg = (refs[0] + refs[1] + refs[2] + refs[3] + 2) >> 2
        ok = ((torch.abs(refs[0] - x) < thresh)
              & (torch.abs(refs[1] - x) < thresh)
              & (torch.abs(refs[2] - x) < thresh)
              & (torch.abs(refs[3] - x) < thresh))
        out = torch.where(sel == k, torch.where(ok, avg, x), out)
    return torch.clamp(out, 0, maxval).to(out_dtype(maxval))


@register
class DebandFilter(Filter):
    id = S.FILTER_DEBAND
    name = "deband"
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.range = max(1, int(s.get("range", 16)))
        self.thresh = int(s.get("thresh", 12))
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        sc = 1 << (buf.pix_fmt.bit_depth - 8)
        planes = [deband_plane(to_int32(p, self.device), rng=self.range,
                               thresh=self.thresh * sc, maxval=self.maxval)
                  for p in buf.planes]
        return [Buffer(planes=planes, pix_fmt=buf.pix_fmt).copy_props(buf)]
