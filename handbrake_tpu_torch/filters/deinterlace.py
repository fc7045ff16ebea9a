"""Deinterlace: YADIF and BWDIF (reference: deinterlace.c, an avfilter
alias over FFmpeg's yadif/bwdif) — the counterpart of
``handbrake_tpu/filters/deinterlace.py``.

Mode bits (deinterlace.c settings convention):
  1 = enable, 2 = spatial interlacing check (yadif) , 4 = bob (2x rate,
  emit both fields), 8 = take field parity from stream flags.

The per-pixel recurrences of yadif/bwdif are purely local (5x5 window over
cur/prev/next), so a whole plane is a handful of int32 torch operations:
row and column offsets are edge-clamped index gathers.  Integer
arithmetic throughout, so the result equals the reference's byte for byte.
"""
from __future__ import annotations

import torch

from ..core.buffer import Buffer, BufFlags
from ..job import schema as S
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import cols as _shift_x
from .kernels import out_dtype, rows as _rows, to_int32

MODE_ENABLE = 1
MODE_SPATIAL = 2
MODE_BOB = 4


def _second(h: int, parity: int, device) -> torch.Tensor:
    """(h, 1) mask of the rows to interpolate (row % 2 != parity)."""
    return ((torch.arange(h, device=device) % 2) != parity)[:, None]


def yadif_plane(cur, prev, nxt, parity: int, spatial_check: bool = True,
                maxval: int = 255) -> torch.Tensor:
    """One deinterlaced field: keeps rows with row%2==parity, interpolates
    the rest.  cur/prev/nxt: int32 (H, W) tensors on one device; parity 0
    keeps the even rows (top field)."""
    c32, p32, n32 = cur, prev, nxt
    h = c32.shape[0]
    second = _second(h, parity, c32.device)
    # building the field not present in cur: when it is the newer one,
    # prev2 = cur, next2 = next (FFmpeg convention)
    pr2, nx2 = (c32, n32) if parity == 1 else (p32, c32)

    cm1, cp1 = _rows(c32, -1), _rows(c32, 1)
    d = (pr2 + nx2) >> 1
    td0 = torch.abs(pr2 - nx2)
    td1 = (torch.abs(_rows(p32, -1) - cm1)
           + torch.abs(_rows(p32, 1) - cp1)) >> 1
    td2 = (torch.abs(_rows(n32, -1) - cm1)
           + torch.abs(_rows(n32, 1) - cp1)) >> 1
    diff = torch.maximum(torch.maximum(td0 >> 1, td1), td2)

    spatial_pred = (cm1 + cp1) >> 1
    spatial_score = (torch.abs(_shift_x(cm1, -1) - _shift_x(cp1, -1))
                     + torch.abs(cm1 - cp1)
                     + torch.abs(_shift_x(cm1, 1) - _shift_x(cp1, 1)) - 1)

    def check(j, score, pred):
        s = (torch.abs(_shift_x(cm1, j - 1) - _shift_x(cp1, -j - 1))
             + torch.abs(_shift_x(cm1, j) - _shift_x(cp1, -j))
             + torch.abs(_shift_x(cm1, j + 1) - _shift_x(cp1, -j + 1)))
        p = (_shift_x(cm1, j) + _shift_x(cp1, -j)) >> 1
        better = s < score
        return torch.where(better, s, score), torch.where(better, p, pred), \
            better

    sc, sp, b1 = check(-1, spatial_score, spatial_pred)
    sc2, sp2, _ = check(-2, sc, sp)
    sc, sp = torch.where(b1, sc2, sc), torch.where(b1, sp2, sp)
    scp, spp, b2 = check(1, sc, sp)
    scp2, spp2, _ = check(2, scp, spp)
    spp = torch.where(b2, spp2, spp)
    spatial_pred = spp
    if spatial_check:
        bq = (_rows(pr2, -2) + _rows(nx2, -2)) >> 1
        fq = (_rows(pr2, 2) + _rows(nx2, 2)) >> 1
        vmax = torch.maximum(torch.maximum(d - cp1, d - cm1),
                             torch.minimum(bq - cm1, fq - cp1))
        vmin = torch.minimum(torch.minimum(d - cp1, d - cm1),
                             torch.maximum(bq - cm1, fq - cp1))
        diff = torch.maximum(torch.maximum(diff, vmin), -vmax)
    interp = torch.minimum(torch.maximum(spatial_pred, d - diff), d + diff)
    out = torch.where(second, interp, c32)
    return torch.clamp(out, 0, maxval).to(out_dtype(maxval))


_BW_LF = (4309, 213)
_BW_HF = (5570, 3801, 1016)
_BW_SP = (5077, 981)


def bwdif_plane(cur, prev, nxt, parity: int, maxval: int = 255
                ) -> torch.Tensor:
    """BWDIF field reconstruction; int32 (H, W) tensors in."""
    c32, p32, n32 = cur, prev, nxt
    h = c32.shape[0]
    second = _second(h, parity, c32.device)
    pr2, nx2 = (c32, n32) if parity == 1 else (p32, c32)

    cm1, cp1 = _rows(c32, -1), _rows(c32, 1)
    cm3, cp3 = _rows(c32, -3), _rows(c32, 3)
    d = (pr2 + nx2) >> 1
    td0 = torch.abs(pr2 - nx2)
    td1 = (torch.abs(_rows(p32, -1) - cm1)
           + torch.abs(_rows(p32, 1) - cp1)) >> 1
    td2 = (torch.abs(_rows(n32, -1) - cm1)
           + torch.abs(_rows(n32, 1) - cp1)) >> 1
    diff = torch.maximum(torch.maximum(td0 >> 1, td1), td2)

    b = ((_rows(pr2, -2) + _rows(nx2, -2)) >> 1) - cm1
    f = ((_rows(pr2, 2) + _rows(nx2, 2)) >> 1) - cp1
    dc = d - cm1
    de = d - cp1
    mmax = torch.maximum(torch.maximum(de, dc), torch.minimum(b, f))
    mmin = torch.minimum(torch.minimum(de, dc), torch.maximum(b, f))
    diff = torch.maximum(torch.maximum(diff, mmin), -mmax)

    hf = (_BW_HF[0] * (pr2 + nx2)
          - _BW_HF[1] * (_rows(pr2, -2) + _rows(nx2, -2)
                         + _rows(pr2, 2) + _rows(nx2, 2))
          + _BW_HF[2] * (_rows(pr2, -4) + _rows(nx2, -4)
                         + _rows(pr2, 4) + _rows(nx2, 4))) >> 2
    interp1 = (hf + _BW_LF[0] * (cm1 + cp1)
               - _BW_LF[1] * (cm3 + cp3)) >> 13
    interp2 = (_BW_SP[0] * (cm1 + cp1) - _BW_SP[1] * (cm3 + cp3)) >> 13
    interp = torch.where(torch.abs(cm1 - cp1) > td0, interp1, interp2)
    interp = torch.minimum(torch.maximum(interp, d - diff), d + diff)
    out = torch.where(diff == 0, d, interp)
    out = torch.where(second, out, c32)
    return torch.clamp(out, 0, maxval).to(out_dtype(maxval))


class _DeintBase(Filter):
    """3-frame window management shared by yadif/bwdif."""
    state = ("keeps state across frames (each frame is filtered with the "
             "frames beside it)")

    def __init__(self, settings=None):
        super().__init__(settings)
        self._q: list = []

    def init(self, fi: FilterInit) -> FilterInit:
        self.mode = int(self.settings.get("mode", 3))
        self.parity = int(self.settings.get("parity", -1))
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        if self.mode & MODE_BOB:
            self.fi.vrate = fi.vrate * 2
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        return self.fi

    def _field_parity(self, buf: Buffer) -> int:
        if self.parity >= 0:
            return self.parity
        return 0 if (buf.flags & BufFlags.TOP_FIRST) else 1

    def _deint(self, prev, cur, nxt, parity):
        raise NotImplementedError

    def _emit(self, prev: Buffer, cur: Buffer, nxt: Buffer) -> list:
        if not (self.mode & MODE_ENABLE):
            return [cur]
        par = self._field_parity(cur)
        outs = []
        bobs = [par, 1 - par] if (self.mode & MODE_BOB) else [par]
        for k, p in enumerate(bobs):
            planes = [self._deint(*(to_int32(x, self.device)
                                    for x in (pp, cc, nn)), p)
                      for pp, cc, nn in
                      zip(prev.planes, cur.planes, nxt.planes)]
            ob = Buffer(planes=planes, pix_fmt=cur.pix_fmt).copy_props(cur)
            ob.flags &= ~(BufFlags.INTERLACED | BufFlags.TOP_FIRST)
            if self.mode & MODE_BOB and cur.duration:
                ob.duration = cur.duration // 2
                if ob.pts is not None:
                    ob.pts = cur.pts + k * ob.duration
                ob.stop = (ob.pts + ob.duration
                           if ob.pts is not None else None)
            outs.append(ob)
        return outs

    def work(self, buf: Buffer) -> list:
        if buf.is_eof():
            return self.flush() + [buf]
        self._q.append(buf)
        if len(self._q) == 2:
            # first frame: prev = itself
            return self._emit(self._q[0], self._q[0], self._q[1])
        if len(self._q) == 3:
            out = self._emit(self._q[0], self._q[1], self._q[2])
            self._q.pop(0)
            return out
        return []

    def flush(self) -> list:
        out = []
        if len(self._q) == 1:
            out += self._emit(self._q[0], self._q[0], self._q[0])
        elif len(self._q) == 2:
            out += self._emit(self._q[0], self._q[1], self._q[1])
        self._q = []
        return out


@register
class YadifFilter(_DeintBase):
    id = S.FILTER_YADIF
    name = "yadif"

    def _deint(self, prev, cur, nxt, parity):
        return yadif_plane(cur, prev, nxt, parity,
                           spatial_check=bool(self.mode & MODE_SPATIAL),
                           maxval=self.maxval)


@register
class BwdifFilter(_DeintBase):
    id = S.FILTER_BWDIF
    name = "bwdif"

    def _deint(self, prev, cur, nxt, parity):
        return bwdif_plane(cur, prev, nxt, parity, maxval=self.maxval)
