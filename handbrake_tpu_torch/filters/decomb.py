"""Selective deinterlacer (reference: decomb.c + eedi2.c) — the
counterpart of ``handbrake_tpu/filters/decomb.py``.

Mode bits (decomb.c:15-52 convention): 1 = yadif, 2 = blend, 4 = cubic
interpolation, 8 = EEDI2, 16 = bob. Operates only on frames comb_detect
tagged (buf.combed) unless no comb_detect ran (then always filters), and
only on pixels in the comb mask when one is present — the reference's
selective behavior.  The mask applies to luma only.

EEDI2's edge-directed interpolation is approximated by the yadif
edge-directed search, as in the reference package; cubic mode upgrades
the 2-tap vertical average to the 4-tap Catmull-Rom the reference uses.
Integer arithmetic in int32, equal to the reference byte for byte.
"""
from __future__ import annotations

import torch

from ..core.buffer import Buffer, BufFlags
from ..job import schema as S
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .deinterlace import _second, yadif_plane
from .kernels import out_dtype, rows as _rows, to_int32

MODE_YADIF = 1
MODE_BLEND = 2
MODE_CUBIC = 4
MODE_EEDI2 = 8
MODE_BOB = 16


def blend_plane(cur, maxval: int = 255) -> torch.Tensor:
    """Vertical [1 2 1]/4 low-pass (decomb blend mode); int32 in."""
    c = cur
    out = (_rows(c, -1) + 2 * c + _rows(c, 1) + 2) >> 2
    return torch.clamp(out, 0, maxval).to(out_dtype(maxval))


def cubic_deint_plane(cur, parity: int, maxval: int = 255) -> torch.Tensor:
    """Replace the missing field with 4-tap Catmull-Rom vertical interp."""
    c = cur
    second = _second(c.shape[0], parity, c.device)
    interp = (-_rows(c, -3) + 9 * (_rows(c, -1) + _rows(c, 1))
              - _rows(c, 3) + 8) >> 4
    out = torch.where(second, torch.clamp(interp, 0, maxval), c)
    return out.to(out_dtype(maxval))


@register
class DecombFilter(Filter):
    id = S.FILTER_DECOMB
    name = "decomb"
    state = ("keeps state across frames (each frame is filtered with the "
             "frames beside it)")

    def init(self, fi: FilterInit) -> FilterInit:
        self.mode = int(self.settings.get("mode", 7))
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self._q: list = []
        return self.fi

    def _filter_frame(self, prev: Buffer, cur: Buffer, nxt: Buffer) -> Buffer:
        if cur.combed == 0 and "comb_mask" in cur.side_data:
            return cur  # analyzed and clean → pass through untouched
        parity = 0 if (cur.flags & BufFlags.TOP_FIRST) else 1
        planes = []
        mask = cur.side_data.get("comb_mask")
        dt = out_dtype(self.maxval)
        for i, (pp, cc, nn) in enumerate(
                zip(prev.planes, cur.planes, nxt.planes)):
            cj = to_int32(cc, self.device)
            if self.mode & (MODE_YADIF | MODE_EEDI2):
                f = yadif_plane(cj, to_int32(pp, self.device),
                                to_int32(nn, self.device), parity,
                                spatial_check=True, maxval=self.maxval)
            elif self.mode & MODE_CUBIC:
                f = cubic_deint_plane(cj, parity, maxval=self.maxval)
            elif self.mode & MODE_BLEND:
                f = blend_plane(cj, maxval=self.maxval)
            else:
                planes.append(cj.to(dt))
                continue
            if mask is not None and i == 0:
                # in int32: few operations take uint16 tensors
                f = torch.where(mask.to(self.device) > 0,
                                f.to(torch.int32), cj).to(dt)
            planes.append(f)
        out = Buffer(planes=planes, pix_fmt=cur.pix_fmt).copy_props(cur)
        out.flags &= ~(BufFlags.INTERLACED | BufFlags.TOP_FIRST)
        out.side_data.pop("comb_mask", None)
        return out

    def work(self, buf: Buffer) -> list:
        if buf.is_eof():
            return self.flush() + [buf]
        self._q.append(buf)
        if len(self._q) == 2:
            return [self._filter_frame(self._q[0], self._q[0], self._q[1])]
        if len(self._q) == 3:
            out = [self._filter_frame(*self._q)]
            self._q.pop(0)
            return out
        return []

    def flush(self) -> list:
        out = []
        if len(self._q) == 1:
            out.append(self._filter_frame(self._q[0], self._q[0],
                                          self._q[0]))
        elif len(self._q) == 2:
            out.append(self._filter_frame(self._q[0], self._q[1],
                                          self._q[1]))
        self._q = []
        return out
