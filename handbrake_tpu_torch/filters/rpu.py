"""Dolby Vision RPU side-data filter (reference: rpu.c — libdovi based).

Metadata-only: RPU payloads ride in buf.side_data["dovi_rpu"] and must
survive crop/scale — level-5 (active area) offsets are adjusted to the
output geometry like rpu.c's crop/scale recompute (rpu.c:245). Full RPU
re-serialization (libdovi equivalent) is a host-native milestone; this
filter keeps the passthrough contract: no frame may lose its RPU.
"""
from __future__ import annotations

from ..core.buffer import Buffer
from .base import Filter, FilterInit, register
from ..job import schema as S


@register
class RPUFilter(Filter):
    id = S.FILTER_RPU
    name = "rpu"
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        # geometry the RPU was authored for vs what we output
        self.src_w = int(s.get("source-width", fi.geometry.width))
        self.src_h = int(s.get("source-height", fi.geometry.height))
        self.crop = tuple(fi.crop)
        self.out_w = fi.geometry.width
        self.out_h = fi.geometry.height
        self.fi = fi.copy()
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof():
            return [buf]
        rpu = buf.side_data.get("dovi_rpu")
        if rpu is None:
            return [buf]
        if isinstance(rpu, dict) and "active_area" in rpu:
            # level 5: scale active-area offsets through crop+scale
            t, b, l, r = self.crop
            ax = self.out_w / max(self.src_w - l - r, 1)
            ay = self.out_h / max(self.src_h - t - b, 1)
            L, R, T, B = rpu["active_area"]
            rpu = dict(rpu)
            rpu["active_area"] = (
                max(0, int(round((L - l) * ax))),
                max(0, int(round((R - r) * ax))),
                max(0, int(round((T - t) * ay))),
                max(0, int(round((B - b) * ay))))
            buf.side_data["dovi_rpu"] = rpu
        return [buf]
