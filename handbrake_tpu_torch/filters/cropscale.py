"""Crop + scale filter (reference: cropscale.c, zscale/zimg semantics) —
the counterpart of ``handbrake_tpu/filters/cropscale.py``.

Settings (cropscale.c:21-24 template): width, height, crop-top, crop-bottom,
crop-left, crop-right, format. Ours adds ``method``
(lanczos|bicubic|bilinear|point); the reference picks zscale (lanczos
default) when usable, else swscale (cropscale.c:150-157).

Chroma siting: 4:2:0 is MPEG-2 left-sited horizontally, centered
vertically — the -0.25 horizontal chroma offset is applied on both input
and output grids, matching zimg's default siting.

A plane that needs no resample is a numpy slice of the source and never
touches the device; a resampled plane is a torch tensor on the filter's
device (FilterInit.device; None: the CUDA card).
"""
from __future__ import annotations

from ..core.buffer import Buffer, Geometry
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import maxval_of, resample_planes
from ..job import schema as S


@register
class CropScaleFilter(Filter):
    id = S.FILTER_CROP_SCALE
    name = "crop_scale"
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.device = resolve_device(fi.device)
        self.crop = (int(s.get("crop-top", 0)), int(s.get("crop-bottom", 0)),
                     int(s.get("crop-left", 0)), int(s.get("crop-right", 0)))
        cw = fi.geometry.width - self.crop[2] - self.crop[3]
        ch = fi.geometry.height - self.crop[0] - self.crop[1]
        self.out_w = int(s.get("width", cw))
        self.out_h = int(s.get("height", ch))
        self.method = s.get("method", "lanczos")
        self.fi = fi.copy()
        self.fi.geometry = Geometry(self.out_w, self.out_h,
                                    fi.geometry.par_num, fi.geometry.par_den)
        self.fi.crop = tuple(a + b for a, b in zip(fi.crop, self.crop))
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        t, b, l, r = self.crop
        fmt = buf.pix_fmt
        mx = maxval_of(fmt)
        sw, sh = fmt.subsampling
        y = buf.planes[0][t:buf.height - b, l:buf.width - r]
        planes = [y]
        # (index, spec) of each plane that needs a resample; chroma is
        # left-sited horizontally when subsampled by 2
        todo = []
        if tuple(y.shape) != (self.out_h, self.out_w):
            todo.append((0, (y, self.out_h, self.out_w, self.method,
                             (0.0, 0.0), (0.0, 0.0), mx)))
        csh = -0.25 if sw == 2 else 0.0
        och = (self.out_h + sh - 1) // sh
        ocw = (self.out_w + sw - 1) // sw
        for p in buf.planes[1:]:
            cp = p[t // sh:(buf.height - b + sh - 1) // sh,
                   l // sw:(buf.width - r + sw - 1) // sw]
            planes.append(cp)
            if tuple(cp.shape) != (och, ocw):
                todo.append((len(planes) - 1,
                             (cp, och, ocw, self.method, (0.0, csh),
                              (0.0, csh), mx)))
        # all of a frame's resamples in one call (one kernel launch on the
        # card)
        if todo:
            done = resample_planes([spec for _i, spec in todo],
                                   device=self.device)
            for (i, _spec), plane in zip(todo, done):
                planes[i] = plane
        # resampled planes stay on the device; the encode stage brings
        # them to the host
        out = Buffer(planes=planes, pix_fmt=fmt).copy_props(buf)
        return [out]
