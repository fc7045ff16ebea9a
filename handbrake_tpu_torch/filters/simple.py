"""Geometry/format filters: ROTATE, GRAYSCALE, PAD, FORMAT (reference:
rotate.c, grayscale.c, pad.c, format.c — avfilter aliases) — the
counterpart of ``handbrake_tpu/filters/simple.py``: relayouts as torch
operations on the filter's device.
"""
from __future__ import annotations

import torch

from ..core.buffer import Buffer, Geometry, PIX_FMTS
from ..job import schema as S
from ..job.colormap import name_to_rgb, rgb_to_yuv
from ..utils.device import resolve_device
from .base import Filter, FilterInit, FilterError, register
from .kernels import maxval_of, out_dtype, resample_plane, to_tensor


def name_to_yuv(name: str) -> tuple:
    return rgb_to_yuv(name_to_rgb(name))


def _flip(a: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.flip for uint8 and uint16 planes (the latter as int16 bits:
    flip takes no uint16)."""
    if a.dtype == torch.uint16:
        return torch.flip(a.view(torch.int16), [dim]).view(torch.uint16)
    return torch.flip(a, [dim])


class _DeviceFilter(Filter):
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        return self.fi


@register
class RotateFilter(_DeviceFilter):
    id = S.FILTER_ROTATE
    name = "rotate"

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.angle = int(s.get("angle", 180)) % 360
        self.hflip = int(s.get("hflip", 0))
        if self.angle not in (0, 90, 180, 270):
            raise FilterError(f"bad rotate angle {self.angle}")
        super().init(fi)
        if self.angle in (90, 270):
            g = fi.geometry
            self.fi.geometry = Geometry(g.height, g.width, g.par_den,
                                        g.par_num)
        return self.fi

    def _apply(self, p):
        a = to_tensor(p, self.device)
        if self.angle == 90:       # clockwise
            a = _flip(a.T, 1)
        elif self.angle == 180:
            a = _flip(_flip(a, 0), 1)
        elif self.angle == 270:
            a = _flip(a.T, 0)
        if self.hflip:
            a = _flip(a, 1)
        return a.contiguous()

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        planes = [self._apply(p) for p in buf.planes]
        return [Buffer(planes=planes, pix_fmt=buf.pix_fmt).copy_props(buf)]


@register
class GrayscaleFilter(_DeviceFilter):
    id = S.FILTER_GRAYSCALE
    name = "grayscale"

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        fmt = buf.pix_fmt
        mid = 1 << (fmt.bit_depth - 1)
        planes = [to_tensor(buf.planes[0], self.device)] + [
            torch.full(tuple(p.shape), mid, dtype=out_dtype(maxval_of(fmt)),
                       device=self.device)
            for p in buf.planes[1:]]
        return [Buffer(planes=planes, pix_fmt=fmt).copy_props(buf)]


@register
class PadFilter(_DeviceFilter):
    id = S.FILTER_PAD
    name = "pad"

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        g = fi.geometry
        self.out_w = int(s.get("width", g.width))
        self.out_h = int(s.get("height", g.height))
        self.x = int(s.get("x", (self.out_w - g.width) // 2))
        self.y = int(s.get("y", (self.out_h - g.height) // 2))
        color = s.get("color", "black")
        self.yuv = name_to_yuv(color) if isinstance(color, str) else color
        super().init(fi)
        self.fi.geometry = Geometry(self.out_w, self.out_h,
                                    g.par_num, g.par_den)
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        fmt = buf.pix_fmt
        sw, sh = fmt.subsampling
        sc = 1 << (fmt.bit_depth - 8)
        planes = []
        for i, p in enumerate(buf.planes):
            pa = to_tensor(p, self.device)
            if i == 0:
                ow, oh, x, y = self.out_w, self.out_h, self.x, self.y
            else:
                ow, oh = (self.out_w + sw - 1) // sw, \
                         (self.out_h + sh - 1) // sh
                x, y = self.x // sw, self.y // sh
            out = torch.full((oh, ow), self.yuv[i] * sc,
                             dtype=out_dtype(maxval_of(fmt)),
                             device=self.device)
            out[y:y + pa.shape[0], x:x + pa.shape[1]] = pa
            planes.append(out)
        return [Buffer(planes=planes, pix_fmt=fmt).copy_props(buf)]


@register
class FormatFilter(_DeviceFilter):
    """Pixel-format conversion (bit depth shift + chroma re-subsampling).
    Auto-inserted before the encoder when formats mismatch (work.c:1506)."""
    id = S.FILTER_FORMAT
    name = "format"

    def init(self, fi: FilterInit) -> FilterInit:
        name = self.settings.get("format", fi.pix_fmt.name)
        if name not in PIX_FMTS:
            raise FilterError(f"unknown pix fmt {name}")
        self.src_fmt = fi.pix_fmt
        self.dst_fmt = PIX_FMTS[name]
        super().init(fi)
        self.fi.pix_fmt = self.dst_fmt
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        src, dst = buf.pix_fmt, self.dst_fmt
        if src.name == dst.name:
            return [buf]
        h, w = buf.planes[0].shape
        shift = dst.bit_depth - src.bit_depth
        mx = maxval_of(dst)
        dt = out_dtype(mx)

        def depth(p):
            a = to_tensor(p, self.device).to(torch.int32)
            if shift > 0:
                a = a << shift
            elif shift < 0:
                a = (a + (1 << (-shift - 1))) >> (-shift)
            return torch.clamp(a, 0, mx).to(dt)

        planes = [depth(buf.planes[0])]
        dcw, dch = (w + dst.subsampling[0] - 1) // dst.subsampling[0], \
                   (h + dst.subsampling[1] - 1) // dst.subsampling[1]
        for p in buf.planes[1:]:
            pd = depth(p)
            if tuple(pd.shape) != (dch, dcw):
                pd = resample_plane(pd, dch, dcw, "bilinear", maxval=mx)
            planes.append(pd)
        if dst.nplanes == 1:
            planes = planes[:1]
        elif src.nplanes == 1 and dst.nplanes == 3:
            mid = torch.full((dch, dcw), 1 << (dst.bit_depth - 1),
                             dtype=dt, device=self.device)
            planes = [planes[0], mid, mid.clone()]
        return [Buffer(planes=planes, pix_fmt=dst).copy_props(buf)]
