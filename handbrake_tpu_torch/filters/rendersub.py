"""Subtitle burn-in (reference: rendersub.c + blend.c) — the counterpart of
``handbrake_tpu/filters/rendersub.py``.

Blends RGBA subtitle bitmaps (from the subtitle decoders and the text
rasterizer) onto YUV frames on the filter's device: a premultiplied alpha
blend, chroma blended at subsampled resolution (hb_blend object analog,
internal.h:485).

Subtitle events arrive as Buffers with track_kind == "subtitle", an RGBA
array in planes[0] (H, W, 4) and a position in .rect; they are queued by
pts (each event's RGBA goes to the device once, when it is queued) and
blended onto every video frame whose pts falls in [pts, stop).  A clear
marker (a bitmap format's next display set, or a VobSub card's end) sets
the stop of the events it retires; an event leaves the queue only when a
frame at or past its stop comes.  The reference drops them when the
marker comes, so a frame a filter ahead still holds (decomb's and
yadif's one frame, the last of a job until the flush) loses a card that
was still on screen at its pts.

The reference's ``blend_rgba`` is a jitted XLA graph, not a kernel; here
it is torch operations in the order in which XLA:CPU evaluates that graph
(read from its optimized HLO and matched on random patches, this repo's
``tests/test_torch_subtitles.py``), so the card and the CPU give the
reference's bytes:
- the RGBA samples times f32(1/255) (XLA rewrites the division by 255);
- the BT.709 product: luma and Cb as (r m0 + g m1) + b m2, each product
  and sum rounded, except the last n % 8 of the patch's n pixels (all of
  them where n < 16, or n < 32 with n % 8 >= 4), which, like every Cr,
  take the fma chain fma(b, m2, fma(g, m1, r m0));
- luma: fma(sy, a, y (1 - a));
- chroma: the site's alpha and colour sums with the products fused into
  them (4:2:0: the alpha as one fma chain over the 2x2 site in row order,
  the colour as two fma pairs, a row each, added; 4:2:2: the alpha from
  the right sample, the colour from the left), times 1 / (sw sh); the
  blend fma(c, a, x (1 - a)) where subsampled, fma(x, 1 - a, c a) at
  4:4:4;
- round half to even, clip, cast.
``fma32`` rounds once on every device, and each other operation is one
elementwise torch operation, rounded alone.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from ..utils.fp import fma32
from .base import Filter, FilterInit, register
from .colorspace import rgb_to_yuv_matrix
from .kernels import to_tensor

_YUV709 = rgb_to_yuv_matrix("bt709").astype(np.float32)
_GEMV_TAIL = 8          # pixels of the product's last group, fused


def _f32(x, dev) -> torch.Tensor:
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=dev)


def _fused_pixels(n: int) -> int:
    """The first pixel (of n, row-major) whose luma and Cb XLA:CPU's dot
    computes as an fma chain."""
    if n < 16 or (n < 32 and n % _GEMV_TAIL >= 4):
        return 0
    return n - n % _GEMV_TAIL


def rgb_to_yuv709(rgb: torch.Tensor) -> list:
    """The reference's ``einsum("hwc,rc->hwr", rgb, M)``, (ph, pw, 3) f32
    in, [Y, Cb, Cr] (ph, pw) f32 out, in XLA:CPU's order."""
    dev = rgb.device
    ph, pw = rgb.shape[:2]
    flat = rgb.reshape(ph * pw, 3)
    cut = _fused_pixels(ph * pw)
    out = []
    for r in range(3):
        m = [_f32(_YUV709[r, c], dev) for c in range(3)]
        p0 = flat[:, 0] * m[0]
        fused = fma32(flat[:, 2], m[2], fma32(flat[:, 1], m[1], p0))
        if r < 2 and cut:
            plain = (p0 + flat[:, 1] * m[1]) + flat[:, 2] * m[2]
            fused = torch.cat([plain[:cut], fused[cut:]])
        out.append(fused.reshape(ph, pw))
    return out


def _site_sums(x: torch.Tensor, m: torch.Tensor, sw: int, sh: int,
               pairs: bool) -> torch.Tensor:
    """The sum of x * m over each sw x sh site (x cut to whole sites), the
    products fused into the sum as XLA:CPU fuses them: at 4:2:0 one fma
    chain in row order, or (pairs) two, a row each, added; at 4:2:2 the
    right sample's product rounded, then the left's fused, or (pairs) the
    left's rounded, then the right's fused."""
    ch, cw = x.shape[0] // sh, x.shape[1] // sw
    s = [[x[i:ch * sh:sh, j:cw * sw:sw] for j in range(sw)]
         for i in range(sh)]
    if (sw, sh) == (2, 1):
        a, b = (s[0][0], s[0][1]) if pairs else (s[0][1], s[0][0])
        return fma32(b, m, a * m)
    if (sw, sh) == (2, 2):
        if pairs:
            return (fma32(s[0][1], m, s[0][0] * m)
                    + fma32(s[1][1], m, s[1][0] * m))
        return fma32(s[1][1], m, fma32(s[1][0], m,
                                       fma32(s[0][1], m, s[0][0] * m)))
    raise NotImplementedError(
        f"render_sub: chroma subsampling {sw}x{sh} is not ported (4:2:0, "
        f"4:2:2 and 4:4:4 are)")


def clamp_site(x0: int, y0: int, pw: int, ph: int, width: int,
               height: int) -> tuple:
    """An event's (x0, y0) moved inside a width x height frame, as the
    reference's filter moves it (a patch larger than the frame goes to 0
    and fails in the blend)."""
    return (max(0, min(x0, width - pw)), max(0, min(y0, height - ph)))


def blend_rgba(y, u, v, rgba, x0: int, y0: int, sw: int, sh: int,
               maxval: int = 255):
    """Alpha-blend an RGBA patch (uint8 (ph, pw, 4), on the planes'
    device) at (x0, y0) onto planar YUV; returns new (y, u, v)."""
    dev = y.device
    ph, pw = rgba.shape[0], rgba.shape[1]
    if y0 + ph > y.shape[0] or x0 + pw > y.shape[1]:
        # the reference's broadcast fails here (a TypeError of jnp)
        raise TypeError(f"render_sub: a {pw}x{ph} subtitle patch at "
                        f"({x0}, {y0}) does not fit the "
                        f"{y.shape[1]}x{y.shape[0]} frame")
    inv255, one = _f32(1.0 / 255.0, dev), _f32(1.0, dev)
    scale = _f32(maxval, dev)
    rgbaf = rgba.to(torch.float32)
    alpha = rgbaf[..., 3]
    a = alpha * inv255
    yuv = rgb_to_yuv709(rgbaf[..., :3] * inv255)
    sy = yuv[0] * scale

    def put(plane, top, left, value):
        out = plane.clone()
        out[top:top + value.shape[0], left:left + value.shape[1]] = \
            torch.clamp(torch.round(value), 0, maxval).to(plane.dtype)
        return out

    ypatch = y[y0:y0 + ph, x0:x0 + pw].to(torch.float32)
    y = put(y, y0, x0, fma32(sy, a, ypatch * (one - a)))

    ch, cw = ph // sh, pw // sw
    if ch > 0 and cw > 0:
        half = _f32(0.5, dev)
        cy0, cx0 = y0 // sh, x0 // sw
        if (sw, sh) == (1, 1):
            asub = a
        else:
            asub = _site_sums(alpha, inv255, sw, sh, False) \
                * _f32(1.0 / (sw * sh), dev)
        planes = []
        for tgt, c in ((u, yuv[1]), (v, yuv[2])):
            t = c + half
            patch = tgt[cy0:cy0 + ch, cx0:cx0 + cw].to(torch.float32)
            if (sw, sh) == (1, 1):
                bl = fma32(patch, one - asub, (t * scale) * asub)
            else:
                sub = _site_sums(t, scale, sw, sh, True) \
                    * _f32(1.0 / (sw * sh), dev)
                bl = fma32(sub, asub, patch * (one - asub))
            planes.append(put(tgt, cy0, cx0, bl))
        u, v = planes
    return y, u, v


@register
class RenderSubFilter(Filter):
    id = S.FILTER_RENDER_SUB
    name = "render_sub"
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        self.events: list = []
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        return self.fi

    def queue_subtitle(self, sub: Buffer):
        """Feed one subtitle event (RGBA bitmap + rect + pts/stop), or a
        clear marker (sub_clear=True): bitmap formats like PGS replace
        the whole screen per display set — a marker ends every open
        event older than its pts there (``work`` drops it once a frame
        reaches that stop).  An event's RGBA goes to the device here,
        once."""
        if getattr(sub, "sub_clear", False):
            cut = sub.pts if sub.pts is not None else 0
            for e in self.events:
                if e.stop is None and (e.pts or 0) < cut:
                    e.stop = cut
            return
        ev = Buffer(track_kind="subtitle").copy_props(sub)
        ev.planes = [to_tensor(sub.planes[0], self.device)]
        ev.rect = sub.rect
        self.events.append(ev)

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        if buf.track_kind == "subtitle":
            self.queue_subtitle(buf)
            return []
        pts = buf.pts if buf.pts is not None else 0
        self.events = [e for e in self.events
                       if e.stop is None or e.stop > pts]
        active = [e for e in self.events
                  if (e.pts or 0) <= pts]
        if not active:
            return [buf]
        sw, sh = buf.pix_fmt.subsampling
        y, u, v = (to_tensor(p, self.device) for p in buf.planes[:3])
        for e in active:
            x0, y0 = (e.rect[0], e.rect[1]) if e.rect else (0, 0)
            rgba = e.planes[0]
            x0, y0 = clamp_site(x0, y0, rgba.shape[1], rgba.shape[0],
                                y.shape[1], y.shape[0])
            y, u, v = blend_rgba(y, u, v, rgba, x0=int(x0), y0=int(y0),
                                 sw=sw, sh=sh, maxval=self.maxval)
        out = Buffer(planes=[y, u, v],
                     pix_fmt=buf.pix_fmt).copy_props(buf)
        return [out]
