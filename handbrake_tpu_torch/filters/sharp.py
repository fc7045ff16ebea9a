"""Sharpen / smooth filters: UNSHARP, LAPSHARP, CHROMA_SMOOTH (reference:
unsharp.c, lapsharp.c, chroma_smooth.c) — the counterpart of
``handbrake_tpu/filters/sharp.py``: stateless per-frame f32 convolutions
by shifted adds, in the reference's order of taps.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from ..utils.fp import fma32
from .base import Filter, FilterInit, register
from .kernels import conv2d_small, out_dtype, pad_edge, to_tensor


def _gauss1d(size: int) -> np.ndarray:
    sigma = size / 3.0
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_blend(plane: torch.Tensor, size: int, strength: float,
                maxval: int, direction: int) -> torch.Tensor:
    """Separable gaussian blur; direction=+1 sharpen (unsharp mask),
    -1 smooth (blend toward blur)."""
    k = _gauss1d(size)
    x = plane.to(torch.float32)
    kv = torch.from_numpy(k).to(x.device)
    pad = size // 2
    h, w = x.shape
    xp = pad_edge(x, pad, pad, 0, 0)
    bl = kv[0] * xp[0:h]
    for i in range(1, size):
        bl = bl + kv[i] * xp[i:i + h]
    blp = pad_edge(bl, 0, 0, pad, pad)
    bl = kv[0] * blp[:, 0:w]
    for i in range(1, size):
        bl = bl + kv[i] * blp[:, i:i + w]
    out = x + direction * strength * (x - bl)
    return torch.clamp(torch.round(out), 0, maxval).to(out_dtype(maxval))


# lapsharp kernels (identity + laplacian variants, normalized)
_KERNELS = {
    "lap": np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32),
    "isolap": np.array([[-1, -4, -1], [-4, 21, -4], [-1, -4, -1]],
                       np.float32),
    "log": np.array([[0, 0, -1, 0, 0], [0, -1, -2, -1, 0],
                     [-1, -2, 17, -2, -1], [0, -1, -2, -1, 0],
                     [0, 0, -1, 0, 0]], np.float32),
    "isolog": np.array([[0, -1, -1, -1, 0], [-1, -2, -4, -2, -1],
                        [-1, -4, 41, -4, -1], [-1, -2, -4, -2, -1],
                        [0, -1, -1, -1, 0]], np.float32),
}


def _lapsharp_plane(plane: torch.Tensor, kernel: str, strength: float,
                    maxval: int) -> torch.Tensor:
    k = _KERNELS[kernel]
    k = k / k.sum()  # normalize so conv includes identity response
    x = plane.to(torch.float32)
    c = conv2d_small(x, k)
    # x * (1 - strength) + c * strength, contracted as the reference's XLA
    # CPU backend does it: one fma on x's product (with two roundings,
    # 0.3-0.6 % of the samples differed by 1 on smooth content)
    out = fma32(x, torch.tensor(1.0 - strength, dtype=torch.float32),
                c * strength)
    return torch.clamp(torch.round(out), 0, maxval).to(out_dtype(maxval))


class _PlaneFilter(Filter):
    """init of the three filters: the maxval and the device."""
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        return self.fi


@register
class UnsharpFilter(_PlaneFilter):
    id = S.FILTER_UNSHARP
    name = "unsharp"

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.y = (float(s.get("y_strength", 0.25)),
                  int(s.get("y_size", 7)) | 1)
        self.c = (float(s.get("cb_strength", self.y[0] / 2)),
                  int(s.get("cb_size", self.y[1])) | 1)
        return super().init(fi)

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        planes = []
        for i, p in enumerate(buf.planes):
            st, sz = self.y if i == 0 else self.c
            pt = to_tensor(p, self.device)
            planes.append(pt if st <= 0 else _blur_blend(
                pt, size=sz, strength=st, maxval=self.maxval, direction=1))
        return [Buffer(planes=planes, pix_fmt=buf.pix_fmt).copy_props(buf)]


@register
class LapsharpFilter(_PlaneFilter):
    id = S.FILTER_LAPSHARP
    name = "lapsharp"

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        kern = s.get("kernel", s.get("y_kernel", "isolap"))
        self.y = (float(s.get("y_strength", 0.2)), kern)
        self.c = (float(s.get("cb_strength", self.y[0] / 2)),
                  s.get("cb_kernel", kern))
        return super().init(fi)

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        planes = []
        for i, p in enumerate(buf.planes):
            st, kern = self.y if i == 0 else self.c
            pt = to_tensor(p, self.device)
            planes.append(pt if st <= 0 else _lapsharp_plane(
                pt, kernel=kern, strength=st, maxval=self.maxval))
        return [Buffer(planes=planes, pix_fmt=buf.pix_fmt).copy_props(buf)]


@register
class ChromaSmoothFilter(_PlaneFilter):
    id = S.FILTER_CHROMA_SMOOTH
    name = "chroma_smooth"

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.cb = (float(s.get("cb_strength", 1.2)),
                   int(s.get("cb_size", 7)) | 1)
        self.cr = (float(s.get("cr_strength", self.cb[0])),
                   int(s.get("cr_size", self.cb[1])) | 1)
        return super().init(fi)

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        planes = [to_tensor(buf.planes[0], self.device)]
        for p, (st, sz) in zip(buf.planes[1:], (self.cb, self.cr)):
            pt = to_tensor(p, self.device)
            planes.append(pt if st <= 0 else _blur_blend(
                pt, size=sz, strength=min(st, 1.0), maxval=self.maxval,
                direction=-1))
        return [Buffer(planes=planes, pix_fmt=buf.pix_fmt).copy_props(buf)]
