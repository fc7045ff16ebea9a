"""Colorspace conversion + HDR tonemap (reference: colorspace.c → zscale)
— the counterpart of ``handbrake_tpu/filters/colorspace.py``.

Pipeline per frame (the zimg model): YUV → RGB (source matrix/range) →
linearize (source transfer) → primaries 3x3 → [tonemap for HDR→SDR] →
encode transfer → RGB → YUV (target matrix/range), all float32 torch
operations on the filter's device, in the reference's order.  Chroma goes
to 4:4:4 and back by bilinear resampling through ``resample_matrix`` (two
f32 matrix products, TF32 off).

Settings: primaries, transfer, matrix, range (targets), tonemap
(hable|reinhard|mobius|linear|clip), npl (nominal peak luminance), desat.
The npl/desat derivation from mastering metadata follows colorspace.c:36-185.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import _weights, div, maxval_of, out_dtype, to_tensor

f32 = np.float32

# Rec. matrices: Kr/Kb per standard
_KRKB = {
    "bt601": (0.299, 0.114),
    "smpte170m": (0.299, 0.114),
    "bt709": (0.2126, 0.0722),
    "bt2020": (0.2627, 0.0593),
    "bt2020nc": (0.2627, 0.0593),
}

# CIE xy primaries + white point per standard
_PRIMARIES = {
    "bt709": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060)),
    "bt601": ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070)),
    "smpte170m": ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070)),
    "bt2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046)),
    "p3": ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)),
}
_D65 = (0.3127, 0.3290)


def rgb_to_yuv_matrix(matrix: str) -> np.ndarray:
    kr, kb = _KRKB[matrix]
    kg = 1.0 - kr - kb
    return np.array([
        [kr, kg, kb],
        [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
        [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
    ], np.float64)


def _rgb_to_xyz(prim) -> np.ndarray:
    (rx, ry), (gx, gy), (bx, by) = prim
    wx, wy = _D65
    m = np.array([[rx / ry, gx / gy, bx / by],
                  [1, 1, 1],
                  [(1 - rx - ry) / ry, (1 - gx - gy) / gy,
                   (1 - bx - by) / by]], np.float64)
    w = np.array([wx / wy, 1.0, (1 - wx - wy) / wy])
    s = np.linalg.solve(m, w)
    return m * s


def primaries_matrix(src: str, dst: str) -> np.ndarray:
    """RGB(src primaries) → RGB(dst primaries), via XYZ (D65 both)."""
    a = _rgb_to_xyz(_PRIMARIES[src])
    b = _rgb_to_xyz(_PRIMARIES[dst])
    return np.linalg.solve(b, a)


# --- transfer curves (normalized 0..1 signal; linear scaled so SDR peak=1) --
def _srgb_ish_gamma(x, inv):  # bt709/601 OETF ≈ gamma 1/0.45 w/ linear toe
    a = 1.09929682680944
    b = 0.018053968510807
    if inv:  # EOTF: signal → linear
        return torch.where(x < 4.5 * b, div(x, 4.5),
                           torch.pow(div(x + (a - 1), a), 1 / 0.45))
    return torch.where(x < b, 4.5 * x,
                       a * torch.pow(x, 0.45) - (a - 1))


_PQ_M1, _PQ_M2 = 2610 / 16384, 2523 / 4096 * 128
_PQ_C1, _PQ_C2, _PQ_C3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32


def _pq(x, inv, ref_white=203.0):
    if inv:  # signal → linear (1.0 = ref_white nits)
        xp = torch.pow(torch.clamp_min(x, 0.0), 1 / _PQ_M2)
        num = torch.clamp_min(xp - _PQ_C1, 0.0)
        lin = torch.pow(num / (_PQ_C2 - _PQ_C3 * xp), 1 / _PQ_M1)
        return lin * (10000.0 / ref_white)
    y = torch.clamp_min(x, 0.0) * (ref_white / 10000.0)
    yp = torch.pow(y, _PQ_M1)
    return torch.pow((_PQ_C1 + _PQ_C2 * yp) / (1 + _PQ_C3 * yp), _PQ_M2)


def _hlg(x, inv):
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    if inv:
        lin = torch.where(x <= 0.5, div(x * x, 3.0),
                          div(torch.exp(div(x - c, a)) + b, 12.0))
        return lin * 12.0  # scene-linear, peak 12x SDR white
    y = div(x, 12.0)
    return torch.where(y <= 1 / 12, torch.sqrt(3 * y),
                       a * torch.log(12 * y - b) + c)


def transfer(x, name: str, inv: bool):
    if name in ("bt709", "bt601", "smpte170m"):
        return _srgb_ish_gamma(x, inv)
    if name in ("smpte2084", "pq"):
        return _pq(x, inv)
    if name in ("arib-std-b67", "hlg"):
        return _hlg(x, inv)
    if name == "linear":
        return x
    raise ValueError(f"unknown transfer {name!r}")


# --- tonemap operators (zscale's set, on max-RGB) ---------------------------
def _hable(v):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((v * (A * v + C * B) + D * E)
            / (v * (A * v + B) + D * F)) - E / F


def tonemap(lin, method: str, peak: float, desat: float):
    """lin: linear RGB (..., 3) with 1.0 = SDR white; peak in same units."""
    if method in ("none", "clip") or peak <= 1.0:
        return torch.clamp(lin, 0.0, 1.0)
    sig = torch.clamp_min(torch.amax(lin, dim=-1, keepdim=True), 1e-6)
    if method == "reinhard":
        offset = (1.0 - 0.5) / 0.5
        mapped = div(sig / (sig + offset) * (peak + offset), peak)
    elif method == "mobius":
        j = 0.3
        a = -j * j * (peak - 1.0) / (j * j - 2.0 * j + peak)
        # the reference's b is an f32 scalar: f32 arithmetic on the host
        b = f32(j * j - 2.0 * j * peak + peak) / f32(max(peak - 1.0, 1e-6))
        num = b * b + f32(2.0) * b * f32(j) + f32(j * j)
        den = b * b + f32(2.0) * b * f32(peak) + f32(peak)
        mapped = torch.where(sig <= j, sig,
                             float(num / den) * (sig + a) / (sig + float(b)))
        mapped = mapped / sig * torch.where(sig <= j, sig, 1.0)
        mapped = torch.where(sig <= j, sig, mapped * sig) / sig
    else:  # hable (filmic) — zscale default for HDR→SDR
        hp = _hable(torch.tensor(peak, dtype=torch.float32))
        mapped = _hable(sig) / hp.to(sig.device)
    ratio = mapped / sig
    out = lin * ratio
    if desat > 0:
        luma = torch.amax(out, dim=-1, keepdim=True)
        coeff = torch.clamp((sig - 1.0) / torch.clamp_min(sig, 1e-6),
                            0.0, 1.0) * desat
        out = out * (1 - coeff) + luma * coeff
    return torch.clamp(out, 0.0, 1.0)


def _mat(m: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(m.astype(np.float32)).to(dev)


def convert_frame(y, u, v, *, src_matrix, dst_matrix, src_transfer,
                  dst_transfer, src_prim, dst_prim, src_full, dst_full,
                  src_depth, dst_depth, tm_method, peak, desat):
    """Full-res (H, W) planes in/out (chroma upsampled by the caller), as
    tensors on one device."""
    dev = y.device
    smax = (1 << src_depth) - 1
    yf = y.to(torch.float32)
    uf = u.to(torch.float32)
    vf = v.to(torch.float32)
    if src_full:
        yn = div(yf, smax)
        cn_u = div(uf, smax) - 0.5
        cn_v = div(vf, smax) - 0.5
    else:
        d = 1 << (src_depth - 8)
        yn = div(yf - 16 * d, 219 * d)
        cn_u = div(uf - 128 * d, 224 * d)
        cn_v = div(vf - 128 * d, 224 * d)
    yuv = torch.stack([yn, cn_u, cn_v], -1)
    m_in = _mat(np.linalg.inv(rgb_to_yuv_matrix(src_matrix)), dev)
    rgb = yuv @ m_in.T
    rgb = torch.clamp(rgb, 0.0, 1.0)
    lin = transfer(rgb, src_transfer, inv=True)
    if src_prim != dst_prim:
        lin = lin @ _mat(primaries_matrix(src_prim, dst_prim), dev).T
    lin = tonemap(lin, tm_method, peak, desat)
    rgb2 = transfer(torch.clamp(lin, 0.0, 1.0), dst_transfer, inv=False)
    yuv2 = rgb2 @ _mat(rgb_to_yuv_matrix(dst_matrix), dev).T
    dmax = (1 << dst_depth) - 1
    if dst_full:
        yo = yuv2[..., 0] * dmax
        uo = (yuv2[..., 1] + 0.5) * dmax
        vo = (yuv2[..., 2] + 0.5) * dmax
    else:
        d = 1 << (dst_depth - 8)
        yo = yuv2[..., 0] * (219 * d) + 16 * d
        uo = yuv2[..., 1] * (224 * d) + 128 * d
        vo = yuv2[..., 2] * (224 * d) + 128 * d
    dt = out_dtype(dmax)
    return tuple(torch.clamp(torch.round(p), 0, dmax).to(dt)
                 for p in (yo, uo, vo))


@register
class ColorspaceFilter(Filter):
    id = S.FILTER_COLORSPACE
    name = "colorspace"
    state = None            # frame-local: one frame out for each frame in

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.dst_prim = s.get("primaries", fi.color_prim)
        self.dst_transfer = s.get("transfer", fi.color_transfer)
        self.dst_matrix = s.get("matrix", fi.color_matrix)
        self.dst_range = s.get("range", fi.color_range)
        self.tm = s.get("tonemap", "hable")
        # colorspace.c:36-185: npl from mastering metadata else 10k/1k nits
        self.npl = float(s.get("npl", 0)) or None
        self.desat = float(s.get("desat", 0.5))
        self.device = resolve_device(fi.device)
        self.src = fi.copy()
        self.fi = fi.copy()
        self.fi.color_prim = self.dst_prim
        self.fi.color_transfer = self.dst_transfer
        self.fi.color_matrix = self.dst_matrix
        self.fi.color_range = self.dst_range
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        fmt = buf.pix_fmt
        src = self.src
        if (src.color_prim == self.dst_prim
                and src.color_transfer == self.dst_transfer
                and src.color_matrix == self.dst_matrix
                and src.color_range == self.dst_range):
            return [buf]
        dev = self.device
        h, w = buf.planes[0].shape
        sw, sh = fmt.subsampling
        mx = maxval_of(fmt)
        # chroma to 4:4:4 (bilinear, siting-aware)
        csh = -0.25 if sw == 2 else 0.0
        ups = []
        for p in buf.planes[1:]:
            avh = _weights(p.shape[0], h, "bilinear", 0.0, 0.0, dev)
            awh = _weights(p.shape[1], w, "bilinear", csh, 0.0, dev)
            x = avh @ to_tensor(p, dev).to(torch.float32)
            ups.append(x @ awh.T)
        npl = self.npl
        if npl is None:
            md = buf.side_data.get("mastering")
            npl = float(md.get("max_luminance", 1000.0)) if md else (
                1000.0 if src.color_transfer in ("smpte2084", "pq",
                                                 "arib-std-b67", "hlg")
                else 100.0)
        peak = max(npl / 203.0, 1.0)
        yo, uo, vo = convert_frame(
            to_tensor(buf.planes[0], dev), ups[0], ups[1],
            src_matrix=src.color_matrix, dst_matrix=self.dst_matrix,
            src_transfer=src.color_transfer, dst_transfer=self.dst_transfer,
            src_prim=src.color_prim, dst_prim=self.dst_prim,
            src_full=(src.color_range == "full"),
            dst_full=(self.dst_range == "full"),
            src_depth=fmt.bit_depth, dst_depth=fmt.bit_depth,
            tm_method=self.tm, peak=float(peak), desat=self.desat)
        # back to subsampled chroma
        planes = [yo]
        ch, cw = (h + sh - 1) // sh, (w + sw - 1) // sw
        for p in (uo, vo):
            avd = _weights(h, ch, "bilinear", 0.0, 0.0, dev)
            awd = _weights(w, cw, "bilinear", 0.0, csh, dev)
            x = avd @ p.to(torch.float32)
            x = x @ awd.T
            planes.append(torch.clamp(torch.round(x), 0, mx).to(yo.dtype))
        out = Buffer(planes=planes, pix_fmt=fmt).copy_props(buf)
        return [out]
