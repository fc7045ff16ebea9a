"""Shared helpers of the filter suite — the counterpart of
``handbrake_tpu/filters/kernels.py``: ``resample_matrix``,
``_apply_separable`` (here ``resample_plane``), ``pad_edge`` and
``conv2d_small``, plus the edge-clamped shifts the other filters share.

Resampling follows the zimg model the reference uses via zscale
(cropscale.c:150-157): separable filters with exact sample-grid math and
chroma-siting offsets.  The reference computes out = A_v @ img @ A_h^T as
two dense f32 products; the port takes each output sample's band of
nonzero weights (``resample_band``, from the copied ``resample_matrix``,
built on the host once per geometry and kept on the device) and sums it
as a chain of f32 fmas in ascending input order from 0, the order in
which XLA:CPU computes the reference's vertical product; then round half
to even, clip and cast.  On the card that is the hand-written kernel
``csrc/resample.cu`` (``resample_cuda.py``); ``resample_plain`` is its
plain version, the same chain through ``utils/fp.fma32``, which a plane
on the CPU takes.  So the card and the CPU give the same bits.  XLA:CPU
sums the horizontal product in another order at some shapes, where a
sample whose value lands near .5 may differ from the reference by one
LSB; the 0/1 weights of ``point`` are exact.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.fp import fma32


# ---------------------------------------------------------------------------
# resample weight matrices (host, cached)
# ---------------------------------------------------------------------------
def _sinc(x):
    return np.sinc(x)


def _lanczos(x, a):
    x = np.asarray(x, np.float64)
    return np.where(np.abs(x) < a, _sinc(x) * _sinc(x / a), 0.0)


def _bicubic(x, b=0.0, c=0.5):  # Catmull-Rom default (zimg "bicubic")
    x = np.abs(np.asarray(x, np.float64))
    x2, x3 = x * x, x * x * x
    p1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
          + (6 - 2 * b)) / 6
    p2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
          + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6
    return np.where(x < 1, p1, np.where(x < 2, p2, 0.0))


def _bilinear(x):
    x = np.abs(np.asarray(x, np.float64))
    return np.maximum(1.0 - x, 0.0)


_KERNELS = {
    "lanczos": (lambda x, s: _lanczos(x / s, 3.0), 3.0),
    "bicubic": (lambda x, s: _bicubic(x / s), 2.0),
    "bilinear": (lambda x, s: _bilinear(x / s), 1.0),
    "point": (None, 0.5),
}


@functools.lru_cache(maxsize=256)
def resample_matrix(n_in: int, n_out: int, kind: str = "lanczos",
                    shift_in: float = 0.0, shift_out: float = 0.0):
    """(n_out, n_in) float32 weight matrix.

    shift_in/shift_out: sample-grid offsets in the respective pixel units
    (chroma siting: left-sited 4:2:0 horizontal = -0.25).
    Sample j sits at physical position j + 0.5 + shift (units of its own
    grid); rows are normalized to sum 1 (edge clamp = weight folding).
    """
    scale = n_in / n_out
    if kind == "point":
        A = np.zeros((n_out, n_in), np.float32)
        for i in range(n_out):
            src = min(n_in - 1, max(0, int((i + 0.5) * scale)))
            A[i, src] = 1.0
        return A
    fn, base_support = _KERNELS[kind]
    s = max(scale, 1.0)  # widen when downscaling
    support = base_support * s
    A = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5 + shift_out) * scale - 0.5 - shift_in
        lo = max(0, int(math.floor(center - support)))
        hi = min(n_in - 1, int(math.ceil(center + support)))
        j = np.arange(lo, hi + 1)
        w = fn(j - center, s)
        tot = w.sum()
        if tot == 0:
            A[i, min(n_in - 1, max(0, int(round(center))))] = 1.0
        else:
            A[i, lo:hi + 1] = w / tot
    return A.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _weights(n_in: int, n_out: int, kind: str, shift_in: float,
             shift_out: float, device: torch.device) -> torch.Tensor:
    """resample_matrix as a tensor on `device`, uploaded once (the
    colorspace filter's chroma resampling multiplies by it)."""
    return torch.from_numpy(resample_matrix(n_in, n_out, kind, shift_in,
                                            shift_out)).to(device)


@functools.lru_cache(maxsize=256)
def resample_band(n_in: int, n_out: int, kind: str = "lanczos",
                  shift_in: float = 0.0, shift_out: float = 0.0):
    """The band of each row of ``resample_matrix``: (lo, taps), lo int32
    (n_out,) and taps float32 (T, n_out), tap-major, with taps[k, o] =
    A[o, lo[o] + k].  T is the widest span from a row's first nonzero
    weight to its last; a narrower row's band is moved left where it would
    reach past n_in, so every band lies inside the input and holds the
    row's nonzero weights in order, with zeros around them."""
    a = resample_matrix(n_in, n_out, kind, shift_in, shift_out)
    nz = a != 0
    first = nz.argmax(axis=1)
    last = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    n_taps = int((last - first).max()) + 1
    lo = np.minimum(first, n_in - n_taps).astype(np.int32)
    taps = np.ascontiguousarray(
        a[np.arange(n_out)[None, :], lo[None, :] + np.arange(n_taps)[:, None]])
    return lo, taps


@functools.lru_cache(maxsize=64)
def _band(n_in: int, n_out: int, kind: str, shift_in: float,
          shift_out: float, device: torch.device) -> tuple:
    """resample_band as tensors on `device`, uploaded once."""
    return tuple(torch.from_numpy(b).to(device) for b in
                 resample_band(n_in, n_out, kind, shift_in, shift_out))


def _band_pass(x: torch.Tensor, lo: torch.Tensor, taps: torch.Tensor
               ) -> torch.Tensor:
    """out[o, :] = the fma chain of taps[k, o] * x[lo[o] + k, :] over k
    ascending, from 0, in f32 (x: (n_in, m) float32)."""
    acc = torch.zeros((lo.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    idx = lo.long()
    for k in range(taps.shape[0]):
        acc = fma32(taps[k][:, None], x[idx + k], acc)
    return acc


def resample_plain(img: torch.Tensor, lo_v, taps_v, lo_h, taps_h,
                   maxval: int) -> torch.Tensor:
    """The plain version of the resample kernel, on img's device: the
    vertical band's fma chain, then the horizontal band's on the f32
    intermediate, round (half to even), clip to [0, maxval], cast to
    uint8/uint16."""
    x = _band_pass(img.to(torch.float32), lo_v, taps_v)
    x = _band_pass(x.T, lo_h, taps_h).T
    return torch.clamp(torch.round(x), 0, maxval).to(out_dtype(maxval))


def to_tensor(plane, device: torch.device) -> torch.Tensor:
    """A plane (numpy, read-only views included, or a tensor) on `device`."""
    if isinstance(plane, torch.Tensor):
        return plane.to(device)
    return torch.from_numpy(
        np.require(plane, requirements=["C", "W"])).to(device)


def resample_plane(plane, out_h: int, out_w: int, kind: str = "lanczos",
                   shift_in=(0.0, 0.0), shift_out=(0.0, 0.0),
                   maxval: int = 255, device=None) -> torch.Tensor:
    """Resample one plane through its separable bands.  The plane is a
    numpy array or a tensor; the work runs on the tensor's device, else on
    `device` (None: the CUDA card): the kernel on the card, its plain
    version on the CPU.  Returns a tensor there."""
    dev = resolve_device(plane.device if isinstance(plane, torch.Tensor)
                         else device)
    in_h, in_w = plane.shape
    bv = _band(in_h, out_h, kind, float(shift_in[0]), float(shift_out[0]),
               dev)
    bh = _band(in_w, out_w, kind, float(shift_in[1]), float(shift_out[1]),
               dev)
    x = to_tensor(plane, dev)
    if dev.type == "cuda":
        from .resample_cuda import resample_cuda
        return resample_cuda(x.contiguous(), *bv, *bh, maxval)
    return resample_plain(x, *bv, *bh, maxval)


def maxval_of(pix_fmt) -> int:
    return (1 << pix_fmt.bit_depth) - 1


# ---------------------------------------------------------------------------
# edge-clamped shifts and small convolutions (the filters' shared helpers)
# ---------------------------------------------------------------------------
def clamped(n: int, off: int, device) -> torch.Tensor:
    """Index vector clip(arange(n) + off, 0, n - 1) on `device`."""
    return torch.clamp(torch.arange(off, n + off, device=device), 0, n - 1)


def rows(a: torch.Tensor, off: int) -> torch.Tensor:
    """Vertical neighbour with edge clamp: out[y] = a[clip(y + off)]."""
    return a if off == 0 else a[clamped(a.shape[-2], off, a.device)]


def cols(a: torch.Tensor, off: int) -> torch.Tensor:
    """Horizontal neighbour with edge clamp: out[:, x] = a[:, clip(x + off)]."""
    return a if off == 0 else a[..., clamped(a.shape[-1], off, a.device)]


def shift2(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[clip(y + dy), clip(x + dx)] over the last two axes."""
    return cols(a[..., clamped(a.shape[-2], dy, a.device), :]
                if dy else a, dx)


def pad_edge(x: torch.Tensor, t: int, b: int, l: int, r: int
             ) -> torch.Tensor:
    """Edge-replicate padding (jnp.pad mode="edge") by clamped indices."""
    h, w = x.shape
    ys = torch.clamp(torch.arange(-t, h + b, device=x.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-l, w + r, device=x.device), 0, w - 1)
    return x[ys][:, xs]


def conv2d_small(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """x: (H, W) float32; k: (kh, kw) numpy.  Edge-replicate convolution by
    shifted adds, in the reference's order (row-major taps, zero taps
    skipped).  Each step out + w * tap is one fused multiply-add, as the
    reference's XLA CPU backend contracts it: with the separate multiply
    and add, a 5x5 kernel's sums differed in the last bit on two thirds
    of the samples, and the rounded output on 2 % of them."""
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    xp = pad_edge(x, ph, ph, pw, pw)
    out = torch.zeros_like(x)
    for dy in range(kh):
        for dx in range(kw):
            w = float(k[dy, dx])
            if w != 0.0:
                out = fma32(xp[dy:dy + x.shape[0], dx:dx + x.shape[1]],
                            torch.tensor(w, dtype=torch.float32), out)
    return out


def div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s rounded as an IEEE division on every device.  A Python
    scalar divisor would make PyTorch's CUDA kernel multiply by its
    reciprocal, which rounds differently; a 0-dim tensor on a's device
    keeps the true division the reference computes."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


def out_dtype(maxval: int) -> torch.dtype:
    return torch.uint8 if maxval <= 255 else torch.uint16


def to_int32(plane, device: torch.device) -> torch.Tensor:
    """A uint8/uint16 plane as int32 on `device` (uint16 tensors support
    few operations, so integer filters work in int32 and cast back)."""
    return to_tensor(plane, device).to(torch.int32)
