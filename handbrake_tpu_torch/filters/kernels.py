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
in the order in which XLA:CPU sums the reference's products
(``vertical_order``, ``horizontal_order``: fma chains in lanes of the
input index, in blocks of it, with a separately rounded tail); then round
half to even, clip and cast.  On the card that is the hand-written kernel
``csrc/resample.cu`` (``resample_cuda.py``); ``resample_plain`` is its
plain version, the same order through ``utils/fp.fma32``, which a plane
on the CPU takes.  So the card and the CPU give the same bits, and both
give the reference's bits wherever the order was measured
(``tests/test_torch_resample_order.py``).
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


# XLA:CPU's order of the reference's two f32 products, measured on an
# AVX-512 host (jaxlib 0.9.0: each dot runs as a YNNPACK kernel; the map
# is tests/test_torch_resample_order.py).  Each output sums its K terms
# (k the input index) in blocks of the K axis, [0, B), [B, 2B), ..., each
# block from 0, the blocks added in order.  Within a block a term goes to
# lane k mod L as an fma chain; the lanes are added as neighbours, (l0 +
# l1) + (l2 + l3), or, for the columns from `split` on, as halves of the
# vector, (l0 + l4) + (l2 + l6) and (l1 + l5) + (l3 + l7).  Past the last
# multiple of L, the tail terms are multiplied and added (two roundings
# each; one, an fma chain, where `tail_fma`) in order from 0, and that sum
# is added last.  B is the K extent of a 128 KiB panel of the kernel's n
# columns.
_PANEL = 32768          # f32 values of that panel
_CHUNK = 64             # the vertical product's column tile, at least
_FIT = 65536            # f32 of K x (rows + half its tile) it stays below
_NARROW_LAST = 8        # columns up to which a last tile after wider ones
                        # rounds each product (all of K a tail), for 2 to
_NARROW_ROWS = 4        # this many rows
_MANY_ROWS = 51         # output rows from which the vertical product
                        # takes the horizontal product's kernels
_GEMV_LANES = 8         # lanes of the product with one output row


def _block(n_cols: int, lanes: int) -> int:
    b = _PANEL // n_cols
    return b - b % 4 if lanes > 1 else b


def horizontal_order(n_in: int, n_out: int, rows: int = 2) -> tuple:
    """(lanes, block, main, split, tail_fma) of XLA:CPU's sum of the
    horizontal product ``einsum("ow,cw->oc")`` over n_in terms into n_out
    columns of `rows` output rows: terms at main = n_in - n_in % lanes and
    beyond form the tail; the columns from split on add their lanes as
    halves.  From 2 rows on XLA picks the kernel by the output width, with
    no split.  One row is a matrix-vector product: eight lanes, no blocks,
    the columns in groups of eight adding neighbours and the last n_out %
    8 halves, the tail an fma chain."""
    if rows == 1:
        lanes = _GEMV_LANES
        return (lanes, max(n_in, 1), n_in - n_in % lanes,
                n_out - n_out % lanes, True)
    r = (n_out - 1) % 64 + 1
    if n_out <= 24:
        lanes, cols = 4, (-(-n_out // 4) * 4 if n_out <= 16 else 8)
    elif 17 <= r <= 32:
        lanes, cols = 2, 32
    elif r >= 49:
        lanes, cols = 1, 64
    else:
        lanes, cols = 4, 16
    return lanes, _block(cols, lanes), n_in - n_in % lanes, n_out, False


def vertical_order(n_in: int, width: int, n_out: int) -> list:
    """XLA:CPU's order of the vertical product ``einsum("oh,hw->ow")`` over
    n_in terms into n_out rows, for a plane `width` columns wide: [(col0,
    col1, lanes, block, main)], one entry for each run of columns that
    shares it.  From _MANY_ROWS output rows on, XLA picks the kernel by the
    plane's width as ``horizontal_order`` does by the output width, for
    every column.  Below that, a plane up to 64 wide is one tile (four
    lanes up to 16 columns); a wider one takes tiles of n = 64 2^j columns,
    the widest for which n_in x (the rows, rounded up to 32 or 64 past 16,
    + n / 2) f32 stay below _FIT (64 where none does), with a narrower last
    tile; a last tile of up to 8 columns of 2 to 4 rows rounds each
    product (main 0).  One output row is one fma chain."""
    if n_out == 1:
        return [(0, width, 1, max(n_in, 1), n_in)]
    if n_out >= _MANY_ROWS:
        return [(0, width, *horizontal_order(n_in, width)[:3])]
    if width <= _CHUNK:
        lanes = 4 if width <= 16 else 1
        cols = -(-width // 4) * 4 if lanes > 1 else width
        return [(0, width, lanes, _block(cols, lanes),
                 n_in - n_in % lanes)]
    rows = n_out if n_out <= 16 else 32 if n_out <= 32 else 64
    tile = _CHUNK
    while tile < width and n_in * (rows + tile) < _FIT:
        tile *= 2
    split = width - width % tile
    runs = [(0, split, 1, _block(tile, 1), n_in)] if split else []
    if split < width:
        last = width - split
        narrow = split and last <= _NARROW_LAST and n_out <= _NARROW_ROWS
        runs.append((split, width, 1, _block(last, 1), 0 if narrow
                     else n_in))
    return runs


def _lane_sum(acc: torch.Tensor, split=None) -> torch.Tensor:
    """The lanes acc (L, n, m) added as neighbours, and for the outputs
    from `split` on (axis 1) as halves of the vector."""
    near = acc
    while near.shape[0] > 1:
        near = near[0::2] + near[1::2]
    if split is None or split >= acc.shape[1]:
        return near[0]
    half = acc
    while half.shape[0] > 1:
        h = half.shape[0] // 2
        half = half[:h] + half[h:]
    far = (torch.arange(acc.shape[1], device=acc.device) >= split)[:, None]
    return torch.where(far, half[0], near[0])


def _band_pass(x: torch.Tensor, lo: torch.Tensor, taps: torch.Tensor,
               order=(1, None, None)) -> torch.Tensor:
    """out[o, :] = the sum of taps[k, o] * x[lo[o] + k, :] over the band in
    f32 (x: (n_in, m) float32), in `order` = (lanes, block, main[, split,
    tail_fma]) over the absolute input index lo[o] + k
    (``horizontal_order``, ``vertical_order``; the outputs o from split on
    add their lanes as halves); the default is one fma chain in ascending
    order from 0.  A zero weight adds a zero, which changes no sum, so the
    band's zero padding changes no bit."""
    lanes, block, main = order[:3]
    split = order[3] if len(order) > 3 else None
    tail_fma = len(order) > 4 and order[4]
    n_in, n_out, m = x.shape[0], lo.shape[0], x.shape[1]
    block = block or n_in
    main = n_in if main is None else main
    idx = lo.long()
    rows = torch.arange(n_out, device=x.device)
    acc = torch.zeros((lanes, n_out, m), dtype=torch.float32,
                      device=x.device)
    total = torch.zeros((n_out, m), dtype=torch.float32, device=x.device)
    tail = torch.zeros_like(total)
    for t in range(taps.shape[0]):
        k = idx + t
        w, v = taps[t][:, None], x[k]
        flush = (k % block == 0) & (k < main)
        if bool(flush.any()):
            f = flush[:, None]
            total = torch.where(f, total + _lane_sum(acc, split), total)
            acc = torch.where(f, torch.zeros_like(acc), acc)
        in_tail = (k >= main)[:, None]
        lane = k % lanes
        cur = acc[lane, rows]
        acc[lane, rows] = torch.where(in_tail, cur, fma32(w, v, cur))
        if bool(in_tail.any()):
            tail = torch.where(in_tail, fma32(w, v, tail) if tail_fma
                               else w * v + tail, tail)
    return (total + _lane_sum(acc, split)) + tail


def resample_plain(img: torch.Tensor, lo_v, taps_v, lo_h, taps_h,
                   maxval: int) -> torch.Tensor:
    """The plain version of the resample kernel, on img's device: the
    vertical band's sum in ``vertical_order``, then the horizontal band's
    on the f32 intermediate in ``horizontal_order``, round (half to even),
    clip to [0, maxval], cast to uint8/uint16."""
    x = img.to(torch.float32)
    in_h, in_w = x.shape
    x = torch.cat([_band_pass(x[:, c0:c1], lo_v, taps_v, (lanes, b, main))
                   for c0, c1, lanes, b, main
                   in vertical_order(in_h, in_w, lo_v.shape[0])],
                  dim=1)
    x = _band_pass(x.T, lo_h, taps_h,
                   horizontal_order(in_w, lo_h.shape[0], x.shape[0])).T
    return torch.clamp(torch.round(x), 0, maxval).to(out_dtype(maxval))


def to_tensor(plane, device: torch.device) -> torch.Tensor:
    """A plane (numpy, read-only views included, or a tensor) on `device`."""
    if isinstance(plane, torch.Tensor):
        return plane.to(device)
    return torch.from_numpy(
        np.require(plane, requirements=["C", "W"])).to(device)


def resample_planes(specs, device=None) -> list:
    """Resample planes through their separable bands.  specs: (plane,
    out_h, out_w, kind, shift_in, shift_out, maxval) each, a plane being a
    numpy array or a tensor; the work runs on the first plane's device if
    it is a tensor, else on `device` (None: the CUDA card): one launch of
    the kernel for all of them on the card (up to three, of one sample
    size), the plain version plane by plane on the CPU.  Returns tensors
    there."""
    p0 = specs[0][0]
    dev = resolve_device(p0.device if isinstance(p0, torch.Tensor)
                         else device)
    items = []
    for plane, out_h, out_w, kind, shift_in, shift_out, maxval in specs:
        in_h, in_w = plane.shape
        sv = (float(shift_in[0]), float(shift_out[0]))
        sh = (float(shift_in[1]), float(shift_out[1]))
        x = to_tensor(plane, dev)
        items.append((x, *_band(in_h, out_h, kind, *sv, dev),
                      *_band(in_w, out_w, kind, *sh, dev), maxval,
                      (out_h, out_w, kind, sv, sh)))
    if dev.type == "cuda":
        from . import resample_cuda
        return resample_cuda.resample_frame([
            (x.contiguous(), *bands, mx,
             resample_cuda.planned(*x.shape, *geo, x.element_size(),
                                   out_dtype(mx).itemsize, dev))
            for x, *bands, mx, geo in items])
    return [resample_plain(x, *bands, mx) for x, *bands, mx, _geo in items]


def resample_plane(plane, out_h: int, out_w: int, kind: str = "lanczos",
                   shift_in=(0.0, 0.0), shift_out=(0.0, 0.0),
                   maxval: int = 255, device=None) -> torch.Tensor:
    """Resample one plane through its separable bands
    (``resample_planes`` of one plane)."""
    return resample_planes([(plane, out_h, out_w, kind, shift_in,
                             shift_out, maxval)], device)[0]


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
