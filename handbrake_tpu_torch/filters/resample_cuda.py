"""CUDA wrapper of the resample kernel (``csrc/resample.cu``) — the card's
path of ``handbrake_tpu/filters/kernels.py``'s ``_apply_separable`` for
the planes of a frame at once.

The kernel's one launch covers up to three planes: for each plane, its
bands (``kernels.resample_band``), its summation order
(``kernels.vertical_order``, ``kernels.horizontal_order``) and its tile
plan (``plan``: the output tile, the input window each tile row and
column needs, and the shared memory that takes), passed as one kernel
parameter; the source's note gives the design and its bounds.  The
source is compiled with nvcc for sm_90a, with ``--fmad=false``, once for
each pair of sample sizes in and out (``SAMPLE_BYTES``, a library each,
so that they build in parallel), on first use into the package's
``_build`` directory (keyed by the source hash) and loaded with ctypes.  The kernel runs on the current stream and does
not synchronise.  ``launches`` counts the calls of this process that
launched it; its plain twin is ``kernels.resample_plain``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import threading

import numpy as np
import torch

from ..native.build import compile_shared, nvcc_command
from .kernels import (horizontal_order, out_dtype, resample_band,
                      vertical_order)

SOURCE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "csrc", "resample.cu"))
# fmas only where the source writes them: the summation order is the
# contract with the plain version
NVCC_FLAGS = ("--fmad=false",)

MAX_PLANES = 3
# a block's shared memory: at most this much (the H100's 227 KB), and
# within SMEM_SHARED where a tile that small is planned, so that two
# blocks share an SM
SMEM_LIMIT = 232448
SMEM_SHARED = 113 * 1024
# output tiles (rows, columns) in the order tried; the columns stay a
# multiple of 16 (16-byte output stores)
TILES = ((16, 128), (8, 128), (16, 64), (8, 64), (4, 64), (4, 32), (2, 32),
         (1, 32), (1, 16))
# the widest window: the kernel splits its items by an f32 reciprocal of
# the window's four-column groups, exact up to 2048 of them
MAX_WIN_W = 8192

# the bytes of a sample in and out that a build holds (the source's
# RESAMPLE_IN and RESAMPLE_OUT)
SAMPLE_BYTES = ((1, 1), (1, 2), (2, 1), (2, 2))

launches = 0

_locks = {k: threading.Lock() for k in SAMPLE_BYTES}
_libs = {}

_ci, _cf, _vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_INTS = ("in_h", "in_w", "out_h", "out_w", "tv", "th", "in_bytes",
         "out_bytes")
_PLAN_INTS = ("tile_h", "tile_w", "tiles_y", "tiles_x", "first_tile",
              "win_h", "win_w", "v_lanes", "v_block", "v_block2", "v_split",
              "v_main", "v_main2", "h_lanes", "h_block", "h_main", "h_split",
              "h_tail_fma", "copy16", "store16")


class Plane(ctypes.Structure):
    """The source's struct Plane, field for field."""
    _fields_ = ([(n, _vp) for n in ("x", "out", "lo_v", "taps_v", "lo_h",
                                    "taps_h", "row0", "col0")]
                + [(n, _ci) for n in _INTS] + [("maxval", _cf)]
                + [(n, _ci) for n in _PLAN_INTS])


class Params(ctypes.Structure):
    """The source's struct Params."""
    _fields_ = [("p", Plane * MAX_PLANES), ("scratch", _vp),
                ("n_planes", _ci), ("n_tiles", _ci), ("stage_bytes", _ci),
                ("mid_floats", _ci)]


def load(in_bytes: int = 1, out_bytes: int = 1):
    """Build (once) and load the kernel library for these sample sizes."""
    key = (in_bytes, out_bytes)
    if key not in _locks:
        raise ValueError(f"resample: no kernel for {in_bytes}-byte samples "
                         f"in and {out_bytes}-byte out")
    with _locks[key]:
        if key not in _libs:
            with open(SOURCE) as f:
                src = f.read()
            so = compile_shared(
                f"resample{in_bytes}{out_bytes}", {"resample.cu": src},
                nvcc_command("resample.cu", NVCC_FLAGS + (
                    f"-DRESAMPLE_IN={in_bytes}",
                    f"-DRESAMPLE_OUT={out_bytes}")))
            _libs[key] = bind(ctypes.CDLL(so))
        return _libs[key]


def bind(lib):
    """Set the argument types of a build of the source; checks that its
    Params is the one mirrored here."""
    lib.resample_frame_launch.restype = _ci
    lib.resample_frame_launch.argtypes = [ctypes.POINTER(Params), _ci, _ci,
                                          _vp]
    lib.resample_params_size.restype = _ci
    lib.resample_kernel_attrs.restype = _ci
    lib.resample_kernel_attrs.argtypes = [_ci, _ci, ctypes.POINTER(_ci),
                                          ctypes.POINTER(_ci)]
    lib.resample_blocks_per_sm.restype = _ci
    lib.resample_blocks_per_sm.argtypes = [_ci, _ci, _ci, ctypes.POINTER(_ci)]
    if lib.resample_params_size() != ctypes.sizeof(Params):
        raise RuntimeError("resample.cu's Params differs from its mirror in "
                           "resample_cuda.py")
    return lib


def kernel_attrs(in_bytes: int = 1, out_bytes: int = 1, lib=None) -> dict:
    """The compiled kernel's registers a thread and local (spill) bytes
    for these sample sizes."""
    regs, local = _ci(), _ci()
    rc = (lib or load(in_bytes, out_bytes)).resample_kernel_attrs(
        in_bytes, out_bytes, ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"resample kernel attributes: cudaError {rc}")
    return {"regs": regs.value, "local_bytes": local.value}


def blocks_per_sm(smem: int, in_bytes: int = 1, out_bytes: int = 1,
                  lib=None) -> int:
    """Blocks of the kernel an SM holds at `smem` bytes of shared memory
    (the persistent grid is this times the SMs)."""
    n = _ci()
    rc = (lib or load(in_bytes, out_bytes)).resample_blocks_per_sm(
        in_bytes, out_bytes, smem, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"resample occupancy: cudaError {rc}")
    return n.value


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A plane's tiling: output tiles of tile_h x tile_w, the first input
    row (row0, one a tile row) and column (col0, one a tile column,
    aligned down to 16 bytes) of each tile's window, the window's rows and
    columns (win_h, win_w: the largest a tile needs, win_w a whole number
    of 16 bytes), the bands' tap counts (tv, th) and the shared memory a
    block takes for it."""
    tile_h: int
    tile_w: int
    row0: np.ndarray
    col0: np.ndarray
    win_h: int
    win_w: int
    tv: int
    th: int
    in_bytes: int
    out_bytes: int

    @property
    def tiles(self) -> int:
        return self.row0.size * self.col0.size

    @property
    def stage_bytes(self) -> int:
        """A ring stage: the window, then the tile's taps (f32) and band
        starts (int32), in whole 16 bytes."""
        n = (self.win_h * self.win_w * self.in_bytes
             + 4 * (self.tv * self.tile_h + self.th * self.tile_w
                    + self.tile_h + self.tile_w))
        return -(-n // 16) * 16

    @property
    def mid_floats(self) -> int:
        return self.tile_h * self.win_w

    @property
    def smem(self) -> int:
        return smem_bytes([self])


def smem_bytes(plans) -> int:
    """Shared memory of a block running these plans' tiles: two ring
    stages of the largest, the largest f32 tile and the largest output
    tile."""
    return (2 * max(p.stage_bytes for p in plans)
            + 4 * max(p.mid_floats for p in plans)
            + max(p.tile_h * p.tile_w * p.out_bytes for p in plans))


def _spans(lo, n_taps, tile):
    """Per tile of `tile` outputs: the least band start, and the end of
    the furthest band."""
    starts = np.arange(0, lo.size, tile)
    return (np.minimum.reduceat(lo, starts),
            np.maximum.reduceat(lo, starts) + n_taps)


def plan(in_h: int, in_w: int, lo_v, n_taps_v: int, lo_h, n_taps_h: int,
         in_bytes: int, out_bytes: int, tiles=TILES) -> TilePlan:
    """Tile plan of one plane for its bands (lo_v, lo_h: host int arrays
    of the output rows' and columns' first input index; the bands' tap
    counts): the first of `tiles` whose block fits SMEM_SHARED, else the
    first that fits SMEM_LIMIT.  Raises ValueError where no tile fits."""
    lo_v = np.asarray(lo_v, np.int64)
    lo_h = np.asarray(lo_h, np.int64)
    align = 16 // in_bytes
    fits = []
    for tile_h, tile_w in tiles:
        tile_h = min(tile_h, lo_v.size)
        r_lo, r_hi = _spans(lo_v, n_taps_v, tile_h)
        c_lo, c_hi = _spans(lo_h, n_taps_h, tile_w)
        col0 = c_lo - c_lo % align
        win_w = int((c_hi - col0).max())
        p = TilePlan(tile_h, tile_w, r_lo.astype(np.int32),
                     col0.astype(np.int32), int((r_hi - r_lo).max()),
                     -(-win_w // align) * align, n_taps_v, n_taps_h,
                     in_bytes, out_bytes)
        if p.win_w > MAX_WIN_W:
            continue
        if p.smem <= SMEM_SHARED:
            return p
        fits.append(p)
    for p in fits:
        if p.smem <= SMEM_LIMIT:
            return p
    raise ValueError(
        f"resample_cuda: no tile fits {SMEM_LIMIT} bytes of shared memory "
        f"and {MAX_WIN_W} window columns for {in_w}x{in_h} to "
        f"{lo_h.size}x{lo_v.size} with {n_taps_v} x {n_taps_h} taps")


@functools.lru_cache(maxsize=64)
def planned(in_h: int, in_w: int, out_h: int, out_w: int, kind: str,
            shift_v: tuple, shift_h: tuple, in_bytes: int, out_bytes: int,
            device: torch.device) -> tuple:
    """plan() of a geometry's bands, with its window origins on `device`,
    made once per geometry."""
    lo_v, taps_v = resample_band(in_h, out_h, kind, *shift_v)
    lo_h, taps_h = resample_band(in_w, out_w, kind, *shift_h)
    p = plan(in_h, in_w, lo_v, taps_v.shape[0], lo_h, taps_h.shape[0],
             in_bytes, out_bytes)
    return p, torch.from_numpy(p.row0).to(device), \
        torch.from_numpy(p.col0).to(device)


def vector_path(ptr: int, width: int, sample_bytes: int) -> bool:
    """Whether rows of `width` samples from address `ptr` allow 16-byte
    copies (cp.async) or stores: the base and the pitch 16-byte aligned."""
    return ptr % 16 == 0 and (width * sample_bytes) % 16 == 0


def _check_band(name, lo, taps, n_out, n_in, device):
    ok = (lo.device == device and taps.device == device
          and lo.dtype == torch.int32 and taps.dtype == torch.float32
          and lo.dim() == 1 and taps.dim() == 2 and lo.shape[0] == n_out
          and taps.shape[1] == n_out and 1 <= taps.shape[0] <= n_in
          and lo.is_contiguous() and taps.is_contiguous())
    if not ok:
        raise ValueError(
            f"resample_cuda: the {name} band is lo {lo.dtype} "
            f"{tuple(lo.shape)}, taps {taps.dtype} {tuple(taps.shape)} on "
            f"{lo.device}, expected contiguous int32 ({n_out},) and float32 "
            f"(T <= {n_in}, {n_out}) on {device}")


def _check_plane(x, dev):
    if x.device != dev or x.device.type != "cuda":
        raise ValueError(f"resample_cuda: tensors must be on one CUDA "
                         f"device, got {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.uint8, torch.uint16) \
            or not x.is_contiguous():
        raise ValueError(f"resample_cuda: the plane is {x.dtype} "
                         f"{tuple(x.shape)} (contiguous: "
                         f"{x.is_contiguous()}), expected a contiguous 2-D "
                         f"uint8 or uint16 plane")


def prepare(items, scratch=None):
    """Check the planes and fill the kernel's parameter.  items: up to
    MAX_PLANES tuples (x, lo_v, taps_v, lo_h, taps_h, maxval[, plan]),
    plan being ``planned()``'s (plan, row0, col0) for these bands or
    absent (then it is made here, which waits for the card to copy the
    bands' starts).  Returns (the outputs, launch arguments of
    ``resample_frame_launch``, the objects they point into).
    ``resample_frame`` is the entry; this split lets a timing loop launch
    without the checks.  `scratch` (f32 on the card) is the unfused
    ablation variant's intermediate."""
    if not 1 <= len(items) <= MAX_PLANES:
        raise ValueError(f"resample_cuda: 1 to {MAX_PLANES} planes a call, "
                         f"got {len(items)}")
    dev = items[0][0].device
    prm = Params()
    outs, keep, plans = [], [prm, scratch], []
    first = 0
    for i, item in enumerate(items):
        x, lo_v, taps_v, lo_h, taps_h, maxval = item[:6]
        _check_plane(x, dev)
        if not 0 < maxval < 65536:
            raise ValueError(f"resample_cuda: maxval {maxval} above 16 "
                             f"bits")
        in_h, in_w = x.shape
        out_h, out_w = lo_v.shape[0], lo_h.shape[0]
        _check_band("vertical", lo_v, taps_v, out_h, in_h, dev)
        _check_band("horizontal", lo_h, taps_h, out_w, in_w, dev)
        out = torch.empty((out_h, out_w), dtype=out_dtype(maxval),
                          device=dev)
        if len(item) > 6 and item[6] is not None:
            p, row0, col0 = item[6]
        else:
            p = plan(in_h, in_w, lo_v.cpu().numpy(), taps_v.shape[0],
                     lo_h.cpu().numpy(), taps_h.shape[0], x.element_size(),
                     out.element_size())
            row0 = torch.from_numpy(p.row0).to(dev)
            col0 = torch.from_numpy(p.col0).to(dev)
        if (p.in_bytes, p.out_bytes) != (x.element_size(),
                                         out.element_size()) \
                or p.row0.size * p.tile_h < out_h \
                or p.col0.size * p.tile_w < out_w:
            raise ValueError("resample_cuda: the tile plan is not this "
                             "plane's")
        if plans and (p.in_bytes, p.out_bytes) != (plans[0].in_bytes,
                                                   plans[0].out_bytes):
            raise ValueError("resample_cuda: the planes of one call must "
                             "share their sample sizes")
        runs = vertical_order(in_h, in_w, out_h)
        h_lanes, h_block, h_main, h_split, h_tail_fma = horizontal_order(
            in_w, out_w, out_h)
        pl = prm.p[i]
        for name, t in (("x", x), ("out", out), ("lo_v", lo_v),
                        ("taps_v", taps_v), ("lo_h", lo_h),
                        ("taps_h", taps_h), ("row0", row0),
                        ("col0", col0)):
            setattr(pl, name, t.data_ptr())
        for name, v in (("in_h", in_h), ("in_w", in_w), ("out_h", out_h),
                        ("out_w", out_w), ("tv", taps_v.shape[0]),
                        ("th", taps_h.shape[0]),
                        ("in_bytes", p.in_bytes),
                        ("out_bytes", p.out_bytes), ("maxval", maxval),
                        ("tile_h", p.tile_h), ("tile_w", p.tile_w),
                        ("tiles_y", p.row0.size), ("tiles_x", p.col0.size),
                        ("first_tile", first), ("win_h", p.win_h),
                        ("win_w", p.win_w), ("v_lanes", runs[0][2]),
                        ("v_block", runs[0][3]), ("v_block2", runs[-1][3]),
                        ("v_split", runs[0][1]), ("v_main", runs[0][4]),
                        ("v_main2", runs[-1][4]),
                        ("h_lanes", h_lanes), ("h_block", h_block),
                        ("h_main", h_main), ("h_split", h_split),
                        ("h_tail_fma", int(h_tail_fma)),
                        ("copy16", int(vector_path(x.data_ptr(), in_w,
                                                   p.in_bytes))),
                        ("store16", int(vector_path(out.data_ptr(), out_w,
                                                    p.out_bytes)))):
            setattr(pl, name, v)
        first += p.tiles
        plans.append(p)
        outs.append(out)
        keep += [x, lo_v, taps_v, lo_h, taps_h, row0, col0, out]
    prm.scratch = None if scratch is None else scratch.data_ptr()
    prm.n_planes = len(items)
    prm.n_tiles = first
    prm.stage_bytes = max(p.stage_bytes for p in plans)
    prm.mid_floats = max(p.mid_floats for p in plans)
    smem = smem_bytes(plans)
    args = (ctypes.byref(prm), smem, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    return outs, args, keep


def resample_frame(items) -> list:
    """Resample up to three planes on the card in one launch: each item
    (x, lo_v, taps_v, lo_h, taps_h, maxval[, plan]) as ``prepare`` takes
    it, x uint8 or uint16 on CUDA, all of one sample size in and out;
    returns each (out_h, out_w) plane, uint8 for maxval <= 255, else
    uint16.  Raises on any other dtype, shape or device, and where the
    launch fails.  resample_band keeps every band inside the plane; that
    is not checked here, as it would wait for the card."""
    global launches
    outs, args, _keep = prepare(items)
    rc = load(items[0][0].element_size(),
              outs[0].element_size()).resample_frame_launch(*args)
    if rc != 0:
        raise RuntimeError(f"resample launch failed: cudaError {rc}")
    launches += 1
    return outs


def resample_cuda(x, lo_v, taps_v, lo_h, taps_h, maxval: int
                  ) -> torch.Tensor:
    """One plane through ``resample_frame``: x through the vertical band
    (lo_v, taps_v) and the horizontal band (lo_h, taps_h) of
    ``kernels.resample_band``, on x's device."""
    return resample_frame([(x, lo_v, taps_v, lo_h, taps_h, maxval)])[0]
