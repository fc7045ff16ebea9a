"""CUDA wrapper of the H.264 deblock kernel (``csrc/deblock264.cu``) —
the counterpart of ``handbrake_tpu/codecs/h264/deblock_pallas.py``'s
``deblock``: the Pallas kernel and the ``compute_bs`` in front of it.

The kernel takes the planes and the per-MB side data (mv, nnz, t8,
intra) and derives bS itself.  Each plane is cut into bands of MB rows,
one CTA each, launched cooperatively; a CTA walks its band's MB
anti-diagonals a diagonal or two behind the band above, whose progress it
reads from a counter in global memory.  Each diagonal's tiles are
prefetched into shared memory with ``cp.async``, the strips later
diagonals still filter are carried there, and each line is filtered in
registers (the source's note gives the design and its bounds).  Each
sample is read once.

The source is compiled with nvcc for sm_90a on first use into the
package's ``_build`` directory (keyed by the source hash) and loaded
with ctypes.  The kernel launches on the current stream and does not
synchronise.  ``launches`` counts the kernel launches of this process;
its plain twin is ``deblock_torch.deblock_plain`` on
``deblock_torch.compute_bs``.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading

import torch

from ...native.build import compile_shared, nvcc_command

SOURCE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "csrc",
    "deblock264.cu"))

# the largest frame side the kernel takes, in samples (8192x4320, H.264
# level 6.2's largest frame, fits)
MAX_SIDE = 8192
# per-band progress counters the kernel hands on between its CTAs: bands
# per plane at most, times three planes (csrc/deblock264.cu kMaxBands)
N_DONE = 3 * 64

launches = 0

_lock = threading.Lock()
_lib = [None]


def load():
    """Build (once) and load the kernel library."""
    with _lock:
        if _lib[0] is None:
            with open(SOURCE) as f:
                src = f.read()
            so = compile_shared("deblock264", {"deblock264.cu": src},
                                nvcc_command("deblock264.cu"))
            lib = ctypes.CDLL(so)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.deblock264_launch.restype = ci
            lib.deblock264_launch.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, ci,
                ci, vp]
            _lib[0] = lib
        return _lib[0]


@functools.lru_cache(maxsize=None)
def _c_scal(scal: tuple):
    return (ctypes.c_int32 * 10)(*scal)


def _check(name, t, dtype, shape, device, align=1):
    if t.device != device:
        raise ValueError(f"deblock_cuda: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"deblock_cuda: {name} is {t.dtype}, "
                         f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"deblock_cuda: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"deblock_cuda: {name} is not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"deblock_cuda: {name} is not {align}-byte "
                         f"aligned")


def prepare(ry, ru, rv, mv, nnz, mb_intra, t8, scal, with_strong):
    """Check the arguments and allocate the outputs; returns (outputs,
    launch arguments of ``deblock264_launch``).  ``deblock_cuda`` is
    the entry; this split lets a timing loop launch without the
    checks."""
    dev = ry.device
    if dev.type != "cuda":
        raise ValueError(f"deblock_cuda: tensors must be on CUDA, "
                         f"got {dev}")
    H, W = ry.shape
    if H % 16 or W % 16 or H == 0 or W == 0:
        raise ValueError(f"deblock_cuda: plane {H}x{W} is not MB-aligned")
    if H > MAX_SIDE or W > MAX_SIDE:
        raise ValueError(
            f"deblock_cuda: a {W}x{H} frame is above the kernel's limit of "
            f"{MAX_SIDE} samples in width and height (8192x4320 fits)")
    mb_h, mb_w = H // 16, W // 16
    n_mb = mb_h * mb_w
    _check("ry", ry, torch.uint8, (H, W), dev, 16)
    _check("ru", ru, torch.uint8, (H // 2, W // 2), dev, 16)
    _check("rv", rv, torch.uint8, (H // 2, W // 2), dev, 16)
    _check("mv", mv, torch.int16, (n_mb, 2), dev, 4)
    _check("nnz", nnz, torch.int32, (n_mb, 16), dev, 16)
    for name, f in (("mb_intra", mb_intra), ("t8", t8)):
        if f is not None:
            _check(name, f, torch.bool, (n_mb,), dev)
    sc = tuple(int(v) for v in scal)
    if len(sc) != 10:
        raise ValueError(f"deblock_cuda: scal has {len(sc)} values, "
                         f"expected 10")
    outs = tuple(torch.empty_like(p) for p in (ry, ru, rv))
    # a buffer of its own for each call, so that launches on different
    # streams never share one
    done = torch.zeros(N_DONE, dtype=torch.int64, device=dev)
    args = (ry.data_ptr(), ru.data_ptr(), rv.data_ptr(),
            *(o.data_ptr() for o in outs), mv.data_ptr(), nnz.data_ptr(),
            None if mb_intra is None else mb_intra.data_ptr(),
            None if t8 is None else t8.data_ptr(), done.data_ptr(), mb_w,
            mb_h, _c_scal(sc), int(bool(with_strong)), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    return outs, args


def deblock_cuda(ry, ru, rv, mv, nnz, mb_intra, t8, scal, with_strong):
    """Launch the kernel: filtered copies of the uint8 planes (ry (H,W),
    ru/rv (H/2,W/2)) given the per-MB side data, mv (n_mb, 2) int16
    qpel, nnz (n_mb, 16) int32 per-4x4 counts (raster blocks), mb_intra
    and t8 (n_mb,) bool or None (all inter / no 8x8 transform), and scal,
    the 10 ints of ``deblock_scal``.  Raises on any other dtype, shape or
    device, and above the frame-size limit."""
    global launches
    outs, args = prepare(ry, ru, rv, mv, nnz, mb_intra, t8, scal,
                         with_strong)
    rc = load().deblock264_launch(*args)
    if rc != 0:
        raise RuntimeError(f"deblock264 launch failed: cudaError {rc}")
    launches += 1
    return outs
