"""CUDA wrapper of the banded resample kernel (``csrc/resample.cu``) — the
card's path of ``handbrake_tpu/filters/kernels.py``'s
``_apply_separable`` for one plane.

The kernel's two launches (the vertical band into an f32 scratch plane,
then the horizontal band, the rounding, the clip and the cast) take the
bands of ``kernels.resample_band``; the source's note gives the design
and its bounds.  The source is compiled with nvcc for sm_90a, with
``--fmad=false``, on first use into the package's ``_build`` directory
(keyed by the source hash) and loaded with ctypes.  The kernel runs on
the current stream and does not synchronise.  ``launches`` counts the
calls of this process that launched it; its plain twin is
``kernels.resample_plain``.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..native.build import compile_shared, nvcc_command
from .kernels import out_dtype

SOURCE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "csrc", "resample.cu"))
# fmas only where the source writes them: the summation order is the
# contract with the plain version
NVCC_FLAGS = ("--fmad=false",)

launches = 0

_lock = threading.Lock()
_lib = [None]


def load():
    """Build (once) and load the kernel library."""
    with _lock:
        if _lib[0] is None:
            with open(SOURCE) as f:
                src = f.read()
            so = compile_shared("resample", {"resample.cu": src},
                                nvcc_command("resample.cu", NVCC_FLAGS))
            lib = ctypes.CDLL(so)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.resample_launch.restype = ci
            lib.resample_launch.argtypes = [
                vp, ci, ci, ci, vp, vp, ci, vp, vp, ci, vp, vp, ci, ci, ci,
                cf, ci, vp]
            _lib[0] = lib
        return _lib[0]


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


def prepare(x, lo_v, taps_v, lo_h, taps_h, maxval: int):
    """Check the arguments and allocate the output and the scratch plane;
    returns (out, launch arguments of ``resample_launch``, the buffers
    they point into).  ``resample_cuda`` is the entry; this split lets a
    timing loop launch without the checks."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"resample_cuda: tensors must be on CUDA, got {dev}")
    if x.dim() != 2 or x.dtype not in (torch.uint8, torch.uint16) \
            or not x.is_contiguous():
        raise ValueError(f"resample_cuda: the plane is {x.dtype} "
                         f"{tuple(x.shape)} (contiguous: "
                         f"{x.is_contiguous()}), expected a contiguous 2-D "
                         f"uint8 or uint16 plane")
    if not 0 < maxval < 65536:
        raise ValueError(f"resample_cuda: maxval {maxval} above 16 bits")
    in_h, in_w = x.shape
    out_h, out_w = lo_v.shape[0], lo_h.shape[0]
    _check_band("vertical", lo_v, taps_v, out_h, in_h, dev)
    _check_band("horizontal", lo_h, taps_h, out_w, in_w, dev)
    dt = out_dtype(maxval)
    out = torch.empty((out_h, out_w), dtype=dt, device=dev)
    mid = torch.empty((out_h, in_w), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), x.element_size(), in_h, in_w, lo_v.data_ptr(),
            taps_v.data_ptr(), taps_v.shape[0], lo_h.data_ptr(),
            taps_h.data_ptr(), taps_h.shape[0], mid.data_ptr(),
            out.data_ptr(), out.element_size(), out_h, out_w, float(maxval),
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    return out, args, (x, lo_v, taps_v, lo_h, taps_h, mid, out)


def resample_cuda(x, lo_v, taps_v, lo_h, taps_h, maxval: int
                  ) -> torch.Tensor:
    """Resample a plane on the card: x (uint8 or uint16, on CUDA) through
    the vertical band (lo_v, taps_v) and the horizontal band (lo_h,
    taps_h) of ``kernels.resample_band``, on x's device; returns the
    (out_h, out_w) plane, uint8 for maxval <= 255, else uint16.  Raises on
    any other dtype, shape or device.  resample_band keeps every band
    inside the plane; that is not checked here, as it would wait for the
    card."""
    global launches
    out, args, _keep = prepare(x, lo_v, taps_v, lo_h, taps_h, maxval)
    rc = load().resample_launch(*args)
    if rc != 0:
        raise RuntimeError(f"resample launch failed: cudaError {rc}")
    launches += 1
    return out
