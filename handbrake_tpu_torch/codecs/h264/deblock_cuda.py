"""CUDA wrapper of the H.264 deblock kernel (``csrc/deblock264.cu``) —
the counterpart of ``handbrake_tpu/codecs/h264/deblock_pallas.py``.

The source is compiled with nvcc for sm_90a on first use into the
package's ``_build`` directory (keyed by the source hash) and loaded
with ctypes.  The kernel launches on the current stream and does not
synchronise.  ``launches`` counts the kernel launches of this process;
its plain twin is ``deblock_torch.deblock_plain``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np
import torch

from ...native.build import compile_shared

SOURCE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "csrc",
    "deblock264.cu"))

launches = 0

_lock = threading.Lock()
_lib = [None]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or "nvcc")


def _nvcc_cmd(workdir, out):
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            os.path.join(workdir, "deblock264.cu"), "-o", out]


def load():
    """Build (once) and load the kernel library."""
    with _lock:
        if _lib[0] is None:
            with open(SOURCE) as f:
                src = f.read()
            so = compile_shared("deblock264", {"deblock264.cu": src},
                                _nvcc_cmd)
            lib = ctypes.CDLL(so)
            vp = ctypes.c_void_p
            lib.deblock264_launch.restype = ctypes.c_int
            lib.deblock264_launch.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                vp, ctypes.c_int, ctypes.c_int, vp]
            _lib[0] = lib
        return _lib[0]


def _check(name, t, dtype, shape, device):
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


def deblock_cuda(ry, ru, rv, bs_v, bs_h, scal, with_strong):
    """Launch the kernel: filtered copies of the uint8 planes
    (ry (H,W), ru/rv (H/2,W/2)) given bS (mb_h, mb_w, 4, 4) int32 and
    scal int32[10] from deblock_scal."""
    global launches
    dev = ry.device
    if dev.type != "cuda":
        raise ValueError(f"deblock_cuda: tensors must be on CUDA, "
                         f"got {dev}")
    H, W = ry.shape
    if H % 16 or W % 16:
        raise ValueError(f"deblock_cuda: plane {H}x{W} is not MB-aligned")
    mb_h, mb_w = H // 16, W // 16
    _check("ry", ry, torch.uint8, (H, W), dev)
    _check("ru", ru, torch.uint8, (H // 2, W // 2), dev)
    _check("rv", rv, torch.uint8, (H // 2, W // 2), dev)
    _check("bs_v", bs_v, torch.int32, (mb_h, mb_w, 4, 4), dev)
    _check("bs_h", bs_h, torch.int32, (mb_h, mb_w, 4, 4), dev)
    sc = np.ascontiguousarray(scal, np.int32)
    if sc.shape != (10,):
        raise ValueError(f"deblock_cuda: scal has shape {sc.shape}")
    lib = load()
    oy, ou, ov = (torch.empty_like(p) for p in (ry, ru, rv))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.deblock264_launch(
        ry.data_ptr(), ru.data_ptr(), rv.data_ptr(),
        oy.data_ptr(), ou.data_ptr(), ov.data_ptr(),
        bs_v.data_ptr(), bs_h.data_ptr(), mb_w, mb_h,
        sc.ctypes.data, int(bool(with_strong)), dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"deblock264 launch failed: cudaError {rc}")
    launches += 1
    return oy, ou, ov
