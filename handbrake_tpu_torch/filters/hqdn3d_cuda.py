"""CUDA wrapper of the hqdn3d kernel (``csrc/hqdn3d.cu``) — the card's
path of ``handbrake_tpu/filters/denoise.py``'s ``hqdn3d_plane`` for all
planes of a frame at once.

The kernel's two launches (32 rows a block for the horizontal pass, 32
columns a block for the vertical and temporal passes, the rescale and the
new f32 state; in each block one warp runs the recurrence on samples that
other warps stage through shared memory) cover every plane; the source's
note gives the design and its bounds.  The source is compiled with nvcc
for sm_90a on first use into the package's ``_build`` directory (keyed by
the source hash) and loaded with ctypes.  The kernel runs on the current
stream and does not synchronise.  ``launches`` counts the calls of this
process that launched it; its plain twin is ``denoise.hqdn3d_plane``.

``chain_probe`` and ``div_check`` run the source's two measurement
entries: the cycles of one dependent low-pass step, and the kernel's
division by 255 against the IEEE one over every f32 in [0, 256).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ..native.build import compile_shared, nvcc_command
from .kernels import out_dtype

SOURCE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "csrc", "hqdn3d.cu"))

launches = 0
# the f32 bit patterns below 256.0f's: every value |prev - cur| can take
DIV_CHECK_END = int(np.float32(256.0).view(np.uint32))

_lock = threading.Lock()
_lib = [None]


def load():
    """Build (once) and load the kernel library."""
    with _lock:
        if _lib[0] is None:
            with open(SOURCE) as f:
                src = f.read()
            so = compile_shared("hqdn3d", {"hqdn3d.cu": src},
                                nvcc_command("hqdn3d.cu"))
            lib = ctypes.CDLL(so)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.hqdn3d_launch.restype = ci
            lib.hqdn3d_launch.argtypes = [
                ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, cf, cf, ci, ci,
                vp]
            lib.hqdn3d_chain_probe.restype = ci
            lib.hqdn3d_chain_probe.argtypes = [ci, cf, ci, vp, vp, ci, vp]
            lib.hqdn3d_div_check.restype = ci
            lib.hqdn3d_div_check.argtypes = [ctypes.c_uint, vp, vp, vp, ci,
                                             vp]
            _lib[0] = lib
        return _lib[0]


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"hqdn3d_cuda: {name} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous: {t.is_contiguous()}), expected a "
            f"contiguous {dtype} {tuple(shape)} on {device}")


def prepare(planes, ants, g_sp, g_tmp, maxval: int):
    """Check the arguments and allocate outputs and scratch; returns
    ([(out, new_ant)], launch arguments of ``hqdn3d_launch``, the buffers
    the launch arguments point into).  ``hqdn3d_cuda`` is the entry; this
    split lets a timing loop launch without the checks."""
    n = len(planes)
    if not 1 <= n <= 3 or not (len(ants) == len(g_sp) == len(g_tmp) == n):
        raise ValueError(f"hqdn3d_cuda: {n} planes, {len(ants)} states, "
                         f"{len(g_sp)} and {len(g_tmp)} gammas")
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"hqdn3d_cuda: tensors must be on CUDA, got {dev}")
    if not 0 < maxval < 65536:
        raise ValueError(f"hqdn3d_cuda: maxval {maxval} above 16 bits")
    dt = out_dtype(maxval)
    outs, keep = [], []
    ptrs = {k: [] for k in ("src", "ant", "hbuf", "out", "ant_out")}
    for i, (p, a) in enumerate(zip(planes, ants)):
        if p.dim() != 2:
            raise ValueError(f"hqdn3d_cuda: plane {i} is not 2-D")
        _check(f"plane {i}", p, dt, p.shape, dev)
        _check(f"state {i}", a, torch.float32, p.shape, dev)
        o, ao = torch.empty_like(p), torch.empty_like(a)
        hb = torch.empty_like(a) if g_sp[i] > 0.0 else None
        outs.append((o, ao))
        keep += [p, a, o, ao, hb]
        for k, t in zip(ptrs, (p, a, hb, o, ao)):
            ptrs[k].append(None if t is None else t.data_ptr())
    arr = {k: (ctypes.c_void_p * n)(*v) for k, v in ptrs.items()}
    dims_h = (ctypes.c_int * n)(*(p.shape[0] for p in planes))
    dims_w = (ctypes.c_int * n)(*(p.shape[1] for p in planes))
    gs = (ctypes.c_float * n)(*g_sp)
    gt = (ctypes.c_float * n)(*g_tmp)
    args = (n, arr["src"], arr["ant"], arr["hbuf"], arr["out"],
            arr["ant_out"], dims_h, dims_w, gs, gt, 1 if maxval <= 255 else 2,
            255.0 / maxval, maxval / 255.0, maxval, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    return outs, args, keep


def hqdn3d_cuda(planes, ants, g_sp, g_tmp, maxval: int) -> list:
    """Denoise a frame's planes on the card: planes (uint8 for maxval <=
    255, else uint16) and their f32 states of the same shape, per-plane
    spatial and temporal gammas.  Returns [(out plane, new state)].
    Raises on any other dtype, shape or device."""
    global launches
    outs, args, _keep = prepare(planes, ants, g_sp, g_tmp, maxval)
    rc = load().hqdn3d_launch(*args)
    if rc != 0:
        raise RuntimeError(f"hqdn3d launch failed: cudaError {rc}")
    launches += 1
    return outs


def _stream():
    dev = torch.device("cuda", torch.cuda.current_device())
    return dev, torch.cuda.current_stream(dev).cuda_stream


def chain_probe(steps: int, gamma: float, ieee_div: bool) -> dict:
    """One warp through `steps` dependent low-pass steps at `gamma`, on
    register values only, with the kernel's division or ``__fdiv_rn``:
    {"cycles": clock64 cycles a step, "ms": CUDA-event ms a step (launch
    included, so take `steps` large)}."""
    dev, st = _stream()
    out = torch.empty(32, dtype=torch.float32, device=dev)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = load()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    rc = lib.hqdn3d_chain_probe(steps, gamma, int(ieee_div), out.data_ptr(),
                                cyc.data_ptr(), dev.index, st)
    b.record()
    if rc != 0:
        raise RuntimeError(f"hqdn3d_chain_probe failed: cudaError {rc}")
    b.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("hqdn3d_chain_probe: non-finite results")
    return {"cycles": int(cyc.item()) / steps,
            "ms": a.elapsed_time(b) / steps}


def div_check() -> dict:
    """The kernel's division by 255 against ``__fdiv_rn`` on the card, bit
    for bit, for every f32 in [0, 256): {"checked" (the values the kernel
    compared, which it counts), "mismatches", "first_bad" (the smallest
    differing bit pattern, or None)}."""
    dev, st = _stream()
    checked = torch.zeros(1, dtype=torch.int64, device=dev)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    first = torch.full((1,), -1, dtype=torch.int32, device=dev)
    rc = load().hqdn3d_div_check(DIV_CHECK_END, checked.data_ptr(),
                                 bad.data_ptr(), first.data_ptr(), dev.index,
                                 st)
    if rc != 0:
        raise RuntimeError(f"hqdn3d_div_check failed: cudaError {rc}")
    n_bad = int(bad.item())
    return {"checked": int(checked.item()), "mismatches": n_bad,
            "first_bad": (int(first.item()) & 0xFFFFFFFF) if n_bad else None}
