#!/usr/bin/env python3
"""Where the resample kernel's time goes: ``csrc/resample.cu`` beside its
predecessor and its variants, timed on one NVIDIA GPU.

    python3 -m handbrake_tpu_torch.tools.ablate_resample

Builds, with nvcc at once, the kernel as it is, variants of it (the
source's switches defined ahead of a copy of the source, each checked to
be one the source reads): ``unfused`` (RESAMPLE_FUSED 0: the f32
intermediate tile goes to a global scratch plane and back), ``scalar``
(RESAMPLE_VEC 1: one column a thread in the vertical pass, the output
stored a sample at a time), five that leave phases out (RESAMPLE_PHASES:
``no_copies``, ``no_vertical``, ``no_horizontal``, ``no_stores``,
``copies_only``) and ``fast_only`` (RESAMPLE_SLOW 0: every band as one
chain), whose outputs are wrong and only their times mean something; the
kernel with other output tiles than its plan's first (``TILED``); and
``v1``, the kernel before its redesign (``resample_v1.cu`` beside this
tool: two launches a plane, a thread a sample, the intermediate in device
memory).  On the letterbox job's frame (``profile_job.letterbox_frames``:
3840x1608 film of a 3840x2160 frame, scaled to 1920x804 with lanczos,
4:2:0) it fails unless unfused, scalar and the tiles equal the kernel bit
for bit, and counts the samples where v1 (an ascending chain, not the
kernel's order) differs; then it times each in turns (v1, kernel,
unfused, scalar, the partial ones, the tiles, and back in the reverse
order; three rounds): CUDA events around 25 back-to-back frames (warm:
the planes stay in L2), and the median of 25 frames each after a 64 MB
write (cold L2).  Prints the card's name and power limit, each variant's
registers, local bytes, shared memory and blocks an SM, and one JSON
line.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..filters import resample_cuda
from ..filters.kernels import _band
from ..native.build import compile_shared, nvcc_command
from . import profile_job as pj

REPS, ROUNDS = 25, 3
FLUSH_BYTES = 64 << 20
OUT_W, OUT_H = 1920, 804
V1_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "resample_v1.cu")
# name -> the switches defined ahead of the kernel's source
SWITCHED = {"kernel": {}, "unfused": {"RESAMPLE_FUSED": 0},
            "scalar": {"RESAMPLE_VEC": 1},
            # phases left out (their outputs are wrong; times only)
            "no_copies": {"RESAMPLE_PHASES": 14},
            "no_vertical": {"RESAMPLE_PHASES": 13},
            "no_horizontal": {"RESAMPLE_PHASES": 3},
            "no_stores": {"RESAMPLE_PHASES": 7},
            "copies_only": {"RESAMPLE_PHASES": 1},
            "fast_only": {"RESAMPLE_SLOW": 0}}
PARTIAL = ("no_copies", "no_vertical", "no_horizontal", "no_stores",
           "copies_only", "fast_only")
# the kernel with other output tiles than the plan's first (rows, columns)
TILED = {"tile_8x128": (8, 128), "tile_32x128": (32, 128),
         "tile_16x64": (16, 64), "tile_16x256": (16, 256)}
ORDER = ("v1", "kernel", "unfused", "scalar", *PARTIAL, *TILED,
         *tuple(TILED)[::-1], *PARTIAL[::-1], "scalar", "unfused", "kernel",
         "v1")


def variant_source(src: str, switches: dict) -> str:
    """The source with `switches` defined ahead of it."""
    for k in switches:
        if f"#ifndef {k}\n" not in src:
            raise RuntimeError(f"ablation no longer applies: {k}")
    return "".join(f"#define {k} {v}\n" for k, v in switches.items()) + src


def _build(name, files, source):
    return ctypes.CDLL(compile_shared(
        f"resample_{name}", files,
        nvcc_command(source, resample_cuda.NVCC_FLAGS)))


def build() -> dict:
    with open(resample_cuda.SOURCE) as f:
        src = f.read()
    with open(V1_SOURCE) as f:
        v1 = f.read()
    with ThreadPoolExecutor(len(SWITCHED) + 1) as ex:
        futs = {k: ex.submit(_build, k, {"resample.cu": variant_source(
            src, sw)}, "resample.cu") for k, sw in SWITCHED.items()}
        futs["v1"] = ex.submit(_build, "v1", {"resample_v1.cu": v1},
                               "resample_v1.cu")
        libs = {k: f.result() for k, f in futs.items()}
    for k in SWITCHED:
        resample_cuda.bind(libs[k])
    ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    libs["v1"].resample_launch.restype = ci
    libs["v1"].resample_launch.argtypes = [
        vp, ci, ci, ci, vp, vp, ci, vp, vp, ci, vp, vp, ci, ci, ci, cf, ci,
        vp]
    return libs


def frame_planes(dev):
    """The letterbox job's first frame, cropped to its film, on `dev`."""
    y, u, v = pj.letterbox_frames(1)[0]
    return [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
            for p in (y, u, v)]


def _items(planes, dev, tiles=None):
    """resample_frame's items for the frame's planes, with the main path's
    plan, or with plans of the given tiles."""
    items = []
    for p, sh in zip(planes, (0.0, -0.25, -0.25)):
        o_h, o_w = (OUT_H, OUT_W) if sh == 0.0 else (OUT_H // 2, OUT_W // 2)
        bv = _band(p.shape[0], o_h, "lanczos", 0.0, 0.0, dev)
        bh = _band(p.shape[1], o_w, "lanczos", sh, sh, dev)
        pl = resample_cuda.planned(*p.shape, o_h, o_w, "lanczos", (0.0, 0.0),
                                   (sh, sh), 1, 1, dev)
        if tiles is not None:
            t = resample_cuda.plan(*p.shape, bv[0].cpu().numpy(),
                                   bv[1].shape[0], bh[0].cpu().numpy(),
                                   bh[1].shape[0], 1, 1, tiles)
            pl = (t, torch.from_numpy(t.row0).to(dev),
                  torch.from_numpy(t.col0).to(dev))
        items.append((p, *bv, *bh, 255, pl))
    return items


def launchers(libs, planes, dev):
    """name -> (a function that runs one frame, its outputs, the shared
    memory a block takes)."""
    items = _items(planes, dev)
    run = {}
    # the unfused variant's intermediate: a tile for each block the card
    # can hold (at most 8 blocks of 256 threads an SM)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(8 * sms * max(it[6][0].mid_floats for it in items),
                          dtype=torch.float32, device=dev)
    variants = [(k, libs[k], items, scratch if k == "unfused" else None)
                for k in SWITCHED]
    variants += [(k, libs["kernel"], _items(planes, dev, (t,)), None)
                 for k, t in TILED.items()]
    for k, lib, its, scr in variants:
        outs, args, keep = resample_cuda.prepare(its, scr)

        def one(lib=lib, args=args, keep=keep):
            if lib.resample_frame_launch(*args) != 0:
                raise RuntimeError("resample launch failed")
        run[k] = (one, outs, args[1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    v1_args, v1_outs = [], []
    for p, lo_v, taps_v, lo_h, taps_h, _mx, _pl in items:
        out = torch.empty((lo_v.shape[0], lo_h.shape[0]), dtype=torch.uint8,
                          device=dev)
        mid = torch.empty((lo_v.shape[0], p.shape[1]), dtype=torch.float32,
                          device=dev)
        v1_outs.append(out)
        v1_args.append(((p.data_ptr(), 1, p.shape[0], p.shape[1],
                         lo_v.data_ptr(), taps_v.data_ptr(),
                         taps_v.shape[0], lo_h.data_ptr(), taps_h.data_ptr(),
                         taps_h.shape[0], mid.data_ptr(), out.data_ptr(), 1,
                         out.shape[0], out.shape[1], 255.0, dev.index or 0,
                         stream), mid))

    def v1():
        for a, _mid in v1_args:
            if libs["v1"].resample_launch(*a) != 0:
                raise RuntimeError("v1 resample launch failed")
    run["v1"] = (v1, v1_outs, 0)
    run["_keep"] = (items, scratch, v1_args)
    return run


def timed(fn, flush=None) -> float:
    """Device ms of one frame fn() (after three to warm): with flush None,
    CUDA events around REPS back-to-back frames, divided by REPS (warm:
    the planes stay in L2); else the median of REPS frames, each alone
    between events after a write of the `flush` buffer (cold L2; the
    write is outside the events)."""
    for _ in range(3):
        fn()
    if flush is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / REPS
    times = []
    for i in range(REPS):
        flush.fill_(i & 0xff)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_resample: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    libs = build()
    attrs = {k: resample_cuda.kernel_attrs(1, 1, libs[k]) for k in SWITCHED}
    run = launchers(libs, frame_planes(dev), dev)
    exact = ("unfused", "scalar", *TILED)
    for k in ("kernel", "v1", *exact):
        run[k][0]()
    torch.cuda.synchronize()
    ref = run["kernel"][1]
    for k in exact:
        if not all(torch.equal(a, b) for a, b in zip(run[k][1], ref)):
            raise RuntimeError(f"resample variant {k} differs from the "
                               f"kernel")
    v1_differ = [int((a != b).sum()) for a, b in zip(run["v1"][1], ref)]
    print(f"resample variants {', '.join(exact)}: equal to the kernel; v1 "
          f"differs on {v1_differ} Y/U/V samples (its ascending chain) "
          f"({card})", flush=True)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    warm = {k: [] for k in set(ORDER)}
    cold = {k: [] for k in set(ORDER)}
    for _ in range(ROUNDS):
        for k in ORDER:
            warm[k].append(timed(run[k][0]))
            cold[k].append(timed(run[k][0], flush))
    ms = {k: statistics.median(v) for k, v in warm.items()}
    cold_ms = {k: statistics.median(v) for k, v in cold.items()}
    per_sm = {}
    for k in ("v1", "kernel", "unfused", "scalar", *PARTIAL, *TILED):
        extra = ""
        if k != "v1":
            lib = libs.get(k, libs["kernel"])
            per_sm[k] = resample_cuda.blocks_per_sm(run[k][2], 1, 1, lib)
            a = attrs.get(k, attrs["kernel"])
            extra = (f", {a['regs']} registers, {a['local_bytes']} local "
                     f"bytes, {run[k][2]} B of shared memory, {per_sm[k]} "
                     f"blocks an SM")
        print(f"resample {k} on the letterbox frame ({card}): "
              f"{ms[k]:.4f} ms warm, {cold_ms[k]:.4f} ms cold L2{extra}",
              flush=True)
    print(json.dumps({"card": card, "ms": ms, "cold_ms": cold_ms,
                      "attrs": attrs, "blocks_per_sm": per_sm,
                      "v1_differ": v1_differ}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
