#!/usr/bin/env python3
"""Where the deblock kernel's time goes: ablations of ``csrc/deblock264.cu``
timed on one NVIDIA GPU.

    python3 -m handbrake_tpu_torch.tools.ablate_deblock264

Builds the kernel as it is and variants of it with one part taken out
(by editing a copy of the source; every edit is checked to apply), all
with nvcc at once, then times each at 1080p (120x68 MBs, the analyzer's
``with_strong=False``) on two inputs: "quiet", where every bS is 0 (as on
most MBs of a main-path P frame), and "noisy", where most edges filter.
The variants' outputs are wrong by construction; only their times mean
something.  Each time is CUDA events around 25 back-to-back launches,
the median of three rounds, with the variants taken in turn within a
round.  The band variants show what spreading each plane over several
SMs gives.  Prints the card's name and power limit and one JSON line.
Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MB_W, MB_H = 120, 68
REPS, ROUNDS = 25, 3


def _cut(src, old, new):
    if old not in src:
        raise RuntimeError(f"ablation no longer applies: {old!r}")
    return src.replace(old, new)


def variants(src):
    """name -> kernel source.  Each removes one part of the work."""
    no_filter = _cut(src, "    for (int e = 0; e < BS / 4; e++) {\n",
                     "    for (int e = 0; e < 0; e++) {\n")
    no_stores = src
    for old, new in (
            ("            if (l < CL || last_row) *reinterpret_cast<Row*>"
             "(orow) = q;", ""),
            ("                    store_strip<HALO>(out + ((size_t)y * BS",
             "                    if (0) store_strip<HALO>(out + "
             "((size_t)y * BS"),
            ("                    *reinterpret_cast<Row*>(orow - BS * W) = "
             "*srow;", "                    ;")):
        no_stores = _cut(no_stores, old, new)
    tile_copy = ("        cp_async<BS>(tb + i * BS, in + (y * BS + r) * W + "
                 "x * BS);")
    no_loads = _cut(src, tile_copy, "        if (0)" + tile_copy[7:])
    return {
        "kernel": src,
        # the edge filters (bS still derived, lines still loaded/stored)
        "no_filter": no_filter,
        # every global store of a sample
        "no_stores": no_stores,
        # the cp.async of the tiles' rows (side data still copied, so
        # bS and the work stay as they are; the samples are stale)
        "no_tile_loads": no_loads,
        # neither: what is left is the CTAs' own work
        "no_stores_no_tile_loads": _cut(
            no_stores, tile_copy, "        if (0)" + tile_copy[7:]),
        # one band per plane: one CTA walks all of a plane's diagonals
        "one_band": _cut(src, "constexpr int kBandRows = 16;",
                         "constexpr int kBandRows = 1 << 20;"),
        # bands of about 8 MB rows instead of 16
        "band_rows_8": _cut(src, "constexpr int kBandRows = 16;",
                            "constexpr int kBandRows = 8;"),
    }


def build(workdir, name, src):
    from handbrake_tpu_torch.codecs.h264.deblock_cuda import _nvcc
    cu = os.path.join(workdir, f"{name}.cu")
    so = os.path.join(workdir, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v", cu, "-o", so],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{r.stderr}")
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", r.stderr)]
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.deblock264_launch.restype = ci
    lib.deblock264_launch.argtypes = [vp] * 11 + [ci, ci, vp, ci, ci, vp]
    return name, lib, regs


def inputs(dev):
    import torch
    rng = np.random.default_rng(1)
    n = MB_W * MB_H
    H, W = MB_H * 16, MB_W * 16

    def t(a):
        return torch.from_numpy(a).to(dev)

    planes = (t(rng.integers(90, 110, (H, W)).astype(np.uint8)),
              t(rng.integers(90, 110, (H // 2, W // 2)).astype(np.uint8)),
              t(rng.integers(90, 110, (H // 2, W // 2)).astype(np.uint8)))
    return {
        "quiet": (*planes, t(np.zeros((n, 2), np.int16)),
                  t(np.zeros((n, 16), np.int32)), None,
                  t(np.zeros(n, bool))),
        "noisy": (*planes, t(rng.integers(-20, 20, (n, 2)).astype(np.int16)),
                  t(rng.integers(0, 3, (n, 16)).astype(np.int32)), None,
                  t(rng.random(n) < 0.3)),
    }


def time_ms(lib, args):
    import torch
    for _ in range(3):
        if lib.deblock264_launch(*args) != 0:
            raise RuntimeError("launch failed")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        lib.deblock264_launch(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def main() -> int:
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.deblock import deblock_scal
    if not torch.cuda.is_available():
        print("ablate_deblock264: no CUDA device", file=sys.stderr)
        return 2
    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with open(deblock_cuda.SOURCE) as f:
        srcs = variants(f.read())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as wd, \
            ThreadPoolExecutor(len(srcs)) as ex:
        built = list(ex.map(lambda kv: build(wd, *kv), srcs.items()))
        data = inputs(dev)
        times = {}
        for _ in range(ROUNDS):
            for name, lib, _ in built:
                for k, v in data.items():
                    # fresh arguments: each library counts its launches
                    # from 1, so none may reuse another's progress buffer
                    args = deblock_cuda.prepare(*v, deblock_scal(30, 27),
                                                False)[1]
                    times.setdefault((name, k), []).append(
                        time_ms(lib, args))
    print(f"deblock264 ablations at 1080p ({label}); ms per launch, median "
          f"of {ROUNDS} rounds of {REPS} back-to-back launches:")
    rows = []
    for name, _, regs in built:
        q = statistics.median(times[(name, "quiet")])
        n = statistics.median(times[(name, "noisy")])
        print(f"  {name:24s} quiet {q:.4f}  noisy {n:.4f}  registers {regs}")
        rows.append({"variant": name, "quiet_ms": q, "noisy_ms": n,
                     "registers": regs})
    print(json.dumps({"card": label, "ablations": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
