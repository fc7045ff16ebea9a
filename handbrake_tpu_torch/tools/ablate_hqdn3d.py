#!/usr/bin/env python3
"""Where the hqdn3d kernel's time goes: variants of ``csrc/hqdn3d.cu``
timed on one NVIDIA GPU.

    python3 -m handbrake_tpu_torch.tools.ablate_hqdn3d

Builds the kernel as it is and variants of it (by editing a copy of the
source; every edit is checked to apply), all with nvcc at once, then
times each on a 1920x1080 4:2:0 frame of ``make_interlaced_clip`` with
the ``--hqdn3d`` preset's gammas.  Variants that change the arithmetic
give wrong outputs by construction; only their times mean something.
Each time is CUDA events around 25 back-to-back calls (each call is the
kernel's two launches), the median of three rounds, with the variants
taken in turn within a round.  Prints the card's name and power limit
and one JSON line.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.buffer import Geometry
from ..filters import hqdn3d_cuda
from ..filters.base import FilterInit
from ..filters.denoise import DenoiseFilter
from ..job import param
from ..job import schema as S
from ..native.build import compile_shared, nvcc_command
from ..utils.synth import make_interlaced_clip

W, H = 1920, 1080
REPS, ROUNDS = 25, 3


def _cut(src, old, new):
    if old not in src:
        raise RuntimeError(f"ablation no longer applies: {old!r}")
    return src.replace(old, new)


def variants(src):
    """name -> kernel source."""
    launch_v = "        vpass<uint8_t><<<gv, kThreads, 0, st>>>(a);\n"
    launch_h = "        if (spatial) hpass<uint8_t><<<gh, kThreads, 0, st>>>(a);\n"
    return {
        "kernel": src,
        # no loads ahead: each step's inputs loaded when it runs
        "chunk_1": _cut(src, "constexpr int kChunk = 8;",
                        "constexpr int kChunk = 1;"),
        # the chain with the fast approximate power and division
        "fast_pow_div": _cut(_cut(src, "powf(simil, g)", "__powf(simil, g)"),
                             "__fdiv_rn(fabsf(d), 255.0f)",
                             "__fdividef(fabsf(d), 255.0f)"),
        # the chain without the power at all
        "no_pow": _cut(src, "powf(simil, g)", "simil"),
        # one pass alone (8-bit planes)
        "hpass_only": _cut(src, launch_v, "\n"),
        "vpass_only": _cut(src, launch_h, "\n"),
    }


def _load(name, text):
    so = compile_shared(f"hqdn3d_{name}", {"hqdn3d.cu": text},
                        nvcc_command("hqdn3d.cu"))
    lib = ctypes.CDLL(so)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hqdn3d_launch.restype = ci
    lib.hqdn3d_launch.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                  ci, cf, cf, ci, ci, vp]
    return lib


def _time(lib, args):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        if lib.hqdn3d_launch(*args) != 0:
            raise RuntimeError("hqdn3d launch failed")
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_hqdn3d: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    with open(hqdn3d_cuda.SOURCE) as f:
        srcs = variants(f.read())
    with ThreadPoolExecutor(len(srcs)) as ex:
        futs = {k: ex.submit(_load, k, v) for k, v in srcs.items()}
        libs = {k: f.result() for k, f in futs.items()}
    f = DenoiseFilter(param.generate_filter_settings(S.FILTER_DENOISE,
                                                     "medium"))
    f.init(FilterInit(geometry=Geometry(W, H), device="cpu"))
    planes = [torch.from_numpy(p).cuda()
              for p in make_interlaced_clip(W, H, 1, seed=4)[0]]
    ants = [p.float() for p in planes]
    _out, args, _keep = hqdn3d_cuda.prepare(planes, ants, f.g_sp, f.g_tmp,
                                            255)
    for lib in libs.values():
        _time(lib, args)                    # warm
    times = {k: [] for k in libs}
    for _ in range(ROUNDS):
        for k, lib in libs.items():
            times[k].append(_time(lib, args))
    ms = {k: statistics.median(v) for k, v in times.items()}
    for k, v in ms.items():
        print(f"hqdn3d {k} at {W}x{H} 4:2:0 ({card}): {v:.4f} ms a call",
              flush=True)
    print(json.dumps({"card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
