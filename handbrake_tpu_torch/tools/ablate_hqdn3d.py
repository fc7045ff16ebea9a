#!/usr/bin/env python3
"""Where the hqdn3d kernel's time goes: variants of ``csrc/hqdn3d.cu``
timed on one NVIDIA GPU.

    python3 -m handbrake_tpu_torch.tools.ablate_hqdn3d

Builds the kernel as it is, variants of it (the source's switches,
defined ahead of a copy of the source; each is checked to be one the
source reads) and ``hqdn3d_ablate.cu``'s variants (beside this tool; it
includes the kernel's source), all with nvcc at once.  On a 1920x1080
4:2:0 frame of ``make_interlaced_clip`` with the ``--hqdn3d`` preset's
gammas it first runs every variant that computes what the kernel
computes and fails unless its outputs and f32 states equal the
kernel's, bit for bit; then it times each beside the chain floor that
the source's chain probe measures: luma's dependent steps (each pass
alone: its own) at the probe's cycles a step and the card's top SM
clock.  The variants that run one pass alone give wrong outputs; only
their times mean something.  Each time is CUDA events around 25
back-to-back calls (each call is the kernel's two launches), the median
of three rounds, with the variants taken in turn within a round.  Prints
the card's name and power limit and one JSON line.  Imports nothing of
JAX.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
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
PROBE_STEPS = 1 << 16

STEPS = (W - 1) + (H - 1)      # luma's horizontal, then vertical steps

ABLATION_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "hqdn3d_ablate.cu")

# name -> (the switches it sets ahead of the kernel's source, or its
# variant in hqdn3d_ablate.cu; luma's dependent steps it runs; whether
# its outputs must equal the kernel's)
VARIANTS = {
    "kernel": ({}, STEPS, True),
    # no staging: the chain warp alone on global memory, each step's
    # loads and stores and the temporal pass in the chain
    "chain_alone": (1, STEPS, True),
    # the temporal low-pass back on vpass's chain warp
    "temporal_in_chain": (2, STEPS, True),
    # the IEEE division in place of the reciprocal and its correction
    "fdiv_rn": ({"HQDN3D_IEEE_DIV": 1}, STEPS, True),
    # one pass alone
    "hpass_only": ({"HQDN3D_PASSES": 1}, W - 1, False),
    "vpass_only": ({"HQDN3D_PASSES": 2}, H - 1, False),
}


def variant_source(src: str, switches: dict) -> str:
    """The source with `switches` defined ahead of it."""
    for k in switches:
        if f"#ifndef {k}\n" not in src:
            raise RuntimeError(f"ablation no longer applies: {k}")
    return "".join(f"#define {k} {v}\n" for k, v in switches.items()) + src


def ablation_sources(src: str) -> dict:
    """The files of the ablation library: hqdn3d_ablate.cu and the
    kernel's source it includes."""
    with open(ABLATION_SOURCE) as f:
        abl = f.read()
    if '#include "hqdn3d.cu"' not in abl:
        raise RuntimeError("hqdn3d_ablate.cu no longer includes the kernel")
    return {"hqdn3d.cu": src, "hqdn3d_ablate.cu": abl}


_LAUNCH_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]


def _load(name, files, source):
    lib = ctypes.CDLL(compile_shared(f"hqdn3d_{name}", files,
                                     nvcc_command(source)))
    lib.hqdn3d_launch.restype = ctypes.c_int
    lib.hqdn3d_launch.argtypes = _LAUNCH_ARGS
    return lib


def build_variants(src: str) -> dict:
    """name -> a function of hqdn3d_launch's arguments that launches the
    variant; the kernel's variants and the ablation library are built in
    parallel."""
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        futs = {k: ex.submit(_load, k, {"hqdn3d.cu": variant_source(src, sw)},
                             "hqdn3d.cu")
                for k, (sw, _, _) in VARIANTS.items() if isinstance(sw, dict)}
        abl = ex.submit(_load, "ablate", ablation_sources(src),
                        "hqdn3d_ablate.cu").result()
        libs = {k: f.result() for k, f in futs.items()}
    abl.hqdn3d_ablate_launch.restype = ctypes.c_int
    abl.hqdn3d_ablate_launch.argtypes = [ctypes.c_int] + _LAUNCH_ARGS
    return {k: libs[k].hqdn3d_launch if isinstance(sw, dict)
            else functools.partial(abl.hqdn3d_ablate_launch, sw)
            for k, (sw, _, _) in VARIANTS.items()}


def _launch(fn, args):
    if fn(*args) != 0:
        raise RuntimeError("hqdn3d launch failed")


def check_exact(launch: dict, args, outs) -> None:
    """Runs each variant that must compute what the kernel computes on
    `args` (whose outputs are `outs`, set to zeros and NaN states before
    each run) and raises unless its outputs and states equal the
    kernel's."""
    ref = None
    for k, fn in launch.items():
        if not VARIANTS[k][2]:
            continue
        for o, ao in outs:
            o.zero_()
            ao.fill_(float("nan"))
        _launch(fn, args)
        torch.cuda.synchronize()
        got = [(o.clone(), ao.clone()) for o, ao in outs]
        if ref is None:
            ref = got
        elif not all(torch.equal(o, ro) and torch.equal(ao, rao)
                     for (o, ao), (ro, rao) in zip(got, ref)):
            raise RuntimeError(f"hqdn3d variant {k} differs from the kernel")


def _time(fn, args):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        _launch(fn, args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_hqdn3d: needs an NVIDIA GPU")
    card, clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().rsplit(", ", 1)
    clock_hz = float(clock.split()[0]) * 1e6
    with open(hqdn3d_cuda.SOURCE) as f:
        src = f.read()
    launch = build_variants(src)
    f = DenoiseFilter(param.generate_filter_settings(S.FILTER_DENOISE,
                                                     "medium"))
    f.init(FilterInit(geometry=Geometry(W, H), device="cpu"))
    planes = [torch.from_numpy(p).cuda()
              for p in make_interlaced_clip(W, H, 1, seed=4)[0]]
    ants = [p.float() for p in planes]
    outs, args, _keep = hqdn3d_cuda.prepare(planes, ants, f.g_sp, f.g_tmp,
                                            255)
    check_exact(launch, args, outs)
    exact = [k for k, v in VARIANTS.items() if v[2]]
    print(f"hqdn3d variants {', '.join(exact)}: outputs and states equal "
          f"the kernel's ({card})", flush=True)
    for fn in launch.values():
        _time(fn, args)                     # warm
    times = {k: [] for k in launch}
    for _ in range(ROUNDS):
        for k, fn in launch.items():
            times[k].append(_time(fn, args))
    ms = {k: statistics.median(v) for k, v in times.items()}
    hqdn3d_cuda.chain_probe(64, f.g_sp[0], False)   # loads the function
    probe = hqdn3d_cuda.chain_probe(PROBE_STEPS, f.g_sp[0], False)
    print(f"hqdn3d chain probe ({card}): {probe['cycles']:.2f} cycles, "
          f"{probe['ms'] * 1e6:.2f} ns a step", flush=True)
    floor = {k: steps * probe["cycles"] / clock_hz * 1e3
             for k, (_, steps, _) in VARIANTS.items()}
    for k, v in ms.items():
        print(f"hqdn3d {k} at {W}x{H} 4:2:0 ({card}): {v:.4f} ms a call, "
              f"{v / floor[k]:.3f}x its chain floor ({VARIANTS[k][1]} "
              f"steps at {clock_hz / 1e6:.0f} MHz, {floor[k]:.4f} ms)",
              flush=True)
    print(json.dumps({"card": card, "ms": ms, "chain_floor_ms": floor,
                      "step_cycles": probe["cycles"],
                      "step_ns": probe["ms"] * 1e6}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
