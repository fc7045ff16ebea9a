#!/usr/bin/env python3
"""The port's device filters on one NVIDIA GPU: time and kernels per frame.

    python3 -m handbrake_tpu_torch.tools.profile_filters

Every filter of ``suite()`` runs at the settings its CLI flag gives
(``param.generate_filter_settings`` of the flag's default preset) on a
window of three frames of ``utils/synth.make_interlaced_clip`` at
1920x1080 (colorspace: 3840x2160 10-bit BT.2020 PQ to BT.709 with the
hable tonemap), its planes already on the card.  For each: the warm time
of one ``work`` call (one output frame), the median of CUDA events around
single calls; the CUDA kernels one call launches and their device time
(``torch.profiler`` over three calls); and the bytes bound of one frame
(its planes read and written once, with the frames and state it reads,
at 3.35 TB/s).  ``chip_smoke.py`` uses the suite, the windows, the runner
and the bounds from here.  Prints the card's name and power limit and
one JSON line.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from ..core.buffer import PIX_FMTS, Buffer, Geometry
from ..filters.base import FilterInit, create_filter
from ..filters import graph  # noqa: F401  (registers every filter)
from ..job import param
from ..job import schema as S
from ..utils.synth import make_clip, make_interlaced_clip

W, H = 1920, 1080
UHD = (3840, 2160)
WINDOW = 3
MEM_BW = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
REPS = 9                # timed calls per filter
# colorspace: a 10-bit BT.2020 PQ source to BT.709 SDR
HDR_SOURCE = dict(color_prim="bt2020", color_transfer="smpte2084",
                  color_matrix="bt2020")


def suite() -> list:
    """(name, filter id, settings, integer arithmetic?, frames read per
    output frame, f32 state bytes per sample) of every device filter, at
    its CLI flag's settings."""
    def flag(fid, preset):
        return param.generate_filter_settings(fid, preset)

    return [
        ("comb_detect", S.FILTER_COMB_DETECT,
         flag(S.FILTER_COMB_DETECT, "default"), True, 2, 0),
        ("decomb", S.FILTER_DECOMB, flag(S.FILTER_DECOMB, "default"), True,
         3, 0),
        ("yadif", S.FILTER_YADIF, flag(S.FILTER_YADIF, "default"), True, 3,
         0),
        ("bwdif", S.FILTER_BWDIF, flag(S.FILTER_BWDIF, "default"), True, 3,
         0),
        ("detelecine", S.FILTER_DETELECINE,
         flag(S.FILTER_DETELECINE, "default"), True, 2, 0),
        ("hqdn3d", S.FILTER_DENOISE, flag(S.FILTER_DENOISE, "medium"),
         False, 1, 8),
        ("nlmeans", S.FILTER_NLMEANS, flag(S.FILTER_NLMEANS, "medium"),
         False, 2, 0),
        ("bm3d", S.FILTER_BM3D, flag(S.FILTER_BM3D, "medium"), False, 1, 0),
        ("deblock", S.FILTER_DEBLOCK, flag(S.FILTER_DEBLOCK, "medium"),
         True, 1, 0),
        ("deband", S.FILTER_DEBAND, flag(S.FILTER_DEBAND, "medium"), True,
         1, 0),
        ("unsharp", S.FILTER_UNSHARP, flag(S.FILTER_UNSHARP, "medium"),
         False, 1, 0),
        ("lapsharp", S.FILTER_LAPSHARP, flag(S.FILTER_LAPSHARP, "medium"),
         False, 1, 0),
        ("chroma_smooth", S.FILTER_CHROMA_SMOOTH,
         flag(S.FILTER_CHROMA_SMOOTH, "medium"), False, 1, 0),
        ("grayscale", S.FILTER_GRAYSCALE, {}, True, 1, 0),
        ("rotate", S.FILTER_ROTATE, {"angle": 90}, True, 1, 0),
        ("pad", S.FILTER_PAD, {"width": W, "height": 1200}, True, 1, 0),
        ("colorspace", S.FILTER_COLORSPACE,
         {"primaries": "bt709", "transfer": "bt709", "matrix": "bt709",
          "tonemap": "hable"}, False, 1, 0),
    ]


def window(name: str, n: int = WINDOW) -> tuple:
    """(frames as numpy planes, pixel format name, FilterInit overrides)
    of a filter's input window."""
    if name == "colorspace":
        frames = [tuple((p.astype(np.uint16) << 2) | (p.astype(np.uint16) & 3)
                        for p in f) for f in make_clip(*UHD, n, seed=2)]
        return frames, "yuv420p10", HDR_SOURCE
    return make_interlaced_clip(W, H, n, seed=1), "yuv420p", {}


def run(fid, settings, frames, fmt, fi_kw, device) -> tuple:
    """The filter on `device` over `frames` (numpy planes or tensors) and
    an EOF: (filter, output buffers)."""
    h, w = frames[0][0].shape
    f = create_filter(fid, dict(settings))
    f.init(FilterInit(geometry=Geometry(w, h), pix_fmt=PIX_FMTS[fmt],
                      device=device, **fi_kw))
    out = []
    for i, planes in enumerate(frames):
        out += f.work(Buffer(planes=list(planes), pix_fmt=PIX_FMTS[fmt],
                             pts=i * 3003, duration=3003,
                             stop=(i + 1) * 3003))
    out += f.work(Buffer.eof())
    return f, [b for b in out if not b.is_eof()]


def bytes_bound(name, frame, out, reads, state_bytes) -> dict:
    """One output frame's bytes: `reads` input frames like `frame` and the
    output planes `out`, each sample once (comb_detect: two lumas in, its
    mask out), and the f32 state read and written (hqdn3d); over the
    memory rate."""
    size = sum(p.size for p in frame)
    bps = frame[0].itemsize
    if name == "comb_detect":
        nbytes = 3 * frame[0].size
    else:
        nbytes = (reads * size * bps
                  + sum(p.numel() * p.element_size()
                        if isinstance(p, torch.Tensor) else p.nbytes
                        for p in out)
                  + 2 * state_bytes * size)
    return {"bytes": nbytes, "bound_ms": nbytes / MEM_BW * 1e3}


def on_card(frames) -> list:
    return [[torch.from_numpy(np.ascontiguousarray(p)).cuda() for p in f]
            for f in frames]


def _warm_filter(fid, settings, frames, fmt, fi_kw):
    """A filter on the card, fed the window twice so that its queue and
    state are filled; returns (filter, a function of one work call)."""
    h, w = frames[0][0].shape
    f = create_filter(fid, dict(settings))
    f.init(FilterInit(geometry=Geometry(w, h), pix_fmt=PIX_FMTS[fmt],
                      device="cuda", **fi_kw))
    k = [0]

    def call():
        planes = frames[k[0] % len(frames)]
        k[0] += 1
        return f.work(Buffer(planes=list(planes), pix_fmt=PIX_FMTS[fmt],
                             pts=k[0] * 3003, duration=3003))

    for _ in range(2 * len(frames)):
        call()
    torch.cuda.synchronize()
    return f, call


def time_filter(fid, settings, frames, fmt, fi_kw, reps=REPS) -> float:
    """Warm ms of one work call on the card (planes already there): the
    median of CUDA events around single calls."""
    _, call = _warm_filter(fid, settings, frames, fmt, fi_kw)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernels_per_call(fid, settings, frames, fmt, fi_kw, calls=3) -> dict:
    """CUDA kernels (and copies) one work call launches, and their device
    time, from torch.profiler over `calls` warm calls."""
    _, call = _warm_filter(fid, settings, frames, fmt, fi_kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": sum(e.count for e in dev) / calls,
            "device_ms": sum(e.self_device_time_total for e in dev)
            / calls / 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_filters: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"card": card, "filters": {}}
    for name, fid, st, _, reads, state in suite():
        frames, fmt, fi_kw = window(name)
        dev_frames = on_card(frames)
        _, outs = run(fid, st, dev_frames, fmt, fi_kw, "cuda")
        b = bytes_bound(name, frames[0], outs[0].planes, reads, state)
        ms = time_filter(fid, st, dev_frames, fmt, fi_kw)
        k = kernels_per_call(fid, st, dev_frames, fmt, fi_kw)
        rec = dict(ms=ms, **k, **b)
        out["filters"][name] = rec
        print(f"{name} ({card}): {ms:.4f} ms per frame warm (CUDA events), "
              f"{k['kernels']:.0f} CUDA kernels and copies per frame, "
              f"{k['device_ms']:.4f} ms of device time; bytes bound "
              f"{b['bound_ms'] * 1e3:.2f} us ({b['bytes']} B)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
