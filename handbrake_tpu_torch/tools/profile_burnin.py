"""Where a burned subtitle's time goes on the card.

    python3 -m handbrake_tpu_torch.tools.profile_burnin

1. The 2160p letterbox job of ``chip_smoke.py`` (5 (a), the CLI's default
   preset) three ways, two rounds each, warm in the second: plain; with
   an SRT cue on every frame burned in (``--srt-file --srt-burn 1``); and
   with the same cue offset past the clip's end, so render_sub is in the
   graph but blends nothing.  Each prints the job's fps and the host
   seconds of its stages (``profile_job.StageTimers``).
2. ``RenderSubFilter.work`` alone on a 3840x2160 4:2:0 frame whose planes
   are numpy (as the job hands them over: the filter uploads them), and
   ``blend_rgba`` alone on planes already on the card, with the cue the
   job rasterizes: host ms a call, with a synchronize, the card's time
   and launches a call from ``torch.profiler``, and the kernels that take
   the most device time.

Needs the CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..cli.__main__ import main as cli_main
from ..core.buffer import Buffer, Geometry, PIX_FMTS
from ..filters.base import FilterInit
from ..filters.rendersub import RenderSubFilter, blend_rgba
from ..subtitles.raster import render_text_rgba
from . import profile_job as pj

CUE = "A burned subtitle\nin two lines"
N = 33
REPS = 10


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def jobs(tmp: str):
    src = os.path.join(tmp, "letterbox.y4m")
    pj.write_letterbox(src, pj.letterbox_frames(N))
    srt = os.path.join(tmp, "cue.srt")
    with open(srt, "w", encoding="utf-8") as f:
        f.write(f"1\n00:00:00,000 --> 00:00:05,000\n{CUE}\n\n")
    burn = ["--srt-file", srt, "--srt-burn", "1"]
    for rnd in range(2):
        for name, extra in (("plain", []), ("burned", burn),
                            ("render_sub idle", burn + ["--srt-offset",
                                                        "4000"])):
            out = os.path.join(tmp, "out.mp4")
            with pj.JobSpy() as spy, pj.StageTimers() as st:
                if cli_main(pj.letterbox_argv(src, out) + extra) != 0:
                    raise RuntimeError(f"the {name} job failed")
            stages = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                st.sec.items()))
            print(f"round {rnd + 1}, {name}: {N / spy.seconds:.2f} fps; "
                  f"host s: {stages}", flush=True)


def _timed(fn, label):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    host = (time.perf_counter() - t0) / REPS
    torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / REPS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 3 / 1e3
    print(f"{label}: {host * 1e3:.2f} ms a call on the host, "
          f"{synced * 1e3:.2f} with a synchronize; the card "
          f"{dev_ms:.3f} ms, {sum(e.count for e in kern) / 3:.0f} "
          f"launches a call", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.key[:70]}: {e.count / 3:.0f} a call, "
              f"{e.self_device_time_total / 3 / 1e3:.3f} ms", flush=True)


def alone():
    dev = torch.device("cuda")
    top = pj.JOB_BAR
    rgba, (x0, y0) = render_text_rgba(CUE, pj.JOB_W, pj.JOB_H - 2 * top)
    print(f"the cue: {rgba.shape[1]}x{rgba.shape[0]} at ({x0}, "
          f"{y0 + top}) of the {pj.JOB_W}x{pj.JOB_H} frame", flush=True)
    rng = np.random.default_rng(0)
    planes = [rng.integers(0, 256, s).astype(np.uint8) for s in
              ((pj.JOB_H, pj.JOB_W), (pj.JOB_H // 2, pj.JOB_W // 2),
               (pj.JOB_H // 2, pj.JOB_W // 2))]
    f = RenderSubFilter({})
    f.init(FilterInit(geometry=Geometry(pj.JOB_W, pj.JOB_H),
                      pix_fmt=PIX_FMTS["yuv420p"], device="cuda"))
    ev = Buffer(track_kind="subtitle", pts=0)
    ev.planes, ev.rect = [rgba], (x0, y0 + top)
    f.queue_subtitle(ev)
    card = [torch.from_numpy(p).to(dev) for p in planes]
    _timed(lambda: f.work(Buffer(planes=list(planes),
                                 pix_fmt=PIX_FMTS["yuv420p"], pts=3000)),
           "RenderSubFilter.work, numpy planes in")
    _timed(lambda: blend_rgba(*card, f.events[0].planes[0], x0=x0,
                              y0=y0 + top, sw=2, sh=2),
           "blend_rgba, planes on the card")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_burnin needs the CUDA card")
    print(f"card: {_card()}", flush=True)
    with tempfile.TemporaryDirectory(prefix="profile_burnin_") as tmp:
        jobs(tmp)
    alone()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
