"""The HEVC CTU analyzer and the AV1 motion search alone on the card.

    python3 -m handbrake_tpu_torch.tools.profile_analyzers [--json]

On two ``make_clip`` frames padded to 1920x1088 (a 1080p P frame's coded
planes), in a process of its own: for each analyzer, two rounds of one
call under ``torch.profiler`` (the card's busy ms and its kernels, copies
and sets, from the raw trace), CUDA events around 20 calls (median) and
the host clock around one synchronised call, and in the second round
the per-operator table of device time.  Prints the card's name and
power limit first; with ``--json``, the second round's numbers as the
last line.  It needs a CUDA card and raises without one.

Run it in a fresh process: in a process that has run many profiles
before (``chip_smoke.py`` after its phases 1-12), a one-call trace has
been seen to lack its first few dozen kernels.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..codecs.av1.analyzer import motion_search
from ..codecs.hevc.analyzer import analyze_ctus
from ..utils.device import resolve_device
from ..utils.synth import make_clip

W, H, ROWS = 1920, 1080, 1088
REPS = 20


def device_events(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def profile_once(fn, cpu=False):
    """One call of fn under the profiler: (the profile, busy ms, kernels,
    copies and sets)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = device_events(prof)
    kernels = sum(1 for e in evs
                  if not e.name().startswith(("Memcpy", "Memset")))
    busy = sum(e.duration_ns() for e in evs) / 1e6
    return prof, busy, kernels, len(evs) - kernels


def events_ms(fn, reps=REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    dev = resolve_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    ref, src = (np.pad(f[0], ((0, ROWS - H), (0, 0)), mode="edge")
                for f in make_clip(W, H, 2, seed=13))
    s = torch.from_numpy(src).to(dev)
    r = torch.from_numpy(ref).to(dev)
    fns = {"hevc": lambda: analyze_ctus(s, r, W // 32, ROWS // 32, 255),
           "av1": lambda: motion_search(s, r, 8)}
    rec = {}
    for rnd in range(2):
        for name, fn in fns.items():
            prof, busy, kernels, copies = profile_once(fn, cpu=rnd == 1)
            ms = events_ms(fn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            rec[name] = {"device_ms": busy, "kernels": kernels,
                         "copies_sets": copies, "events_ms": ms,
                         "host_ms": wall}
            print(f"round {rnd} {name} ({card}): device {busy:.3f} ms, "
                  f"{kernels} kernels, {copies} copies/sets a call; events "
                  f"{ms:.3f} ms (median of {REPS}); host clock {wall:.3f} "
                  f"ms", flush=True)
            if rnd == 1:
                print(prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=12),
                    flush=True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB",
          flush=True)
    if "--json" in sys.argv[1:]:
        print(json.dumps({"card": card, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
