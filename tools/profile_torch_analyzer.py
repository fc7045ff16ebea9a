#!/usr/bin/env python3
"""Device time of the PyTorch port's P-frame analyzer at 1080p on one GPU.

Usage: python3 tools/profile_torch_analyzer.py [--reps N]

Encodes an IDR and one P frame of ``utils.synth.make_clip`` at 1920x1080
(High profile: CABAC, in-loop deblock, 8x8) on ``cuda``, then times one
more analyzer call on the next frame against the same references: the
median of ``--reps`` runs by CUDA events, and one ``torch.profiler`` pass
that counts the device kernels, their busy time, and the kernels that
take the most of it.  Prints the card's name and power limit beside the
numbers.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H, QP = 1920, 1080, 26


def cuda_ms(fn, reps):
    import torch
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.codecs.h264.transform import chroma_qp
    from handbrake_tpu_torch.utils.synth import make_clip
    if not torch.cuda.is_available():
        print("profile_torch_analyzer: no CUDA device", file=sys.stderr)
        return 2
    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    frames = make_clip(W, H, 3)
    enc = H264Encoder(EncoderConfig(
        width=W, height=H, qp=QP, gop=600, deblock=True, cabac=True,
        transform8x8=True, dispatch_batch=1))
    for f in frames[:2]:
        enc.encode_frame(*f)
    src = torch.from_numpy(np.concatenate(
        [enc._pad_to_mb(p, s).ravel()
         for p, s in zip(frames[2], (16, 8, 8))])).cuda()
    refs = (enc.recon_y, enc.recon_u, enc.recon_v)

    def call():
        return enc._analyzer(src, *refs, QP, chroma_qp(QP, 0))

    ms = cuda_ms(call, args.reps)
    print(f"analyzer at 1080p ({label}): {ms:.2f} ms per P frame "
          f"(median of {args.reps}, CUDA events)", flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    print(f"analyzer profile ({label}): {len(kern)} device kernels, "
          f"{busy:.2f} ms device busy in {wall:.2f} ms wall (profiled)",
          flush=True)
    by = {}
    for e in kern:
        n, t = by.get(e.name, (0, 0.0))
        by[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {t:8.3f} ms {n:5d}x {name[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
