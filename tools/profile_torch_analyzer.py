#!/usr/bin/env python3
"""Device time of the PyTorch port's P-frame analyzer at 1080p on one GPU.

Usage: python3 tools/profile_torch_analyzer.py [--reps N] [--json]

Encodes an IDR and one P frame of ``utils.synth.make_clip`` at 1920x1080
(High profile: CABAC, in-loop deblock, 8x8) on ``cuda``, then times one
more analyzer call on the next frame against the same references: the
median of ``--reps`` runs by CUDA events, and one ``torch.profiler`` pass
that counts the device kernels, their busy time, and the kernels that
take the most of it.  Then the call's bound (``bound``): the least time
the card could take for it, the larger of its bytes (each input plane
read once, each output tensor written once) over the memory rate and
its integer operations (``analyzer_ops``) over the card's scalar rate;
and the plain version's time, the same torch ops on the host CPU on the
same inputs (one call, after one warm-up call).  Prints the card's name and power limit beside the numbers; with
``--json`` the numbers as the last line.  Run it in a fresh process.
Imports nothing of JAX.
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
MEM_BW = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
SCALAR_RATE = 67e12     # H100 SXM non-tensor f32 ops/s, the table's
                        # nearest rate for scalar int32 work
SAD_OPS = 3             # a difference, its absolute value, an add
MAC_OPS = 2             # a multiply and an add


def analyzer_ops(mb_w: int, mb_h: int, transform8x8: bool = True) -> dict:
    """Integer operations of one call of ``codecs/h264/analyzer.py`` on a
    mb_w x mb_h frame, by stage, from its shapes (a sum of 16 samples, a
    SAD term, a tap or a matrix product's multiply-add each counted as
    ``analyzer.py`` computes them; comparisons, argmins, gathers and the
    compaction not counted): the 4x decimation of both planes, the 81
    coarse shifts (LOWRES_R 4), the 2 x 49 full-pel candidates
    (REFINE_R 3), the 6-tap grids of a 24x24 window (horizontal 24x19,
    vertical 19x24, centre 19x19) and the 12 averaged phases of 18x18,
    the 25 quarter-pel candidates, the luma 4x4 and 8x8 transform, quant,
    dequant and inverse (two 4x4 or 8x8 products each way, 4 operations
    a coefficient to quantise and 2 to dequantise), the two SSDs of the
    8x8 choice, and each chroma plane's bilinear prediction (8
    operations a sample), 4x4 transforms both ways and quant."""
    from handbrake_tpu_torch.codecs.h264.analyzer import LOWRES_R, REFINE_R
    n, h, w = mb_w * mb_h, 16 * mb_h, 16 * mb_w
    coarse = (2 * LOWRES_R + 1) ** 2
    fine = 2 * (2 * REFINE_R + 1) ** 2
    grid = (24 * 19 + 19 * 24 + 19 * 19) * 6 * MAC_OPS + 12 * 18 * 18 * 2
    t4 = 16 * 2 * 64 * MAC_OPS
    stages = {
        "decimate": 2 * h * w,
        "coarse": coarse * (h // 4) * (w // 4) * SAD_OPS,
        "full_pel": n * fine * 256 * SAD_OPS,
        "sub_pel_grids": n * grid,
        "quarter_pel": n * 25 * 256 * SAD_OPS,
        "luma_4x4": n * (2 * t4 + 256 * (4 + 2)),
        "luma_8x8": n * ((2 * 4 * 2 * 512 * MAC_OPS + 256 * (4 + 2)
                          + 2 * 256 * SAD_OPS) if transform8x8 else 0),
        "chroma": n * 2 * (64 * 8 + 2 * 4 * 2 * 64 * MAC_OPS + 64 * 6)}
    return {**stages, "total": sum(stages.values())}


def bound(in_bytes: int, out_bytes: int, ops: int) -> dict:
    t_bytes = (in_bytes + out_bytes) / MEM_BW * 1e3
    t_ops = ops / SCALAR_RATE * 1e3
    return {"bytes": in_bytes + out_bytes, "ops": ops,
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _out_bytes(out) -> int:
    """Bytes of every tensor a call returns (lists of chunks included)."""
    import torch
    total = 0
    for v in out.values():
        for t in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


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
    ap.add_argument("--json", action="store_true")
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
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    ops = analyzer_ops(mb_w, mb_h)
    in_bytes = src.numel() * src.element_size() + sum(
        r.numel() * r.element_size() for r in refs)
    b = bound(in_bytes, _out_bytes(call()), ops["total"])
    cpu_args = (src.cpu(), *(r.cpu() for r in refs), QP, chroma_qp(QP, 0))
    enc._analyzer(*cpu_args)
    t0 = time.perf_counter()
    enc._analyzer(*cpu_args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"analyzer on the host CPU ({label}): {plain_ms:.1f} ms a call "
          f"({torch.get_num_threads()} threads)", flush=True)
    print(f"analyzer bound ({label}): {b['bound_ms'] * 1e3:.2f} us by "
          f"{b['bound_by']} ({b['ops'] / 1e9:.3f} G int ops at "
          f"{SCALAR_RATE / 1e12:.0f} T/s: {b['ops_ms'] * 1e3:.2f} us; "
          f"{b['bytes'] / 1e6:.2f} MB at {MEM_BW / 1e12:.2f} TB/s: "
          f"{b['bytes_ms'] * 1e3:.2f} us); the call {ms / b['bound_ms']:.0f}"
          f"x it", flush=True)
    if args.json:
        import json
        print(json.dumps({"card": label, "events_ms": ms,
                          "device_ms": busy, "kernels": len(kern),
                          "profiled_wall_ms": wall, "plain_ms": plain_ms,
                          "ops_by_stage": ops,
                          **b}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
