#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``handbrake_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (none is caught; any failure exits non-zero before the last line):

1. Build the deblock kernel (``csrc/deblock264.cu``, nvcc, sm_90a) and the
   native slice coder (``native/hb264.cpp``, g++), both at once.
2. Hold the deblock kernel (planes and per-MB side data in; it derives
   bS itself) against its plain PyTorch version, ``deblock_plain`` on
   ``compute_bs``, on the card, bit for bit: random planes with intra
   MBs at 120x68 (1080p), 1x1, 3x7, 8x2, 1x68, 120x1 and 240x135 (2160p)
   MBs, both ``with_strong`` variants, and 512x270 (4320p) with
   ``with_strong=False``; 1080p with ``mb_intra=None``; and an
   all-filtering 1080p input (every edge filters), both variants.  Show
   that the wrapper refuses a frame above its size limit.  Time
   the kernel alone (CUDA events around 25 back-to-back launches with
   the arguments prepared first), the wrapper call (events around each
   single call) and the plain version, on the random 1080p input.
3. Drive the main path: a 1920x1080 High-profile encode (CABAC, in-loop
   deblock, 8x8 transform) of 33 synthetic frames (IDR + 32 P) with
   ``dispatch_batch=8``, pipelined as ``bench.py`` drives it, after a
   short warm-up encode.  The stream must equal the (also warm)
   ``dispatch_batch=1`` stream, its first 3 frames must
   equal the port's ``device="cpu"`` stream, and the deblock kernel must
   have launched once per analyzed P frame.
4. Time the kernel on a main-path P frame's own inputs: one analyzer
   call on the clip's next frame against the serial drive's references;
   its unfiltered recon, mv, nnz and t8 at qp 26 go to the kernel, whose
   output must equal the analyzer's and the plain version's.
5. Print the kernels line (``ms`` is step 4's time, beside the bytes
   bound and the dependency-chain floor), the card's name and power
   limit, and the result line.

Imports nothing of JAX and nothing of ``handbrake_tpu``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

W, H = 1920, 1080
N_FRAMES = 33           # IDR + 32 P frames: four full dispatch batches
NB = 8                  # dispatch batch of the main path (bench.py's)
QP = 26
N_CPU = 3               # frames also encoded on the CPU
MEM_BW = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
# the table's nearest rate for the kernel's scalar int32 work: H100 SXM
# non-tensor f32, ops/s (NVIDIA data sheet)
SCALAR_RATE = 67e12
# int32 operations per filtered line, estimated from the edge filters of
# csrc/deblock264.cu (loads and stores not counted)
OPS_PER_LINE = {"luma": 40, "chroma": 20}
# side data the function needs per MB: coded flags of the 16 4x4 blocks
# (2 B), mv (2 x int16), t8 and intra (1 B)
SIDE_BYTES = 7
# dependency chain of one MB step: dependent integer operations on the
# critical path of one luma edge filter (csrc/deblock264.cu luma_edge:
# difference, shift, adds, shift, clip, add, clip), and the latency of
# each in SM cycles (integer ALU latency on the card's generation)
CHAIN_OPS_PER_EDGE = 10
CYCLES_PER_OP = 4
KERNEL_REPS = 25
# (mb_w, mb_h, qp, with_strong variants): 1080p, tiny, tall, wide, 2160p
# and 4320p (the largest frame the kernel takes; its plain version is
# slow, so one variant)
KERNEL_CASES = ((120, 68, 30, (False, True)), (1, 1, 36, (False, True)),
                (3, 7, 40, (False, True)), (8, 2, 24, (False, True)),
                (1, 68, 32, (False, True)), (120, 1, 26, (False, True)),
                (240, 135, 28, (False, True)), (512, 270, 28, (False,)))
BIG = (4800, 9600)      # a luma plane above the kernel's size limit


def smi(query):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def card() -> str:
    return smi("name,power.limit")


def max_clock_hz() -> float:
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def deblock_case(seed, mb_w, mb_h, p_intra=0.2):
    """Random planes (half of the luma smooth, so filters fire) and MB
    data with intra MBs, as numpy, in the kernel's dtypes."""
    rng = np.random.default_rng(seed)
    Hp, Wp = mb_h * 16, mb_w * 16
    n_mb = mb_w * mb_h
    y = rng.integers(0, 256, (Hp, Wp)).astype(np.uint8)
    u = rng.integers(0, 256, (Hp // 2, Wp // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (Hp // 2, Wp // 2)).astype(np.uint8)
    y[:Hp // 2] = (y[:Hp // 2] // 8) + 100
    u //= 2
    v //= 2
    mv = rng.integers(-20, 20, (n_mb, 2)).astype(np.int16)
    nnz = rng.integers(0, 3, (n_mb, 16)).astype(np.int32)
    nnz[rng.random((n_mb, 16)) < 0.6] = 0
    t8 = rng.random(n_mb) < 0.3
    intra = rng.random(n_mb) < p_intra
    nnz = np.where(intra[:, None], 0, nnz).astype(np.int32)
    return y, u, v, mv, nnz, intra, t8 & ~intra


def all_filtering_case(seed, mb_w, mb_h):
    """Flat planes in a checkerboard of 4x4 blocks two levels apart, and
    every bS >= 2 (every block coded, no 8x8 transform, some intra MBs):
    every edge of every MB filters, so the whole chain is driven."""
    rng = np.random.default_rng(seed)
    n_mb = mb_w * mb_h

    def steps(h, w, base):
        i, j = np.mgrid[0:h, 0:w]
        return (base + 2 * ((i // 4 + j // 4) % 2)).astype(np.uint8)

    return (steps(mb_h * 16, mb_w * 16, 100),
            steps(mb_h * 8, mb_w * 8, 120), steps(mb_h * 8, mb_w * 8, 130),
            rng.integers(-20, 20, (n_mb, 2)).astype(np.int16),
            rng.integers(1, 4, (n_mb, 16)).astype(np.int32),
            rng.random(n_mb) < 0.2, np.zeros(n_mb, bool))


def cuda_ms(fn, reps):
    """Median device time of fn() over reps runs, by CUDA events around
    each call (host-side preparation included)."""
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


def kernel_ms(args, n=KERNEL_REPS):
    """The kernel alone: CUDA events around n back-to-back launches with
    the arguments prepared first (deblock_cuda.prepare), divided by n.
    These launches are not counted: they bypass the wrapper."""
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    lib = deblock_cuda.load()
    for _ in range(3):
        if lib.deblock264_launch(*args) != 0:
            raise RuntimeError("deblock264 launch failed")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        lib.deblock264_launch(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def bounds(planes, bs_v, bs_h, mb_w, mb_h, clock_hz):
    """The bound (bytes or operations, whichever is larger) and the
    dependency-chain floor of one launch on these inputs."""
    n_mb = mb_w * mb_h
    # each plane byte read once and written once, and the side data at
    # what the function needs (SIDE_BYTES per MB)
    nbytes = 2 * sum(p.numel() for p in planes) + SIDE_BYTES * n_mb
    # lines these inputs filter: 4 luma lines per bS group; chroma takes
    # luma edges 0 and 2, 2 lines per group, in U and V
    ops = (int((bs_v > 0).sum() + (bs_h > 0).sum()) * 4
           * OPS_PER_LINE["luma"]
           + int((bs_v[:, :, 0::2] > 0).sum()
                 + (bs_h[:, :, 0::2] > 0).sum()) * 2 * 2
           * OPS_PER_LINE["chroma"])
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = ops / SCALAR_RATE * 1e3
    # MB steps along the wavefront x 8 dependent edge filters x their
    # dependent integer operations x the latency of each
    sk = mb_w + 2 * (mb_h - 1)
    chain_us = sk * 8 * CHAIN_OPS_PER_EDGE * CYCLES_PER_OP / clock_hz * 1e6
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "t_bytes": t_bytes,
            "t_ops": t_ops, "chain_floor_us": chain_us}


def phase_build():
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.native import get_lib

    def timed(f):
        t0 = time.perf_counter()
        f()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        fk = ex.submit(timed, deblock_cuda.load)
        fn = ex.submit(timed, get_lib)
        tk, tn = fk.result(), fn.result()
    print(f"build: deblock264.cu (nvcc sm_90a) {tk:.1f} s, hb264.cpp (g++) "
          f"{tn:.1f} s, {time.perf_counter() - t0:.1f} s in all", flush=True)


def check_kernel(case, mb_w, mb_h, qp, strong, intra_none=False):
    """One launch against deblock_plain(compute_bs(...)) on the card;
    returns (max_abs_err, samples changed, kernel inputs, bS)."""
    import torch
    from handbrake_tpu_torch.codecs.h264.deblock import deblock_scal
    from handbrake_tpu_torch.codecs.h264.deblock_cuda import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.deblock_torch import (compute_bs,
                                                               deblock_plain)
    dev = torch.device("cuda")
    y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev) for a in case)
    if intra_none:
        intra = None
    scal = deblock_scal(qp, max(0, qp - 3))
    bs_v, bs_h = compute_bs(mb_w, mb_h, mv, nnz, intra, t8)
    got = deblock_cuda(y, u, v, mv, nnz, intra, t8, scal, strong)
    want = deblock_plain(y, u, v, bs_v, bs_h, scal, strong)
    torch.cuda.synchronize()
    err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(got, want))
    changed = sum(int((a != b).sum()) for a, b in zip(got, (y, u, v)))
    print(f"deblock264 {mb_w}x{mb_h} MBs qp {qp} with_strong={strong}"
          f"{' mb_intra=None' if intra_none else ''}: max_abs_err {err}, "
          f"{changed} samples filtered", flush=True)
    if err != 0:
        raise RuntimeError("deblock264 disagrees with its plain version")
    if changed == 0 and mb_w * mb_h > 100:
        raise RuntimeError("deblock264 filtered nothing")
    return err, changed, (y, u, v, mv, nnz, intra, t8, scal), (bs_v, bs_h)


def phase_kernel(label, clock_hz):
    """Kernel vs plain version on random, all-filtering and large inputs;
    returns the kernel's JSON entry (without the main-path numbers)."""
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.deblock_torch import (compute_bs,
                                                               deblock_plain)
    max_err = 0
    for mb_w, mb_h, qp, variants in KERNEL_CASES:
        case = deblock_case(mb_w * 1000 + mb_h, mb_w, mb_h)
        for strong in variants:
            err, _, args, _ = check_kernel(case, mb_w, mb_h, qp, strong)
            max_err = max(max_err, err)
    err, _, args, (bs_v, bs_h) = check_kernel(
        deblock_case(120068, 120, 68), 120, 68, 30, False, intra_none=True)
    max_err = max(max_err, err)
    case = all_filtering_case(7, 120, 68)
    for strong in (False, True):
        err, changed, _, _ = check_kernel(case, 120, 68, 36, strong)
        max_err = max(max_err, err)
        if changed < sum(a.size for a in case[:3]) // 8:
            raise RuntimeError("the all-filtering input filtered too little")
    # the main path's variant and shape (all inter), random input
    y, u, v, mv, nnz, intra, t8, scal = args
    _, largs = deblock_cuda.prepare(*args, False)
    ms_random = kernel_ms(largs)
    wrapper_ms = cuda_ms(lambda: deblock_cuda.deblock_cuda(*args, False),
                         KERNEL_REPS)

    def plain():
        return deblock_plain(y, u, v, *compute_bs(120, 68, mv, nnz, intra,
                                                  t8), scal, False)

    plain_ms = cuda_ms(plain, 3)
    b = bounds((y, u, v), bs_v, bs_h, 120, 68, clock_hz)
    print(f"deblock264 at 1080p, random input ({label}): kernel "
          f"{ms_random:.4f} ms ({KERNEL_REPS} back-to-back launches, CUDA "
          f"events), wrapper call {wrapper_ms:.4f} ms (median of "
          f"{KERNEL_REPS} single calls, CUDA events), plain {plain_ms:.2f} "
          f"ms (compute_bs + deblock_plain); bound {b['bound_ms'] * 1e3:.2f} "
          f"us by {b['bound_by']} ({b['bytes']} B at 3.35 TB/s: "
          f"{b['t_bytes'] * 1e3:.2f} us; ~{b['ops']} int32 ops at 67 T/s: "
          f"{b['t_ops'] * 1e3:.2f} us); chain floor "
          f"{b['chain_floor_us']:.1f} us", flush=True)
    # above the size limit the wrapper raises, naming the limit
    dev = torch.device("cuda")
    n_mb = (BIG[0] // 16) * (BIG[1] // 16)
    big = (torch.zeros(BIG, dtype=torch.uint8, device=dev),
           torch.zeros((BIG[0] // 2, BIG[1] // 2), dtype=torch.uint8,
                       device=dev),
           torch.zeros((BIG[0] // 2, BIG[1] // 2), dtype=torch.uint8,
                       device=dev),
           torch.zeros((n_mb, 2), dtype=torch.int16, device=dev),
           torch.zeros((n_mb, 16), dtype=torch.int32, device=dev))
    try:
        deblock_cuda.deblock_cuda(*big, None, None, scal, False)
    except ValueError as e:
        print(f"deblock264 at {BIG[1]}x{BIG[0]}: refused ({e})", flush=True)
    else:
        raise RuntimeError("deblock_cuda took a frame above its limit")
    del big
    return {"name": "deblock264", "route": "cuda",
            "source": "handbrake_tpu_torch/csrc/deblock264.cu",
            "replaces": "handbrake_tpu/codecs/h264/deblock_pallas.py:213",
            "equal": max_err == 0, "max_abs_err": max_err,
            "ms_random": ms_random, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_us": b["bound_ms"] * 1e3, "bound_by": b["bound_by"],
            "chain_floor_us": b["chain_floor_us"], "library_ms": None}


def encode(frames, device, batch, depth):
    """Encode frames through begin_frame/finish_frame with up to `depth`
    frames in flight; returns (per-frame bytes, encoder, seconds in all,
    seconds in begin_frame, seconds in finish_frame)."""
    import torch
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    enc = H264Encoder(EncoderConfig(
        width=W, height=H, qp=QP, gop=600, deblock=True, cabac=True,
        transform8x8=True, dispatch_batch=batch), device=device)
    out, pend = [], []
    t_begin = t_finish = 0.0

    def finish():
        nonlocal t_finish
        t = time.perf_counter()
        out.append(enc.finish_frame(pend.pop(0)))
        t_finish += time.perf_counter() - t

    t0 = time.perf_counter()
    for f in frames:
        t = time.perf_counter()
        pend.append(enc.begin_frame(*f))
        t_begin += time.perf_counter() - t
        if len(pend) > depth:
            finish()
    while pend:
        finish()
    if device != "cpu":
        torch.cuda.synchronize()
    return out, enc, time.perf_counter() - t0, t_begin, t_finish


def phase_main_path(label):
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.utils.synth import make_clip
    # one frame more than the drive: the source of the main-path-input
    # timing of the kernel (make_clip's first frames do not depend on n)
    frames = make_clip(W, H, N_FRAMES + 1)[:N_FRAMES]
    # warm-up: one batch through both drives, so that neither timed run
    # pays for first allocations and library set-up
    encode(frames[:NB + 1], "cuda", NB, NB + 2)
    encode(frames[:2], "cuda", 1, 0)
    # the main path: batches of 8, ~2 batches in flight (bench.py's drive)
    deblock_cuda.launches = 0
    main, enc8, t_main, _, _ = encode(frames, "cuda", NB, NB + 2)
    launches = deblock_cuda.launches
    n_p = N_FRAMES - 1
    print(f"main path: {N_FRAMES} frames 1920x1080, deblock264 launches "
          f"{launches}, P frames {n_p}, re-analysed {enc8.n_redo}",
          flush=True)
    if launches != n_p + enc8.n_redo or launches == 0:
        raise RuntimeError("the main path did not launch deblock264 once "
                           "per analyzed P frame")
    # serial, one frame per dispatch: the comparison stream
    ser, enc1, t_ser, tb_ser, tf_ser = encode(frames, "cuda", 1, 0)
    if main != ser:
        bad = [i for i, (a, b) in enumerate(zip(main, ser)) if a != b]
        raise RuntimeError(f"dispatch_batch=8 stream differs from "
                           f"dispatch_batch=1 at frames {bad}")
    for a, b in ((enc8.recon_y, enc1.recon_y), (enc8.recon_u, enc1.recon_u),
                 (enc8.recon_v, enc1.recon_v)):
        if not torch.equal(a, b):
            raise RuntimeError("final reference planes differ between "
                               "dispatch_batch 8 and 1")
    stream = b"".join(main)
    if not stream.startswith(b"\x00\x00\x00\x01") or \
            min(len(f) for f in main) == 0:
        raise RuntimeError("malformed annex-B stream")
    cpu, _, t_cpu, _, _ = encode(frames[:N_CPU], "cpu", 1, 0)
    if cpu != main[:N_CPU]:
        bad = [i for i, (a, b) in enumerate(zip(cpu, main)) if a != b]
        raise RuntimeError(f"GPU stream differs from the CPU stream at "
                           f"frames {bad}")
    kbit = len(stream) * 8 / N_FRAMES / 1000
    print(f"main path ({label}): warm, dispatch_batch=8 pipelined "
          f"{N_FRAMES / t_main:.2f} fps ({enc8.n_redo} re-analysed), "
          f"dispatch_batch=1 serial {N_FRAMES / t_ser:.2f} fps (both incl. "
          f"the IDR), {kbit:.1f} kbit/frame; streams equal; first {N_CPU} "
          f"frames equal the CPU stream ({t_cpu:.1f} s on the CPU)",
          flush=True)
    print(f"serial run ({label}): begin_frame {tb_ser / N_FRAMES * 1e3:.1f} "
          f"ms/frame (upload, dispatch; the IDR's native I slice), "
          f"finish_frame {tf_ser / N_FRAMES * 1e3:.1f} ms/frame (wait for "
          f"the device, fetch, native CABAC)", flush=True)
    return launches, enc1


def phase_main_path_input(label, enc, clock_hz):
    """The kernel on a main-path P frame's own inputs: one analyzer call
    (deblock on, 8x8) on the clip's next frame against the serial
    encoder's final references; its unfiltered recon, mv, nnz and t8 go
    to the kernel, which must give the analyzer's filtered planes and
    the plain version's.  Returns (kernel ms, bound, chain floor)."""
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.analyzer import build_p_analyzer
    from handbrake_tpu_torch.codecs.h264.deblock import deblock_scal
    from handbrake_tpu_torch.codecs.h264.deblock_torch import (compute_bs,
                                                               deblock_plain)
    from handbrake_tpu_torch.codecs.h264.transform import chroma_qp
    from handbrake_tpu_torch.utils.synth import make_clip
    frame = make_clip(W, H, N_FRAMES + 1)[N_FRAMES]
    src = torch.from_numpy(np.concatenate(
        [enc._pad_to_mb(p, m).ravel() for p, m in zip(frame, (16, 8, 8))]
    )).cuda()
    qpc = chroma_qp(QP, 0)
    d = build_p_analyzer(enc.mb_w, enc.mb_h, deblock=True,
                         transform8x8=True)(
        src, enc.recon_y, enc.recon_u, enc.recon_v, QP, qpc)
    planes = (d["recon_y_nf"], d["urec_nf"], d["vrec_nf"])
    mv, nnz, t8 = d["mv"], d["luma_nnz"].to(torch.int32), d["t8"].bool()
    scal = deblock_scal(QP, qpc)
    outs, largs = deblock_cuda.prepare(*planes, mv, nnz, None, t8, scal,
                                       False)
    ms = kernel_ms(largs)
    bs_v, bs_h = compute_bs(enc.mb_w, enc.mb_h, mv, nnz, None, t8)
    want = deblock_plain(*planes, bs_v, bs_h, scal, False)
    for got, w, an in zip(outs, want, (d["recon_y"], d["urec"], d["vrec"])):
        if not (torch.equal(got, w) and torch.equal(got, an)):
            raise RuntimeError("deblock264 on main-path input differs from "
                               "its plain version or the analyzer's output")
    b = bounds(planes, bs_v, bs_h, enc.mb_w, enc.mb_h, clock_hz)
    print(f"deblock264 on a main-path P frame's inputs ({label}): kernel "
          f"{ms:.4f} ms ({KERNEL_REPS} back-to-back launches, CUDA events); "
          f"equal to the plain version and the analyzer's output; bS > 0 "
          f"at {int((bs_v > 0).sum() + (bs_h > 0).sum())} of "
          f"{bs_v.numel() + bs_h.numel()} luma edge groups; bound "
          f"{b['bound_ms'] * 1e3:.2f} us by {b['bound_by']}, chain floor "
          f"{b['chain_floor_us']:.1f} us", flush=True)
    return ms, b


def one_card():
    """Make only the first visible card visible to this process (before
    CUDA starts), so the run uses, and reports, exactly one card."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        "0" if vis is None else vis.split(",")[0].strip())


def main() -> int:
    one_card()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    from handbrake_tpu_torch.utils.device import resolve_device
    resolve_device(None)
    t0 = time.perf_counter()
    label = card()
    print(f"card: {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    clock_hz = max_clock_hz()
    print(f"card: max SM clock {clock_hz / 1e6:.0f} MHz", flush=True)
    phase_build()
    entry = phase_kernel(label, clock_hz)
    launches, enc = phase_main_path(label)
    ms, b = phase_main_path_input(label, enc, clock_hz)
    entry.update(launches=launches, ms=ms, bound_ms=b["bound_ms"],
                 bound_us=b["bound_ms"] * 1e3, bound_by=b["bound_by"],
                 chain_floor_us=b["chain_floor_us"])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [entry]}))
    print(label)
    count = torch.cuda.device_count()
    if count != 1:
        raise RuntimeError(f"{count} cards visible, expected 1")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
