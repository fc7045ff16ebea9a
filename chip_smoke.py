#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``handbrake_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (none is caught; any failure exits non-zero before the last line):

1. Build the deblock kernel (``csrc/deblock264.cu``, nvcc, sm_90a) and the
   native slice coder (``native/hb264.cpp``, g++), both at once.
2. Hold the deblock kernel against its plain PyTorch version on the card,
   bit for bit, at 1080p (120x68 MBs) and at 1x1, 3x7 and 8x2 MBs, both
   ``with_strong`` variants, on random planes with intra MBs; time both.
3. Drive the main path: a 1920x1080 High-profile encode (CABAC, in-loop
   deblock, 8x8 transform) of 33 synthetic frames (IDR + 32 P) with
   ``dispatch_batch=8``, pipelined as ``bench.py`` drives it, after a
   short warm-up encode.  The stream must equal the (also warm)
   ``dispatch_batch=1`` stream, its first 3 frames must
   equal the port's ``device="cpu"`` stream, and the deblock kernel must
   have launched once per analyzed P frame.
4. Print the kernels line, the card's name and power limit, and the
   result line.

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


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def deblock_case(seed, mb_w, mb_h, p_intra=0.2):
    """Random planes (half of the luma smooth, so filters fire) and MB
    data with intra MBs, as numpy."""
    rng = np.random.default_rng(seed)
    Hp, Wp = mb_h * 16, mb_w * 16
    n_mb = mb_w * mb_h
    y = rng.integers(0, 256, (Hp, Wp)).astype(np.uint8)
    u = rng.integers(0, 256, (Hp // 2, Wp // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (Hp // 2, Wp // 2)).astype(np.uint8)
    y[:Hp // 2] = (y[:Hp // 2] // 8) + 100
    u //= 2
    v //= 2
    mv = rng.integers(-20, 20, (n_mb, 2)).astype(np.int32)
    nnz = rng.integers(0, 3, (n_mb, 16)).astype(np.int32)
    nnz[rng.random((n_mb, 16)) < 0.6] = 0
    t8 = rng.random(n_mb) < 0.3
    intra = rng.random(n_mb) < p_intra
    nnz = np.where(intra[:, None], 0, nnz)
    return y, u, v, mv, nnz, intra, t8 & ~intra


def cuda_ms(fn, reps):
    """Median device time of fn() over reps runs, by CUDA events."""
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


def phase_kernel(label):
    """Kernel vs plain version; returns the kernel's JSON entry (without
    launches)."""
    import torch
    from handbrake_tpu_torch.codecs.h264.deblock import deblock_scal
    from handbrake_tpu_torch.codecs.h264.deblock_cuda import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.deblock_torch import (compute_bs,
                                                               deblock_plain)
    dev = torch.device("cuda")
    max_err = 0
    timing = None
    for mb_w, mb_h, qp in ((120, 68, 30), (1, 1, 36), (3, 7, 40),
                           (8, 2, 24)):
        qpc = max(0, qp - 3)
        case = deblock_case(mb_w * 1000 + mb_h, mb_w, mb_h)
        y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev)
                                       for a in case)
        bs_v, bs_h = compute_bs(mb_w, mb_h, mv, nnz, intra, t8)
        scal = deblock_scal(qp, qpc)
        for strong in (False, True):
            got = deblock_cuda(y, u, v, bs_v, bs_h, scal, strong)
            want = deblock_plain(y, u, v, bs_v, bs_h, scal, strong)
            torch.cuda.synchronize()
            err = max(int((a.int() - b.int()).abs().max())
                      for a, b in zip(got, want))
            changed = sum(int((a != b).sum()) for a, b in zip(got, (y, u, v)))
            print(f"deblock264 {mb_w}x{mb_h} MBs qp {qp} with_strong="
                  f"{strong}: max_abs_err {err}, {changed} samples "
                  f"filtered", flush=True)
            if err != 0:
                raise RuntimeError("deblock264 disagrees with its plain "
                                   "version")
            if changed == 0 and mb_w * mb_h > 100:
                raise RuntimeError("deblock264 filtered nothing")
            max_err = max(max_err, err)
        if (mb_w, mb_h) == (120, 68):
            # the main path's variant and shape
            args = (y, u, v, bs_v, bs_h, scal, False)
            ms = cuda_ms(lambda: deblock_cuda(*args), 25)
            plain_ms = cuda_ms(lambda: deblock_plain(*args), 3)
            # each plane byte read once and written once, and bS read
            # once at the one byte its values 0..4 need (the port stores
            # it as int32, a choice the bound does not charge)
            nbytes = (2 * sum(p.numel() for p in (y, u, v))
                      + bs_v.numel() + bs_h.numel())
            # lines this input filters: 4 luma lines per bS group; chroma
            # takes luma edges 0 and 2, 2 lines per group, in U and V
            ops = (int((bs_v > 0).sum() + (bs_h > 0).sum()) * 4
                   * OPS_PER_LINE["luma"]
                   + int((bs_v[:, :, 0::2] > 0).sum()
                         + (bs_h[:, :, 0::2] > 0).sum()) * 2 * 2
                   * OPS_PER_LINE["chroma"])
            t_bytes = nbytes / MEM_BW * 1e3
            t_ops = ops / SCALAR_RATE * 1e3
            timing = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations",
                      "bytes": nbytes, "ops": ops,
                      "t_bytes": t_bytes, "t_ops": t_ops}
    print(f"deblock264 at 1080p ({label}): kernel {timing['ms']:.4f} ms "
          f"(median of 25, CUDA events), plain {timing['plain_ms']:.2f} ms, "
          f"bound {timing['bound_ms'] * 1e3:.2f} us by "
          f"{timing['bound_by']} ({timing['bytes']} B at 3.35 TB/s: "
          f"{timing['t_bytes'] * 1e3:.2f} us; ~{timing['ops']} int32 ops at "
          f"67 T/s: {timing['t_ops'] * 1e3:.2f} us)", flush=True)
    return {"name": "deblock264", "route": "cuda",
            "source": "handbrake_tpu_torch/csrc/deblock264.cu",
            "replaces": "handbrake_tpu/codecs/h264/deblock_pallas.py:213",
            "equal": max_err == 0, "max_abs_err": max_err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_us": timing["bound_ms"] * 1e3,
            "bound_by": timing["bound_by"], "library_ms": None}


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
    frames = make_clip(W, H, N_FRAMES)
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
    return launches


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
    phase_build()
    entry = phase_kernel(label)
    launches = phase_main_path(label)
    entry["launches"] = launches
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
