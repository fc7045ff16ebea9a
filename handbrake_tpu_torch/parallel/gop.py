"""GOP-parallel encode — the counterpart of ``handbrake_tpu/parallel/gop.py``.

The frames are cut into G keyframe-aligned chunks, each an independent
GOP with its own encoder.  Frame t of every GOP is analysed in one call
of the GOP analyzer (``analyzer.build_p_analyzer_gops``: each frame
against its own GOP's reference, at its own qp), and each GOP's encoder
entropy-codes its frame from that analysis on a thread pool (the native
slice coder drops the GIL).  Each GOP's IDR is coded on the host.

The reference shards the GOP axis over a device mesh, one GOP a device,
and takes G = min(gop_parallel, devices, frames).  The port runs the GOP
axis on its one device, so callers pass G = min(gop_parallel, frames);
the streams equal the reference's wherever both take the same G.  The
reference's ``psum`` of the two-pass complexities becomes a sum over the
GOP axis.  A finished GOP's later steps analyse nothing (the reference
pads them with its last frame and discards the output).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.device import resolve_device


def split_gops(n_frames: int, n_gops: int) -> list:
    """Contiguous keyframe-aligned chunks: [(start, length)] per gop."""
    base = n_frames // n_gops
    rem = n_frames % n_gops
    out = []
    s = 0
    for g in range(n_gops):
        ln = base + (1 if g < rem else 0)
        out.append((s, ln))
        s += ln
    return out


def exchange_rc_stats(complexity, total_bits: float) -> np.ndarray:
    """Two-pass bit allocation over the GOPs: each GOP's share of
    total_bits in proportion to its pass-1 complexity, in float32 as the
    reference computes it (its psum across shards is this sum)."""
    c = np.asarray(complexity, np.float32)
    tot = np.float32(0.0)
    for x in c:
        tot = np.float32(tot + x)
    return c / np.maximum(tot, np.float32(1e-9)) * np.float32(total_bits)


def _qp_of(qp, g: int, t: int) -> int:
    """qp: a scalar, a per-gop scalar list or a per-gop list of per-frame
    qp sequences (what the two-pass allocator feeds)."""
    if np.isscalar(qp):
        return int(qp)
    q = qp[g]
    return int(q) if np.isscalar(q) else int(q[min(t, len(q) - 1)])


def _on(dev, p) -> torch.Tensor:
    if isinstance(p, torch.Tensor):
        return p.to(dev)
    return torch.from_numpy(np.ascontiguousarray(p, np.uint8)).to(dev)


def encode_gop_parallel(frames, width: int, height: int, qp, n_gops: int,
                        fps=(30000, 1001), device=None):
    """Encode frames as n_gops independent GOPs on `device` (None: the
    CUDA card).  qp as in the reference: a scalar, a per-gop list of
    scalars, or a per-gop list of per-frame qp sequences.

    Returns (streams, full_stream, frame_aus): per-gop annex-B segments,
    their concatenation, and per-gop per-frame access units.  Each GOP's
    stream equals that GOP's frames encoded serially by its own
    encoder."""
    from ..codecs.h264.analyzer import build_p_analyzer_gops
    from ..codecs.h264.encoder import EncoderConfig, H264Encoder
    from ..codecs.h264.transform import chroma_qp

    dev = resolve_device(device)
    G = int(n_gops)
    chunks = split_gops(len(frames), G)
    if not all(ln > 0 for _, ln in chunks):
        raise ValueError("more gops than frames")
    mb_w = (width + 15) // 16
    mb_h = (height + 15) // 16
    encs = [H264Encoder(EncoderConfig(width=width, height=height,
                                      qp=_qp_of(qp, g, 0), gop=max(ln, 1),
                                      fps=fps, backend="host"), device=dev)
            for g, (_, ln) in enumerate(chunks)]
    analyze = build_p_analyzer_gops(mb_w, mb_h)

    frame_aus = [[] for _ in range(G)]
    # frame 0 of each gop: IDR on the host (native I slice)
    for g, (s, _ln) in enumerate(chunks):
        frame_aus[g].append(encs[g].encode_frame(*frames[s],
                                                 qp=_qp_of(qp, g, 0)))

    max_len = max(ln for _, ln in chunks)
    with ThreadPoolExecutor(max_workers=min(G, 8)) as pool:
        for t in range(1, max_len):
            live = [g for g, (_s, ln) in enumerate(chunks) if t < ln]
            src = [[encs[g]._pad_to_mb(p, mb)
                    for p, mb in zip(frames[chunks[g][0] + t], (16, 8, 8))]
                   for g in live]
            # one host→device copy a plane for all GOPs of the step
            ys, us, vs = (_on(dev, np.stack([f[k] for f in src]))
                          for k in range(3))
            qps = [_qp_of(qp, g, t) for g in live]
            outs = analyze(ys, us, vs,
                           *([_on(dev, getattr(encs[g], name)) for g in live]
                             for name in ("recon_y", "recon_u", "recon_v")),
                           qps, [chroma_qp(q, 0) for q in qps])

            def entropy_one(j):
                return encs[live[j]].encode_p_from_analysis(
                    *src[j], outs[j], qps[j])
            for g, au in zip(live, pool.map(entropy_one, range(len(live)))):
                frame_aus[g].append(au)
    streams = [b"".join(a) for a in frame_aus]
    return streams, b"".join(streams), frame_aus


def encode_gop_parallel_2pass(frames, width: int, height: int,
                              target_kbps: float, n_gops: int,
                              fps=(30000, 1001), qp1: int = 32, device=None):
    """Two-pass GOP-parallel encode to a bitrate target, as the reference
    does it: pass 1 at qp1 measures each GOP's bits, ``exchange_rc_stats``
    shares out the budget, each GOP's budget maps to a fractional qp by
    the 2^(-qp/6) rate model, dithered over its frames, and up to three
    passes correct the qp toward the target (stopping within 4 %).

    Returns (streams, full_stream, stats dict)."""
    G = int(n_gops)
    chunks = split_gops(len(frames), G)
    fps_f = fps[0] / fps[1]
    duration_s = len(frames) / fps_f
    total_bits = target_kbps * 1000.0 * duration_s

    p1_streams, _, _ = encode_gop_parallel(frames, width, height, qp1, G,
                                           fps, device)
    complexity = np.asarray([len(s) * 8.0 for s in p1_streams], np.float64)
    budgets = exchange_rc_stats(complexity, total_bits)

    qfs = []
    for g, (_, ln) in enumerate(chunks):
        dq = 6.0 * np.log2(max(complexity[g], 1.0)
                           / max(float(budgets[g]), 1.0))
        qfs.append(float(qp1 + dq))

    def dither(qf, ln):
        qf = float(np.clip(qf, 10, 48))
        lo, frac = int(np.floor(qf)), qf % 1.0
        # deterministic error-diffusion dither → fractional effective qp
        seq, acc = [], 0.0
        for _ in range(ln):
            acc += frac
            if acc >= 1.0:
                seq.append(lo + 1)
                acc -= 1.0
            else:
                seq.append(lo)
        return seq

    streams = full = frame_aus = None
    corr = 0.0
    for _attempt in range(3):
        qps = [dither(qfs[g] + corr, ln)
               for g, (_, ln) in enumerate(chunks)]
        streams, full, frame_aus = encode_gop_parallel(
            frames, width, height, qps, G, fps, device)
        actual_kbps = len(full) * 8.0 / duration_s / 1000.0
        if abs(actual_kbps - target_kbps) <= 0.04 * target_kbps:
            break
        # rate-model correction toward the target
        corr += 6.0 * np.log2(actual_kbps / target_kbps)
    return streams, full, {"target_kbps": target_kbps,
                           "actual_kbps": actual_kbps,
                           "budgets": budgets.tolist(),
                           "pass1_bits": complexity.tolist(),
                           "qps": [q[0] for q in qps],
                           "frame_aus": frame_aus}
