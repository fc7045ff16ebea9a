"""GOP-parallel encode — the counterpart of ``handbrake_tpu/parallel/gop.py``.

The frames are cut into G keyframe-aligned chunks, each an independent
GOP with its own encoder, and the GOPs are dealt out over the ranks of a
mesh (``parallel/mesh.py``), GOP g to rank g mod n.  Each GOP lives
wholly on its rank: rank 0 sends it each frame once, step by step as the
GOPs advance, and its encoder, reconstruction, analyzer calls and host
entropy coding run there.  On each rank, frame t of every live GOP is
analysed in one call of the GOP analyzer (``build_p_analyzer_gops``:
each frame against its own GOP's reference, at its own qp), and each
GOP's encoder entropy-codes its frame from that analysis on a thread
pool (the native slice coder drops the GIL).  Each GOP's IDR is coded on
the host.  The access units come back to rank 0 in GOP order.

The reference shards the GOP axis over its devices, one GOP a device,
and takes G = min(gop_parallel, devices, frames).  The port takes G =
min(gop_parallel, frames) whatever the rank count: with more GOPs than
ranks a rank runs its GOPs as a loop, with fewer the other ranks idle,
and without a process group the one rank runs them all.  The streams
equal the reference's wherever both take the same G.  The reference's
``psum`` of the two-pass complexities becomes an ``all_gather`` of each
rank's GOPs and the same sequential f32 sum in GOP order on every rank
(a sum in the backend's order could differ by an ulp and move a
dithered qp).  A finished GOP's later steps analyse nothing (the
reference pads them with its last frame and discards the output).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


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
    reference computes it, summed in GOP order (the reference's psum
    across shards is this sum; over a mesh, ``gather_gops`` first)."""
    c = np.asarray(complexity, np.float32)
    tot = np.float32(0.0)
    for x in c:
        tot = np.float32(tot + x)
    return c / np.maximum(tot, np.float32(1e-9)) * np.float32(total_bits)


def gather_gops(mesh, local: np.ndarray) -> np.ndarray:
    """(G,) values each rank holds for its own GOPs (g mod n == rank) →
    every GOP's value on every rank, by an all_gather."""
    if mesh.n == 1:
        return np.asarray(local)
    every = mesh.world.all_gather(np.asarray(local))
    return np.asarray([every[g % mesh.n, g] for g in range(len(local))])


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


class _Gops:
    """This rank's GOPs of a window and its part of the frame stream.
    Rank 0 holds the window (`frames`) and sends each rank the frames of
    its live GOPs a step at a time, one step ahead of its own work; a
    rank keeps what it received when ``keep`` (the two-pass encode runs
    its later passes on them)."""

    def __init__(self, mesh, frames, width, height, G, fps, n_frames,
                 shapes, dtype, keep=False):
        self.mesh, self.frames = mesh, frames
        self.width, self.height, self.fps = width, height, fps
        self.chunks = split_gops(n_frames, G)
        self.mine = [g for g in range(G) if g % mesh.n == mesh.rank]
        self.shapes = shapes
        self.dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self.kept = {g: [] for g in self.mine} if keep else None
        self.streamed = False

    def _live(self, r: int, t: int) -> list:
        return [g for g in range(r, len(self.chunks), self.mesh.n)
                if t < self.chunks[g][1]]

    def _frame(self, g: int, t: int):
        return self.frames[self.chunks[g][0] + t]

    def _feed(self, t: int, pending):
        """{g: (y, u, v)} of this rank's live GOPs at step t, and the
        sends still in flight."""
        mesh, live = self.mesh, self._live(self.mesh.rank, t)
        if mesh.rank == 0:
            if not self.streamed and mesh.n > 1:
                if pending is not None:
                    pending.wait()
                sends = [(r, p) for r in range(1, mesh.n)
                         for g in self._live(r, t) for p in self._frame(g, t)]
                pending = mesh.world.post(sends) if sends else None
            return {g: self._frame(g, t) for g in live}, pending
        if self.streamed:
            return {g: self.kept[g][t] for g in live}, None
        if not live:
            return {}, None
        got = mesh.world.exchange(recvs=[(0, sh, self.dtype) for _g in live
                                         for sh in self.shapes])
        planes = [p.cpu().numpy() for p in got]
        cur = {g: tuple(planes[3 * k:3 * k + 3]) for k, g in enumerate(live)}
        if self.kept is not None:
            for g, f in cur.items():
                self.kept[g].append(f)
        return cur, None

    def encode(self, qp) -> dict:
        """{g: [access unit a frame]} of this rank's GOPs at qp (as
        ``encode_gop_parallel`` takes it)."""
        from ..codecs.h264.analyzer import build_p_analyzer_gops
        from ..codecs.h264.encoder import EncoderConfig, H264Encoder
        from ..codecs.h264.transform import chroma_qp

        dev = self.mesh.device
        mb_w = (self.width + 15) // 16
        mb_h = (self.height + 15) // 16
        encs = {g: H264Encoder(EncoderConfig(
            width=self.width, height=self.height, qp=_qp_of(qp, g, 0),
            gop=max(self.chunks[g][1], 1), fps=self.fps, backend="host"),
            device=dev) for g in self.mine}
        analyze = build_p_analyzer_gops(mb_w, mb_h)
        aus = {g: [] for g in self.mine}
        pending = None
        max_len = max(ln for _, ln in self.chunks)
        with ThreadPoolExecutor(max_workers=min(max(len(self.mine), 1),
                                                8)) as pool:
            for t in range(max_len):
                cur, pending = self._feed(t, pending)
                live = sorted(cur)
                if t == 0:
                    # frame 0 of each gop: IDR on the host (native I slice)
                    for g in live:
                        aus[g].append(encs[g].encode_frame(
                            *cur[g], qp=_qp_of(qp, g, 0)))
                    continue
                if not live:
                    continue
                src = [[encs[g]._pad_to_mb(p, mb)
                        for p, mb in zip(cur[g], (16, 8, 8))] for g in live]
                # one host→device copy a plane for all GOPs of the step
                ys, us, vs = (_on(dev, np.stack([f[k] for f in src]))
                              for k in range(3))
                qps = [_qp_of(qp, g, t) for g in live]
                outs = analyze(ys, us, vs,
                               *([_on(dev, getattr(encs[g], name))
                                  for g in live]
                                 for name in ("recon_y", "recon_u",
                                              "recon_v")),
                               qps, [chroma_qp(q, 0) for q in qps])

                def entropy_one(j):
                    return encs[live[j]].encode_p_from_analysis(
                        *src[j], outs[j], qps[j])
                for g, au in zip(live,
                                 pool.map(entropy_one, range(len(live)))):
                    aus[g].append(au)
        if pending is not None:
            pending.wait()
        self.streamed = True
        return aus

    def gather(self, aus: dict):
        """Rank 0: every GOP's access units in GOP order; None elsewhere."""
        mesh = self.mesh
        if mesh.rank != 0:
            mesh.world.send_obj(0, aus)
            return None
        every = dict(aus)
        for r in range(1, mesh.n):
            every.update(mesh.world.recv_obj(r))
        return [every[g] for g in range(len(self.chunks))]


def _window_args(frames):
    return [tuple(p.shape) for p in frames[0]], np.asarray(frames[0][0]).dtype


def _mesh_for(mesh, device):
    from .mesh import make_mesh
    return make_mesh(tile=1, device=device) if mesh is None else mesh


def _encode_item(mesh, frames, width, height, qp, G, fps, n_frames, shapes,
                 dtype):
    gops = _Gops(mesh, frames, width, height, G, fps, n_frames, shapes,
                 dtype)
    frame_aus = gops.gather(gops.encode(qp))
    if frame_aus is None:
        return None
    streams = [b"".join(a) for a in frame_aus]
    return streams, b"".join(streams), frame_aus


def encode_gop_parallel(frames, width: int, height: int, qp, n_gops: int,
                        fps=(30000, 1001), device=None, mesh=None):
    """Encode frames as n_gops independent GOPs over `mesh` (None: the
    world's ranks, or one rank on `device` without a process group;
    device None is the CUDA card).  Called on rank 0.  qp as in the
    reference: a scalar, a per-gop list of scalars, or a per-gop list of
    per-frame qp sequences.

    Returns (streams, full_stream, frame_aus): per-gop annex-B segments,
    their concatenation, and per-gop per-frame access units.  Each GOP's
    stream equals that GOP's frames encoded serially by its own
    encoder."""
    G = int(n_gops)
    if not all(ln > 0 for _, ln in split_gops(len(frames), G)):
        raise ValueError("more gops than frames")
    return _mesh_for(mesh, device).run(
        _encode_item, width, height, qp, G, fps, len(frames),
        *_window_args(frames), root=frames)


def _dither(qf, ln):
    """Deterministic error-diffusion dither of a fractional qp over ln
    frames."""
    qf = float(np.clip(qf, 10, 48))
    lo, frac = int(np.floor(qf)), qf % 1.0
    seq, acc = [], 0.0
    for _ in range(ln):
        acc += frac
        if acc >= 1.0:
            seq.append(lo + 1)
            acc -= 1.0
        else:
            seq.append(lo)
    return seq


def _encode_2pass_item(mesh, frames, width, height, target_kbps, G, fps,
                       qp1, n_frames, shapes, dtype):
    """Every rank: pass 1 of its GOPs, the complexities gathered, the
    budgets and qps computed alike everywhere, up to three passes over
    the kept frames with the total size gathered after each; rank 0
    gathers the last pass's access units."""
    gops = _Gops(mesh, frames, width, height, G, fps, n_frames, shapes,
                 dtype, keep=True)
    chunks = gops.chunks
    fps_f = fps[0] / fps[1]
    duration_s = n_frames / fps_f
    total_bits = target_kbps * 1000.0 * duration_s

    def sizes(aus) -> np.ndarray:
        """Every GOP's stream size in bytes."""
        v = np.zeros(G, np.int64)
        for g, a in aus.items():
            v[g] = sum(map(len, a))
        return gather_gops(mesh, v)

    complexity = sizes(gops.encode(qp1)) * 8.0
    budgets = exchange_rc_stats(complexity, total_bits)
    qfs = []
    for g in range(G):
        dq = 6.0 * np.log2(max(complexity[g], 1.0)
                           / max(float(budgets[g]), 1.0))
        qfs.append(float(qp1 + dq))

    corr = 0.0
    for _attempt in range(3):
        qps = [_dither(qfs[g] + corr, ln) for g, (_, ln) in enumerate(chunks)]
        aus = gops.encode(qps)
        actual_kbps = int(sizes(aus).sum()) * 8.0 / duration_s / 1000.0
        if abs(actual_kbps - target_kbps) <= 0.04 * target_kbps:
            break
        # rate-model correction toward the target
        corr += 6.0 * np.log2(actual_kbps / target_kbps)
    frame_aus = gops.gather(aus)
    if frame_aus is None:
        return None
    streams = [b"".join(a) for a in frame_aus]
    return streams, b"".join(streams), {
        "target_kbps": target_kbps, "actual_kbps": actual_kbps,
        "budgets": budgets.tolist(), "pass1_bits": complexity.tolist(),
        "qps": [q[0] for q in qps], "frame_aus": frame_aus}


def encode_gop_parallel_2pass(frames, width: int, height: int,
                              target_kbps: float, n_gops: int,
                              fps=(30000, 1001), qp1: int = 32, device=None,
                              mesh=None):
    """Two-pass GOP-parallel encode to a bitrate target, as the reference
    does it: pass 1 at qp1 measures each GOP's bits, ``exchange_rc_stats``
    shares out the budget, each GOP's budget maps to a fractional qp by
    the 2^(-qp/6) rate model, dithered over its frames, and up to three
    passes correct the qp toward the target (stopping within 4 %).  The
    mesh must span the world (its all_gathers take every rank).

    Returns (streams, full_stream, stats dict)."""
    mesh = _mesh_for(mesh, device)
    if mesh.world is not None and mesh.n not in (1, mesh.world.size):
        raise ValueError("the two-pass encode needs a mesh of the whole "
                         "world")
    return mesh.run(_encode_2pass_item, width, height, float(target_kbps),
                    int(n_gops), fps, qp1, len(frames),
                    *_window_args(frames), root=frames)
