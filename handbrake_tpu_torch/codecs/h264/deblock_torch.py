"""H.264 in-loop deblock (spec 8.7) as torch ops — the counterpart of
``handbrake_tpu/codecs/h264/deblock_tpu.py``.

The normative order (raster MBs; per MB the vertical edges, then the
horizontal ones) has sample dependencies on MB (x-1, y) and (x+1, y-1):
a slope-2 wavefront.  MBs on one anti-diagonal t = x + 2y touch disjoint
samples, so each diagonal is filtered at once, in place on the plane:
a vertical phase over (member, row) lines, then a horizontal phase over
(member, column) lines.  This is the schedule of ``build_deblock_fn``
without its skewed-array layout.

``deblock`` is the public entry.  CPU tensors take ``compute_bs`` and the
plain wavefront ``deblock_plain`` below; CUDA tensors go straight to the
kernel of ``deblock_cuda``, which derives bS itself from the same side
data (no fallback).  The CPU pair is the plain version the tests and
``chip_smoke.py`` hold the kernel against.
"""
from __future__ import annotations

import functools

import torch

from .deblock import deblock_scal


def compute_bs(mb_w, mb_h, mv, nnz, mb_intra, t8):
    """Boundary strengths (spec 8.7.2.1, single ref), as
    ``deblock_tpu.compute_bs``.

    mv: (n_mb, 2) qpel; nnz: (n_mb, 16) per-4x4 counts (raster blocks);
    mb_intra: (n_mb,) bool or None (all inter); t8: (n_mb,) bool or None.
    Returns (bs_v, bs_h), each (mb_h, mb_w, 4 edges, 4 groups) int32."""
    dev = nnz.device
    nnzg = nnz.reshape(mb_h, mb_w, 4, 4) != 0
    if t8 is not None:
        # 8x8-transform MBs: a 4x4 cell counts as coded if any cell of
        # the covering 8x8 block is (hbdec264.cpp block_bs nzl)
        t8m = t8.reshape(mb_h, mb_w, 1, 1).bool()
        q = nnzg.reshape(mb_h, mb_w, 2, 2, 2, 2).any(dim=5).any(dim=3)
        fold = q.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        nnzg = torch.where(t8m, fold, nnzg)
    G = nnzg.permute(0, 2, 1, 3).reshape(mb_h * 4, mb_w * 4)
    intra = (torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev)
             if mb_intra is None else mb_intra.reshape(mb_h, mb_w).bool())
    mvx = mv[:, 0].reshape(mb_h, mb_w).to(torch.int32)
    mvy = mv[:, 1].reshape(mb_h, mb_w).to(torch.int32)
    t8g = (t8.reshape(mb_h, mb_w).bool() if t8 is not None
           else torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev))

    def mb_edge_bs(i_cur, i_nb, nz_p, nz_q, dmx, dmy):
        b_mv = (dmx.abs() >= 4) | (dmy.abs() >= 4)
        return torch.where(i_cur | i_nb, 4, torch.where(
            nz_p | nz_q, 2, torch.where(b_mv, 1, 0)))

    def inner_bs(intra_b, nz_p, nz_q, e, not_t8):
        bs = torch.where(intra_b, 3, torch.where(nz_p | nz_q, 2, 0))
        return bs * not_t8 if e & 1 else bs

    # --- vertical edges: bs_v[y, x, e, k], k = row group ---
    zc = torch.zeros((mb_h, 1), dtype=torch.bool, device=dev)
    zi = torch.zeros((mb_h, 1), dtype=torch.int32, device=dev)
    i_left = torch.cat([zc, intra[:, :-1]], dim=1)
    dmx = mvx - torch.cat([zi, mvx[:, :-1]], dim=1)
    dmy = mvy - torch.cat([zi, mvy[:, :-1]], dim=1)
    Gk = G.reshape(mb_h, 4, mb_w, 4)            # [y, k, x, c]
    not_t8 = (~t8g)[:, None, :]
    has_left = (torch.arange(mb_w, device=dev) > 0)[None, None, :]
    e_list = []
    for e in range(4):
        if e == 0:
            nz_p = torch.cat(
                [torch.zeros((mb_h, 4, 1), dtype=torch.bool, device=dev),
                 Gk[:, :, :-1, 3]], dim=2)      # [y, k, x]
        else:
            nz_p = Gk[:, :, :, e - 1]
        nz_q = Gk[:, :, :, e]
        if e == 0:
            bs = mb_edge_bs(intra[:, None, :], i_left[:, None, :],
                            nz_p, nz_q, dmx[:, None, :], dmy[:, None, :])
            bs = bs * has_left
        else:
            bs = inner_bs(intra[:, None, :], nz_p, nz_q, e, not_t8)
        e_list.append(bs.permute(0, 2, 1))      # (mb_h, mb_w, 4 groups)
    bs_v = torch.stack(e_list, dim=2)

    # --- horizontal edges: bs_h[y, x, e, k], k = column group ---
    zr = torch.zeros((1, mb_w), dtype=torch.bool, device=dev)
    zri = torch.zeros((1, mb_w), dtype=torch.int32, device=dev)
    i_top = torch.cat([zr, intra[:-1, :]], dim=0)
    dmx = mvx - torch.cat([zri, mvx[:-1, :]], dim=0)
    dmy = mvy - torch.cat([zri, mvy[:-1, :]], dim=0)
    Gr = G.reshape(mb_h, 4, mb_w, 4)            # [y, r, x, k]
    not_t8 = (~t8g)[:, :, None]
    has_top = (torch.arange(mb_h, device=dev) > 0)[:, None, None]
    e_list = []
    for e in range(4):
        if e == 0:
            nz_p = torch.cat(
                [torch.zeros((1, mb_w, 4), dtype=torch.bool, device=dev),
                 Gr[:-1, 3, :, :]], dim=0)      # [y, x, k]
        else:
            nz_p = Gr[:, e - 1, :, :]
        nz_q = Gr[:, e, :, :]
        if e == 0:
            bs = mb_edge_bs(intra[:, :, None], i_top[:, :, None],
                            nz_p, nz_q, dmx[:, :, None], dmy[:, :, None])
            bs = bs * has_top
        else:
            bs = inner_bs(intra[:, :, None], nz_p, nz_q, e, not_t8)
        e_list.append(bs)
    bs_h = torch.stack(e_list, dim=2)
    return bs_v.to(torch.int32), bs_h.to(torch.int32)


# ---------------------------------------------------------------------------
# edge filters on lines: each sample argument is an int32 tensor holding
# that sample position of every line; return the new values
# ---------------------------------------------------------------------------
def _clip3(lo, hi, x):
    return torch.minimum(torch.maximum(x, lo), hi)


def _tc0(bs, t0):
    return torch.where(bs <= 1, t0[0], torch.where(bs == 2, t0[1], t0[2]))


def _luma_edge(s, bs, al, bl, t0, with_strong):
    """s: [p3, p2, p1, p0, q0, q1, q2, q3].  Returns the 8 new values."""
    p3, p2, p1, p0, q0, q1, q2, q3 = s
    filt = ((bs > 0) & ((p0 - q0).abs() < al)
            & ((p1 - p0).abs() < bl) & ((q1 - q0).abs() < bl))
    ap = (p2 - p0).abs()
    aq = (q2 - q0).abs()
    tc0 = _tc0(bs, t0)
    tc = tc0 + (ap < bl).int() + (aq < bl).int()
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
    np0 = (p0 + delta).clamp(0, 255)
    nq0 = (q0 - delta).clamp(0, 255)
    avg = (p0 + q0 + 1) >> 1
    np1 = p1 + _clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1)
    nq1 = q1 + _clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1)
    normal = filt & (bs < 4) if with_strong else filt
    o0 = torch.where(normal, np0, p0)
    o4 = torch.where(normal, nq0, q0)
    o1 = torch.where(normal & (ap < bl), np1, p1)
    o5 = torch.where(normal & (aq < bl), nq1, q1)
    if not with_strong:
        return [p3, p2, o1, o0, o4, o5, q2, q3]
    strong = filt & (bs == 4)
    small = (p0 - q0).abs() < ((al >> 2) + 2)
    sp = strong & small & (ap < bl)
    sq = strong & small & (aq < bl)
    o0 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                     torch.where(strong, (2 * p1 + p0 + q1 + 2) >> 2, o0))
    o1 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, o1)
    o2 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    o4 = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                     torch.where(strong, (2 * q1 + q0 + p1 + 2) >> 2, o4))
    o5 = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, o5)
    o6 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    return [p3, o2, o1, o0, o4, o5, o6, q3]


def _chroma_edge(s, bs, al, bl, t0, with_strong):
    """s: [p1, p0, q0, q1].  Returns the 4 new values."""
    p1, p0, q0, q1 = s
    filt = ((bs > 0) & ((p0 - q0).abs() < al)
            & ((p1 - p0).abs() < bl) & ((q1 - q0).abs() < bl))
    tc = _tc0(bs, t0) + 1
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
    normal = filt & (bs < 4) if with_strong else filt
    o0 = torch.where(normal, (p0 + delta).clamp(0, 255), p0)
    o1 = torch.where(normal, (q0 - delta).clamp(0, 255), q0)
    if with_strong:
        strong = filt & (bs == 4)
        o0 = torch.where(strong, (2 * p1 + p0 + q1 + 2) >> 2, o0)
        o1 = torch.where(strong, (2 * q1 + q0 + p1 + 2) >> 2, o1)
    return [p1, o0, o1, q1]


def _filter_plane(P, bs_v, bs_h, mb_w, mb_h, bsz, al, bl, t0,
                  with_strong):
    """Wavefront-filter one plane in place.

    P: (mb_h*bsz + halo, mb_w*bsz + halo) int32, the plane with a halo
    of pad rows on top and pad columns on the left (bS is 0 across the
    frame border, so the pad is read and written back unchanged).
    bs_v/bs_h: (mb_h, mb_w, 4, 4) int32 from compute_bs."""
    dev = P.device
    luma = bsz == 16
    halo, n_edges, width = (4, 4, 8) if luma else (2, 2, 4)
    edge = _luma_edge if luma else _chroma_edge
    # chroma uses luma edges 0 and 2; its 8 lines map to groups by 2
    eidx = torch.arange(4, device=dev) if luma else \
        torch.tensor([0, 2], device=dev)
    grp = torch.arange(bsz, device=dev) // (4 if luma else 2)
    own = torch.arange(bsz, device=dev)
    span = torch.arange(-halo, bsz, device=dev) + halo
    sk = mb_w + 2 * (mb_h - 1)
    for t in range(sk):
        y_lo, y_hi = max(0, (t - mb_w + 2) // 2), min(mb_h - 1, t // 2)
        if y_hi < y_lo:
            continue
        ys = torch.arange(y_lo, y_hi + 1, device=dev)
        xs = t - 2 * ys
        # V phase: lines = (member, row); samples run along columns
        rows = (ys * bsz)[:, None] + own + halo              # (m, bsz)
        cols = (xs * bsz)[:, None] + span                    # (m, halo+bsz)
        w = P[rows[:, :, None], cols[:, None, :]]            # (m, bsz, n)
        bv = bs_v[ys, xs][:, eidx][:, :, grp]                # (m, ne, bsz)
        for e in range(n_edges):
            o = 4 * e
            new = edge([w[:, :, o + j] for j in range(width)], bv[:, e],
                       al, bl, t0, with_strong)
            w[:, :, o:o + width] = torch.stack(new, dim=2)
        P[rows[:, :, None], cols[:, None, :]] = w
        # H phase: lines = (member, column); samples run along rows
        rows = (ys * bsz)[:, None] + span                    # (m, halo+bsz)
        cols = (xs * bsz)[:, None] + own + halo              # (m, bsz)
        w = P[rows[:, :, None], cols[:, None, :]]            # (m, n, bsz)
        bh = bs_h[ys, xs][:, eidx][:, :, grp]
        for e in range(n_edges):
            o = 4 * e
            new = edge([w[:, o + j, :] for j in range(width)], bh[:, e],
                       al, bl, t0, with_strong)
            w[:, o:o + width, :] = torch.stack(new, dim=1)
        P[rows[:, :, None], cols[:, None, :]] = w


def deblock_plain(ry, ru, rv, bs_v, bs_h, scal, with_strong):
    """The plain wavefront: filtered copies of the uint8 planes."""
    mb_h, mb_w = bs_v.shape[:2]
    sc = [int(x) for x in scal]
    out = []
    for plane, bsz, (al, bl, *t0) in ((ry, 16, sc[0:5]), (ru, 8, sc[5:10]),
                                      (rv, 8, sc[5:10])):
        halo = 4 if bsz == 16 else 2
        P = torch.nn.functional.pad(plane.to(torch.int32), (halo, 0, halo, 0))
        _filter_plane(P, bs_v, bs_h, mb_w, mb_h, bsz, al, bl, t0,
                      with_strong)
        out.append(P[halo:, halo:].to(torch.uint8))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _scal(qp: int, qpc: int) -> tuple:
    return tuple(int(v) for v in deblock_scal(qp, qpc))


def deblock(ry, ru, rv, mv, nnz, mb_intra, t8, qp, qpc, with_strong=True):
    """Deblock one frame: (ry, ru, rv) uint8 planes → filtered copies.

    mv (n_mb, 2) qpel, nnz (n_mb, 16) per-4x4 counts, mb_intra and t8
    (n_mb,) bool or None (all inter / no 8x8 transform).  with_strong=False
    is the bS ≤ 2 variant the analyzer chains on all-inter frames (bS 3/4
    then take the normal filter, as the Pallas kernel does).  CPU tensors
    take compute_bs and the plain wavefront; CUDA tensors launch the
    kernel of ``deblock_cuda`` (mv int16, nnz int32, flags bool; no
    fallback); other devices raise."""
    if ry.device.type == "cuda":
        from .deblock_cuda import deblock_cuda
        return deblock_cuda(ry, ru, rv, mv, nnz, mb_intra, t8,
                            _scal(int(qp), int(qpc)), with_strong)
    if ry.device.type != "cpu":
        raise ValueError(f"deblock: unsupported device {ry.device}")
    mb_h, mb_w = ry.shape[0] // 16, ry.shape[1] // 16
    bs_v, bs_h = compute_bs(mb_w, mb_h, mv, nnz, mb_intra, t8)
    return deblock_plain(ry, ru, rv, bs_v, bs_h, deblock_scal(qp, qpc),
                         with_strong)
