"""HEVC P-frame CTU motion analysis as torch ops — the counterpart of
``handbrake_tpu/codecs/hevc/encoder_tpu.py`` (``build_ctu_analyzer_fn``).

Per CTU 32 of a P frame, step for step as the reference:

  * a coarse search on 4x-decimated luma planes: 121 shifts of the
    edge-padded reference, 8x8 block SADs plus 2 * (|dx| + |dy|), the
    first minimum, scaled by 4 and clamped to +-MV_CLAMP full pels;
  * the CTU's 48x48 reference window at the coarse vector;
  * a full-pel refine over +-3 (49 candidates, penalty 3 * (|dx| + |dy|));
  * the aligned 40x40 window at the best full-pel position;
  * the 16 quarter-pel grids, in the exact separable 8-tap arithmetic of
    ``predict.mc_luma``, and the SADs of 25 quarter-pel candidates.

The reference fetches each window with one-hot matmuls because gathers
are slow on a TPU; here a window is an index gather, which selects the
same samples.  Everything is integer (int16 samples and differences,
int32 sums and filter taps), so the card, the CPU and the reference give
the same bits.  Ties take the first minimum, as ``jnp.argmin`` does.

The 121 coarse shifts are one batched tensor; the 49 full-pel and 25
quarter-pel candidates are batched over the CTU axis, CTU_CHUNK CTUs a
pass (1080p's 2040 CTUs in one).
"""
from __future__ import annotations

import numpy as np
import torch

from .tables import LUMA_FILTER
from ...utils.device import resolve_device

PAD_A = 32        # reference padding per side
LOWRES_R = 5      # coarse radius on 4x-decimated planes (= +-20 px)
REFINE_R = 3      # full-pel refine radius
WIN = 48          # CTU window: 32 + 2*8 margin (refine 3 + 8-tap 4 <= 8)
AWIN = 40         # aligned subpel window: 32 + 2*4
MV_CLAMP = 21     # coarse full-pel clamp; 21 + 3 refine <= 24 window reach
CTU_CHUNK = 2048  # CTUs per pass of the per-CTU steps

# the 25 quarter-pel candidates (dqx, dqy), dqy outer, as the reference
_QCANDS = np.array([(dqx, dqy) for dqy in range(-2, 3)
                    for dqx in range(-2, 3)], np.int64)

calls = 0         # analyzer calls, read around a job by the smoke run


def edge_pad(plane: torch.Tensor, p: int) -> torch.Tensor:
    """``np.pad(plane, p, mode="edge")`` as a gather (any dtype)."""
    h, w = plane.shape
    dev = plane.device
    rows = torch.arange(-p, h + p, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-p, w + p, device=dev).clamp_(0, w - 1)
    return plane[rows[:, None], cols[None, :]]


def _penalty(r: int, k: int, device) -> torch.Tensor:
    """k * (|dx| + |dy|) over the (2r+1)^2 shifts, dy outer."""
    d = torch.arange(-r, r + 1, device=device, dtype=torch.int32).abs()
    return (k * (d[:, None] + d[None, :])).reshape(-1)


def _coarse(src: torch.Tensor, ref: torch.Tensor, cw: int, ch: int):
    """The coarse full-pel vector of each CTU (mv_cx, mv_cy), (n,) int64."""
    H, W = src.shape
    h4, w4 = H // 4, W // 4
    s4 = src.reshape(h4, 4, w4, 4).sum((1, 3), dtype=torch.int32) >> 4
    r4 = ref.reshape(h4, 4, w4, 4).sum((1, 3), dtype=torch.int32) >> 4
    side = 2 * LOWRES_R + 1
    win = edge_pad(r4.to(torch.int16), LOWRES_R).unfold(0, h4, 1).unfold(
        1, w4, 1)                                   # (side, side, h4, w4)
    d = (s4.to(torch.int16) - win).abs_()
    blk = d.reshape(side * side, ch, 8, cw, 8).sum((2, 4), dtype=torch.int32)
    cost = blk + _penalty(LOWRES_R, 2, src.device)[:, None, None]
    best = torch.argmin(cost, dim=0).reshape(-1)
    mv_cy = ((best // side - LOWRES_R) * 4).clamp_(-MV_CLAMP, MV_CLAMP)
    mv_cx = ((best % side - LOWRES_R) * 4).clamp_(-MV_CLAMP, MV_CLAMP)
    return mv_cx, mv_cy


def _subpel_grids(A: torch.Tensor, maxval: int) -> torch.Tensor:
    """A: (n, 40, 40) int32, A[:, 4, 4] the block origin at the best
    full-pel position.  Returns (n, 4 fx, 4 fy, 33, 33): [r, c] is the
    interpolated sample at block-relative (c-1 + fx/4, r-1 + fy/4), the
    exact mc_luma arithmetic (raw horizontal filter at scale 64; vertical
    + 2048 >> 12 when fy > 0, else + 32 >> 6)."""
    taps = torch.as_tensor(LUMA_FILTER[1:].T.astype(np.int32),
                           device=A.device)            # (8 taps, 3 phases)
    hacc = A[:, :, 0:33, None] * taps[0]
    for k in range(1, 8):
        hacc = hacc + A[:, :, k:k + 33, None] * taps[k]
    tmp = torch.cat([(A[:, :, 3:36] << 6)[..., None], hacc], -1)
    # tmp: (n, 40 rows, 33 cols, 4 fx)
    vacc = tmp[:, 0:33, :, :, None] * taps[0]
    for k in range(1, 8):
        vacc = vacc + tmp[:, k:k + 33, :, :, None] * taps[k]
    g = torch.cat([((tmp[:, 3:36] + 32) >> 6)[..., None],
                   (vacc + (1 << 11)) >> 12], -1)   # (n, 33, 33, fx, fy)
    return g.clamp_(0, maxval).permute(0, 3, 4, 1, 2)


def _refine(wy: torch.Tensor, src_ctu: torch.Tensor, maxval: int):
    """Full-pel then quarter-pel refine of CTUs whose 48x48 windows are
    wy (n, 48, 48) int16 and sources src_ctu (n, 32, 32) int16.  Returns
    (fdx, fdy, qdx, qdy, sad): the refine's steps and the best SAD."""
    n = wy.shape[0]
    r = REFINE_R
    side = 2 * r + 1
    ar = torch.arange(n, device=wy.device)
    cand = wy.unfold(1, 32, 1).unfold(2, 32, 1)[:, 8 - r:9 + r, 8 - r:9 + r]
    sad = (cand - src_ctu[:, None, None]).abs_().sum((3, 4),
                                                     dtype=torch.int32)
    cost = sad.reshape(n, side * side) + _penalty(r, 3, wy.device)
    fbi = torch.argmin(cost, dim=1)
    fdy, fdx = fbi // side - r, fbi % side - r
    A = wy.unfold(1, AWIN, 1).unfold(2, AWIN, 1)[ar, 4 + fdy, 4 + fdx]
    grids = _subpel_grids(A.to(torch.int32), maxval)
    q = torch.as_tensor(_QCANDS, device=wy.device)
    pred = grids.unfold(3, 32, 1).unfold(4, 32, 1)[
        :, q[:, 0] & 3, q[:, 1] & 3, 1 + (q[:, 1] >> 2), 1 + (q[:, 0] >> 2)]
    qsad = (pred - src_ctu[:, None].to(torch.int32)).abs_().sum(
        (2, 3), dtype=torch.int32)                      # (n, 25)
    qbi = torch.argmin(qsad, dim=1)
    best = qsad.gather(1, qbi[:, None])[:, 0]
    return fdx, fdy, q[qbi, 0], q[qbi, 1], best


def analyze_ctus(src_y: torch.Tensor, ref_y: torch.Tensor, cw: int, ch: int,
                 maxval: int = 255) -> dict:
    """src_y, ref_y: (32 ch, 32 cw) luma planes (any integer dtype) on one
    device.  Returns {"mv": (n, 2) quarter-pel int32 (x, y), "sad": (n,)
    f32} for the n = cw * ch CTUs in raster order, on that device."""
    global calls
    calls += 1
    dev = src_y.device
    n = cw * ch
    src = src_y.to(torch.int16)
    ref = ref_y.to(torch.int16)
    mv_cx, mv_cy = _coarse(src, ref, cw, ch)

    src_ctu = src.reshape(ch, 32, cw, 32).permute(0, 2, 1, 3).reshape(
        n, 32, 32)
    refp = edge_pad(ref, PAD_A)
    cy = torch.arange(ch, device=dev).repeat_interleave(cw)
    cx = torch.arange(cw, device=dev).repeat(ch)
    ar = torch.arange(WIN, device=dev)
    r0 = 32 * cy + mv_cy + (PAD_A - 8)
    c0 = 32 * cx + mv_cx + (PAD_A - 8)
    parts = []
    for i in range(0, n, CTU_CHUNK):
        j = min(n, i + CTU_CHUNK)
        wy = refp[(r0[i:j, None] + ar)[:, :, None],
                  (c0[i:j, None] + ar)[:, None, :]]     # (j-i, 48, 48)
        parts.append(_refine(wy, src_ctu[i:j], maxval))
    fdx, fdy, qdx, qdy, sad = (torch.cat(p) for p in zip(*parts))
    mvx = (mv_cx + fdx) * 4 + qdx
    mvy = (mv_cy + fdy) * 4 + qdy
    return {"mv": torch.stack([mvx, mvy], 1).to(torch.int32),
            "sad": sad.to(torch.float32)}


def build_ctu_analyzer(cw: int, ch: int, qp: int, maxval: int = 255,
                       device=None):
    """analyze(src_y, src_u, src_v, ref_y, ref_u, ref_v) -> {"mv", "sad"}
    as numpy, run on `device` (None: the CUDA card; the encoder's call site of the reference's
    jitted analyzer).  qp is reserved, as in the reference; chroma MC is
    recomputed on the host."""
    del qp
    dev = resolve_device(device)

    def analyze(src_y, src_u, src_v, ref_y, ref_u, ref_v):
        del src_u, src_v, ref_u, ref_v
        s = torch.from_numpy(np.ascontiguousarray(src_y, np.int16)).to(dev)
        r = torch.from_numpy(np.ascontiguousarray(ref_y, np.int16)).to(dev)
        out = analyze_ctus(s, r, cw, ch, maxval)
        return {k: v.cpu().numpy() for k, v in out.items()}

    return analyze
