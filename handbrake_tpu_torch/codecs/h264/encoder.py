"""H.264 encoder — the counterpart of ``H264Encoder`` in
``handbrake_tpu/codecs/h264/encoder.py``, with its two backends.

``backend="device"`` (the default): IDR frames are coded by the native
C++ I slice and filtered by the native deblock; the recon is then
uploaded once, so the next P frame's reference lies on the device.  P
frames run the analyzer (``analyzer.py``, with the deblock kernel chained
when the in-loop filter is on) on the device; the native CABAC/CAVLC P
slice then codes them on the host from a compact device→host fetch.  MBs
whose inter SAD is poor fall back to intra in the native stage, which
patches a host copy of the recon; in-flight analyses that used the stale
reference are re-run against the patched one (``_propagate_refs``).
With ``intra4x4`` the I slices go through the host walker instead.

``backend="host"``: the numpy MB walker codes every frame with CAVLC
(Intra16x16 and, with ``intra4x4``, Intra4x4; P_L0_16x16 and P_Skip from
a host motion search; the 8x8 inter transform), optionally steered by an
``analysis`` dict of per-MB hints.  Its in-loop filter is the native
``hb264_deblock``.  The module-level engine (MBCtx, motion_search, the
luma/chroma transforms) is what ``encoder_b.py`` builds on.

Pipelined use overlaps the device analysis of frame N+1 with the host
entropy coding of frame N::

    p0 = enc.begin_frame(y0, u0, v0)
    p1 = enc.begin_frame(y1, u1, v1)   # device starts frame 1
    out0 = enc.finish_frame(p0)         # host codes frame 0

``encode_p_from_analysis`` codes one P frame from analysis computed
elsewhere: the GOP-parallel path (``parallel/gop.py``) analyses frame t
of every GOP in one call and each GOP's encoder walks its own frames.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from . import predict as P
from . import transform as T
from ...native import get_lib
from ...utils.device import resolve_device
from .analyzer import (build_p_analyzer, build_p_analyzer_batch,
                       intra_thresh_for_qp)
from .bits import nal_unit
from .cavlc import encode_residual, nc_context
from .syntax import NAL_IDR, NAL_SLICE, PPS, SLICE_I, SLICE_P, SPS, \
    SliceHeader
from .tables import CBP_INTER_INV, CBP_INTRA4x4_INV, ZIGZAG_4x4
from ..vui import sar16

PAD = 32  # reference-plane edge padding for ME/MC


def _ue_len(v: int) -> int:
    return 2 * (v + 1).bit_length() - 1


def _se_len(v: int) -> int:
    k = (2 * v - 1) if v > 0 else (-2 * v)
    return _ue_len(k)


def _sad(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


@dataclasses.dataclass
class EncoderConfig:
    width: int
    height: int
    qp: int = 26
    gop: int = 60                 # IDR interval in frames
    search_range: int = 16        # full-pel ME radius (host walker)
    fps: tuple = (30000, 1001)
    chroma_qp_offset: int = 0
    level_idc: int = 40
    # "device": analysis on the device, native slice coding; "host": the
    # numpy CAVLC walker.  Only a caller who asks gets "host".
    backend: str = "device"
    deblock: bool = False         # in-loop deblocking (spec 8.7)
    cabac: bool = False           # CABAC entropy coding (Main/High)
    # Intra_4x4 in the host walker: I slices go through it on either
    # backend
    intra4x4: bool = False
    transform8x8: bool = False    # 8x8 transform for inter MBs (High)
    # analyze N consecutive P frames per dispatch, chaining the recon on
    # the device; the batch shares one qp
    dispatch_batch: int = 1
    # the pixel aspect the SPS's VUI signals (1:1: none is written)
    sar: tuple = (1, 1)


class MBCtx:
    """Per-frame mutable coding state shared by encoder and decoder."""

    def __init__(self, mb_w: int, mb_h: int):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.nnz_l = np.zeros((mb_h * 4, mb_w * 4), np.int32)
        self.nnz_cb = np.zeros((mb_h * 2, mb_w * 2), np.int32)
        self.nnz_cr = np.zeros((mb_h * 2, mb_w * 2), np.int32)
        self.mvs: dict = {}       # (mbx,mby) -> (mvx,mvy)
        self.refs: dict = {}      # (mbx,mby) -> 0 inter | -1 intra
        self.t8x8 = np.zeros((mb_h, mb_w), bool)

    def nc_luma(self, by: int, bx: int) -> int:
        return nc_context(int(self.nnz_l[by, bx - 1]) if bx > 0 else 0,
                          int(self.nnz_l[by - 1, bx]) if by > 0 else 0,
                          bx > 0, by > 0)

    def nc_chroma(self, plane, by: int, bx: int) -> int:
        return nc_context(int(plane[by, bx - 1]) if bx > 0 else 0,
                          int(plane[by - 1, bx]) if by > 0 else 0,
                          bx > 0, by > 0)


def zigzag(block4: np.ndarray) -> list:
    """4x4 coeff matrix → 16 levels in zigzag scan order."""
    return [int(v) for v in block4.reshape(16)[ZIGZAG_4x4]]


# ---------------------------------------------------------------------------
# Intra luma 16x16: analyse + reconstruct
# ---------------------------------------------------------------------------
def _i16_neighbors(recon_y, mbx, mby):
    x0, y0 = mbx * 16, mby * 16
    top = recon_y[y0 - 1, x0:x0 + 16].astype(np.int32) if mby > 0 else None
    left = recon_y[y0:y0 + 16, x0 - 1].astype(np.int32) if mbx > 0 else None
    topleft = int(recon_y[y0 - 1, x0 - 1]) if (mbx > 0 and mby > 0) else None
    return top, left, topleft


def i16_candidate_modes(top, left, topleft):
    modes = [P.I16_DC]
    if top is not None:
        modes.append(P.I16_V)
    if left is not None:
        modes.append(P.I16_H)
    if top is not None and left is not None and topleft is not None:
        modes.append(P.I16_PLANE)
    return modes


def encode_i16_luma(src16, pred16, qp):
    """Transform+quant an I16 MB. Returns (dc_levels_scan, ac_levels[16][16],
    recon16, cbp_ac, nnz_per_block[16 raster])."""
    res = src16.astype(np.int32) - pred16
    blocks = T.to_blocks4(np, res)                      # (16,4,4) raster
    w = T.fdct4x4(np, blocks)
    dc_raster = w[:, 0, 0].reshape(4, 4)                # DC per block, raster
    dch = T.hadamard4x4(np, dc_raster[None])[0] // 2    # x264 dct4x4dc halving
    dclv = T.quant_dc(np, dch, qp, intra=True)
    ac = w.copy()
    ac[:, 0, 0] = 0
    aclv = T.quant4x4(np, ac, qp, intra=True)

    # reconstruction (spec 8.5.6 + 8.5.12)
    f = T.ihadamard4x4(np, dclv[None])[0]
    dcq = T.dequant_luma_dc(np, f, qp)
    dq = T.dequant4x4(np, aclv, qp)
    dq[:, 0, 0] = dcq.reshape(16)
    r = T.idct4x4(np, dq)
    recon = np.clip(pred16 + T.from_blocks4(np, r, 16, 16), 0, 255)

    nnz = (aclv.reshape(16, 16) != 0).sum(axis=1)
    cbp_ac = int(nnz.sum() > 0)
    dc_scan = [int(v) for v in dclv.reshape(16)[ZIGZAG_4x4]]
    return dc_scan, aclv, recon, cbp_ac, nnz


# ---------------------------------------------------------------------------
# Chroma (shared by intra and inter MBs)
# ---------------------------------------------------------------------------
def encode_chroma(src8, pred8, qpc, intra):
    """One chroma component 8x8. Returns (dc_scan4, ac_levels[4], recon8,
    has_dc, has_ac, nnz_per_block[4 raster])."""
    res = src8.astype(np.int32) - pred8
    blocks = T.to_blocks4(np, res)                      # (4,4,4)
    w = T.fdct4x4(np, blocks)
    dc = w[:, 0, 0].reshape(2, 2)
    dch = T.hadamard2x2(np, dc[None])[0]
    dclv = T.quant_dc(np, dch, qpc, intra=intra)
    ac = w.copy()
    ac[:, 0, 0] = 0
    aclv = T.quant4x4(np, ac, qpc, intra=intra)

    f = T.hadamard2x2(np, dclv[None])[0]
    dcq = T.dequant_chroma_dc(np, f, qpc)
    dq = T.dequant4x4(np, aclv, qpc)
    dq[:, 0, 0] = dcq.reshape(4)
    r = T.idct4x4(np, dq)
    recon = np.clip(pred8 + T.from_blocks4(np, r, 8, 8), 0, 255)

    nnz = (aclv.reshape(4, 16) != 0).sum(axis=1)
    dc_scan = [int(dclv[0, 0]), int(dclv[0, 1]), int(dclv[1, 0]),
               int(dclv[1, 1])]
    has_dc = any(v != 0 for v in dc_scan)
    has_ac = bool(nnz.sum() > 0)
    return dc_scan, aclv, recon, has_dc, has_ac, nnz


def _chroma_neighbors(plane, mbx, mby):
    x0, y0 = mbx * 8, mby * 8
    top = plane[y0 - 1, x0:x0 + 8].astype(np.int32) if mby > 0 else None
    left = plane[y0:y0 + 8, x0 - 1].astype(np.int32) if mbx > 0 else None
    topleft = int(plane[y0 - 1, x0 - 1]) if (mbx > 0 and mby > 0) else None
    return top, left, topleft


def chroma_candidate_modes(top, left):
    modes = [P.CHROMA_DC]
    if left is not None:
        modes.append(P.CHROMA_H)
    if top is not None:
        modes.append(P.CHROMA_V)
    if top is not None and left is not None:
        modes.append(P.CHROMA_PLANE)
    return modes


# ---------------------------------------------------------------------------
# Inter: 16x16 full+subpel motion estimation (host reference; device path in
# encoder_tpu computes the same SADs batched)
# ---------------------------------------------------------------------------
def motion_search(src16, ref_pad, x0, y0, pred_mv, rng, lm):
    """Return (mvx, mvy) quarter-pel minimizing SAD + lm*mvd_bits."""
    W = ref_pad.shape[1] - 2 * PAD
    H = ref_pad.shape[0] - 2 * PAD
    # clamp full-pel displacement so the 21x21 interp window stays inside pad
    lo_x = max(-rng, -(x0 + PAD - 8))
    hi_x = min(rng, W + PAD - 8 - (x0 + 16))
    lo_y = max(-rng, -(y0 + PAD - 8))
    hi_y = min(rng, H + PAD - 8 - (y0 + 16))

    def cost_full(dx, dy):
        blk = ref_pad[y0 + dy + PAD:y0 + dy + PAD + 16,
                      x0 + dx + PAD:x0 + dx + PAD + 16]
        mvd_bits = (_se_len(4 * dx - pred_mv[0]) + _se_len(4 * dy - pred_mv[1]))
        return _sad(src16, blk) + lm * mvd_bits

    # start at predicted mv (full-pel) and (0,0)
    starts = {(0, 0), (int(np.clip(pred_mv[0] >> 2, lo_x, hi_x)),
               int(np.clip(pred_mv[1] >> 2, lo_y, hi_y)))}
    best, bc = (0, 0), None
    for s in starts:
        c = cost_full(*s)
        if bc is None or c < bc:
            best, bc = s, c
    # diamond refinement
    step = max(1, rng // 2)
    while step >= 1:
        improved = True
        while improved:
            improved = False
            for dx, dy in ((step, 0), (-step, 0), (0, step), (0, -step)):
                nx, ny = best[0] + dx, best[1] + dy
                if not (lo_x <= nx <= hi_x and lo_y <= ny <= hi_y):
                    continue
                c = cost_full(nx, ny)
                if c < bc:
                    best, bc = (nx, ny), c
                    improved = True
        step //= 2

    # sub-pel refine: half then quarter around the best
    bmv = (best[0] * 4, best[1] * 4)
    bcost = None
    for phase in (2, 1):
        cand_best = bmv
        for dy in (-phase, 0, phase):
            for dx in (-phase, 0, phase):
                mv = (bmv[0] + dx, bmv[1] + dy)
                blk = P.mc_luma_block(ref_pad, PAD, x0, y0, 16, 16,
                                      mv[0], mv[1])
                c = (_sad(src16, blk)
                     + lm * (_se_len(mv[0] - pred_mv[0])
                             + _se_len(mv[1] - pred_mv[1])))
                if bcost is None or c < bcost:
                    cand_best, bcost = mv, c
        bmv = cand_best
    return bmv


def encode_inter_luma(src16, pred16, qp):
    """Transform+quant inter residual. Returns (levels(16,4,4), recon16,
    cbp_luma 4bit, nnz[16])."""
    res = src16.astype(np.int32) - pred16
    blocks = T.to_blocks4(np, res)
    w = T.fdct4x4(np, blocks)
    lv = T.quant4x4(np, w, qp, intra=False)
    nnz = (lv.reshape(16, 16) != 0).sum(axis=1)
    # cbp per 8x8 quadrant (raster-block index: quadrant = (i//8)*2+((i%4)//2))
    idx = np.arange(16)
    quad = (idx // 8) * 2 + (idx % 4) // 2
    cbp = 0
    for q in range(4):
        if nnz[quad == q].sum() > 0:
            cbp |= 1 << q
    # zero uncoded quadrants (they are not transmitted)
    for q in range(4):
        if not (cbp >> q) & 1:
            lv[quad == q] = 0
            nnz[quad == q] = 0
    dq = T.dequant4x4(np, lv, qp)
    r = T.idct4x4(np, dq)
    recon = np.clip(pred16 + T.from_blocks4(np, r, 16, 16), 0, 255)
    return lv, recon, cbp, nnz


def encode_inter_luma8(src16, pred16, qp):
    """8x8-transform inter residual (High profile, spec 8.5.12.3/8.5.13.1).
    Returns (subs(16,16) CAVLC sub-streams in MB z-order, recon16,
    cbp_luma 4bit, nnz(4,4) per 4x4 cell raster-within-MB).

    CAVLC carries each 8x8 quadrant as four interleaved 16-coeff
    sub-streams (sub-stream j takes scan positions 4i+j of the 8x8 zigzag;
    hbdec264.cpp parse_residual_cavlc `coeff8[quad][4*i + (k&3)]`)."""
    res = src16.astype(np.int32) - pred16
    quads = np.stack([res[(q // 2) * 8:(q // 2) * 8 + 8,
                          (q % 2) * 8:(q % 2) * 8 + 8] for q in range(4)])
    lv8 = T.fquant8x8(np, quads, qp, intra=False)
    cbp = 0
    for q in range(4):
        if np.any(lv8[q]):
            cbp |= 1 << q
        else:
            lv8[q] = 0
    rq = T.idct8x8(np, T.dequant8x8(np, lv8, qp))
    recon = pred16.astype(np.int32).copy()
    for q in range(4):
        if (cbp >> q) & 1:
            y0, x0 = (q // 2) * 8, (q % 2) * 8
            recon[y0:y0 + 8, x0:x0 + 8] = np.clip(
                recon[y0:y0 + 8, x0:x0 + 8] + rq[q], 0, 255)
    # sub-streams + per-cell nnz: z-order k within MB, quad = k>>2, j = k&3
    subs = np.zeros((16, 16), np.int32)
    nnz = np.zeros(16, np.int32)                 # per raster 4x4 cell
    for k in range(16):
        q, j = k >> 2, k & 3
        scan = lv8[q].ravel()[T.ZIG8]
        sub = scan[j::4]
        subs[k] = sub
        nnz[int(_CODED_ORDER[k])] = int((sub != 0).sum())
    return subs, recon, cbp, nnz


# raster 4x4-block index within MB for coded (zig) order
_CODED_ORDER = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15])
# _CODED_ORDER[k] = raster index of k-th coded block
_CODED_ORDER_C = np.array([0, 1, 2, 3])



def _to_np(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()


class _D2H:
    """A device→host copy started ahead of use: a non_blocking copy into
    pinned host memory, recorded with a CUDA event (the role of
    copy_to_host_async)."""
    __slots__ = ("host", "event")

    def __init__(self, t):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _fetch(items, pre=None) -> list:
    """Host copies of `items` (tensors or numpy arrays), using the
    copies started for them where there are any (pre: id → _D2H)."""
    out = []
    for x in items:
        d = pre.get(id(x)) if pre else None
        out.append(d.numpy() if d is not None else _to_np(x))
    return out


class _Pending:
    """In-flight frame: device analysis dispatched, entropy not yet done."""
    __slots__ = ("kind", "done_bytes", "dev", "qp", "qpc", "src",
                 "packed_src", "refs", "redo_refs", "frame_num",
                 "batch", "batch_next")

    def __init__(self):
        self.kind = "done"
        self.done_bytes = b""
        self.dev = None
        self.redo_refs = None
        self.batch = None            # (rec, k) once dispatched batched
        self.batch_next = None       # next pending of the same batch


class _BatchRec:
    """One dispatched N-frame batch: stacked analyzer outputs and the
    host copy of what the entropy stage reads, started at dispatch."""
    __slots__ = ("outs", "n_real", "small_np", "payload_np", "nch",
                 "next_first", "_pre")

    def __init__(self, outs, n_real, guess):
        self.outs = outs
        self.n_real = n_real
        self.small_np = None
        self.payload_np = None
        self.next_first = None       # first pending of the next batch
                                     # that consumed this batch's carry
        src = outs["payload_nib"]
        self.nch = max(1, min(guess, src.shape[1]))
        self._pre = (_D2H(outs["packed_small"]), _D2H(src[:, :self.nch]))

    def fetch(self):
        if self.small_np is None:
            self.small_np, self.payload_np = (d.numpy() for d in self._pre)


class H264Encoder:
    """Stateful one-ref H.264 encoder. encode_frame() → annex-B bytes.
    device=None runs on the CUDA card; the host backend's recon stays
    in host memory."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.backend not in ("device", "host"):
            raise ValueError(f"h264: unknown backend {cfg.backend!r}")
        if cfg.cabac and (cfg.backend == "host" or cfg.intra4x4):
            # the walker writes CAVLC: under a CABAC PPS its slices
            # would be corrupt
            raise ValueError("h264: the host walker (backend='host', "
                             "intra4x4) codes CAVLC only, not CABAC")
        self._natlib = get_lib()
        w, h = cfg.width, cfg.height
        self.mb_w = (w + 15) // 16
        self.mb_h = (h + 15) // 16
        self.sps = SPS(profile_idc=100 if cfg.transform8x8
                       else (77 if cfg.cabac else 66),
                       width_mbs=self.mb_w, height_mbs=self.mb_h,
                       crop_right=self.mb_w * 16 - w,
                       crop_bottom=self.mb_h * 16 - h,
                       level_idc=cfg.level_idc,
                       vui_timing=(cfg.fps[1], 2 * cfg.fps[0]),
                       sar=sar16(*cfg.sar, "h264: the pixel aspect"))
        self.pps = PPS(pic_init_qp=cfg.qp,
                       chroma_qp_index_offset=cfg.chroma_qp_offset,
                       cabac=cfg.cabac,
                       transform_8x8=cfg.transform8x8)
        self.frame_num = 0
        self.idr_pic_id = 0
        self.frame_idx = 0
        self.recon_y = None
        self.recon_u = None
        self.recon_v = None
        self.last_frame_was_idr = False
        self._queue = collections.deque()   # in-flight begin_frame order
        self._nch_guess = 8                 # payload chunks likely needed
        self._batch_accum = []
        self._batch_n = 1
        self._batch_analyzer = None
        self._last_batch_rec = None
        self._last_carry = None
        self._dummy_rec = None
        self._ipred4 = None  # the walker's Intra4x4 modes of the frame
        self.n_redo = 0     # analyses re-run after an intra-fallback patch
        # SAD-domain lambda of the walker's mode decisions
        self.lm = 0.85 * 2 ** ((cfg.qp - 12) / 6.0)
        self._analyzer = None
        if cfg.backend == "host":
            return
        self._analyzer = build_p_analyzer(
            self.mb_w, self.mb_h, deblock=cfg.deblock,
            transform8x8=cfg.transform8x8)
        if cfg.dispatch_batch > 1:
            self._batch_n = int(cfg.dispatch_batch)
            self._batch_analyzer = build_p_analyzer_batch(
                self.mb_w, self.mb_h, self._batch_n,
                deblock=cfg.deblock, transform8x8=cfg.transform8x8)

    @classmethod
    def from_reference_state(cls, cfg: EncoderConfig, state: dict,
                             device=None) -> "H264Encoder":
        """Continue a stream another encoder began.  state holds what
        ``handbrake_tpu``'s encoder keeps between frames, as numpy and
        ints: recon_y/u/v, frame_num, frame_idx, idr_pic_id.  No frame
        may be in flight in that encoder."""
        enc = cls(cfg, device)
        enc.frame_num = int(state["frame_num"])
        enc.frame_idx = int(state["frame_idx"])
        enc.idr_pic_id = int(state["idr_pic_id"])
        enc._set_recon(state["recon_y"], state["recon_u"], state["recon_v"])
        return enc

    # -- frame-level -------------------------------------------------------
    def headers(self) -> bytes:
        return self.sps.to_nal() + self.pps.to_nal()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload_planes(self, *planes):
        return tuple(self._upload(np.asarray(p, np.uint8)) for p in planes)

    def _set_recon(self, y, u, v):
        """The next frame's reference: uploaded for the device analyzer,
        kept on the host for the walker."""
        if self._analyzer is not None:
            y, u, v = self._upload_planes(y, u, v)
        self.recon_y, self.recon_u, self.recon_v = y, u, v

    def _pad_to_mb(self, plane, mbsize):
        Ht, Wt = self.mb_h * mbsize, self.mb_w * mbsize
        h, w = plane.shape
        if (h, w) == (Ht, Wt):
            return np.ascontiguousarray(plane, np.uint8)
        return np.pad(plane.astype(np.uint8),
                      ((0, Ht - h), (0, Wt - w)), mode="edge")

    def encode_frame(self, y, u, v, analysis=None, qp=None) -> bytes:
        """Encode one frame (y: HxW, u/v: H/2 x W/2, uint8). Returns NALs.
        qp overrides cfg.qp for this frame."""
        return self.finish_frame(self.begin_frame(y, u, v, analysis, qp))

    def begin_frame(self, y, u, v, analysis=None, qp=None):
        """Dispatch frame analysis. IDR and host-backend frames are
        encoded at once; device P frames return with the device analysis
        in flight.  Call finish_frame() in FIFO order.  analysis (host
        backend only): {(mbx, mby): {"i16_mode": m, "mv": (x, y)}} hints
        that replace the walker's own mode and motion search."""
        if analysis is not None and self._analyzer is not None:
            # the device analyzer has no use for them: the reference
            # drops them on its P frames
            raise ValueError("h264: analysis= steers the host walker; "
                             "it needs backend='host'")
        idr = (self.frame_idx % self.cfg.gop) == 0
        if idr and self._batch_accum:
            # the accumulated P frames anchor on the pre-IDR recon chain
            self._dispatch_batch()
        self.last_frame_was_idr = idr
        qp = self.cfg.qp if qp is None else int(qp)
        self.lm = 0.85 * 2 ** ((qp - 12) / 6.0)
        out = b""
        if idr:
            out += self.headers()
            self.frame_num = 0
        yp = self._pad_to_mb(y, 16)
        up = self._pad_to_mb(u, 8)
        vp = self._pad_to_mb(v, 8)
        p = _Pending()
        p.qp = qp
        p.frame_num = self.frame_num
        if not idr and self._analyzer is not None:
            p.kind = "p"
            p.qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
            p.src = (yp, up, vp)
            # one host→device transfer per frame (planes packed)
            p.packed_src = np.concatenate([yp.ravel(), up.ravel(),
                                           vp.ravel()])
            p.done_bytes = out
            if self._batch_analyzer is not None:
                p.refs = None
                self._batch_accum.append(p)
                if len(self._batch_accum) >= self._batch_n:
                    self._dispatch_batch()
            else:
                p.refs = (self.recon_y, self.recon_u, self.recon_v)
                p.dev = self._analyze(p)
                # next frame's reference = this frame's device recon
                self.recon_y = p.dev["recon_y"]
                self.recon_u = p.dev["urec"]
                self.recon_v = p.dev["vrec"]
        else:
            p.done_bytes = out + self._encode_slice(yp, up, vp, idr,
                                                    analysis, qp)
        self.frame_num = ((self.frame_num + 1)
                          % (1 << self.sps.log2_max_frame_num))
        self.frame_idx += 1
        self._queue.append(p)
        return p

    def _analyze(self, p):
        """Run the single-frame analyzer for p against p.refs and start
        the device→host copies of what the entropy stage reads: under
        pipelined use they overlap the next frame's device work."""
        dev = self._analyzer(self._upload(p.packed_src), *p.refs, p.qp,
                             p.qpc)
        chunks = dev["payload_nib"]
        items = [dev["packed_small"]] + chunks[:min(len(chunks),
                                                    self._nch_guess)]
        dev["_pre"] = {id(t): _D2H(t) for t in items}
        return dev

    def _dispatch_batch(self):
        """Run the accumulated P frames through the batched analyzer in
        one dispatch (cfg.dispatch_batch)."""
        accum = self._batch_accum
        if not accum:
            return
        self._batch_accum = []
        qp, qpc = accum[0].qp, accum[0].qpc
        for p in accum:              # the batch shares one qp (RC per batch)
            p.qp, p.qpc = qp, qpc
        srcs = np.stack([p.packed_src for p in accum])
        refs = (self.recon_y, self.recon_u, self.recon_v)
        outs = self._batch_analyzer(self._upload(srcs), *refs, qp, qpc)
        rec = _BatchRec(outs, len(accum), self._nch_guess)
        for k, p in enumerate(accum):
            p.batch = (rec, k)
            p.batch_next = accum[k + 1] if k + 1 < len(accum) else None
        # link for carry-patch propagation: if our refs were the carry of
        # a previous batch record, that record must know whom to redo
        prev = self._last_batch_rec
        if prev is not None and refs[0] is self._last_carry:
            prev.next_first = accum[0]
        k_last = len(accum) - 1
        self.recon_y = outs["recon_y"][k_last]
        self.recon_u = outs["urec"][k_last]
        self.recon_v = outs["vrec"][k_last]
        self._last_batch_rec = rec
        self._last_carry = self.recon_y

    def _batched_dev(self, p):
        """Per-frame view dict over a _BatchRec, shaped like a
        single-frame analyzer output for _encode_slice_device."""
        rec, k = p.batch
        rec.fetch()
        outs = rec.outs
        n_chunks = outs["payload"].shape[1]
        dev = {"packed_small": rec.small_np[k],
               "payload": [outs["payload"][k, c] for c in range(n_chunks)],
               "payload_nib": [rec.payload_np[k, c] if c < rec.nch
                               else outs["payload_nib"][k, c]
                               for c in range(n_chunks)]}
        for key in ("luma_lv", "udc", "uac", "vdc", "vac",
                    "recon_y", "urec", "vrec",
                    "recon_y_nf", "urec_nf", "vrec_nf"):
            if key in outs:
                dev[key] = outs[key][k]
        dev["_batch_next"] = p.batch_next
        dev["_batch_last"] = (k == rec.n_real - 1)
        dev["_batch_rec"] = rec
        return dev

    def finish_frame(self, p) -> bytes:
        """Entropy-code a begun frame. Must be called in begin order."""
        if not (self._queue and self._queue[0] is p):
            raise RuntimeError("h264: finish_frame order must be FIFO")
        self._queue.popleft()
        if p.kind == "done":
            return p.done_bytes
        if p.kind == "p" and p.dev is None and p.batch is None \
                and p.redo_refs is None:
            self._dispatch_batch()   # partial-batch flush
        if p.redo_refs is not None:
            # a predecessor patched the reference this analysis consumed
            # (intra fallback after dispatch) — re-run against the fix
            old = p.dev if p.dev is not None else \
                (self._batched_dev(p) if p.batch is not None else None)
            p.refs = p.redo_refs
            p.dev = self._analyze(p)
            self.n_redo += 1
            new = (p.dev["recon_y"], p.dev["urec"], p.dev["vrec"])
            if old is not None:
                self._propagate_refs(old, new)
            if p.batch_next is not None:
                # the batch successor's analysis also used stale refs
                p.batch_next.redo_refs = new
            p.batch = None
        dev = p.dev if p.dev is not None else self._batched_dev(p)
        return p.done_bytes + self._encode_slice_device(
            p.src[0], p.src[1], p.src[2], dev, p.qp, p.frame_num)

    def encode_p_from_analysis(self, yp, up, vp, dev, qp=None) -> bytes:
        """Entropy-code one P frame from analyzer outputs computed
        outside this encoder (the GOP-parallel path: the analysis of every
        GOP's frame ran in one call; this owns the GOP's sequential walk
        and state).  yp/up/vp are MB-aligned host planes; dev holds this
        frame's analyzer outputs, whose recon becomes the reference."""
        qp = self.cfg.qp if qp is None else int(qp)
        self.recon_y = dev["recon_y"]
        self.recon_u = dev["urec"]
        self.recon_v = dev["vrec"]
        out = self._encode_slice_device(yp, up, vp, dev, qp, self.frame_num)
        self.frame_num = ((self.frame_num + 1)
                          % (1 << self.sps.log2_max_frame_num))
        self.frame_idx += 1
        self.last_frame_was_idr = False
        return out

    def _propagate_refs(self, old_dev, new_refs):
        """Re-point everything that referenced old_dev's recon planes."""
        for q in self._queue:
            if q.kind == "p" and q.refs is not None \
                    and q.refs[0] is old_dev["recon_y"]:
                # keep q.refs current so a later propagation (e.g. the
                # re-dispatched frame itself getting patched) still matches
                q.refs = new_refs
                q.redo_refs = new_refs
        # batched frames chain explicitly (views break identity checks)
        nxt = old_dev.get("_batch_next")
        if nxt is not None and nxt in self._queue:
            nxt.redo_refs = new_refs
        if old_dev.get("_batch_last"):
            rec = old_dev.get("_batch_rec")
            if rec is not None and rec.next_first is not None \
                    and rec.next_first in self._queue:
                # a later batch consumed this batch's (now stale) carry
                rec.next_first.redo_refs = new_refs
            if self.recon_y is self._last_carry \
                    and rec is self._last_batch_rec:
                self.recon_y, self.recon_u, self.recon_v = new_refs
                self._last_carry = self.recon_y
        if self.recon_y is old_dev["recon_y"]:
            self.recon_y, self.recon_u, self.recon_v = new_refs

    # -- native (C++) stage ------------------------------------------------
    def _nal(self, ref_idc: int, ntype: int, rbsp: bytes) -> bytes:
        inb = np.frombuffer(rbsp, np.uint8)
        out = np.empty(len(rbsp) + len(rbsp) // 2 + 8, np.uint8)
        n = self._natlib.hb264_rbsp_to_ebsp(
            self._u8p(inb), len(rbsp), self._u8p(out), out.size)
        if n < 0:
            raise RuntimeError("h264: NAL emulation-prevention overflow")
        return (b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | ntype])
                + out[:n].tobytes())

    @staticmethod
    def _u8p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    @staticmethod
    def _i8p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))

    @staticmethod
    def _i16p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))

    @staticmethod
    def _i32p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def _native_i_slice(self, y, u, v, qp, qpc, hdr_bw):
        """Native IDR I slice; returns (NAL bytes, recon planes)."""
        sy, su, sv = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
        ry, ru, rv = (np.zeros_like(p) for p in (sy, su, sv))
        cap = self.mb_w * self.mb_h * 900 + len(hdr_bw._bytes) + 64
        out = np.empty(cap, np.uint8)
        hdr = np.frombuffer(bytes(hdr_bw._bytes), np.uint8)
        n = self._natlib.hb264_encode_i_slice(
            self.mb_w, self.mb_h, qp, qpc, int(self.cfg.cabac),
            self._u8p(hdr), hdr.size, hdr_bw._cur, hdr_bw._nbits,
            self._u8p(sy), self._u8p(su), self._u8p(sv),
            self._u8p(ry), self._u8p(ru), self._u8p(rv),
            self._u8p(out), cap)
        if n < 0:
            raise RuntimeError("h264: native I slice overflowed its buffer")
        return self._nal(3, NAL_IDR, out[:n].tobytes()), (ry, ru, rv)

    def _parse_packed(self, buf, n_mb, cap):
        """Decode the analyzer's packed_small byte buffer into the
        walker's per-MB arrays."""
        buf = np.ascontiguousarray(buf, np.uint8)
        out = {}
        hdr = np.frombuffer(buf, np.int32, 3, 0)
        out["n_intra"], out["n_coded"], out["overflow"] = (int(x) for x in hdr)
        off = 12
        out["mv"] = np.frombuffer(buf, np.int16, n_mb * 2, off).reshape(
            n_mb, 2)
        off += n_mb * 4
        out["sad"] = np.frombuffer(buf, np.int32, n_mb, off)
        off += n_mb * 4
        out["cbp_luma"] = np.frombuffer(buf, np.int8, n_mb, off)
        off += n_mb
        out["t8"] = np.frombuffer(buf, np.int8, n_mb, off)
        off += n_mb
        out["unnz"] = np.frombuffer(buf, np.int8, n_mb * 4, off).reshape(
            n_mb, 4)
        off += n_mb * 4
        out["vnnz"] = np.frombuffer(buf, np.int8, n_mb * 4, off).reshape(
            n_mb, 4)
        off += n_mb * 4
        idx_dt = np.int16 if n_mb <= 32767 else np.int32
        out["coded_idx"] = np.frombuffer(buf, idx_dt, cap, off)
        off += cap * np.dtype(idx_dt).itemsize
        out["nib_ok"] = np.frombuffer(buf, np.int8, n_mb, off)
        return out

    def _dummy_recon(self):
        """Zero planes handed to the native walker when no MB can take the
        intra-fallback path (n_intra == 0): the walker never reads or
        writes them, so the device recon never crosses to the host."""
        if self._dummy_rec is None:
            H, W = self.mb_h * 16, self.mb_w * 16
            self._dummy_rec = (np.zeros((H, W), np.uint8),
                               np.zeros((H // 2, W // 2), np.uint8),
                               np.zeros((H // 2, W // 2), np.uint8))
        return self._dummy_rec

    def _native_p_slice(self, y, u, v, small, dev, n_intra, qp, qpc,
                        hdr_bw) -> bytes:
        sy, su, sv = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
        if n_intra > 0:
            # recon planes pre-filled with the device recon; the walker
            # patches intra-fallback MBs in place.  With deblock the
            # patch base is the UNFILTERED recon (intra prediction reads
            # pre-filter samples); the whole frame re-filters below.
            keys = (("recon_y_nf", "urec_nf", "vrec_nf")
                    if self.cfg.deblock else ("recon_y", "urec", "vrec"))
            ry, ru, rv = (np.array(x, np.uint8)
                          for x in _fetch([dev[k] for k in keys]))
        else:
            ry, ru, rv = self._dummy_recon()
        cap = self.mb_w * self.mb_h * 900 + len(hdr_bw._bytes) + 64
        out = np.empty(cap, np.uint8)
        hdr = np.frombuffer(bytes(hdr_bw._bytes), np.uint8)

        def arr(name, dt):
            return np.ascontiguousarray(small[name], dt)

        n_mb = self.mb_w * self.mb_h
        mv = arr("mv", np.int16)
        sad = arr("sad", np.int32)
        luma_lv = arr("luma_lv", np.int16)
        cbp_luma = arr("cbp_luma", np.int8)
        t8a = (arr("t8", np.int8) if self.cfg.transform8x8
               else np.zeros(n_mb, np.int8))
        udc, vdc = arr("udc", np.int16), arr("vdc", np.int16)
        uac, vac = arr("uac", np.int16), arr("vac", np.int16)
        unnz, vnnz = arr("unnz", np.int8), arr("vnnz", np.int8)
        out_intra = np.zeros(n_mb, np.int8)
        out_nnz = np.zeros(n_mb * 16, np.int8)
        n = self._natlib.hb264_encode_p_slice(
            self.mb_w, self.mb_h, qp, qpc, intra_thresh_for_qp(qp),
            int(self.cfg.cabac), int(self.cfg.transform8x8),
            self._u8p(hdr), hdr.size, hdr_bw._cur, hdr_bw._nbits,
            self._u8p(sy), self._u8p(su), self._u8p(sv),
            self._i16p(mv), self._i32p(sad),
            self._i16p(luma_lv), self._i8p(cbp_luma), self._i8p(t8a),
            self._i16p(udc), self._i16p(vdc), self._i16p(uac),
            self._i16p(vac), self._i8p(unnz), self._i8p(vnnz),
            self._u8p(ry), self._u8p(ru), self._u8p(rv),
            self._u8p(out), cap, self._i8p(out_intra), self._i8p(out_nnz))
        if n < 0:
            raise RuntimeError("h264: native P slice overflowed its buffer")
        if n_intra > 0:
            if self.cfg.deblock:
                # re-filter the patched frame with the true intra mask +
                # final nnz grid (native spec 8.7 filter)
                mvs32 = np.ascontiguousarray(mv.astype(np.int32).ravel())
                t8eff = np.ascontiguousarray(t8a * (1 - out_intra), np.int8)
                self._natlib.hb264_deblock(
                    self._u8p(ry), self._u8p(ru), self._u8p(rv),
                    self.mb_w, self.mb_h, qp, qpc,
                    self._i8p(out_intra), self._i32p(mvs32),
                    self._i8p(out_nnz),
                    self._i8p(t8eff) if self.cfg.transform8x8 else None)
            # intra-fallback MBs were patched into the host recon copy —
            # upload it once and re-point the reference chain (in-flight
            # analyses re-dispatch)
            self._propagate_refs(dev, self._upload_planes(ry, ru, rv))
        return self._nal(3, NAL_SLICE, out[:n].tobytes())

    # -- device-assisted P slice ------------------------------------------
    def _encode_slice_device(self, y, u, v, dev, qp, frame_num) -> bytes:
        """Native syntax walk over the device analysis: the exact skip
        decision, the (rare) intra fallback, and the entropy coding.
        Levels arrive through the compact nibble payload (coded MBs only,
        fetched chunk by chunk); the int16 arrays are the fallback for
        level overflow or dense frames."""
        qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
        hdr = SliceHeader(slice_type=SLICE_P, idr=False,
                          frame_num=frame_num, qp=qp,
                          disable_deblocking=0 if self.cfg.deblock else 1)
        n_mb = self.mb_w * self.mb_h
        per = dev["payload"][0].shape[0]
        n_chunks = len(dev["payload"])
        nib = dev["payload_nib"]
        pre = dev.get("_pre")
        guess = min(n_chunks, self._nch_guess)
        got = _fetch([dev["packed_small"]] + nib[:guess], pre)
        small = self._parse_packed(got[0], n_mb, per * n_chunks)
        chunks = got[1:]
        n_intra = int(small["n_intra"])
        n_coded = int(small["n_coded"])
        if int(small["overflow"]) or n_coded > per * n_chunks:
            keys = ("luma_lv", "udc", "uac", "vdc", "vac")
            for k, a in zip(keys, _fetch([dev[k] for k in keys])):
                small[k] = np.ascontiguousarray(a, np.int16)
            self._nch_guess = n_chunks
        else:
            nch = -(-n_coded // per) if n_coded else 0
            if nch > guess:
                chunks += _fetch(nib[guess:nch], pre)
            self._nch_guess = min(n_chunks, nch + 1)
            pay = np.zeros((n_mb, 392), np.int16)
            if nch:
                rows = np.concatenate(chunks[:nch])[:n_coded]
                cidx = small["coded_idx"][:n_coded]
                # unpack 4-bit two's complement pairs
                b = rows.view(np.uint8).astype(np.int16)
                unp = np.empty((rows.shape[0], 392), np.int16)
                unp[:, 0::2] = ((b & 15) ^ 8) - 8
                unp[:, 1::2] = ((b >> 4) ^ 8) - 8
                bad = np.nonzero(small["nib_ok"][cidx] == 0)[0]
                if bad.size:
                    # int8 rows for the out-of-range MBs
                    full_rows = _fetch([dev["payload"][k // per][k % per]
                                        for k in bad])
                    for j, r8 in zip(bad, full_rows):
                        unp[j] = np.asarray(r8, np.int16)
                pay[cidx] = unp
            small["luma_lv"] = pay[:, :256].reshape(n_mb, 16, 4, 4)
            small["udc"] = pay[:, 256:260]
            small["uac"] = pay[:, 260:324].reshape(n_mb, 4, 4, 4)
            small["vdc"] = pay[:, 324:328]
            small["vac"] = pay[:, 328:392].reshape(n_mb, 4, 4, 4)
        return self._native_p_slice(y, u, v, small, dev, n_intra, qp, qpc,
                                    hdr.write(self.sps, self.pps))

    # -- host walker (CAVLC) ----------------------------------------------
    def _encode_slice(self, y, u, v, idr: bool, analysis=None,
                      qp=None) -> bytes:
        """One frame coded at once: an IDR frame without intra4x4 or
        hints by the native I slice, every other by the MB walker.  The
        recon becomes the next frame's reference."""
        qp = self.cfg.qp if qp is None else qp
        qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
        deblk = 0 if self.cfg.deblock else 1
        if idr and analysis is None and not self.cfg.intra4x4:
            hdr = SliceHeader(slice_type=SLICE_I, idr=True, frame_num=0,
                              idr_pic_id=self.idr_pic_id, qp=qp,
                              disable_deblocking=deblk)
            payload, rec = self._native_i_slice(
                y, u, v, qp, qpc, hdr.write(self.sps, self.pps))
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
            if self.cfg.deblock:
                # all-intra frame: bS is 4/3 everywhere, nnz/mv unused
                self._apply_deblock(*rec, qp, qpc)
            self._set_recon(*rec)
            return payload
        slice_type = SLICE_I if idr else SLICE_P
        hdr = SliceHeader(slice_type=slice_type, idr=idr,
                          frame_num=0 if idr else self.frame_num,
                          idr_pic_id=self.idr_pic_id if idr else 0,
                          qp=qp, disable_deblocking=deblk)
        bw = hdr.write(self.sps, self.pps)

        ctx = MBCtx(self.mb_w, self.mb_h)
        self._ipred4 = np.full((self.mb_h * 4, self.mb_w * 4), -1,
                               np.int32)
        new_y = np.zeros_like(y)
        new_u = np.zeros_like(u)
        new_v = np.zeros_like(v)
        ref_y = ref_u = ref_v = None
        if not idr:
            ref_y = P.pad_plane(self.recon_y, PAD)
            ref_u = P.pad_plane(self.recon_u, PAD)
            ref_v = P.pad_plane(self.recon_v, PAD)

        skip_run = 0
        for mby in range(self.mb_h):
            for mbx in range(self.mb_w):
                skip_run = self._encode_mb(
                    bw, y, u, v, new_y, new_u, new_v, ref_y, ref_u, ref_v,
                    ctx, mbx, mby, qp, qpc, slice_type, skip_run, analysis)
        if skip_run > 0:
            bw.ue(skip_run)
        bw.rbsp_trailing()
        if self.cfg.deblock:
            self._apply_deblock(new_y, new_u, new_v, qp, qpc, ctx=ctx)
        self._set_recon(new_y, new_u, new_v)
        if idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
        return nal_unit(3, NAL_IDR if idr else NAL_SLICE, bw.get_rbsp())

    def _apply_deblock(self, ry, ru, rv, qp, qpc, ctx=None):
        """Loop-filter the contiguous uint8 planes in place with the
        native hb264_deblock (spec 8.7): the filtered frame is the
        reference and the conformance output.  ctx None: an all-intra
        frame."""
        mb_w, mb_h = self.mb_w, self.mb_h
        if ctx is None:
            mb_intra = np.ones((mb_h, mb_w), bool)
            mvs = np.zeros((mb_h, mb_w, 2), np.int32)
            nnz = np.zeros((mb_h * 4, mb_w * 4), np.int32)
            t8g = None
        else:
            mb_intra = np.zeros((mb_h, mb_w), bool)
            mvs = np.zeros((mb_h, mb_w, 2), np.int32)
            for (mbx, mby), r in ctx.refs.items():
                mb_intra[mby, mbx] = (r == -1)
            for (mbx, mby), mv in ctx.mvs.items():
                mvs[mby, mbx] = mv
            nnz = ctx.nnz_l
            t8g = ctx.t8x8
        im = np.ascontiguousarray(mb_intra, np.int8).ravel()
        mv32 = np.ascontiguousarray(mvs, np.int32).ravel()
        nz = np.ascontiguousarray(nnz != 0, np.int8).ravel()
        t8a = (np.ascontiguousarray(t8g, np.int8).ravel()
               if t8g is not None else None)
        self._natlib.hb264_deblock(
            self._u8p(ry), self._u8p(ru), self._u8p(rv), mb_w, mb_h, qp,
            qpc, self._i8p(im), self._i32p(mv32), self._i8p(nz),
            self._i8p(t8a) if t8a is not None else None)

    # -- macroblock level --------------------------------------------------
    def _encode_mb(self, bw, y, u, v, new_y, new_u, new_v,
                   ref_y, ref_u, ref_v, ctx, mbx, mby, qp, qpc,
                   slice_type, skip_run, analysis):
        x0, y0 = mbx * 16, mby * 16
        cx0, cy0 = mbx * 8, mby * 8
        src16 = y[y0:y0 + 16, x0:x0 + 16]
        srcu = u[cy0:cy0 + 8, cx0:cx0 + 8]
        srcv = v[cy0:cy0 + 8, cx0:cx0 + 8]

        # ---- analysis: intra candidate ----
        top, left, topleft = _i16_neighbors(new_y, mbx, mby)
        best_imode, best_ipred, best_icost = None, None, None
        pre = None if analysis is None else analysis.get((mbx, mby))
        imodes = i16_candidate_modes(top, left, topleft)
        if pre is not None and pre.get("i16_mode") in imodes:
            imodes = [pre["i16_mode"]]
        for m in imodes:
            pred = P.intra16_pred(m, top, left, topleft)
            c = _sad(src16, pred) + self.lm * 4
            if best_icost is None or c < best_icost:
                best_imode, best_ipred, best_icost = m, pred, c

        i4 = None
        if self.cfg.intra4x4:
            # true-reconstruction RDO between I_4x4 and I_16x16: SSD of
            # the actual coded result + an nnz-proportional rate proxy
            # (the SAD pre-quant model misranks them at mid/coarse qp)
            i4 = self._analyze_i4(src16, new_y, mbx, mby, qp)
            _dc, _ac, rec16_i16, _cbp, nnz16v = encode_i16_luma(
                src16, best_ipred, qp)
            lam2 = 0.85 * 2.0 ** ((qp - 12) / 3.0)
            s32 = src16.astype(np.int64)
            j16 = (((s32 - rec16_i16) ** 2).sum()
                   + lam2 * (6.0 * float(np.sum(nnz16v)) + 10.0))
            j4 = (((s32 - i4[4]) ** 2).sum()
                  + lam2 * (6.0 * float(sum(i4[3])) + 30.0))
            if j4 < j16:
                best_icost = min(best_icost, i4[0])
            else:
                i4 = None
        inter_ok = slice_type == SLICE_P
        if inter_ok:
            pred_mv = P.predict_mv_16x16(ctx.mvs, ctx.refs, mbx, mby,
                                         self.mb_w)
            if pre is not None and "mv" in pre:
                mv = pre["mv"]
            else:
                mv = motion_search(src16, ref_y, x0, y0, pred_mv,
                                   self.cfg.search_range, self.lm)
            mc = P.mc_luma_block(ref_y, PAD, x0, y0, 16, 16, mv[0], mv[1])
            mcost = (_sad(src16, mc)
                     + self.lm * (_se_len(mv[0] - pred_mv[0])
                                  + _se_len(mv[1] - pred_mv[1])))
            use_intra = best_icost < mcost
        else:
            use_intra = True

        if use_intra:
            if i4 is not None:
                _, modes_z, levels16, nnz16, recon16 = i4
                return self._write_intra4_mb(
                    bw, ctx, mbx, mby, modes_z, levels16, nnz16, recon16,
                    srcu, srcv, new_y, new_u, new_v, qp, qpc, slice_type,
                    skip_run)
            return self._write_intra_mb(
                bw, ctx, mbx, mby, src16, srcu, srcv, new_y, new_u, new_v,
                best_imode, best_ipred, qp, qpc, slice_type, skip_run)
        return self._write_inter_mb(
            bw, ctx, mbx, mby, src16, srcu, srcv, new_y, new_u, new_v,
            ref_y, ref_u, ref_v, mv, pred_mv, mc, qp, qpc, skip_run)

    # -- Intra_4x4 (spec 8.3.1) -------------------------------------------
    def _i4_mode_at(self, gx, gy, local):
        if (gx, gy) in local:
            return local[(gx, gy)]
        if gx < 0 or gy < 0 or gx >= self.mb_w * 4 or gy >= self.mb_h * 4:
            return -1
        v = int(self._ipred4[gy, gx])
        # spec 8.3.1.1: an available neighbour not coded Intra_4x4 (inter /
        # skip, constrained_intra_pred off) predicts as mode 2 (DC); only
        # genuinely unavailable (out-of-picture) neighbours force MPM=2
        # via -1.  Mirrors hbdec264.cpp mpm4 "v < 0 ? 2 : v".
        return 2 if v < 0 else v
    def _i4_mpm(self, gx, gy, local):
        a = self._i4_mode_at(gx - 1, gy, local)
        b = self._i4_mode_at(gx, gy - 1, local)
        if a < 0 or b < 0:
            return 2
        return min(a, b)

    def _blk_coded_before(self, gx, gy, mbx, mby, zidx):
        """decoder blk_avail mirror: cell decoded before block zidx of the
        current MB (raster MBs; z-order blocks within)."""
        if gx < 0 or gy < 0 or gx >= self.mb_w * 4 or gy >= self.mb_h * 4:
            return False
        mbi = (gy // 4) * self.mb_w + (gx // 4)
        cur = mby * self.mb_w + mbx
        if mbi != cur:
            return mbi < cur
        b = (gy % 4) * 4 + (gx % 4)
        z = int(np.nonzero(_CODED_ORDER == b)[0][0])
        return z < zidx

    def _analyze_i4(self, src16, new_y, mbx, mby, qp):
        """Greedy per-block mode decision with in-loop reconstruction.
        Returns (cost, modes_z, levels16, nnz16, recon16)."""
        x0, y0 = mbx * 16, mby * 16
        H, W = new_y.shape
        # extended context: row above (incl. 8 top-right), col left, corner
        ext = np.zeros((17, 25), np.int32)
        ys = max(0, y0 - 1)
        if y0 > 0:
            xe = min(W, x0 + 24)
            ext[0, 1:1 + xe - x0] = new_y[y0 - 1, x0:xe]
        if x0 > 0:
            ye = min(H, y0 + 16)
            ext[1:1 + ye - y0, 0] = new_y[y0:ye, x0 - 1]
        if x0 > 0 and y0 > 0:
            ext[0, 0] = new_y[y0 - 1, x0 - 1]
        del ys
        modes_z, levels16, nnz16 = [], [0] * 16, [0] * 16
        local = {}
        cost = 0.0
        for k in range(16):
            b = int(_CODED_ORDER[k])
            bx, by = b % 4, b // 4
            gx, gy = mbx * 4 + bx, mby * 4 + by
            px, py = bx * 4, by * 4
            ha = self._blk_coded_before(gx - 1, gy, mbx, mby, k)
            hb = self._blk_coded_before(gx, gy - 1, mbx, mby, k)
            hc = self._blk_coded_before(gx + 1, gy - 1, mbx, mby, k)
            hd = self._blk_coded_before(gx - 1, gy - 1, mbx, mby, k)
            top = ext[py, 1 + px:1 + px + 8].copy()
            left = ext[1 + py:1 + py + 4, px].copy()
            tl = int(ext[py, px])
            mpm = self._i4_mpm(gx, gy, local)
            ok = [2]
            if hb:
                ok += [0, 3, 7]
            if ha:
                ok += [1, 8]
            if ha and hb and hd:
                ok += [4, 5, 6]
            src4 = src16[py:py + 4, px:px + 4].astype(np.int32)
            best = None
            for m in ok:
                pred = P.intra4_pred(m, top, left, tl, ha, hb, hc, hd)
                c = (np.abs(src4 - pred).sum()
                     + self.lm * (1 if m == mpm else 4))
                if best is None or c < best[0]:
                    best = (c, m, pred)
            c, m, pred = best
            res = src4 - pred
            w = T.fdct4x4(np, res[None])
            lv = T.quant4x4(np, w, qp, intra=True)
            nz = int((lv != 0).sum())
            dq = T.dequant4x4(np, lv, qp)
            r = T.idct4x4(np, dq)[0]
            rec4 = np.clip(pred + r, 0, 255)
            ext[1 + py:1 + py + 4, 1 + px:1 + px + 4] = rec4
            local[(gx, gy)] = m
            modes_z.append(m)
            levels16[b] = lv[0]
            nnz16[b] = nz
            cost += c
        recon16 = ext[1:17, 1:17]
        return cost, modes_z, levels16, nnz16, recon16

    def _write_intra4_mb(self, bw, ctx, mbx, mby, modes_z, levels16,
                         nnz16, recon16, srcu, srcv, new_y, new_u, new_v,
                         qp, qpc, slice_type, skip_run):
        x0, y0 = mbx * 16, mby * 16
        cx0, cy0 = mbx * 8, mby * 8
        if slice_type == SLICE_P:
            if skip_run >= 0:
                bw.ue(skip_run)
            skip_run = 0
            bw.ue(5)                      # I_NxN in P
        else:
            bw.ue(0)
        if self.cfg.transform8x8:
            bw.put_bit(0)                 # transform_size_8x8_flag: 4x4
        # prediction modes (prev flag + 3-bit remainder), z-order
        local = {}
        for k in range(16):
            b = int(_CODED_ORDER[k])
            gx = mbx * 4 + b % 4
            gy = mby * 4 + b // 4
            mpm = self._i4_mpm(gx, gy, local)
            m = modes_z[k]
            if m == mpm:
                bw.put_bit(1)
            else:
                bw.put_bit(0)
                bw.put(m if m < mpm else m - 1, 3)
            local[(gx, gy)] = m
        # chroma (same decision as the I16 path)
        tu, lu, tlu = _chroma_neighbors(new_u, mbx, mby)
        tv, lv_, tlv = _chroma_neighbors(new_v, mbx, mby)
        best = None
        for cm in chroma_candidate_modes(tu, lu):
            pu = P.chroma_pred(cm, tu, lu, tlu)
            pv = P.chroma_pred(cm, tv, lv_, tlv)
            c = _sad(srcu, pu) + _sad(srcv, pv)
            if best is None or c < best[0]:
                best = (c, cm, pu, pv)
        _, cmode, predu, predv = best
        udc, uac, urec, u_dc, u_ac, nnz_u = encode_chroma(srcu, predu,
                                                          qpc, True)
        vdc, vac, vrec, v_dc, v_ac, nnz_v = encode_chroma(srcv, predv,
                                                          qpc, True)
        cbp_chroma = 2 if (u_ac or v_ac) else (1 if (u_dc or v_dc) else 0)
        idx = np.arange(16)
        quad_of = (idx // 8) * 2 + (idx % 4) // 2
        cbp_luma = 0
        for q in range(4):
            if sum(nnz16[i] for i in range(16) if quad_of[i] == q):
                cbp_luma |= 1 << q
        cbp = cbp_luma | (cbp_chroma << 4)
        bw.ue(cmode)
        bw.ue(CBP_INTRA4x4_INV[cbp])
        if cbp:
            bw.se(0)                      # mb_qp_delta (fixed-QP)
        # luma residual (z-order, 16-coeff blocks, coded quads only)
        b0y, b0x = mby * 4, mbx * 4
        for k in range(16):
            b = int(_CODED_ORDER[k])
            by4, bx4 = b0y + b // 4, b0x + b % 4
            if not (cbp_luma >> int(quad_of[b])) & 1:
                ctx.nnz_l[by4, bx4] = 0
                continue
            nc = ctx.nc_luma(by4, bx4)
            tc = encode_residual(bw, zigzag(levels16[b]), nc, 16)
            ctx.nnz_l[by4, bx4] = tc
        if cbp:
            self._write_chroma_residual(bw, ctx, mbx, mby, cbp_chroma,
                                        udc, uac, nnz_u, vdc, vac, nnz_v)
        else:
            ctx.nnz_cb[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
            ctx.nnz_cr[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
        new_y[y0:y0 + 16, x0:x0 + 16] = recon16
        new_u[cy0:cy0 + 8, cx0:cx0 + 8] = urec
        new_v[cy0:cy0 + 8, cx0:cx0 + 8] = vrec
        ctx.refs[(mbx, mby)] = -1
        for k in range(16):
            b = int(_CODED_ORDER[k])
            self._ipred4[mby * 4 + b // 4, mbx * 4 + b % 4] = modes_z[k]
        return skip_run

    def _write_intra_mb(self, bw, ctx, mbx, mby, src16, srcu, srcv,
                        new_y, new_u, new_v, imode, ipred, qp, qpc,
                        slice_type, skip_run):
        x0, y0 = mbx * 16, mby * 16
        cx0, cy0 = mbx * 8, mby * 8
        dc_scan, aclv, recon_y16, cbp_ac, nnz_l = encode_i16_luma(
            src16, ipred, qp)

        # chroma mode decision on reconstructed neighbors
        tu, lu, tlu = _chroma_neighbors(new_u, mbx, mby)
        tv, lv_, tlv = _chroma_neighbors(new_v, mbx, mby)
        best = None
        for cm in chroma_candidate_modes(tu, lu):
            pu = P.chroma_pred(cm, tu, lu, tlu)
            pv = P.chroma_pred(cm, tv, lv_, tlv)
            c = _sad(srcu, pu) + _sad(srcv, pv)
            if best is None or c < best[0]:
                best = (c, cm, pu, pv)
        _, cmode, predu, predv = best
        udc, uac, urec, u_dc, u_ac, nnz_u = encode_chroma(srcu, predu, qpc,
                                                          True)
        vdc, vac, vrec, v_dc, v_ac, nnz_v = encode_chroma(srcv, predv, qpc,
                                                          True)
        cbp_chroma = 2 if (u_ac or v_ac) else (1 if (u_dc or v_dc) else 0)

        # mb_type: I_16x16 variant encodes pred mode + cbp
        mb_type = 1 + imode + 4 * cbp_chroma + 12 * (1 if cbp_ac else 0)
        if slice_type == SLICE_P:
            if skip_run >= 0:
                bw.ue(skip_run)
            skip_run = 0
            mb_type += 5
        bw.ue(mb_type)
        bw.ue(cmode)
        bw.se(0)  # mb_qp_delta (fixed-QP)

        self._write_luma_residual_i16(bw, ctx, mbx, mby, dc_scan, aclv,
                                      cbp_ac, nnz_l)
        self._write_chroma_residual(bw, ctx, mbx, mby, cbp_chroma,
                                    udc, uac, nnz_u, vdc, vac, nnz_v)

        new_y[y0:y0 + 16, x0:x0 + 16] = recon_y16
        new_u[cy0:cy0 + 8, cx0:cx0 + 8] = urec
        new_v[cy0:cy0 + 8, cx0:cx0 + 8] = vrec
        ctx.refs[(mbx, mby)] = -1
        if getattr(self, "_ipred4", None) is not None:
            self._ipred4[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        return skip_run

    def _write_inter_mb(self, bw, ctx, mbx, mby, src16, srcu, srcv,
                        new_y, new_u, new_v, ref_y, ref_u, ref_v,
                        mv, pred_mv, mc_y, qp, qpc, skip_run):
        x0, y0 = mbx * 16, mby * 16
        cx0, cy0 = mbx * 8, mby * 8
        lv, recon_y16, cbp_luma, nnz_l = encode_inter_luma(src16, mc_y, qp)
        t8 = False
        subs8 = None
        if self.cfg.transform8x8:
            # true-recon RDO 4x4 vs 8x8 (same cost model as the i4/i16
            # decision: SSD + lambda * nnz-proportional rate proxy)
            subs8, rec8, cbp8, nnz8 = encode_inter_luma8(src16, mc_y, qp)
            lam2 = 0.85 * 2.0 ** ((qp - 12) / 3.0)
            s32 = src16.astype(np.int64)
            j4 = (((s32 - recon_y16) ** 2).sum()
                  + lam2 * 6.0 * float(np.sum(nnz_l)))
            j8 = (((s32 - rec8) ** 2).sum()
                  + lam2 * 6.0 * float(np.sum(nnz8)))
            if j8 < j4:
                t8 = True
                recon_y16, cbp_luma, nnz_l = rec8, cbp8, nnz8
            ctx.t8x8[mby, mbx] = t8 and cbp_luma != 0
        mcu = P.mc_chroma_block(ref_u, PAD, cx0, cy0, 8, 8, mv[0], mv[1])
        mcv = P.mc_chroma_block(ref_v, PAD, cx0, cy0, 8, 8, mv[0], mv[1])
        udc, uac, urec, u_dc, u_ac, nnz_u = encode_chroma(srcu, mcu, qpc,
                                                          False)
        vdc, vac, vrec, v_dc, v_ac, nnz_v = encode_chroma(srcv, mcv, qpc,
                                                          False)
        cbp_chroma = 2 if (u_ac or v_ac) else (1 if (u_dc or v_dc) else 0)
        cbp = cbp_luma | (cbp_chroma << 4)

        skip_mv = P.skip_mv(ctx.mvs, ctx.refs, mbx, mby, self.mb_w)
        if cbp == 0 and tuple(mv) == tuple(skip_mv):
            # P_Skip: no syntax, recon = MC at skip mv
            new_y[y0:y0 + 16, x0:x0 + 16] = mc_y
            new_u[cy0:cy0 + 8, cx0:cx0 + 8] = mcu
            new_v[cy0:cy0 + 8, cx0:cx0 + 8] = vrec  # vrec==mcv (cbp 0)
            ctx.mvs[(mbx, mby)] = tuple(mv)
            ctx.refs[(mbx, mby)] = 0
            return skip_run + 1

        bw.ue(skip_run)
        bw.ue(0)  # mb_type P_L0_16x16
        bw.se(mv[0] - pred_mv[0])
        bw.se(mv[1] - pred_mv[1])
        bw.ue(CBP_INTER_INV[cbp])
        if self.cfg.transform8x8 and (cbp & 15):
            bw.put_bit(1 if t8 else 0)    # transform_size_8x8_flag (7.3.5)
        if cbp != 0:
            bw.se(0)  # mb_qp_delta
        if cbp_luma and t8:
            self._write_luma_residual_inter8(bw, ctx, mbx, mby, subs8,
                                             cbp_luma)
        elif cbp_luma:
            self._write_luma_residual_inter(bw, ctx, mbx, mby, lv, cbp_luma,
                                            nnz_l)
        else:
            ctx.nnz_l[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 0
        self._write_chroma_residual(bw, ctx, mbx, mby, cbp_chroma,
                                    udc, uac, nnz_u, vdc, vac, nnz_v)

        new_y[y0:y0 + 16, x0:x0 + 16] = recon_y16
        new_u[cy0:cy0 + 8, cx0:cx0 + 8] = urec
        new_v[cy0:cy0 + 8, cx0:cx0 + 8] = vrec
        ctx.mvs[(mbx, mby)] = tuple(mv)
        ctx.refs[(mbx, mby)] = 0
        return 0


    # -- residual writers --------------------------------------------------
    def _write_luma_residual_i16(self, bw, ctx, mbx, mby, dc_scan, aclv,
                                 cbp_ac, nnz_l):
        b0y, b0x = mby * 4, mbx * 4
        # DC block: nC from block 0's neighbors
        nc = ctx.nc_luma(b0y, b0x)
        encode_residual(bw, dc_scan, nc, 16)
        if cbp_ac:
            for k in range(16):
                ridx = _CODED_ORDER[k]
                by, bx = b0y + ridx // 4, b0x + ridx % 4
                nc = ctx.nc_luma(by, bx)
                levels = zigzag(aclv[ridx])[1:]  # AC: 15 coeffs
                tc = encode_residual(bw, levels, nc, 15)
                ctx.nnz_l[by, bx] = tc
        else:
            ctx.nnz_l[b0y:b0y + 4, b0x:b0x + 4] = 0

    def _write_luma_residual_inter(self, bw, ctx, mbx, mby, lv, cbp_luma,
                                   nnz_l):
        b0y, b0x = mby * 4, mbx * 4
        for k in range(16):
            ridx = _CODED_ORDER[k]
            quad = (ridx // 8) * 2 + (ridx % 4) // 2
            by, bx = b0y + ridx // 4, b0x + ridx % 4
            if not (cbp_luma >> quad) & 1:
                ctx.nnz_l[by, bx] = 0
                continue
            nc = ctx.nc_luma(by, bx)
            tc = encode_residual(bw, zigzag(lv[ridx]), nc, 16)
            ctx.nnz_l[by, bx] = tc

    def _write_luma_residual_inter8(self, bw, ctx, mbx, mby, subs,
                                    cbp_luma):
        """8x8-transform luma residual: four interleaved CAVLC sub-streams
        per coded quadrant, z-order (subs from encode_inter_luma8; decoder
        mirror hbdec264.cpp parse_residual_cavlc t8x8 branch)."""
        b0y, b0x = mby * 4, mbx * 4
        for k in range(16):
            ridx = int(_CODED_ORDER[k])
            quad = (ridx // 8) * 2 + (ridx % 4) // 2
            by, bx = b0y + ridx // 4, b0x + ridx % 4
            if not (cbp_luma >> quad) & 1:
                ctx.nnz_l[by, bx] = 0
                continue
            nc = ctx.nc_luma(by, bx)
            tc = encode_residual(bw, subs[k], nc, 16)
            ctx.nnz_l[by, bx] = tc

    def _write_chroma_residual(self, bw, ctx, mbx, mby, cbp_chroma,
                               udc, uac, nnz_u, vdc, vac, nnz_v):
        b0y, b0x = mby * 2, mbx * 2
        if cbp_chroma == 0:
            ctx.nnz_cb[b0y:b0y + 2, b0x:b0x + 2] = 0
            ctx.nnz_cr[b0y:b0y + 2, b0x:b0x + 2] = 0
            return
        encode_residual(bw, udc, -1, 4)
        encode_residual(bw, vdc, -1, 4)
        if cbp_chroma == 2:
            for plane, aclv, nnzmap in ((0, uac, ctx.nnz_cb),
                                        (1, vac, ctx.nnz_cr)):
                for k in range(4):
                    ridx = int(_CODED_ORDER_C[k])
                    by, bx = b0y + ridx // 2, b0x + ridx % 2
                    nc = ctx.nc_chroma(nnzmap, by, bx)
                    tc = encode_residual(bw, zigzag(aclv[ridx])[1:], nc, 15)
                    nnzmap[by, bx] = tc
        else:
            ctx.nnz_cb[b0y:b0y + 2, b0x:b0x + 2] = 0
            ctx.nnz_cr[b0y:b0y + 2, b0x:b0x + 2] = 0
