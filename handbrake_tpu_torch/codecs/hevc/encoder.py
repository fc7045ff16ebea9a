"""HEVC encoder — CTU layer, host reference path.

Produces Main-profile annex-B streams: IDR I slices (32x32 intra CUs,
planar/DC/H/V search) and P slices (2Nx2N inter with quarter-pel ME,
merge/skip, AMVP, intra fallback). One reference picture, one slice per
picture, CTB = CU = TU = 32 (chroma TB 16), SAO/deblocking signalled off so
reconstruction is bit-exact against any conformant decoder.

Role of the reference's encx265.c work object (x265 replaced wholesale per
SURVEY.md §2.5). The batched P-frame analysis runs as torch ops on the
encoder's device (analyzer.py); this walker owns the sequential CABAC
(SURVEY.md §7 "Hard parts #1").
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import predict as P
from . import transform as T
from .cabac import CabacEncoder, ContextSet
from .residual import encode_residual
from .syntax import (NAL_IDR_W_RADL, NAL_TRAIL_R, PPS, SLICE_I, SLICE_P, SPS,
                     VPS, SliceHeader, nal_unit)
from .tables import chroma_qp
from ...utils.device import resolve_device
from ..vui import sar16

PAD = 48  # reference-plane edge padding for ME/MC (8-tap needs +-3)

CAND_MODES = (P.PLANAR, P.DC, P.HOR, P.VER)


def _sad(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


def _eg1_len(v: int) -> int:
    """bits of order-1 exp-golomb bypass coding of v >= 0."""
    k, n = 1, 0
    while v >= (1 << k):
        v -= 1 << k
        k += 1
        n += 1
    return n + 1 + k


def _mvd_bits(dx: int, dy: int) -> int:
    n = 2
    for d in (dx, dy):
        a = abs(d)
        if a > 0:
            n += 1
        if a > 1:
            n += _eg1_len(a - 2) + 1
        elif a == 1:
            n += 1
    return n


@dataclasses.dataclass
class EncoderConfig:
    width: int
    height: int
    qp: int = 30
    gop: int = 60
    search_range: int = 24
    fps: tuple = (30000, 1001)
    level_idc: int = 120
    lm: float | None = None
    backend: str = "device"  # batched torch CTU analysis of P frames on the
                             # encoder's device; "host" = motion_search
    bit_depth: int = 8      # 8 (Main) or 10 (Main 10) — encx265 multi-depth
    sar: tuple = (1, 1)     # the pixel aspect the VUI signals (1:1: none)


def mpm_list(cand_a: int, cand_b: int):
    """8.4.2 candModeList; candB is always DC in our CTU==PU geometry."""
    if cand_a == cand_b:
        if cand_a < 2:
            return [P.PLANAR, P.DC, P.VER]
        return [cand_a, 2 + ((cand_a + 29) % 32), 2 + ((cand_a - 1) % 32)]
    out = [cand_a, cand_b]
    for m in (P.PLANAR, P.DC, P.VER):
        if m not in out:
            out.append(m)
            break
    return out


class FrameState:
    """Per-picture CTU maps used for prediction context."""

    def __init__(self, cw: int, ch: int):
        self.intra_mode = np.full((ch, cw), -1, np.int32)  # -1 = not intra
        self.is_inter = np.zeros((ch, cw), bool)
        self.is_skip = np.zeros((ch, cw), bool)
        self.mv = np.zeros((ch, cw, 2), np.int32)


def merge_candidate(st: FrameState, cx: int, cy: int):
    """First available spatial merge candidate (MaxNumMergeCand=1):
    A1 (left), B1 (above), B0 (above-right), B2 (above-left); A0 is never
    decoded yet in raster CTU==PU order. Returns (mvx, mvy) or None."""
    ch, cw = st.is_inter.shape
    for nx, ny in ((cx - 1, cy), (cx, cy - 1), (cx + 1, cy - 1),
                   (cx - 1, cy - 1)):
        if 0 <= nx < cw and 0 <= ny < ch and st.is_inter[ny, nx]:
            return (int(st.mv[ny, nx, 0]), int(st.mv[ny, nx, 1]))
    return None


def amvp_candidates(st: FrameState, cx: int, cy: int):
    """8.5.3.2.6 with single ref / no scaling: A from A1; B from B1,B0,B2."""
    ch, cw = st.is_inter.shape

    def mv_at(nx, ny):
        if 0 <= nx < cw and 0 <= ny < ch and st.is_inter[ny, nx]:
            return (int(st.mv[ny, nx, 0]), int(st.mv[ny, nx, 1]))
        return None

    mva = mv_at(cx - 1, cy)
    mvb = None
    for nx, ny in ((cx + 1, cy - 1), (cx, cy - 1), (cx - 1, cy - 1)):
        mvb = mv_at(nx, ny)
        if mvb is not None:
            break
    cands = []
    if mva is not None:
        cands.append(mva)
    if mvb is not None and mvb != mva:
        cands.append(mvb)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands


def motion_search(src, ref_pad, x0, y0, n, pred_mvs, rng_px, lm, bd=8):
    """Quarter-pel ME minimizing SAD + lm * mvd_bits (vs best AMVP cand)."""
    H = ref_pad.shape[0] - 2 * PAD
    W = ref_pad.shape[1] - 2 * PAD
    lo_x = max(-rng_px, -(x0 + PAD - 12))
    hi_x = min(rng_px, W + PAD - 12 - (x0 + n))
    lo_y = max(-rng_px, -(y0 + PAD - 12))
    hi_y = min(rng_px, H + PAD - 12 - (y0 + n))

    def mvd_cost(mvx, mvy):
        return min(_mvd_bits(mvx - p[0], mvy - p[1]) for p in pred_mvs)

    def cost_full(dx, dy):
        blk = ref_pad[y0 + dy + PAD:y0 + dy + PAD + n,
                      x0 + dx + PAD:x0 + dx + PAD + n]
        return _sad(src, blk) + lm * mvd_cost(4 * dx, 4 * dy)

    starts = {(0, 0)}
    for p in pred_mvs:
        starts.add((int(np.clip(p[0] >> 2, lo_x, hi_x)),
                    int(np.clip(p[1] >> 2, lo_y, hi_y))))
    best, bc = (0, 0), None
    for s in starts:
        c = cost_full(*s)
        if bc is None or c < bc:
            best, bc = s, c
    step = max(1, rng_px // 2)
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
    bmv = (best[0] * 4, best[1] * 4)
    bcost = None
    for phase in (2, 1):
        cand = bmv
        for dy in (-phase, 0, phase):
            for dx in (-phase, 0, phase):
                mv = (bmv[0] + dx, bmv[1] + dy)
                blk = P.mc_luma(ref_pad, PAD, x0, y0, n, n, mv[0], mv[1], bd)
                c = _sad(src, blk) + lm * mvd_cost(mv[0], mv[1])
                if bcost is None or c < bcost:
                    cand, bcost = mv, c
        bmv = cand
    return bmv


class HEVCEncoder:
    """Stateful one-ref HEVC encoder. encode_frame() -> annex-B bytes.
    device=None analyses P frames on the CUDA card; "cpu" on the CPU."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cw = (cfg.width + 31) // 32
        self.ch = (cfg.height + 31) // 32
        self.W = self.cw * 32
        self.H = self.ch * 32
        self.bd = cfg.bit_depth
        self.vps = VPS(level_idc=cfg.level_idc, bit_depth=self.bd)
        self.sps = SPS(width=self.W, height=self.H,
                       crop_right=self.W - cfg.width,
                       crop_bottom=self.H - cfg.height,
                       level_idc=cfg.level_idc,
                       vui_timing=(cfg.fps[1], cfg.fps[0]),
                       bit_depth=self.bd,
                       sar=sar16(*cfg.sar, "hevc: the pixel aspect"))
        self.pps = PPS(init_qp=cfg.qp)
        self.frame_idx = 0
        self.poc = 0
        self.recon_y = None
        self.recon_u = None
        self.recon_v = None
        self.lm = cfg.lm if cfg.lm is not None \
            else 0.85 * 2 ** ((cfg.qp - 12) / 3.0) * (1 << (self.bd - 8))
        self._analyzer = None
        if cfg.backend == "device":
            from .analyzer import build_ctu_analyzer
            self._analyzer = build_ctu_analyzer(self.cw, self.ch, cfg.qp,
                                                maxval=(1 << self.bd) - 1,
                                                device=self.device)

    def headers(self) -> bytes:
        return self.vps.to_nal() + self.sps.to_nal() + self.pps.to_nal()

    def _pad(self, plane, size):
        Ht = self.ch * size
        Wt = self.cw * size
        h, w = plane.shape
        if (h, w) == (Ht, Wt):
            return plane.astype(np.int32)
        return np.pad(plane.astype(np.int32), ((0, Ht - h), (0, Wt - w)),
                      mode="edge")

    def encode_frame(self, y, u, v, qp=None) -> bytes:
        """qp overrides cfg.qp for this frame (rate control; slice header
        carries slice_qp_delta so any per-frame value is legal)."""
        idr = (self.frame_idx % self.cfg.gop) == 0
        qp = self.cfg.qp if qp is None else int(qp)
        self.lm = self.cfg.lm if self.cfg.lm is not None \
            else 0.85 * 2 ** ((qp - 12) / 3.0) * (1 << (self.bd - 8))
        out = b""
        if idr:
            out += self.headers()
            self.poc = 0
        yp = self._pad(y, 32)
        up = self._pad(u, 16)
        vp = self._pad(v, 16)
        dev = None
        if not idr and self._analyzer is not None:
            dev = self._analyzer(yp, up, vp, self.recon_y, self.recon_u,
                                 self.recon_v)
            dev = {k: np.asarray(a) for k, a in dev.items()}
        out += self._encode_slice(yp, up, vp, idr, dev, qp)
        self.frame_idx += 1
        self.poc = (self.poc + 1) % (1 << self.sps.log2_max_poc_lsb)
        self.last_frame_was_idr = idr
        return out

    # -- slice level ---------------------------------------------------------
    def _encode_slice(self, y, u, v, idr: bool, dev=None, qp=None) -> bytes:
        qp = self.cfg.qp if qp is None else qp
        stype = SLICE_I if idr else SLICE_P
        hdr = SliceHeader(slice_type=stype, idr=idr, poc_lsb=self.poc, qp=qp)
        bw = hdr.write(self.sps, self.pps)
        enc = CabacEncoder(ContextSet(0 if idr else 1, qp))

        st = FrameState(self.cw, self.ch)
        new_y = np.zeros_like(y)
        new_u = np.zeros_like(u)
        new_v = np.zeros_like(v)
        ref = None
        if not idr:
            ref = (P.pad_plane(self.recon_y, PAD),
                   P.pad_plane(self.recon_u, PAD),
                   P.pad_plane(self.recon_v, PAD))
        n_ctu = self.cw * self.ch
        for i in range(n_ctu):
            cy, cx = divmod(i, self.cw)
            self._encode_ctu(enc, st, y, u, v, new_y, new_u, new_v, ref,
                             cx, cy, qp, stype, dev)
            enc.terminate(1 if i == n_ctu - 1 else 0)
        enc.write_to(bw)
        self.recon_y, self.recon_u, self.recon_v = new_y, new_u, new_v
        return nal_unit(NAL_IDR_W_RADL if idr else NAL_TRAIL_R, bw.get_rbsp())

    # -- CTU level -----------------------------------------------------------
    def _encode_ctu(self, enc, st, y, u, v, new_y, new_u, new_v, ref,
                    cx, cy, qp, stype, dev=None):
        x0, y0 = cx * 32, cy * 32
        cx0, cy0 = cx * 16, cy * 16
        src_y = y[y0:y0 + 32, x0:x0 + 32]
        src_u = u[cy0:cy0 + 16, cx0:cx0 + 16]
        src_v = v[cy0:cy0 + 16, cx0:cx0 + 16]

        if stype == SLICE_P:
            i = cy * self.cw + cx
            merge_mv = merge_candidate(st, cx, cy)
            amvp = amvp_candidates(st, cx, cy)
            if dev is not None:
                mv = (int(dev["mv"][i, 0]), int(dev["mv"][i, 1]))
                inter_sad = float(dev["sad"][i])
            else:
                mv = motion_search(src_y, ref[0], x0, y0, 32, amvp,
                                   self.cfg.search_range, self.lm, self.bd)
                inter_sad = None
            pred_y = P.mc_luma(ref[0], PAD, x0, y0, 32, 32, mv[0], mv[1],
                               self.bd)
            pred_u = P.mc_chroma(ref[1], PAD, cx0, cy0, 16, 16, mv[0],
                                 mv[1], self.bd)
            pred_v = P.mc_chroma(ref[2], PAD, cx0, cy0, 16, 16, mv[0],
                                 mv[1], self.bd)
            if inter_sad is None:
                inter_sad = _sad(src_y, pred_y)
            # intra fallback probe (cheap: DC only) when inter is poor
            use_intra = False
            if inter_sad > 18.0 * 1024 * (1 << (self.bd - 8)):
                imode, ipred, icost = self._intra_search(
                    new_y, st, cx, cy, src_y)
                if icost < inter_sad:
                    use_intra = True
            if not use_intra:
                self._write_inter_ctu(enc, st, cx, cy, src_y, src_u, src_v,
                                      pred_y, pred_u, pred_v, mv, merge_mv,
                                      amvp, new_y, new_u, new_v, qp)
                return
            # fall through to intra coding in P slice
            self._write_skipflag(enc, st, cx, cy, 0)
            enc.bin("pred_mode", 0, 1)  # intra
            self._write_intra_ctu(enc, st, cx, cy, src_y, src_u, src_v,
                                  new_y, new_u, new_v, qp,
                                  precomputed=(imode, ipred))
            return
        self._write_intra_ctu(enc, st, cx, cy, src_y, src_u, src_v,
                              new_y, new_u, new_v, qp)

    def _write_skipflag(self, enc, st, cx, cy, val):
        ctx = 0
        if cx > 0 and st.is_skip[cy, cx - 1]:
            ctx += 1
        if cy > 0 and st.is_skip[cy - 1, cx]:
            ctx += 1
        enc.bin("cu_skip", ctx, val)

    # -- intra ---------------------------------------------------------------
    def _intra_search(self, new_y, st, cx, cy, src_y):
        x0, y0 = cx * 32, cy * 32
        cand_a = P.DC
        if cx > 0 and st.intra_mode[cy, cx - 1] >= 0:
            cand_a = int(st.intra_mode[cy, cx - 1])
        best = None
        for m in CAND_MODES:
            filt = P.filter_flag(m, 32, 0)
            left, tl, top = P.ref_samples(new_y, x0, y0, 32, filt, self.bd)
            pred = P.intra_pred(m, left, tl, top, 32, 0, self.bd)
            mpm = mpm_list(cand_a, P.DC)
            bits = 2 if m in mpm else 6
            c = _sad(src_y, pred) + self.lm * bits
            if best is None or c < best[2]:
                best = (m, pred, c)
        return best

    def _write_intra_ctu(self, enc, st, cx, cy, src_y, src_u, src_v,
                         new_y, new_u, new_v, qp, precomputed=None):
        x0, y0 = cx * 32, cy * 32
        cx0, cy0 = cx * 16, cy * 16
        if precomputed is None:
            mode, pred_y, _ = self._intra_search(new_y, st, cx, cy, src_y)
        else:
            mode, pred_y = precomputed
        cand_a = P.DC
        if cx > 0 and st.intra_mode[cy, cx - 1] >= 0:
            cand_a = int(st.intra_mode[cy, cx - 1])
        mpm = mpm_list(cand_a, P.DC)

        # part_mode: 2Nx2N (CU is at min size so the flag is coded)
        enc.bin("part_mode", 0, 1)
        if mode in mpm:
            enc.bin("prev_intra", 0, 1)
            idx = mpm.index(mode)
            enc.bypass(1 if idx > 0 else 0)
            if idx > 0:
                enc.bypass(idx - 1)
        else:
            enc.bin("prev_intra", 0, 0)
            rem = mode
            for cand in sorted(mpm, reverse=True):
                if mode > cand:
                    rem -= 1
            enc.bypass_bits(rem, 5)
        # intra_chroma_pred_mode: derived (DM) mode
        enc.bin("chroma_pred", 0, 0)

        # chroma prediction with DM mode
        pu, pv = [], []
        for plane, out in ((new_u, pu), (new_v, pv)):
            left, tl, top = P.ref_samples(plane, cx0, cy0, 16, False,
                                          self.bd)
            out.append(P.intra_pred(mode, left, tl, top, 16, 1, self.bd))
        pred_u, pred_v = pu[0], pv[0]

        lv_y, rec_y = self._code_tu(src_y, pred_y, qp, 5)
        qpc = chroma_qp(qp)
        lv_u, rec_u = self._code_tu(src_u, pred_u, qpc, 4)
        lv_v, rec_v = self._code_tu(src_v, pred_v, qpc, 4)
        cbf_y = int(lv_y.any())
        cbf_u = int(lv_u.any())
        cbf_v = int(lv_v.any())
        enc.bin("cbf_chroma", 0, cbf_u)
        enc.bin("cbf_chroma", 0, cbf_v)
        enc.bin("cbf_luma", 1, cbf_y)
        if cbf_y:
            encode_residual(enc, lv_y, 5, 0)
        if cbf_u:
            encode_residual(enc, lv_u, 4, 1)
        if cbf_v:
            encode_residual(enc, lv_v, 4, 2)

        new_y[y0:y0 + 32, x0:x0 + 32] = rec_y
        new_u[cy0:cy0 + 16, cx0:cx0 + 16] = rec_u
        new_v[cy0:cy0 + 16, cx0:cx0 + 16] = rec_v
        st.intra_mode[cy, cx] = mode

    def _code_tu(self, src, pred, qp, log2n):
        bd = self.bd
        res = src.astype(np.int32) - pred
        c = T.fwd_transform(np, res[None], log2n, bd)[0]
        lv = T.quant(np, c, qp, log2n, True, bd)
        if not lv.any():
            return lv, np.clip(pred, 0, (1 << bd) - 1)
        d = T.dequant(np, lv, qp, log2n, bd)
        r = T.inv_transform(np, d[None], log2n, bd)[0]
        return lv, np.clip(pred + r, 0, (1 << bd) - 1)

    # -- inter ---------------------------------------------------------------
    def _write_inter_ctu(self, enc, st, cx, cy, src_y, src_u, src_v,
                         pred_y, pred_u, pred_v, mv, merge_mv, amvp,
                         new_y, new_u, new_v, qp):
        x0, y0 = cx * 32, cy * 32
        cx0, cy0 = cx * 16, cy * 16
        lv_y, rec_y = self._code_tu_inter(src_y, pred_y, qp, 5)
        qpc = chroma_qp(qp)
        lv_u, rec_u = self._code_tu_inter(src_u, pred_u, qpc, 4)
        lv_v, rec_v = self._code_tu_inter(src_v, pred_v, qpc, 4)
        cbf_y = int(lv_y.any())
        cbf_u = int(lv_u.any())
        cbf_v = int(lv_v.any())
        no_resid = not (cbf_y or cbf_u or cbf_v)
        is_merge = merge_mv is not None and tuple(mv) == merge_mv

        if no_resid and is_merge:
            # cu_skip
            self._write_skipflag(enc, st, cx, cy, 1)
            st.is_skip[cy, cx] = True
            st.is_inter[cy, cx] = True
            st.mv[cy, cx] = mv
            new_y[y0:y0 + 32, x0:x0 + 32] = rec_y
            new_u[cy0:cy0 + 16, cx0:cx0 + 16] = rec_u
            new_v[cy0:cy0 + 16, cx0:cx0 + 16] = rec_v
            return
        self._write_skipflag(enc, st, cx, cy, 0)
        enc.bin("pred_mode", 0, 0)   # inter
        enc.bin("part_mode", 0, 1)   # 2Nx2N
        enc.bin("merge_flag", 0, 1 if is_merge else 0)
        if not is_merge:
            # choose cheaper AMVP candidate
            bits0 = _mvd_bits(mv[0] - amvp[0][0], mv[1] - amvp[0][1])
            bits1 = _mvd_bits(mv[0] - amvp[1][0], mv[1] - amvp[1][1])
            mvp_idx = 0 if bits0 <= bits1 else 1
            pred_mv = amvp[mvp_idx]
            self._write_mvd(enc, mv[0] - pred_mv[0], mv[1] - pred_mv[1])
            enc.bin("mvp_idx", 0, mvp_idx)
            # rqt_root_cbf only coded for non-merge CUs (spec 7.3.8.5);
            # for 2Nx2N merge it is inferred 1 (no-residual merge -> skip).
            enc.bin("rqt_root_cbf", 0, 0 if no_resid else 1)
        if not no_resid:
            enc.bin("cbf_chroma", 0, cbf_u)
            enc.bin("cbf_chroma", 0, cbf_v)
            if cbf_u or cbf_v:
                enc.bin("cbf_luma", 1, cbf_y)
            # else cbf_luma inferred 1; enforce by re-coding luma if needed
            if cbf_y:
                encode_residual(enc, lv_y, 5, 0)
            if cbf_u:
                encode_residual(enc, lv_u, 4, 1)
            if cbf_v:
                encode_residual(enc, lv_v, 4, 2)
        st.is_inter[cy, cx] = True
        st.mv[cy, cx] = mv
        new_y[y0:y0 + 32, x0:x0 + 32] = rec_y
        new_u[cy0:cy0 + 16, cx0:cx0 + 16] = rec_u
        new_v[cy0:cy0 + 16, cx0:cx0 + 16] = rec_v

    def _code_tu_inter(self, src, pred, qp, log2n):
        bd = self.bd
        res = src.astype(np.int32) - pred
        c = T.fwd_transform(np, res[None], log2n, bd)[0]
        lv = T.quant(np, c, qp, log2n, False, bd)
        if not lv.any():
            return lv, np.clip(pred, 0, (1 << bd) - 1)
        d = T.dequant(np, lv, qp, log2n, bd)
        r = T.inv_transform(np, d[None], log2n, bd)[0]
        return lv, np.clip(pred + r, 0, (1 << bd) - 1)

    def _write_mvd(self, enc, dx, dy):
        ax, ay = abs(dx), abs(dy)
        enc.bin("mvd", 0, 1 if ax > 0 else 0)
        enc.bin("mvd", 0, 1 if ay > 0 else 0)
        if ax > 0:
            enc.bin("mvd", 1, 1 if ax > 1 else 0)
        if ay > 0:
            enc.bin("mvd", 1, 1 if ay > 1 else 0)
        for a, d in ((ax, dx), (ay, dy)):
            if a > 0:
                if a > 1:
                    self._eg1(enc, a - 2)
                enc.bypass(1 if d < 0 else 0)

    @staticmethod
    def _eg1(enc, v: int):
        k = 1
        while v >= (1 << k):
            enc.bypass(1)
            v -= 1 << k
            k += 1
        enc.bypass(0)
        enc.bypass_bits(v, k)
