"""H.264 B-frame + multi-reference encoder (host walker, CAVLC).

Extends the one-ref I/P engine (encoder.py) with the x264-medium GOP
structure the RD north star needs (encx264.c drives bframes=3/ref=3 at
medium): IB..BP groups with non-reference B pictures, spatial direct
prediction (8.4.1.2.2 incl. colZeroFlag from the colocated anchor),
B_Skip / B_Direct_16x16 / B_L0 / B_L1 / B_Bi macroblocks, and
multi-reference P slices with per-MB ref_idx selection.

Display-order frames go in via push_frame(); encoded access units come
out in DECODE order as (display_index, bytes) pairs — the caller owns
the DTS delay queue (encx264.c:30 role).  POC type 0 carries the
display order to the decoder.

MV prediction, direct derivation and skip semantics mirror
native/hbdec264.cpp (nb_at / mv_pred / pskip_mv / direct_prepare /
col_zero) exactly — the decoder is the spec reference the encoder's
reconstruction must match bit-for-bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import predict as P
from . import transform as T
from .bits import BitWriter, nal_unit
from .cavlc import encode_residual
from .encoder import (_CODED_ORDER, PAD, EncoderConfig, MBCtx, _sad,
                      _se_len, chroma_candidate_modes, encode_chroma,
                      encode_i16_luma, encode_inter_luma,
                      i16_candidate_modes, motion_search, zigzag)
from .syntax import (NAL_IDR, NAL_SLICE, PPS, SLICE_B, SLICE_I, SLICE_P,
                     SPS, SliceHeader)
from .tables import CBP_INTER_INV, ZIGZAG_4x4
from ..vui import sar16


def _med3(a, b, c):
    return max(min(a, b), min(max(a, b), c))


@dataclasses.dataclass
class RefPic:
    poc: int
    frame_num: int
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    mv: np.ndarray        # (mb_h, mb_w, 2) int32 — 16x16 motion
    inter: np.ndarray     # (mb_h, mb_w) bool — refidx0 == 0 proxy
    ref0: np.ndarray      # (mb_h, mb_w) int32 — L0 ref_idx (-1 intra)
    _pads: tuple = None

    def pads(self):
        if self._pads is None:
            self._pads = (P.pad_plane(self.y, PAD),
                          P.pad_plane(self.u, PAD),
                          P.pad_plane(self.v, PAD))
        return self._pads


class _MState:
    """Per-frame motion state at MB granularity, two lists (the decoder's
    refidx/mv grids)."""

    def __init__(self, mb_w, mb_h):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.ref = [np.full((mb_h, mb_w), -2, np.int32) for _ in range(2)]
        self.mv = [np.zeros((mb_h, mb_w, 2), np.int32) for _ in range(2)]

    def nb(self, l, mbx, mby, cur):
        """(avail, mbav, ref, mvx, mvy) for the MB at (mbx, mby)."""
        if mbx < 0 or mby < 0 or mbx >= self.mb_w or mby >= self.mb_h:
            return (False, False, -1, 0, 0)
        if mby * self.mb_w + mbx >= cur:
            return (False, False, -1, 0, 0)
        r = int(self.ref[l][mby, mbx])
        if r < 0:
            return (False, True, -1, 0, 0)
        return (True, True, r, int(self.mv[l][mby, mbx, 0]),
                int(self.mv[l][mby, mbx, 1]))

    def mv_pred(self, l, mbx, mby, r, cur):
        """spec 8.4.1.3 for a 16x16 partition (hbdec264 mv_pred mirror)."""
        A = self.nb(l, mbx - 1, mby, cur)
        B = self.nb(l, mbx, mby - 1, cur)
        C = self.nb(l, mbx + 1, mby - 1, cur)
        if not C[1]:
            C = self.nb(l, mbx - 1, mby - 1, cur)
        if not B[1] and not C[1]:
            if A[0]:
                return A[3], A[4]
            return 0, 0
        match = [n for n in (A, B, C) if n[0] and n[2] == r]
        if len(match) == 1:
            return match[0][3], match[0][4]
        ax, ay = (A[3], A[4]) if A[0] else (0, 0)
        bx, by = (B[3], B[4]) if B[0] else (0, 0)
        cx, cy = (C[3], C[4]) if C[0] else (0, 0)
        return _med3(ax, bx, cx), _med3(ay, by, cy)

    def pskip_mv(self, mbx, mby, cur):
        A = self.nb(0, mbx - 1, mby, cur)
        B = self.nb(0, mbx, mby - 1, cur)
        if not A[1] or not B[1]:
            return 0, 0
        if (A[0] and A[2] == 0 and A[3] == 0 and A[4] == 0) or \
                (B[0] and B[2] == 0 and B[3] == 0 and B[4] == 0):
            return 0, 0
        return self.mv_pred(0, mbx, mby, 0, cur)

    def set(self, l, mbx, mby, r, mvx, mvy):
        self.ref[l][mby, mbx] = r
        self.mv[l][mby, mbx] = (mvx, mvy)


class H264BEncoder:
    """IB..BP GOP encoder.  push_frame() → [(display_idx, annexb AU)]
    in decode order; flush() drains the tail."""

    def __init__(self, cfg: EncoderConfig, bframes: int = 2,
                 refs: int = 2):
        cfg.backend = "host"
        cfg.cabac = False
        self.cfg = cfg
        self.bframes = max(0, bframes)
        self.refs = max(1, refs)
        w, h = cfg.width, cfg.height
        self.mb_w = (w + 15) // 16
        self.mb_h = (h + 15) // 16
        self.sps = SPS(profile_idc=77, width_mbs=self.mb_w,
                       height_mbs=self.mb_h,
                       crop_right=self.mb_w * 16 - w,
                       crop_bottom=self.mb_h * 16 - h,
                       level_idc=cfg.level_idc,
                       pic_order_cnt_type=0,
                       max_num_ref_frames=self.refs + 1,
                       vui_timing=(cfg.fps[1], 2 * cfg.fps[0]),
                       sar=sar16(*cfg.sar, "h264: the pixel aspect"))
        self.pps = PPS(pic_init_qp=cfg.qp,
                       chroma_qp_index_offset=cfg.chroma_qp_offset)
        self.idr_pic_id = 0
        self.frame_num = 0            # next REFERENCE frame's number
        self.disp_idx = 0             # global display counter
        self.idr_disp = 0             # display idx of current GOP's IDR
        self.dpb: list = []           # RefPic, decode order (ref frames)
        self._pend: list = []         # buffered display frames
        self.lm = 0.85 * 2 ** ((cfg.qp - 12) / 6.0)
        self.recons: dict = {}        # display idx -> recon (tests)

    # -- scheduling --------------------------------------------------------
    def push_frame(self, y, u, v):
        self._pend.append((self.disp_idx, y, u, v))
        self.disp_idx += 1
        return self._drain(final=False)

    def flush(self):
        return self._drain(final=True)

    def _drain(self, final):
        out = []
        gop = self.cfg.gop
        while self._pend:
            d0 = self._pend[0][0]
            if not self.dpb or (gop and d0 % gop == 0):
                d, fy, fu, fv = self._pend.pop(0)
                out.append((d, self._encode_idr(fy, fu, fv, d)))
                continue
            # an upcoming IDR closes the current minigroup early: the
            # frames before it anchor on their own last frame as P
            k = next((i for i, (d, *_rest) in enumerate(self._pend)
                      if gop and d % gop == 0), None)
            if k is not None:
                out += self._emit_group(k)
                continue
            if len(self._pend) >= self.bframes + 1:
                out += self._emit_group(self.bframes + 1)
                continue
            if final:
                out += self._emit_group(len(self._pend))
                continue
            break
        return out

    def _emit_group(self, n):
        """Encode pending[0..n): last frame is the P anchor, others B."""
        group = self._pend[:n]
        self._pend = self._pend[n:]
        out = []
        d, fy, fu, fv = group[-1]
        out.append((d, self._encode_p(fy, fu, fv, d)))
        anchor = self.dpb[-1]
        for d, fy, fu, fv in group[:-1]:
            out.append((d, self._encode_b(fy, fu, fv, d, anchor)))
        return out

    def _poc(self, d):
        return 2 * (d - self.idr_disp)

    def _pad(self, plane, bs):
        Ht, Wt = self.mb_h * bs, self.mb_w * bs
        h, w = plane.shape
        if (h, w) == (Ht, Wt):
            return np.ascontiguousarray(plane, np.uint8)
        return np.pad(plane.astype(np.uint8), ((0, Ht - h), (0, Wt - w)),
                      mode="edge")

    # -- reference lists ---------------------------------------------------
    def _l0_for_p(self):
        """Default P list: short-term refs by descending frame_num
        (decode recency)."""
        return sorted(self.dpb, key=lambda r: -r.frame_num)[:self.refs]

    def _lists_for_b(self, poc):
        past = sorted([r for r in self.dpb if r.poc < poc],
                      key=lambda r: -r.poc)
        fut = sorted([r for r in self.dpb if r.poc > poc],
                     key=lambda r: r.poc)
        l0 = past + fut
        l1 = fut + past
        return l0, l1

    # -- frame encoders ----------------------------------------------------
    def _encode_idr(self, y, u, v, d):
        self.idr_disp = d
        self.frame_num = 0
        self.dpb = []
        au = self.sps.to_nal() + self.pps.to_nal()
        au += self._intra_frame(y, u, v, d, idr=True)
        return au

    def _intra_frame(self, y, u, v, d, idr):
        yp, up, vp = (self._pad(y, 16), self._pad(u, 8), self._pad(v, 8))
        hdr = SliceHeader(slice_type=SLICE_I, idr=idr,
                          frame_num=0 if idr else self.frame_num,
                          idr_pic_id=self.idr_pic_id, qp=self.cfg.qp,
                          poc_lsb=self._poc(d) & 0xFFFF,
                          disable_deblocking=1)
        bw = hdr.write(self.sps, self.pps)
        ctx = MBCtx(self.mb_w, self.mb_h)
        ny = np.zeros_like(yp)
        nu = np.zeros_like(up)
        nv = np.zeros_like(vp)
        qp = self.cfg.qp
        qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
        for mby in range(self.mb_h):
            for mbx in range(self.mb_w):
                self._write_i16_mb(bw, ctx, yp, up, vp, ny, nu, nv,
                                   mbx, mby, qp, qpc, SLICE_I, [0])
        bw.rbsp_trailing()
        if idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
        self._dpb_push(ny, nu, nv, poc=self._poc(d),
                       mv=np.zeros((self.mb_h, self.mb_w, 2), np.int32),
                       ref0=np.full((self.mb_h, self.mb_w), -1, np.int32))
        self.recons[d] = (ny, nu, nv)
        return nal_unit(3, NAL_IDR if idr else NAL_SLICE, bw.get_rbsp())

    def _dpb_push(self, ny, nu, nv, poc, mv, ref0):
        pic = RefPic(poc=0 if poc is None else poc,
                     frame_num=self.frame_num, y=ny, u=nu, v=nv,
                     mv=mv, inter=(ref0 >= 0), ref0=ref0)
        self.dpb.append(pic)
        self.frame_num = (self.frame_num + 1) % \
            (1 << self.sps.log2_max_frame_num)
        while len(self.dpb) > self.refs + 1:
            self.dpb.pop(0)           # sliding window

    def _encode_p(self, y, u, v, d):
        yp, up, vp = (self._pad(y, 16), self._pad(u, 8), self._pad(v, 8))
        qp = self.cfg.qp
        qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
        l0 = self._l0_for_p()
        hdr = SliceHeader(slice_type=SLICE_P, idr=False,
                          frame_num=self.frame_num, qp=qp,
                          poc_lsb=self._poc(d) & 0xFFFF,
                          num_ref_l0=len(l0), disable_deblocking=1)
        bw = hdr.write(self.sps, self.pps)
        ctx = MBCtx(self.mb_w, self.mb_h)
        ms = _MState(self.mb_w, self.mb_h)
        ny = np.zeros_like(yp)
        nu = np.zeros_like(up)
        nv = np.zeros_like(vp)
        pads = [r.pads() for r in l0]
        srs = [self._sr(max(1, (self._poc(d) - r.poc) // 2)) for r in l0]
        mvout = np.zeros((self.mb_h, self.mb_w, 2), np.int32)
        refout = np.full((self.mb_h, self.mb_w), -1, np.int32)
        skip_run = [0]
        for mby in range(self.mb_h):
            for mbx in range(self.mb_w):
                self._encode_p_mb(bw, ctx, ms, yp, up, vp, ny, nu, nv,
                                  pads, len(l0), mbx, mby, qp, qpc,
                                  skip_run, mvout, refout, srs)
        if skip_run[0] > 0:
            bw.ue(skip_run[0])
        bw.rbsp_trailing()
        self._dpb_push(ny, nu, nv, poc=self._poc(d), mv=mvout,
                       ref0=refout)
        self.recons[d] = (ny, nu, nv)
        return nal_unit(2, NAL_SLICE, bw.get_rbsp())

    def _encode_p_mb(self, bw, ctx, ms, yp, up, vp, ny, nu, nv, pads,
                     nref, mbx, mby, qp, qpc, skip_run, mvout, refout,
                     srs):
        x0, y0 = mbx * 16, mby * 16
        cx0, cy0 = mbx * 8, mby * 8
        cur = mby * self.mb_w + mbx
        src16 = yp[y0:y0 + 16, x0:x0 + 16]
        srcu = up[cy0:cy0 + 8, cx0:cx0 + 8]
        srcv = vp[cy0:cy0 + 8, cx0:cx0 + 8]
        # intra candidate
        top = ny[y0 - 1, x0:x0 + 16].astype(np.int32) if mby > 0 else None
        left = ny[y0:y0 + 16, x0 - 1].astype(np.int32) if mbx > 0 else None
        tl = int(ny[y0 - 1, x0 - 1]) if mbx > 0 and mby > 0 else None
        best_i = None
        for m in i16_candidate_modes(top, left, tl):
            pred = P.intra16_pred(m, top, left, tl)
            c = _sad(src16, pred) + self.lm * 4
            if best_i is None or c < best_i[0]:
                best_i = (c, m, pred)
        # inter: best over refs (ME radius scaled by ref distance)
        best = None
        for r in range(nref):
            pmx, pmy = ms.mv_pred(0, mbx, mby, r, cur)
            mv = motion_search(src16, pads[r][0], x0, y0, (pmx, pmy),
                               srs[r], self.lm)
            mc = P.mc_luma_block(pads[r][0], PAD, x0, y0, 16, 16,
                                 mv[0], mv[1])
            cost = (_sad(src16, mc)
                    + self.lm * (_se_len(mv[0] - pmx) + _se_len(mv[1] - pmy)
                                 + (1 if nref == 1 else 2 * r + 1)))
            if best is None or cost < best[0]:
                best = (cost, r, mv, (pmx, pmy), mc)
        if best_i[0] < best[0]:
            if skip_run[0] >= 0:
                bw.ue(skip_run[0])
            skip_run[0] = 0
            self._write_i16_mb(bw, ctx, yp, up, vp, ny, nu, nv, mbx, mby,
                               qp, qpc, SLICE_P, skip_run, ms=ms)
            return
        _, r, mv, pmv, mc = best
        lv, rec_y, cbp_luma, _nnz = encode_inter_luma(src16, mc, qp)
        mcu = P.mc_chroma_block(pads[r][1], PAD, cx0, cy0, 8, 8,
                                mv[0], mv[1])
        mcv = P.mc_chroma_block(pads[r][2], PAD, cx0, cy0, 8, 8,
                                mv[0], mv[1])
        udc, uac, urec, u_dc, u_ac, _ = encode_chroma(srcu, mcu, qpc, False)
        vdc, vac, vrec, v_dc, v_ac, _ = encode_chroma(srcv, mcv, qpc, False)
        cbp_chroma = 2 if (u_ac or v_ac) else (1 if (u_dc or v_dc) else 0)
        cbp = cbp_luma | (cbp_chroma << 4)
        smx, smy = ms.pskip_mv(mbx, mby, cur)
        if cbp == 0 and r == 0 and tuple(mv) == (smx, smy):
            ny[y0:y0 + 16, x0:x0 + 16] = mc
            nu[cy0:cy0 + 8, cx0:cx0 + 8] = mcu
            nv[cy0:cy0 + 8, cx0:cx0 + 8] = mcv
            ms.set(0, mbx, mby, 0, mv[0], mv[1])
            ms.set(1, mbx, mby, -1, 0, 0)
            mvout[mby, mbx] = mv
            refout[mby, mbx] = 0
            skip_run[0] += 1
            return
        bw.ue(skip_run[0])
        skip_run[0] = 0
        bw.ue(0)                       # P_L0_16x16
        if nref > 1:
            self._te(bw, r, nref - 1)  # ref_idx_l0
        bw.se(mv[0] - pmv[0])
        bw.se(mv[1] - pmv[1])
        bw.ue(CBP_INTER_INV[cbp])
        if cbp:
            bw.se(0)
        self._write_inter_resid(bw, ctx, mbx, mby, lv, cbp_luma,
                                udc, uac, vdc, vac, cbp_chroma)
        ny[y0:y0 + 16, x0:x0 + 16] = rec_y
        nu[cy0:cy0 + 8, cx0:cx0 + 8] = urec
        nv[cy0:cy0 + 8, cx0:cx0 + 8] = vrec
        ms.set(0, mbx, mby, r, mv[0], mv[1])
        ms.set(1, mbx, mby, -1, 0, 0)
        mvout[mby, mbx] = mv
        refout[mby, mbx] = r

    # -- B slices ----------------------------------------------------------
    def _encode_b(self, y, u, v, d, anchor):
        yp, up, vp = (self._pad(y, 16), self._pad(u, 8), self._pad(v, 8))
        poc = self._poc(d)
        qp = min(51, self.cfg.qp + 2)      # x264 pbratio analog
        qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
        l0, l1 = self._lists_for_b(poc)
        hdr = SliceHeader(slice_type=SLICE_B, idr=False,
                          frame_num=self.frame_num, qp=qp,
                          poc_lsb=poc & 0xFFFF, is_ref=False,
                          disable_deblocking=1)
        bw = hdr.write(self.sps, self.pps)
        ctx = MBCtx(self.mb_w, self.mb_h)
        ms = _MState(self.mb_w, self.mb_h)
        ny = np.zeros_like(yp)
        nu = np.zeros_like(up)
        nv = np.zeros_like(vp)
        p0 = l0[0].pads()
        p1 = l1[0].pads()
        col = l1[0]
        skip_run = [0]
        lmb = 0.85 * 2 ** ((qp - 12) / 6.0)
        srs = (self._sr((poc - l0[0].poc) // 2),
               self._sr((l1[0].poc - poc) // 2))
        for mby in range(self.mb_h):
            for mbx in range(self.mb_w):
                self._encode_b_mb(bw, ctx, ms, yp, up, vp, ny, nu, nv,
                                  p0, p1, col, mbx, mby, qp, qpc,
                                  skip_run, lmb, srs)
        if skip_run[0] > 0:
            bw.ue(skip_run[0])
        bw.rbsp_trailing()
        self.recons[d] = (ny, nu, nv)
        return nal_unit(0, NAL_SLICE, bw.get_rbsp())

    def _direct_mb(self, ms, col, mbx, mby):
        """Spatial direct derivation (8.4.1.2.2; hbdec264 direct_prepare +
        col_zero with direct_8x8_inference).  Our anchors are 16x16-
        partitioned, so the quadrant corners collapse to the colocated
        MB → one (ref, mv) pair per list for the whole MB."""
        cur = mby * self.mb_w + mbx

        def minpos(a, b):
            return min(a, b) if (a >= 0 and b >= 0) else max(a, b)

        ref = [0, 0]
        mv = [(0, 0), (0, 0)]
        for l in range(2):
            A = ms.nb(l, mbx - 1, mby, cur)
            B = ms.nb(l, mbx, mby - 1, cur)
            C = ms.nb(l, mbx + 1, mby - 1, cur)
            if not C[1]:
                C = ms.nb(l, mbx - 1, mby - 1, cur)
            ref[l] = minpos(minpos(A[2] if A[0] else -1,
                                   B[2] if B[0] else -1),
                            C[2] if C[0] else -1)
        if ref[0] < 0 and ref[1] < 0:
            return [0, 0], [(0, 0), (0, 0)]     # directZeroPrediction
        for l in range(2):
            if ref[l] >= 0:
                mv[l] = ms.mv_pred(l, mbx, mby, ref[l], cur)
        # colZeroFlag: colocated anchor MB zero-ish motion at ref 0
        cz = (bool(col.inter[mby, mbx]) and int(col.ref0[mby, mbx]) == 0
              and abs(int(col.mv[mby, mbx, 0])) <= 1
              and abs(int(col.mv[mby, mbx, 1])) <= 1)
        if cz:
            mv = [(0, 0) if ref[l] == 0 else mv[l] for l in range(2)]
        return ref, mv

    def _b_pred(self, pads0, pads1, ref, mv, x0, y0, cx0, cy0):
        """Prediction for (ref, mv) pairs — L0-only, L1-only or bi-avg."""
        preds = []
        cpreds = []
        for l, pads in ((0, pads0), (1, pads1)):
            if ref[l] < 0:
                continue
            preds.append(P.mc_luma_block(pads[0], PAD, x0, y0, 16, 16,
                                         mv[l][0], mv[l][1]))
            cpreds.append((
                P.mc_chroma_block(pads[1], PAD, cx0, cy0, 8, 8,
                                  mv[l][0], mv[l][1]),
                P.mc_chroma_block(pads[2], PAD, cx0, cy0, 8, 8,
                                  mv[l][0], mv[l][1])))
        if len(preds) == 2:
            yp = (preds[0] + preds[1] + 1) >> 1
            upred = (cpreds[0][0] + cpreds[1][0] + 1) >> 1
            vpred = (cpreds[0][1] + cpreds[1][1] + 1) >> 1
        else:
            yp = preds[0]
            upred, vpred = cpreds[0]
        return yp, upred, vpred

    def _sr(self, dist):
        """ME radius scaled by reference distance (anchors sit
        bframes+1 apart; a fixed radius misses fast pans)."""
        return min(self.cfg.search_range * max(1, dist),
                   self.cfg.search_range + 32)

    def _encode_b_mb(self, bw, ctx, ms, yp, up, vp, ny, nu, nv, p0, p1,
                     col, mbx, mby, qp, qpc, skip_run, lmb, srs):
        x0, y0 = mbx * 16, mby * 16
        cx0, cy0 = mbx * 8, mby * 8
        cur = mby * self.mb_w + mbx
        src16 = yp[y0:y0 + 16, x0:x0 + 16]
        srcu = up[cy0:cy0 + 8, cx0:cx0 + 8]
        srcv = vp[cy0:cy0 + 8, cx0:cx0 + 8]

        # candidates: direct / L0 / L1 / Bi / intra
        dref, dmv = self._direct_mb(ms, col, mbx, mby)
        dy_, du_, dv_ = self._b_pred(p0, p1, dref, dmv, x0, y0, cx0, cy0)
        cost_dir = _sad(src16, dy_) + lmb * 1

        # early skip (x264's first check): if the direct residual
        # quantises away entirely, B_Skip costs ~0.1 bit — nothing beats
        # it (the dominant source of B-frame savings)
        lv_d, rec_d, cbp_l_d, _ = encode_inter_luma(src16, dy_, qp)
        udc_d, uac_d, urec_d, ud_dc, ud_ac, _ = encode_chroma(
            srcu, du_, qpc, False)
        vdc_d, vac_d, vrec_d, vd_dc, vd_ac, _ = encode_chroma(
            srcv, dv_, qpc, False)
        cbpc_d = 2 if (ud_ac or vd_ac) else (1 if (ud_dc or vd_dc) else 0)
        if cbp_l_d == 0 and cbpc_d == 0:
            ny[y0:y0 + 16, x0:x0 + 16] = dy_
            nu[cy0:cy0 + 8, cx0:cx0 + 8] = du_
            nv[cy0:cy0 + 8, cx0:cx0 + 8] = dv_
            for l in range(2):
                ms.set(l, mbx, mby, dref[l], *dmv[l])
            skip_run[0] += 1
            return

        sr0, sr1 = srs
        pm0 = ms.mv_pred(0, mbx, mby, 0, cur)
        mv0 = motion_search(src16, p0[0], x0, y0, pm0, sr0, lmb)
        mc0 = P.mc_luma_block(p0[0], PAD, x0, y0, 16, 16, mv0[0], mv0[1])
        cost0 = (_sad(src16, mc0)
                 + lmb * (2 + _se_len(mv0[0] - pm0[0])
                          + _se_len(mv0[1] - pm0[1])))
        pm1 = ms.mv_pred(1, mbx, mby, 0, cur)
        mv1 = motion_search(src16, p1[0], x0, y0, pm1, sr1, lmb)
        mc1 = P.mc_luma_block(p1[0], PAD, x0, y0, 16, 16, mv1[0], mv1[1])
        cost1 = (_sad(src16, mc1)
                 + lmb * (3 + _se_len(mv1[0] - pm1[0])
                          + _se_len(mv1[1] - pm1[1])))
        bi_y = (mc0 + mc1 + 1) >> 1
        cost_bi = (_sad(src16, bi_y)
                   + lmb * (5 + _se_len(mv0[0] - pm0[0])
                            + _se_len(mv0[1] - pm0[1])
                            + _se_len(mv1[0] - pm1[0])
                            + _se_len(mv1[1] - pm1[1])))
        top = ny[y0 - 1, x0:x0 + 16].astype(np.int32) if mby > 0 else None
        left = ny[y0:y0 + 16, x0 - 1].astype(np.int32) if mbx > 0 else None
        tl = int(ny[y0 - 1, x0 - 1]) if mbx > 0 and mby > 0 else None
        best_i = None
        for m in i16_candidate_modes(top, left, tl):
            pred = P.intra16_pred(m, top, left, tl)
            c = _sad(src16, pred) + lmb * 8
            if best_i is None or c < best_i[0]:
                best_i = (c, m, pred)

        costs = [cost_dir, cost0, cost1, cost_bi, best_i[0]]
        mode = int(np.argmin(costs))
        if mode == 4:
            if skip_run[0] >= 0:
                bw.ue(skip_run[0])
            skip_run[0] = 0
            self._write_i16_mb(bw, ctx, yp, up, vp, ny, nu, nv, mbx, mby,
                               qp, qpc, SLICE_B, skip_run, ms=ms)
            return
        if mode == 0:
            ref, mv, pred = dref, dmv, (dy_, du_, dv_)
        elif mode == 1:
            ref, mv = [0, -1], [mv0, (0, 0)]
            pred = self._b_pred(p0, p1, ref, mv, x0, y0, cx0, cy0)
        elif mode == 2:
            ref, mv = [-1, 0], [(0, 0), mv1]
            pred = self._b_pred(p0, p1, ref, mv, x0, y0, cx0, cy0)
        else:
            ref, mv = [0, 0], [mv0, mv1]
            pred = self._b_pred(p0, p1, ref, mv, x0, y0, cx0, cy0)

        lv, rec_y, cbp_luma, _ = encode_inter_luma(src16, pred[0], qp)
        udc, uac, urec, u_dc, u_ac, _ = encode_chroma(srcu, pred[1], qpc,
                                                      False)
        vdc, vac, vrec, v_dc, v_ac, _ = encode_chroma(srcv, pred[2], qpc,
                                                      False)
        cbp_chroma = 2 if (u_ac or v_ac) else (1 if (u_dc or v_dc) else 0)
        cbp = cbp_luma | (cbp_chroma << 4)

        if mode == 0 and cbp == 0:
            # B_Skip: direct prediction, no residual, via skip run
            ny[y0:y0 + 16, x0:x0 + 16] = pred[0]
            nu[cy0:cy0 + 8, cx0:cx0 + 8] = pred[1]
            nv[cy0:cy0 + 8, cx0:cx0 + 8] = pred[2]
            for l in range(2):
                ms.set(l, mbx, mby, ref[l], *mv[l])
            skip_run[0] += 1
            return
        bw.ue(skip_run[0])
        skip_run[0] = 0
        bw.ue(mode)                    # B_Direct/L0/L1/Bi _16x16
        if mode in (1, 3):
            pm = ms.mv_pred(0, mbx, mby, 0, cur)
            bw.se(mv[0][0] - pm[0])
            bw.se(mv[0][1] - pm[1])
        if mode in (2, 3):
            pm = ms.mv_pred(1, mbx, mby, 0, cur)
            bw.se(mv[1][0] - pm[0])
            bw.se(mv[1][1] - pm[1])
        bw.ue(CBP_INTER_INV[cbp])
        if cbp:
            bw.se(0)
        self._write_inter_resid(bw, ctx, mbx, mby, lv, cbp_luma,
                                udc, uac, vdc, vac, cbp_chroma)
        ny[y0:y0 + 16, x0:x0 + 16] = rec_y
        nu[cy0:cy0 + 8, cx0:cx0 + 8] = urec
        nv[cy0:cy0 + 8, cx0:cx0 + 8] = vrec
        for l in range(2):
            ms.set(l, mbx, mby, ref[l], *mv[l])

    # -- shared writers ----------------------------------------------------
    @staticmethod
    def _te(bw, v, cmax):
        if cmax == 1:
            bw.put_bit(1 - v)
        else:
            bw.ue(v)

    def _write_i16_mb(self, bw, ctx, yp, up, vp, ny, nu, nv, mbx, mby,
                      qp, qpc, slice_type, skip_run, ms=None):
        x0, y0 = mbx * 16, mby * 16
        cx0, cy0 = mbx * 8, mby * 8
        src16 = yp[y0:y0 + 16, x0:x0 + 16]
        srcu = up[cy0:cy0 + 8, cx0:cx0 + 8]
        srcv = vp[cy0:cy0 + 8, cx0:cx0 + 8]
        top = ny[y0 - 1, x0:x0 + 16].astype(np.int32) if mby > 0 else None
        left = ny[y0:y0 + 16, x0 - 1].astype(np.int32) if mbx > 0 else None
        tl = int(ny[y0 - 1, x0 - 1]) if mbx > 0 and mby > 0 else None
        best = None
        for m in i16_candidate_modes(top, left, tl):
            pred = P.intra16_pred(m, top, left, tl)
            c = _sad(src16, pred)
            if best is None or c < best[0]:
                best = (c, m, pred)
        _, imode, ipred = best
        dc_scan, aclv, rec_y, cbp_ac, nnz_l = encode_i16_luma(src16, ipred,
                                                              qp)
        tu, lu, tlu = self._cnb(nu, mbx, mby)
        tv, lv_, tlv = self._cnb(nv, mbx, mby)
        bestc = None
        for cm in chroma_candidate_modes(tu, lu):
            pu = P.chroma_pred(cm, tu, lu, tlu)
            pv = P.chroma_pred(cm, tv, lv_, tlv)
            c = _sad(srcu, pu) + _sad(srcv, pv)
            if bestc is None or c < bestc[0]:
                bestc = (c, cm, pu, pv)
        _, cmode, predu, predv = bestc
        udc, uac, urec, u_dc, u_ac, _ = encode_chroma(srcu, predu, qpc,
                                                      True)
        vdc, vac, vrec, v_dc, v_ac, _ = encode_chroma(srcv, predv, qpc,
                                                      True)
        cbp_chroma = 2 if (u_ac or v_ac) else (1 if (u_dc or v_dc) else 0)
        mb_type = 1 + imode + 4 * cbp_chroma + 12 * (1 if cbp_ac else 0)
        if slice_type == SLICE_P:
            mb_type += 5
        elif slice_type == SLICE_B:
            mb_type += 23
        bw.ue(mb_type)
        bw.ue(cmode)
        bw.se(0)
        # luma I16 residual
        b0y, b0x = mby * 4, mbx * 4
        nc = ctx.nc_luma(b0y, b0x)
        encode_residual(bw, dc_scan, nc, 16)
        if cbp_ac:
            for k in range(16):
                ridx = _CODED_ORDER[k]
                by, bx = b0y + ridx // 4, b0x + ridx % 4
                nc = ctx.nc_luma(by, bx)
                tc = encode_residual(bw, zigzag(aclv[ridx])[1:], nc, 15)
                ctx.nnz_l[by, bx] = tc
        else:
            ctx.nnz_l[b0y:b0y + 4, b0x:b0x + 4] = 0
        self._write_chroma(bw, ctx, mbx, mby, cbp_chroma, udc, uac, vdc,
                           vac)
        ny[y0:y0 + 16, x0:x0 + 16] = rec_y
        nu[cy0:cy0 + 8, cx0:cx0 + 8] = urec
        nv[cy0:cy0 + 8, cx0:cx0 + 8] = vrec
        if ms is not None:
            ms.set(0, mbx, mby, -1, 0, 0)
            ms.set(1, mbx, mby, -1, 0, 0)

    @staticmethod
    def _cnb(plane, mbx, mby):
        x0, y0 = mbx * 8, mby * 8
        top = plane[y0 - 1, x0:x0 + 8].astype(np.int32) if mby > 0 else None
        left = plane[y0:y0 + 8, x0 - 1].astype(np.int32) if mbx > 0 \
            else None
        tl = int(plane[y0 - 1, x0 - 1]) if (mbx > 0 and mby > 0) else None
        return top, left, tl

    def _write_inter_resid(self, bw, ctx, mbx, mby, lv, cbp_luma,
                           udc, uac, vdc, vac, cbp_chroma):
        b0y, b0x = mby * 4, mbx * 4
        if cbp_luma:
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
        else:
            ctx.nnz_l[b0y:b0y + 4, b0x:b0x + 4] = 0
        self._write_chroma(bw, ctx, mbx, mby, cbp_chroma, udc, uac, vdc,
                           vac)

    @staticmethod
    def _write_chroma(bw, ctx, mbx, mby, cbp_chroma, udc, uac, vdc, vac):
        b0y, b0x = mby * 2, mbx * 2
        if cbp_chroma == 0:
            ctx.nnz_cb[b0y:b0y + 2, b0x:b0x + 2] = 0
            ctx.nnz_cr[b0y:b0y + 2, b0x:b0x + 2] = 0
            return
        encode_residual(bw, udc, -1, 4)
        encode_residual(bw, vdc, -1, 4)
        if cbp_chroma == 2:
            for aclv, nnzmap in ((uac, ctx.nnz_cb), (vac, ctx.nnz_cr)):
                for ridx in range(4):
                    by, bx = b0y + ridx // 2, b0x + ridx % 2
                    nc = ctx.nc_chroma(nnzmap, by, bx)
                    tc = encode_residual(bw, zigzag(aclv[ridx])[1:], nc, 15)
                    nnzmap[by, bx] = tc
        else:
            ctx.nnz_cb[b0y:b0y + 2, b0x:b0x + 2] = 0
            ctx.nnz_cr[b0y:b0y + 2, b0x:b0x + 2] = 0
