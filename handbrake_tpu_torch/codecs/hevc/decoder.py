"""HEVC decoder for the Main-profile subset our encoder emits (and any
conformant stream within it: CTB 32 = CU = PU, TU 32/16, one ref, no SAO/
deblocking). Used for round-trip validation (SURVEY.md §4: golden-path
bit-exactness) and as the transcode-input decoder for HEVC sources.
"""
from __future__ import annotations

import numpy as np

from . import predict as P
from . import transform as T
from .cabac import CabacDecoder, ContextSet
from .encoder import FrameState, amvp_candidates, merge_candidate, mpm_list
from .residual import decode_residual
from .syntax import (NAL_IDR_W_RADL, NAL_PPS, NAL_SPS, NAL_TRAIL_R, NAL_VPS,
                     PPS, SLICE_I, SLICE_P, SPS, SliceHeader, split_annexb)
from .tables import chroma_qp
from ..h264.bits import BitReader

PAD = 48


class HEVCDecoder:
    """decode(annexb_bytes) -> list of (y, u, v) uint8 frames (cropped)."""

    def __init__(self):
        self.sps = None
        self.pps = None
        self.ref = None   # (y, u, v) int32 padded planes
        self.bd = 8

    def decode(self, data: bytes):
        frames = []
        for nal_type, rbsp in split_annexb(data):
            if nal_type == NAL_VPS:
                continue
            if nal_type == NAL_SPS:
                self.sps = SPS.parse(rbsp)
            elif nal_type == NAL_PPS:
                self.pps = PPS.parse(rbsp)
            elif nal_type in (NAL_IDR_W_RADL, NAL_TRAIL_R):
                frames.append(self._decode_slice(rbsp, nal_type))
        return frames

    def _decode_slice(self, rbsp: bytes, nal_type: int):
        sps, pps = self.sps, self.pps
        self.bd = sps.bit_depth
        br = BitReader(rbsp)
        hdr = SliceHeader.parse(br, sps, pps, nal_type)
        qp = hdr.qp
        init_type = 0 if hdr.slice_type == SLICE_I else 1
        dec = CabacDecoder(ContextSet(init_type, qp),
                           BitReader(rbsp[br.pos // 8:]))
        cw, ch = sps.width // 32, sps.height // 32
        st = FrameState(cw, ch)
        y = np.zeros((sps.height, sps.width), np.int32)
        u = np.zeros((sps.height // 2, sps.width // 2), np.int32)
        v = np.zeros_like(u)
        ref = None
        if hdr.slice_type == SLICE_P:
            ref = (P.pad_plane(self.ref[0], PAD),
                   P.pad_plane(self.ref[1], PAD),
                   P.pad_plane(self.ref[2], PAD))
        for i in range(cw * ch):
            cy, cx = divmod(i, cw)
            self._decode_ctu(dec, st, y, u, v, ref, cx, cy, qp,
                             hdr.slice_type, cw, ch)
            end = dec.terminate()
            assert end == (1 if i == cw * ch - 1 else 0), "slice end mismatch"
        self.ref = (y, u, v)
        W = sps.width - sps.crop_right
        H = sps.height - sps.crop_bottom
        dt = np.uint8 if self.bd == 8 else np.uint16
        return (y[:H, :W].astype(dt),
                u[:H // 2, :W // 2].astype(dt),
                v[:H // 2, :W // 2].astype(dt))

    def _decode_ctu(self, dec, st, y, u, v, ref, cx, cy, qp, stype, cw, ch):
        x0, y0 = cx * 32, cy * 32
        cx0, cy0 = cx * 16, cy * 16
        if stype == SLICE_P:
            ctx = 0
            if cx > 0 and st.is_skip[cy, cx - 1]:
                ctx += 1
            if cy > 0 and st.is_skip[cy - 1, cx]:
                ctx += 1
            if dec.bin("cu_skip", ctx):
                mv = merge_candidate(st, cx, cy) or (0, 0)
                self._inter_recon(y, u, v, ref, x0, y0, mv)
                st.is_skip[cy, cx] = True
                st.is_inter[cy, cx] = True
                st.mv[cy, cx] = mv
                return
            intra = dec.bin("pred_mode", 0) == 1
        else:
            intra = True
        if intra:
            self._decode_intra_ctu(dec, st, y, u, v, cx, cy, qp)
        else:
            self._decode_inter_ctu(dec, st, y, u, v, ref, cx, cy, qp)

    # -- intra ----------------------------------------------------------------
    def _decode_intra_ctu(self, dec, st, y, u, v, cx, cy, qp):
        x0, y0 = cx * 32, cy * 32
        cx0, cy0 = cx * 16, cy * 16
        assert dec.bin("part_mode", 0) == 1, "NxN intra unsupported"
        cand_a = P.DC
        if cx > 0 and st.intra_mode[cy, cx - 1] >= 0:
            cand_a = int(st.intra_mode[cy, cx - 1])
        mpm = mpm_list(cand_a, P.DC)
        if dec.bin("prev_intra", 0):
            idx = 0
            if dec.bypass():
                idx = 1 + dec.bypass()
            mode = mpm[idx]
        else:
            rem = dec.bypass_bits(5)
            mode = rem
            for cand in sorted(mpm):
                if mode >= cand:
                    mode += 1
        assert dec.bin("chroma_pred", 0) == 0, "only DM chroma mode"

        cbf_u = dec.bin("cbf_chroma", 0)
        cbf_v = dec.bin("cbf_chroma", 0)
        cbf_y = dec.bin("cbf_luma", 1)

        bd = self.bd
        filt = P.filter_flag(mode, 32, 0)
        left, tl, top = P.ref_samples(y, x0, y0, 32, filt, bd)
        pred_y = P.intra_pred(mode, left, tl, top, 32, 0, bd)
        lu, ltl, lto = P.ref_samples(u, cx0, cy0, 16, False, bd)
        pred_u = P.intra_pred(mode, lu, ltl, lto, 16, 1, bd)
        lvv, vtl, vto = P.ref_samples(v, cx0, cy0, 16, False, bd)
        pred_v = P.intra_pred(mode, lvv, vtl, vto, 16, 1, bd)

        qpc = chroma_qp(qp)
        y[y0:y0 + 32, x0:x0 + 32] = self._recon_tu(
            dec, pred_y, cbf_y, qp, 5, 0)
        u[cy0:cy0 + 16, cx0:cx0 + 16] = self._recon_tu(
            dec, pred_u, cbf_u, qpc, 4, 1)
        v[cy0:cy0 + 16, cx0:cx0 + 16] = self._recon_tu(
            dec, pred_v, cbf_v, qpc, 4, 2)
        st.intra_mode[cy, cx] = mode

    def _recon_tu(self, dec, pred, cbf, qp, log2n, cidx):
        bd = self.bd
        if not cbf:
            return np.clip(pred, 0, (1 << bd) - 1)
        lv = decode_residual(dec, log2n, cidx)
        d = T.dequant(np, lv, qp, log2n, bd)
        r = T.inv_transform(np, d[None], log2n, bd)[0]
        return np.clip(pred + r, 0, (1 << bd) - 1)

    # -- inter ----------------------------------------------------------------
    def _decode_inter_ctu(self, dec, st, y, u, v, ref, cx, cy, qp):
        x0, y0 = cx * 32, cy * 32
        cx0, cy0 = cx * 16, cy * 16
        assert dec.bin("part_mode", 0) == 1, "2Nx2N only"
        is_merge = dec.bin("merge_flag", 0)
        if is_merge:
            mv = merge_candidate(st, cx, cy) or (0, 0)
        else:
            dx, dy = self._read_mvd(dec)
            mvp_idx = dec.bin("mvp_idx", 0)
            amvp = amvp_candidates(st, cx, cy)
            mv = (amvp[mvp_idx][0] + dx, amvp[mvp_idx][1] + dy)
        cbf_y = 1
        cbf_u = cbf_v = 0
        # rqt_root_cbf inferred 1 for 2Nx2N merge CUs (spec 7.3.8.5)
        root_cbf = 1 if is_merge else dec.bin("rqt_root_cbf", 0)
        if root_cbf:
            cbf_u = dec.bin("cbf_chroma", 0)
            cbf_v = dec.bin("cbf_chroma", 0)
            if cbf_u or cbf_v:
                cbf_y = dec.bin("cbf_luma", 1)
        else:
            cbf_y = 0
        pred_y = P.mc_luma(ref[0], PAD, x0, y0, 32, 32, mv[0], mv[1],
                           self.bd)
        pred_u = P.mc_chroma(ref[1], PAD, cx0, cy0, 16, 16, mv[0], mv[1],
                             self.bd)
        pred_v = P.mc_chroma(ref[2], PAD, cx0, cy0, 16, 16, mv[0], mv[1],
                             self.bd)
        qpc = chroma_qp(qp)
        y[y0:y0 + 32, x0:x0 + 32] = self._recon_tu(
            dec, pred_y, cbf_y, qp, 5, 0)
        u[cy0:cy0 + 16, cx0:cx0 + 16] = self._recon_tu(
            dec, pred_u, cbf_u, qpc, 4, 1)
        v[cy0:cy0 + 16, cx0:cx0 + 16] = self._recon_tu(
            dec, pred_v, cbf_v, qpc, 4, 2)
        st.is_inter[cy, cx] = True
        st.mv[cy, cx] = mv

    def _inter_recon(self, y, u, v, ref, x0, y0, mv):
        cx0, cy0 = x0 // 2, y0 // 2
        y[y0:y0 + 32, x0:x0 + 32] = P.mc_luma(ref[0], PAD, x0, y0, 32, 32,
                                              mv[0], mv[1], self.bd)
        u[cy0:cy0 + 16, cx0:cx0 + 16] = P.mc_chroma(ref[1], PAD, cx0, cy0,
                                                    16, 16, mv[0], mv[1],
                                                    self.bd)
        v[cy0:cy0 + 16, cx0:cx0 + 16] = P.mc_chroma(ref[2], PAD, cx0, cy0,
                                                    16, 16, mv[0], mv[1],
                                                    self.bd)

    def _read_mvd(self, dec):
        gx = dec.bin("mvd", 0)
        gy = dec.bin("mvd", 0)
        g1x = dec.bin("mvd", 1) if gx else 0
        g1y = dec.bin("mvd", 1) if gy else 0
        out = []
        for g, g1 in ((gx, g1x), (gy, g1y)):
            if not g:
                out.append(0)
                continue
            a = 1
            if g1:
                a = 2 + self._eg1(dec)
            out.append(-a if dec.bypass() else a)
        return out[0], out[1]

    @staticmethod
    def _eg1(dec) -> int:
        k = 1
        base = 0
        while dec.bypass():
            base += 1 << k
            k += 1
        return base + dec.bypass_bits(k)
