"""AV1 encoder — superblock walker, host reference path.

Role of the reference's encsvtav1.c work object (SVT-AV1 replaced
wholesale per SURVEY.md §2.5). Produces OBU temporal units:
[TD][seq hdr (key)][frame OBU], range-coded with adaptive CDFs
(rangecoder.py). Coding tools this round: 64x64 superblocks walked in
raster order as 16x16 blocks, intra DC/V/H/Paeth/Smooth, single-ref
(LAST) full-pel inter with median MV prediction, skip blocks, 8x8
integer DCT + deadzone quant, per-frame CDF reset. Reconstruction is
bit-exact with decoder.py (round-trip asserted in tests).

The batched P-frame motion search runs as torch ops on the encoder's
device (analyzer.py); this walker owns the sequential entropy coding
(SURVEY.md §7 "Hard parts #1").  A device search that fails raises: the
frame is not coded with the host search in its place.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import obu
from . import predict as P
from . import transform as T
from .cdfs import CdfSet, EOB_CLASS_BITS, EOB_CLASS_LO, eob_class
from .rangecoder import RangeEncoder
from ...utils.device import resolve_device

BLOCK = 16          # luma block size (chroma 8)
PAD = 32            # recon padding for ME/MC


@dataclasses.dataclass
class EncoderConfig:
    width: int
    height: int
    qp: int = 30                # 0..51 scale (CLI/CRF); mapped to qindex
    gop: int = 60
    search_range: int = 8
    fps: tuple = (30000, 1001)
    backend: str = "device"     # batched torch search of P frames on the
                                # encoder's device; "host" = _search


def qp_to_qindex(qp: int) -> int:
    return int(np.clip(qp * 5, 1, 255))


def code_residual(enc: RangeEncoder, levels: np.ndarray, token_cdf,
                  eob_cdf) -> bool:
    """Zigzag + eob-class + level tokens for one 8x8. Returns nonzero."""
    zz = levels.reshape(64)[T.ZZ_FLAT]
    nz = np.nonzero(zz)[0]
    eob = int(nz[-1]) + 1 if len(nz) else 0
    c = eob_class(eob)
    enc.encode_symbol(c, eob_cdf)
    if EOB_CLASS_BITS[c]:
        enc.encode_literal(eob - EOB_CLASS_LO[c], EOB_CLASS_BITS[c])
    for i in range(eob):
        l = int(zz[i])
        tok = min(abs(l), 3)
        enc.encode_symbol(tok, token_cdf)
        if tok == 3:
            enc.encode_golomb(abs(l) - 3)
        if tok:
            enc.encode_bit(1 if l < 0 else 0)
    return eob > 0


class AV1Encoder:
    """device=None searches P frames on the CUDA card; "cpu" on the
    CPU."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.w64 = (cfg.width + 63) & ~63
        self.h64 = (cfg.height + 63) & ~63
        self.frame_idx = 0
        self.last_frame_was_idr = False
        self.recon_y = np.zeros((self.h64, self.w64), np.uint8)
        self.recon_u = np.zeros((self.h64 // 2, self.w64 // 2), np.uint8)
        self.recon_v = np.zeros_like(self.recon_u)
        self._ref = None        # padded (y,u,v) of previous recon
        self._analyzer = None
        self.extradata = obu.build_av1c(
            obu.sequence_header(cfg.width, cfg.height))

    # -- reference-plane padding -------------------------------------------
    def _pad_ref(self):
        py = np.pad(self.recon_y.astype(np.int32), PAD, mode="edge")
        pu = np.pad(self.recon_u.astype(np.int32), PAD // 2, mode="edge")
        pv = np.pad(self.recon_v.astype(np.int32), PAD // 2, mode="edge")
        self._ref = (py, pu, pv)

    def encode_frame(self, y, u, v, qp=None) -> bytes:
        cfg = self.cfg
        qidx = qp_to_qindex(cfg.qp if qp is None else int(qp))
        key = (self.frame_idx % cfg.gop) == 0
        self.last_frame_was_idr = key

        ypad = np.zeros((self.h64, self.w64), np.int32)
        ypad[:y.shape[0], :y.shape[1]] = y
        ypad[y.shape[0]:] = ypad[max(y.shape[0] - 1, 0)]
        ypad[:, y.shape[1]:] = ypad[:, max(y.shape[1] - 1, 0)][:, None]
        upad = np.zeros((self.h64 // 2, self.w64 // 2), np.int32)
        vpad = np.zeros_like(upad)
        upad[:u.shape[0], :u.shape[1]] = u
        vpad[:v.shape[0], :v.shape[1]] = v

        enc = RangeEncoder()
        cdf = CdfSet()
        if key:
            self._encode_intra_frame(enc, cdf, ypad, upad, vpad, qidx)
        else:
            self._encode_inter_frame(enc, cdf, ypad, upad, vpad, qidx)
        tile = enc.finish()
        self._pad_ref()

        out = obu.temporal_delimiter()
        if key:
            out += obu.sequence_header(cfg.width, cfg.height, qidx)
        out += obu.frame_obu(obu.KEY_FRAME if key else obu.INTER_FRAME,
                             qidx, tile)
        self.frame_idx += 1
        return out

    # -- shared block coding ------------------------------------------------
    def _code_block_residual(self, enc, cdf, src_y, src_u, src_v,
                             pred_y, pred_u, pred_v, by, bx, qidx, intra):
        """Transform/quant/code/recon one 16x16 block. Returns nonzero."""
        ry = src_y - pred_y
        ru = src_u - pred_u
        rv = src_v - pred_v
        blks = np.stack([ry[:8, :8], ry[:8, 8:], ry[8:, :8], ry[8:, 8:],
                         ru, rv])
        lv = np.stack([T.quantize(c, qidx, intra)
                       for c in T.fdct8x8(blks)])
        nonzero = bool(lv.any())
        enc.encode_symbol(0 if nonzero else 1, cdf.skip)
        if not nonzero:
            rec_y, rec_u, rec_v = pred_y, pred_u, pred_v
        else:
            for i in range(4):
                code_residual(enc, lv[i], cdf.token_y, cdf.eob_y)
            code_residual(enc, lv[4], cdf.token_uv, cdf.eob_uv)
            code_residual(enc, lv[5], cdf.token_uv, cdf.eob_uv)
            res = T.idct8x8(T.dequantize(lv, qidx))
            rec_y = pred_y.copy()
            rec_y[:8, :8] += res[0]
            rec_y[:8, 8:] += res[1]
            rec_y[8:, :8] += res[2]
            rec_y[8:, 8:] += res[3]
            rec_u = pred_u + res[4]
            rec_v = pred_v + res[5]
        self.recon_y[by:by + 16, bx:bx + 16] = np.clip(rec_y, 0, 255)
        cy, cx = by // 2, bx // 2
        self.recon_u[cy:cy + 8, cx:cx + 8] = np.clip(rec_u, 0, 255)
        self.recon_v[cy:cy + 8, cx:cx + 8] = np.clip(rec_v, 0, 255)
        return nonzero

    def _intra_pred(self, mode, by, bx):
        a, l, tl = P.edges(self.recon_y, by, bx, 16, 16)
        py = P.predict(mode, a, l, tl, 16, 16)
        cy, cx = by // 2, bx // 2
        au, lu, tlu = P.edges(self.recon_u, cy, cx, 8, 8)
        av, lv_, tlv = P.edges(self.recon_v, cy, cx, 8, 8)
        pu = P.predict(mode, au, lu, tlu, 8, 8)
        pv = P.predict(mode, av, lv_, tlv, 8, 8)
        return py, pu, pv

    def _best_intra(self, src_y, by, bx):
        best, bm, bp = None, 0, None
        a, l, tl = P.edges(self.recon_y, by, bx, 16, 16)
        for m in range(P.N_INTRA_MODES):
            pred = P.predict(m, a, l, tl, 16, 16)
            sad = int(np.abs(src_y - pred).sum())
            if best is None or sad < best:
                best, bm, bp = sad, m, pred
        return bm, best, bp

    # -- intra frame ---------------------------------------------------------
    def _encode_intra_frame(self, enc, cdf, ypad, upad, vpad, qidx):
        for by in range(0, self.h64, 16):
            for bx in range(0, self.w64, 16):
                sy = ypad[by:by + 16, bx:bx + 16]
                cy, cx = by // 2, bx // 2
                su = upad[cy:cy + 8, cx:cx + 8]
                sv = vpad[cy:cy + 8, cx:cx + 8]
                mode, _, _ = self._best_intra(sy, by, bx)
                enc.encode_symbol(mode, cdf.ymode)
                py, pu, pv = self._intra_pred(mode, by, bx)
                self._code_block_residual(enc, cdf, sy, su, sv, py, pu, pv,
                                          by, bx, qidx, intra=True)

    # -- inter frame ---------------------------------------------------------
    def _mv_pred(self, mvs, r, c):
        cands = []
        if c > 0:
            cands.append(mvs[r][c - 1])
        if r > 0:
            cands.append(mvs[r - 1][c])
        if r > 0 and c > 0:
            cands.append(mvs[r - 1][c - 1])
        while len(cands) < 3:
            cands.append((0, 0))
        xs = sorted(m[0] for m in cands)
        ys = sorted(m[1] for m in cands)
        return xs[1], ys[1]

    def _mc(self, by, bx, mv):
        py, pu, pv = self._ref
        yy, yx = by + PAD + mv[1], bx + PAD + mv[0]
        pred_y = py[yy:yy + 16, yx:yx + 16]
        cmy, cmx = mv[1] >> 1, mv[0] >> 1
        cy, cx = by // 2 + PAD // 2 + cmy, bx // 2 + PAD // 2 + cmx
        pred_u = pu[cy:cy + 8, cx:cx + 8]
        pred_v = pv[cy:cy + 8, cx:cx + 8]
        return pred_y, pred_u, pred_v

    def _search(self, src_y, by, bx, pred_mv):
        py, _, _ = self._ref
        sr = self.cfg.search_range
        best, bmv = None, (0, 0)
        for dy in range(-sr, sr + 1):
            for dx in range(-sr, sr + 1):
                yy, yx = by + PAD + dy, bx + PAD + dx
                sad = int(np.abs(
                    src_y - py[yy:yy + 16, yx:yx + 16]).sum())
                cost = sad + 4 * (abs(dx - pred_mv[0]) +
                                  abs(dy - pred_mv[1]))
                if best is None or cost < best:
                    best, bmv = cost, (dx, dy)
        return bmv, best

    def _encode_inter_frame(self, enc, cdf, ypad, upad, vpad, qidx):
        if self._ref is None:
            self._pad_ref()
        n_cols = self.w64 // 16
        mvs = [[(0, 0)] * n_cols for _ in range(self.h64 // 16)]
        analysis = None
        if self.cfg.backend == "device":
            analysis = self._device_analysis(ypad)
        for r, by in enumerate(range(0, self.h64, 16)):
            for c, bx in enumerate(range(0, self.w64, 16)):
                sy = ypad[by:by + 16, bx:bx + 16]
                cyy, cxx = by // 2, bx // 2
                su = upad[cyy:cyy + 8, cxx:cxx + 8]
                sv = vpad[cyy:cyy + 8, cxx:cxx + 8]
                pred_mv = self._mv_pred(mvs, r, c)
                if analysis is not None:
                    mv = (int(analysis["mvx"][r, c]),
                          int(analysis["mvy"][r, c]))
                    inter_sad = int(analysis["sad"][r, c])
                    inter_sad += 4 * (abs(mv[0] - pred_mv[0]) +
                                      abs(mv[1] - pred_mv[1]))
                else:
                    mv, inter_sad = self._search(sy, by, bx, pred_mv)
                _, intra_sad, _ = self._best_intra(sy, by, bx)
                use_inter = inter_sad <= intra_sad + 32
                if use_inter:
                    mvs[r][c] = mv
                    pred = self._mc(by, bx, mv)
                    # skip = inter, mv==pred_mv, zero residual
                    if mv == pred_mv:
                        ry = sy - pred[0]
                        lv = np.stack([
                            T.quantize(cc, qidx, False)
                            for cc in T.fdct8x8(np.stack(
                                [ry[:8, :8], ry[:8, 8:],
                                 ry[8:, :8], ry[8:, 8:]]))])
                        if not lv.any():
                            enc.encode_symbol(1, cdf.skip)
                            self._store_recon(pred, by, bx)
                            continue
                    enc.encode_symbol(0, cdf.skip)
                    enc.encode_symbol(1, cdf.is_inter)
                    enc.encode_sgolomb(mv[0] - pred_mv[0])
                    enc.encode_sgolomb(mv[1] - pred_mv[1])
                    self._code_block_residual(
                        enc, cdf, sy, su, sv, *pred, by, bx, qidx,
                        intra=False)
                else:
                    mode, _, _ = self._best_intra(sy, by, bx)
                    enc.encode_symbol(0, cdf.skip)
                    enc.encode_symbol(0, cdf.is_inter)
                    enc.encode_symbol(mode, cdf.ymode)
                    pred = self._intra_pred(mode, by, bx)
                    self._code_block_residual(
                        enc, cdf, sy, su, sv, *pred, by, bx, qidx,
                        intra=True)

    def _store_recon(self, pred, by, bx):
        self.recon_y[by:by + 16, bx:bx + 16] = np.clip(pred[0], 0, 255)
        cy, cx = by // 2, bx // 2
        self.recon_u[cy:cy + 8, cx:cx + 8] = np.clip(pred[1], 0, 255)
        self.recon_v[cy:cy + 8, cx:cx + 8] = np.clip(pred[2], 0, 255)

    def _device_analysis(self, ypad):
        """Batched full-pel ME on the encoder's device (analyzer.py).
        An error propagates (the reference catches every exception and
        codes the frame with the host search)."""
        if self._analyzer is None:
            from .analyzer import build_me
            self._analyzer = build_me(
                self.h64 // 16, self.w64 // 16, self.cfg.search_range,
                device=self.device)
        mvx, mvy, sad = self._analyzer(
            ypad.astype(np.uint8),
            self.recon_y)
        return {"mvx": np.asarray(mvx), "mvy": np.asarray(mvy),
                "sad": np.asarray(sad)}
