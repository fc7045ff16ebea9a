"""AV1 decoder — mirrors encoder.py bit-exactly (round-trip verified in
tests/test_av1_codec.py). Plays the dav1d/decavcodec role for the AV1
family (reference decavcodec.c, SURVEY.md §2.3): OBU parse → frame
header → range-decoded superblock walk → recon planes.
"""
from __future__ import annotations

import numpy as np

from . import obu
from . import predict as P
from . import transform as T
from .cdfs import CdfSet, EOB_CLASS_BITS, EOB_CLASS_LO
from .encoder import PAD
from .rangecoder import RangeDecoder


def decode_residual(dec: RangeDecoder, token_cdf, eob_cdf) -> np.ndarray:
    c = dec.decode_symbol(eob_cdf)
    eob = EOB_CLASS_LO[c]
    if EOB_CLASS_BITS[c]:
        eob += dec.decode_literal(EOB_CLASS_BITS[c])
    zz = np.zeros(64, np.int32)
    for i in range(eob):
        tok = dec.decode_symbol(token_cdf)
        lvl = tok
        if tok == 3:
            lvl = 3 + dec.decode_golomb()
        if tok:
            if dec.decode_bit():
                lvl = -lvl
        zz[i] = lvl
    out = np.zeros(64, np.int32)
    out[T.ZZ_FLAT] = zz
    return out.reshape(8, 8)


class AV1Decoder:
    def __init__(self):
        self.width = 0
        self.height = 0
        self.w64 = self.h64 = 0
        self.recon_y = self.recon_u = self.recon_v = None
        self._ref = None
        self.seq = None

    def decode(self, data: bytes) -> list:
        """Decode one temporal unit; returns [(y,u,v)] uint8 frames."""
        frames = []
        for obu_type, payload in obu.parse_obus(data):
            if obu_type == obu.OBU_SEQUENCE_HEADER:
                self.seq = obu.parse_sequence_header(payload)
                self._alloc(self.seq["width"], self.seq["height"])
            elif obu_type == obu.OBU_FRAME:
                ftype, qidx, tile = obu.parse_frame_obu(payload)
                self._decode_frame(ftype, qidx, tile)
                frames.append(self._output())
        return frames

    def _alloc(self, w, h):
        if (w, h) == (self.width, self.height):
            return
        self.width, self.height = w, h
        self.w64 = (w + 63) & ~63
        self.h64 = (h + 63) & ~63
        self.recon_y = np.zeros((self.h64, self.w64), np.uint8)
        self.recon_u = np.zeros((self.h64 // 2, self.w64 // 2), np.uint8)
        self.recon_v = np.zeros_like(self.recon_u)

    def _output(self):
        w, h = self.width, self.height
        return (self.recon_y[:h, :w].copy(),
                self.recon_u[:(h + 1) // 2, :(w + 1) // 2].copy(),
                self.recon_v[:(h + 1) // 2, :(w + 1) // 2].copy())

    def _pad_ref(self):
        py = np.pad(self.recon_y.astype(np.int32), PAD, mode="edge")
        pu = np.pad(self.recon_u.astype(np.int32), PAD // 2, mode="edge")
        pv = np.pad(self.recon_v.astype(np.int32), PAD // 2, mode="edge")
        self._ref = (py, pu, pv)

    # -- block-level mirrors -------------------------------------------------
    def _intra_pred(self, mode, by, bx):
        a, l, tl = P.edges(self.recon_y, by, bx, 16, 16)
        py = P.predict(mode, a, l, tl, 16, 16)
        cy, cx = by // 2, bx // 2
        au, lu, tlu = P.edges(self.recon_u, cy, cx, 8, 8)
        av, lv_, tlv = P.edges(self.recon_v, cy, cx, 8, 8)
        pu = P.predict(mode, au, lu, tlu, 8, 8)
        pv = P.predict(mode, av, lv_, tlv, 8, 8)
        return py, pu, pv

    def _mc(self, by, bx, mv):
        py, pu, pv = self._ref
        yy, yx = by + PAD + mv[1], bx + PAD + mv[0]
        pred_y = py[yy:yy + 16, yx:yx + 16]
        cmy, cmx = mv[1] >> 1, mv[0] >> 1
        cy, cx = by // 2 + PAD // 2 + cmy, bx // 2 + PAD // 2 + cmx
        return pred_y, pu[cy:cy + 8, cx:cx + 8], pv[cy:cy + 8, cx:cx + 8]

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

    def _read_block_residual(self, dec, cdf, pred_y, pred_u, pred_v,
                             by, bx, qidx):
        nonzero = dec.decode_symbol(cdf.skip) == 0
        if not nonzero:
            rec = (pred_y, pred_u, pred_v)
        else:
            lv = np.stack(
                [decode_residual(dec, cdf.token_y, cdf.eob_y)
                 for _ in range(4)] +
                [decode_residual(dec, cdf.token_uv, cdf.eob_uv)
                 for _ in range(2)])
            res = T.idct8x8(T.dequantize(lv, qidx))
            rec_y = pred_y.copy()
            rec_y[:8, :8] += res[0]
            rec_y[:8, 8:] += res[1]
            rec_y[8:, :8] += res[2]
            rec_y[8:, 8:] += res[3]
            rec = (rec_y, pred_u + res[4], pred_v + res[5])
        self.recon_y[by:by + 16, bx:bx + 16] = np.clip(rec[0], 0, 255)
        cy, cx = by // 2, bx // 2
        self.recon_u[cy:cy + 8, cx:cx + 8] = np.clip(rec[1], 0, 255)
        self.recon_v[cy:cy + 8, cx:cx + 8] = np.clip(rec[2], 0, 255)

    def _decode_frame(self, ftype, qidx, tile):
        if self.recon_y is None:
            raise ValueError("frame OBU before sequence header")
        dec = RangeDecoder(tile)
        cdf = CdfSet()
        if ftype == obu.KEY_FRAME:
            for by in range(0, self.h64, 16):
                for bx in range(0, self.w64, 16):
                    mode = dec.decode_symbol(cdf.ymode)
                    pred = self._intra_pred(mode, by, bx)
                    self._read_block_residual(dec, cdf, *pred, by, bx, qidx)
        else:
            self._pad_ref()
            n_cols = self.w64 // 16
            mvs = [[(0, 0)] * n_cols for _ in range(self.h64 // 16)]
            for r, by in enumerate(range(0, self.h64, 16)):
                for c, bx in enumerate(range(0, self.w64, 16)):
                    pred_mv = self._mv_pred(mvs, r, c)
                    if dec.decode_symbol(cdf.skip) == 1:
                        mvs[r][c] = pred_mv
                        pred = self._mc(by, bx, pred_mv)
                        self.recon_y[by:by + 16, bx:bx + 16] = \
                            np.clip(pred[0], 0, 255)
                        cy, cx = by // 2, bx // 2
                        self.recon_u[cy:cy + 8, cx:cx + 8] = \
                            np.clip(pred[1], 0, 255)
                        self.recon_v[cy:cy + 8, cx:cx + 8] = \
                            np.clip(pred[2], 0, 255)
                        continue
                    if dec.decode_symbol(cdf.is_inter) == 1:
                        mv = (pred_mv[0] + dec.decode_sgolomb(),
                              pred_mv[1] + dec.decode_sgolomb())
                        mvs[r][c] = mv
                        pred = self._mc(by, bx, mv)
                    else:
                        mode = dec.decode_symbol(cdf.ymode)
                        pred = self._intra_pred(mode, by, bx)
                    self._read_block_residual(dec, cdf, *pred, by, bx, qidx)
        self._pad_ref()
