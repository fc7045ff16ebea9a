"""AC-3 (ATSC A/52) encoder.

Role of encavcodecaudio.c's AC-3 personality (HandBrake offers AC-3
output for the DVD/AVR ecosystem): windowed 512-point MDCT, exponent
extraction with D45 block-0 strategy + reuse, the SAME parametric
bit-allocation model the decoder runs (shared via ac3dec — encoder and
decoder must agree bit-for-bit on bap for the mantissa stream to be
parseable), SNR-offset binary search to fill the target frame size, and
grouped mantissa packing (shared b1/b2/b4 group state across channels,
mirroring the decode order).

Toolset kept deliberately lean — no coupling, no rematrixing, no block
switching, no dither flags — every tool off is signalled explicitly so
any spec decoder (and ours) parses the stream.  CRC words are written
as zeros: players and libavcodec only verify them under explicit
error-checking flags; A/52 ยง5.4.1 reserves them for error detection.
"""
from __future__ import annotations

import numpy as np

from . import ac3_tables as T
from .ac3dec import Ac3Decoder, _kbd_window, FSCOD_RATES

_NFCHANS = {1: 1, 2: 2, 6: 5}          # fbw channels per input layout
_ACMOD = {1: 1, 2: 2, 6: 7}


class _BW:
    def __init__(self):
        self.bits = []

    def write(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def tell(self):
        return len(self.bits)

    def bytes(self, total_bytes: int) -> bytes:
        bits = (self.bits + [0] * (total_bytes * 8 - len(self.bits)))[
            :total_bytes * 8]
        out = bytearray(total_bytes)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


class Ac3Encoder:
    """encode((n, ch) float32) → list of syncframe bytes.  ch in
    {1, 2, 6}; 6-channel input is FL FR FC LFE BL BR (5.1)."""

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 bitrate: int = 192000):
        if channels not in _ACMOD:
            raise ValueError("AC-3 encoder supports 1/2/6 channels")
        self.sample_rate = sample_rate
        self.channels = channels
        self.fscod = FSCOD_RATES.index(sample_rate)
        kbps = bitrate // 1000
        codes = [i for i, b in enumerate(T.BITRATES) if b >= kbps]
        self.frmsizecod = (codes[0] if codes else 18) << 1
        self.bitrate = T.BITRATES[self.frmsizecod >> 1] * 1000
        from .ac3dec import frame_size
        self.frame_bytes = frame_size(self.fscod, self.frmsizecod)
        self.acmod = _ACMOD[channels]
        self.lfeon = 1 if channels == 6 else 0
        self.nfchans = _NFCHANS[channels]
        w = _kbd_window(256, 5.0)
        self._win = np.concatenate([w, w[::-1]])
        M = 512
        n = np.arange(M)[:, None]
        k = np.arange(M // 2)[None, :]
        # forward transform: inverse of the decoder's -2 * M @ X path
        self._mdct = (-1.0 / 256.0) * np.cos(
            2 * np.pi / M * (n + 0.5 + M / 4) * (k + 0.5))
        self._hist = np.zeros((channels, 256), np.float64)
        self._pend = np.zeros((0, channels), np.float32)
        self._alloc = Ac3Decoder.__new__(Ac3Decoder)  # static bit-alloc
        # fixed allocation parameters (written in every block-0)
        self._sdcycod, self._fdcycod = 2, 1
        self._sgaincod, self._dbpbcod, self._floorcod = 1, 2, 4
        self._fgaincod = 4
        self.endmant = 253                 # chbwcod 60, full bandwidth

    # -- public ------------------------------------------------------------
    def encode(self, pcm: np.ndarray):
        pcm = np.asarray(pcm, np.float32)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        self._pend = np.concatenate([self._pend, pcm], 0)
        out = []
        while len(self._pend) >= 1536:
            chunk = self._pend[:1536]
            self._pend = self._pend[1536:]
            out.append(self._encode_frame(chunk))
        return out

    def flush(self):
        if len(self._pend) == 0:
            return []
        pad = np.zeros((1536 - len(self._pend), self.channels),
                       np.float32)
        self._pend = np.concatenate([self._pend, pad], 0)
        return self.encode(np.zeros((0, self.channels), np.float32))

    # -- core --------------------------------------------------------------
    def _route(self, chunk):
        """Input layout → A/52 transmission order (+ lfe last)."""
        if self.channels == 6:             # FL FR FC LFE BL BR
            return chunk[:, [0, 2, 1, 4, 5, 3]]
        return chunk

    def _encode_frame(self, chunk) -> bytes:
        chunk = self._route(chunk).astype(np.float64)
        nch = self.nfchans + self.lfeon
        # 6 blocks of MDCT coefficients per channel
        X = np.zeros((nch, 6, 256))
        for blk in range(6):
            seg = chunk[blk * 256:(blk + 1) * 256]
            for c in range(nch):
                xin = np.concatenate([self._hist[c], seg[:, c]])
                X[c, blk] = (self._win * xin) @ self._mdct
            self._hist = seg.T.copy()      # 50% MDCT overlap
        # exponents: shared across the 6 blocks (strategy: new in block
        # 0, reuse in 1-5), from the per-bin max magnitude
        mags = np.abs(X).max(axis=1)
        exps = []
        for c in range(self.nfchans):
            exps.append(self._channel_exps(mags[c], self.endmant, gs=4))
        if self.lfeon:
            exps.append(self._channel_exps(mags[nch - 1], 7, gs=1,
                                           abs_cap=15))
        # snroffset search: largest csnroffst whose packed frame fits
        lo, hi = 0, 63
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            frame = self._pack(X, exps, mid)
            if frame is not None:
                best = frame
                lo = mid + 1
            else:
                hi = mid - 1
        if best is None:
            best = self._pack(X, exps, 0, force=True)
        return best

    @staticmethod
    def _channel_exps(mag, end, gs, abs_cap=15):
        raw = np.where(mag[:end] > 0,
                       np.floor(-np.log2(np.maximum(mag[:end], 1e-30))),
                       24).astype(np.int64)
        raw = np.clip(raw, 0, 24)
        # cell targets: bin 0 alone, then gs-wide cells (grouped deltas
        # apply one exponent per cell); exponent must not exceed the
        # finest (minimum) raw value in the cell
        ncell = (end - 1 + gs - 1) // gs
        t = np.empty(ncell + 1, np.int64)
        t[0] = min(int(raw[0]), abs_cap)
        for k in range(ncell):
            t[k + 1] = raw[1 + k * gs:1 + (k + 1) * gs].min()
        # backward limit so the +/-2 delta chain can always stay under
        for k in range(ncell - 1, -1, -1):
            t[k] = min(t[k], t[k + 1] + 2)
        t[0] = min(int(t[0]), abs_cap)
        e = np.empty_like(t)
        e[0] = t[0]
        for k in range(1, ncell + 1):
            d = max(-2, min(2, int(t[k]) - int(e[k - 1])))
            e[k] = e[k - 1] + d
        exps = np.zeros(256, np.int32)
        exps[0] = e[0]
        for k in range(ncell):
            exps[1 + k * gs:1 + (k + 1) * gs] = e[k + 1]
        return exps[:end], e

    def _bap_for(self, exps_full, end, csnr):
        st = {"sdcy": T.SLOWDEC[self._sdcycod],
              "fdcy": T.FASTDEC[self._fdcycod],
              "sgain": T.SLOWGAIN[self._sgaincod],
              "dbknee": T.DBPBTAB[self._dbpbcod],
              "floor": T.FLOORTAB[self._floorcod]}
        snroff = (((csnr - 15) << 4) + 0) << 2
        pad = np.zeros(256, np.int32)
        pad[:end] = exps_full
        return self._alloc._bit_alloc(
            pad, 0, end, self.fscod, T.FASTGAIN[self._fgaincod],
            snroff, st, is_cpl=False, dba=None)

    # -- packing -----------------------------------------------------------
    def _pack(self, X, exps, csnr, force=False):
        nch = self.nfchans + self.lfeon
        ends = [self.endmant] * self.nfchans + ([7] if self.lfeon else [])
        baps = [self._bap_for(exps[c][0], ends[c], csnr)
                for c in range(nch)]
        bw = _BW()
        bw.write(0x0B77, 16)
        bw.write(0, 16)                    # crc1 (not verified by players)
        bw.write(self.fscod, 2)
        bw.write(self.frmsizecod, 6)
        bw.write(8, 5)                     # bsid
        bw.write(0, 3)                     # bsmod
        bw.write(self.acmod, 3)
        if (self.acmod & 1) and self.acmod != 1:
            bw.write(2, 2)                 # cmixlev -4.5 dB
        if self.acmod & 4:
            bw.write(2, 2)                 # surmixlev
        if self.acmod == 2:
            bw.write(0, 2)                 # dsurmod
        bw.write(self.lfeon, 1)
        bw.write(31, 5)                    # dialnorm
        bw.write(0, 1)                     # compre
        bw.write(0, 1)                     # langcode
        bw.write(0, 1)                     # audprodie
        bw.write(0, 2)                     # copyrightb, origbs
        bw.write(0, 1)                     # timecod1e
        bw.write(0, 1)                     # timecod2e
        bw.write(0, 1)                     # addbsie
        for blk in range(6):
            self._pack_block(bw, X, exps, baps, ends, blk, csnr)
            if not force and bw.tell() > self.frame_bytes * 8 - 16:
                return None
        if bw.tell() > self.frame_bytes * 8 - 16 and not force:
            return None
        return bw.bytes(self.frame_bytes)  # zero pad + zero crc2

    def _pack_block(self, bw, X, exps, baps, ends, blk, csnr):
        nf = self.nfchans
        for _ in range(nf):
            bw.write(0, 1)                 # blksw
        for _ in range(nf):
            bw.write(0, 1)                 # dithflag
        bw.write(0, 1)                     # dynrnge
        if self.acmod == 0:
            bw.write(0, 1)
        if blk == 0:
            bw.write(1, 1)                 # cplstre
            bw.write(0, 1)                 # cplinu = 0
        else:
            bw.write(0, 1)
        if self.acmod == 2:
            if blk == 0:
                bw.write(1, 1)             # rematstr
                for _ in range(4):
                    bw.write(0, 1)         # rematflg: off
            else:
                bw.write(0, 1)
        # exponent strategies: D45 (code 3) in block 0, reuse after
        for _ in range(nf):
            bw.write(3 if blk == 0 else 0, 2)
        if self.lfeon:
            bw.write(1 if blk == 0 else 0, 1)
        if blk == 0:
            for _ in range(nf):
                bw.write(60, 6)            # chbwcod → endmant 253
            for c in range(nf):
                e = exps[c][1]             # cell chain (abs + deltas)
                bw.write(int(e[0]), 4)
                ds = [int(e[k + 1]) - int(e[k]) + 2
                      for k in range(len(e) - 1)]
                for g in range(0, len(ds), 3):
                    a, b_, c_ = (ds[g:g + 3] + [2, 2])[:3]
                    bw.write(a * 25 + b_ * 5 + c_, 7)
                bw.write(0, 2)             # gainrng
            if self.lfeon:
                e = exps[self.nfchans + self.lfeon - 1][1]
                bw.write(int(e[0]), 4)
                ds = [int(e[k + 1]) - int(e[k]) + 2
                      for k in range(len(e) - 1)]
                for g in range(0, len(ds), 3):
                    a, b_, c_ = (ds[g:g + 3] + [2, 2])[:3]
                    bw.write(a * 25 + b_ * 5 + c_, 7)
        if blk == 0:
            bw.write(1, 1)                 # baie
            bw.write(self._sdcycod, 2)
            bw.write(self._fdcycod, 2)
            bw.write(self._sgaincod, 2)
            bw.write(self._dbpbcod, 2)
            bw.write(self._floorcod, 3)
            bw.write(1, 1)                 # snroffste
            bw.write(csnr, 6)
            for _ in range(self.nfchans + self.lfeon):
                bw.write(0, 4)             # fsnroffst
                bw.write(self._fgaincod, 3)
        else:
            bw.write(0, 1)                 # baie
            bw.write(0, 1)                 # snroffste
        bw.write(0, 1)                     # deltbaie
        bw.write(0, 1)                     # skiple
        # mantissas, decode order.  Group codes (bap 1/2/4) occupy the
        # stream position of their FIRST member — the decoder consumes
        # the full code there — so collect the ordered mantissa list
        # first, then write with per-category lookahead.
        nch = self.nfchans + self.lfeon
        items = []
        for c in range(nch):
            e = exps[c][0]
            for i in range(ends[c]):
                b = int(baps[c][i])
                if b:
                    items.append((b, X[c, blk, i] * (2.0 ** int(e[i]))))
        vals = {1: [], 2: [], 4: []}
        for b, m in items:
            if b == 1:
                vals[1].append(max(0, min(2, int(round(m * 1.5 + 1)))))
            elif b == 2:
                vals[2].append(max(0, min(4, int(round(m * 2.5 + 2)))))
            elif b == 4:
                vals[4].append(max(0, min(10, int(round(m * 5.5 + 5)))))
        # pad to full final groups (decoder reads whole codes; the
        # surplus members are never consumed)
        vals[1] += [1] * (-len(vals[1]) % 3)
        vals[2] += [2] * (-len(vals[2]) % 3)
        vals[4] += [5] * (-len(vals[4]) % 2)
        cnt = {1: 0, 2: 0, 4: 0}
        for b, m in items:
            if b == 1:
                if cnt[1] % 3 == 0:
                    v = vals[1][cnt[1]:cnt[1] + 3]
                    bw.write(v[0] * 9 + v[1] * 3 + v[2], 5)
                cnt[1] += 1
            elif b == 2:
                if cnt[2] % 3 == 0:
                    v = vals[2][cnt[2]:cnt[2] + 3]
                    bw.write(v[0] * 25 + v[1] * 5 + v[2], 7)
                cnt[2] += 1
            elif b == 3:
                bw.write(max(0, min(6, int(round(m * 3.5 + 3)))), 3)
            elif b == 4:
                if cnt[4] % 2 == 0:
                    v = vals[4][cnt[4]:cnt[4] + 2]
                    bw.write(v[0] * 11 + v[1], 7)
                cnt[4] += 1
            elif b == 5:
                bw.write(max(0, min(14, int(round(m * 7.5 + 7)))), 4)
            else:
                nb = {6: 5, 7: 6, 8: 7, 9: 8, 10: 9, 11: 10, 12: 11,
                      13: 12, 14: 14, 15: 16}[b]
                half = 1 << (nb - 1)
                v = int(round(m * half))
                v = max(-half, min(half - 1, v))
                bw.write(v & ((1 << nb) - 1), nb)
