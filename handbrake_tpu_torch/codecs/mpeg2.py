"""MPEG-2 video decoder (ISO/IEC 13818-2 MP@ML, progressive path).

Role of decavcodec.c's MPEG-2 personality: DVD/VOB program streams and
many broadcast TS captures carry MPEG-2 video — sources/ps.py could
demux them but nothing could decode.  Scope: I/P/B frame pictures,
frame prediction with frame or field DCT (the interlaced DVD's frame
pictures; field pictures and field motion raise), custom quant
matrices, full VLC layer (Tables B.1-B.15), half-pel MC, mismatch
control.

The IDCT is the float64 reference transform; MPEG-2 tolerates bounded
IDCT variance between codecs (IEEE 1180), so conformance against
libavcodec is near-equality (tests assert max |diff| <= 2), not
bit-exactness — unlike our H.264 path where the spec pins the integer
transform.

The sequence header's aspect_ratio_information and frame_rate_code are
read with the sequence extension's frame_rate_extension_n/_d and the
sequence_display_extension's display size (6.3.3, Table 6-3):
``Mpeg2Decoder.sar`` and ``frame_rate``, and ``sequence_info`` for a
demuxer's track (the reference skips the aspect and the extensions).
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np

START_PICTURE = 0x00
START_SLICE_FIRST = 0x01
START_SLICE_LAST = 0xAF
START_USER = 0xB2
START_SEQ = 0xB3
START_EXT = 0xB5
START_SEQ_END = 0xB7
START_GOP = 0xB8

I_TYPE, P_TYPE, B_TYPE = 1, 2, 3

# frame_rate_code (Table 6-4)
FRAME_RATES = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001),
               5: (30, 1), 6: (50, 1), 7: (60000, 1001), 8: (60, 1)}
# aspect_ratio_information 2-4: the display aspect ratio (Table 6-3; 1 is
# square samples)
DISPLAY_ASPECTS = {2: (4, 3), 3: (16, 9), 4: (221, 100)}

DEFAULT_INTRA_MATRIX = np.array([
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83], np.int32)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

ALT_SCAN = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63],
    np.int32)

QSCALE_NONLINEAR = np.array([
    0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22,
    24, 28, 32, 36, 40, 44, 48, 52, 56, 64, 72, 80, 88, 96, 104, 112],
    np.int32)

# Table B.1 — macroblock_address_increment (code given as (bits, value))
_MBA_TAB = [
    ("1", 1), ("011", 2), ("010", 3), ("0011", 4), ("0010", 5),
    ("00011", 6), ("00010", 7), ("0000111", 8), ("0000110", 9),
    ("00001011", 10), ("00001010", 11), ("00001001", 12),
    ("00001000", 13), ("00000111", 14), ("00000110", 15),
    ("0000010111", 16), ("0000010110", 17), ("0000010101", 18),
    ("0000010100", 19), ("0000010011", 20), ("0000010010", 21),
    ("00000100011", 22), ("00000100010", 23), ("00000100001", 24),
    ("00000100000", 25), ("00000011111", 26), ("00000011110", 27),
    ("00000011101", 28), ("00000011100", 29), ("00000011011", 30),
    ("00000011010", 31), ("00000011001", 32), ("00000011000", 33),
    ("00000001000", -1),      # macroblock_escape (+33)
]

# Table B.2-B.4 — macroblock_type (flags: quant, mf, mb, pattern, intra)
_MBTYPE_I = [("1", (0, 0, 0, 0, 1)), ("01", (1, 0, 0, 0, 1))]
_MBTYPE_P = [
    ("1", (0, 1, 0, 1, 0)), ("01", (0, 0, 0, 1, 0)),
    ("001", (0, 1, 0, 0, 0)), ("00011", (0, 0, 0, 0, 1)),
    ("00010", (1, 1, 0, 1, 0)), ("00001", (1, 0, 0, 1, 0)),
    ("000001", (1, 0, 0, 0, 1))]
_MBTYPE_B = [
    ("10", (0, 1, 1, 0, 0)), ("11", (0, 1, 1, 1, 0)),
    ("010", (0, 0, 1, 0, 0)), ("011", (0, 0, 1, 1, 0)),
    ("0010", (0, 1, 0, 0, 0)), ("0011", (0, 1, 0, 1, 0)),
    ("00011", (0, 0, 0, 0, 1)), ("00010", (1, 1, 1, 1, 0)),
    ("000011", (1, 1, 0, 1, 0)), ("000010", (1, 0, 1, 1, 0)),
    ("000001", (1, 0, 0, 0, 1))]

# Table B.9 — coded_block_pattern
_CBP_TAB = [
    ("111", 60), ("1101", 4), ("1100", 8), ("1011", 16), ("1010", 32),
    ("10011", 12), ("10010", 48), ("10001", 20), ("10000", 40),
    ("01111", 28), ("01110", 44), ("01101", 52), ("01100", 56),
    ("01011", 1), ("01010", 61), ("01001", 2), ("01000", 62),
    ("001111", 24), ("001110", 36), ("001101", 3), ("001100", 63),
    ("0010111", 5), ("0010110", 9), ("0010101", 17), ("0010100", 33),
    ("0010011", 6), ("0010010", 10), ("0010001", 18), ("0010000", 34),
    ("00011111", 7), ("00011110", 11), ("00011101", 19),
    ("00011100", 35), ("00011011", 13), ("00011010", 49),
    ("00011001", 21), ("00011000", 41), ("00010111", 14),
    ("00010110", 50), ("00010101", 22), ("00010100", 42),
    ("00010011", 15), ("00010010", 51), ("00010001", 23),
    ("00010000", 43), ("00001111", 25), ("00001110", 37),
    ("00001101", 26), ("00001100", 38), ("00001011", 29),
    ("00001010", 45), ("00001001", 53), ("00001000", 57),
    ("00000111", 30), ("00000110", 46), ("00000101", 54),
    ("00000100", 58),
    ("000000111", 31), ("000000110", 47), ("000000101", 55),
    ("000000100", 59), ("000000011", 27), ("000000010", 39),
    ("000000001", 0),
]

# Table B.10 — motion_code magnitude prefix (the final bit of each
# nonzero codeword is the sign, read separately after this prefix)
_MOTION_TAB = [
    ("1", 0), ("01", 1), ("001", 2), ("0001", 3),
    ("000011", 4), ("0000101", 5), ("0000100", 6), ("0000011", 7),
    ("000001011", 8), ("000001010", 9), ("000001001", 10),
    ("0000010001", 11), ("0000010000", 12), ("0000001111", 13),
    ("0000001110", 14), ("0000001101", 15), ("0000001100", 16)]

# Table B.12 — dct_dc_size_luminance
_DC_LUMA = [
    ("100", 0), ("00", 1), ("01", 2), ("101", 3), ("110", 4),
    ("1110", 5), ("11110", 6), ("111110", 7), ("1111110", 8),
    ("11111110", 9), ("111111110", 10), ("111111111", 11)]
# Table B.13 — dct_dc_size_chrominance
_DC_CHROMA = [
    ("00", 0), ("01", 1), ("10", 2), ("110", 3), ("1110", 4),
    ("11110", 5), ("111110", 6), ("1111110", 7), ("11111110", 8),
    ("111111110", 9), ("1111111110", 10), ("1111111111", 11)]

# Table B.14 — DCT coefficients table zero (run, level); "s" = sign bit.
# First entry "10" is EOB; "1s" (first coeff) / "11s" handled in code.
_B14 = [
    ("11", 0, 1),       # NOTE: only valid as NOT-first coefficient
    ("011", 1, 1), ("0100", 0, 2), ("0101", 2, 1),
    ("00101", 0, 3), ("00111", 3, 1), ("00110", 4, 1),
    ("000110", 1, 2), ("000111", 5, 1), ("000101", 6, 1),
    ("000100", 7, 1),
    ("0000110", 0, 4), ("0000100", 2, 2), ("0000111", 8, 1),
    ("0000101", 9, 1),
    ("00100110", 0, 5), ("00100001", 0, 6), ("00100101", 1, 3),
    ("00100100", 3, 2), ("00100111", 10, 1), ("00100011", 11, 1),
    ("00100010", 12, 1), ("00100000", 13, 1),
    ("0000001010", 0, 7), ("0000001100", 1, 4), ("0000001011", 2, 3),
    ("0000001111", 4, 2), ("0000001001", 5, 2), ("0000001110", 14, 1),
    ("0000001101", 15, 1), ("0000001000", 16, 1),
    ("000000011101", 0, 8), ("000000011000", 0, 9),
    ("000000010011", 0, 10), ("000000010000", 0, 11),
    ("000000011011", 1, 5), ("000000010100", 2, 4),
    ("000000011100", 3, 3), ("000000010010", 4, 3),
    ("000000011110", 6, 2), ("000000010101", 7, 2),
    ("000000010001", 8, 2), ("000000011111", 17, 1),
    ("000000011010", 18, 1), ("000000011001", 19, 1),
    ("000000010111", 20, 1), ("000000010110", 21, 1),
    ("0000000011010", 0, 12), ("0000000011001", 0, 13),
    ("0000000011000", 0, 14), ("0000000010111", 0, 15),
    ("0000000010110", 1, 6), ("0000000010101", 1, 7),
    ("0000000010100", 2, 5), ("0000000010011", 3, 4),
    ("0000000010010", 5, 3), ("0000000010001", 9, 2),
    ("0000000010000", 10, 2), ("0000000011111", 22, 1),
    ("0000000011110", 23, 1), ("0000000011101", 24, 1),
    ("0000000011100", 25, 1), ("0000000011011", 26, 1),
    ("00000000011111", 0, 16), ("00000000011110", 0, 17),
    ("00000000011101", 0, 18), ("00000000011100", 0, 19),
    ("00000000011011", 0, 20), ("00000000011010", 0, 21),
    ("00000000011001", 0, 22), ("00000000011000", 0, 23),
    ("00000000010111", 0, 24), ("00000000010110", 0, 25),
    ("00000000010101", 0, 26), ("00000000010100", 0, 27),
    ("00000000010011", 0, 28), ("00000000010010", 0, 29),
    ("00000000010001", 0, 30), ("00000000010000", 0, 31),
    ("000000000011000", 0, 32), ("000000000010111", 0, 33),
    ("000000000010110", 0, 34), ("000000000010101", 0, 35),
    ("000000000010100", 0, 36), ("000000000010011", 0, 37),
    ("000000000010010", 0, 38), ("000000000010001", 0, 39),
    ("000000000010000", 0, 40),
    ("000000000011111", 1, 8), ("000000000011110", 1, 9),
    ("000000000011101", 1, 10), ("000000000011100", 1, 11),
    ("000000000011011", 1, 12), ("000000000011010", 1, 13),
    ("000000000011001", 1, 14),
    ("0000000000010011", 1, 15), ("0000000000010010", 1, 16),
    ("0000000000010001", 1, 17), ("0000000000010000", 1, 18),
    ("0000000000010100", 6, 3), ("0000000000011010", 11, 1),
    ("0000000000011001", 12, 1), ("0000000000011000", 13, 1),
    ("0000000000010111", 14, 1), ("0000000000010110", 15, 1),
    ("0000000000010101", 16, 1), ("0000000000011111", 27, 1),
    ("0000000000011110", 28, 1), ("0000000000011101", 29, 1),
    ("0000000000011100", 30, 1), ("0000000000011011", 31, 1),
]

# Table B.15 — DCT coefficients table one (intra_vlc_format == 1)
_B15 = [
    ("10", 0, 1), ("010", 1, 1), ("110", 0, 2), ("00101", 2, 1),
    ("0111", 0, 3), ("00111", 3, 1), ("000110", 4, 1), ("00110", 1, 2),
    ("000111", 5, 1), ("0000110", 6, 1), ("0000100", 7, 1),
    ("11100", 0, 4), ("0000111", 2, 2), ("0000101", 8, 1),
    ("1111000", 9, 1), ("11101", 0, 5), ("000101", 0, 6),
    ("1111001", 1, 3), ("00100110", 3, 2), ("1111010", 10, 1),
    ("00100001", 11, 1), ("00100101", 12, 1), ("00100100", 13, 1),
    ("000100", 0, 7), ("00100111", 1, 4), ("11111100", 2, 3),
    ("11111101", 4, 2), ("000000100", 5, 2), ("000000101", 14, 1),
    ("000000111", 15, 1), ("0000001101", 16, 1),
    ("1111011", 0, 8), ("1111100", 0, 9), ("00100011", 0, 10),
    ("00100010", 0, 11), ("00100000", 1, 5), ("0000001100", 2, 4),
    ("000000011100", 3, 3), ("000000010010", 4, 3),
    ("000000011110", 6, 2), ("000000010101", 7, 2),
    ("000000010001", 8, 2), ("000000011111", 17, 1),
    ("000000011010", 18, 1), ("000000011001", 19, 1),
    ("000000010111", 20, 1), ("000000010110", 21, 1),
    ("11111010", 0, 12), ("11111011", 0, 13), ("11111110", 0, 14),
    ("11111111", 0, 15), ("0000000010110", 1, 6),
    ("0000000010101", 1, 7), ("0000000010100", 2, 5),
    ("0000000010011", 3, 4), ("0000000010010", 5, 3),
    ("0000000010001", 9, 2), ("0000000010000", 10, 2),
    ("0000000011111", 22, 1), ("0000000011110", 23, 1),
    ("0000000011101", 24, 1), ("0000000011100", 25, 1),
    ("0000000011011", 26, 1),
    ("00000000011111", 0, 16), ("00000000011110", 0, 17),
    ("00000000011101", 0, 18), ("00000000011100", 0, 19),
    ("00000000011011", 0, 20), ("00000000011010", 0, 21),
    ("00000000011001", 0, 22), ("00000000011000", 0, 23),
    ("00000000010111", 0, 24), ("00000000010110", 0, 25),
    ("00000000010101", 0, 26), ("00000000010100", 0, 27),
    ("00000000010011", 0, 28), ("00000000010010", 0, 29),
    ("00000000010001", 0, 30), ("00000000010000", 0, 31),
    ("000000000011000", 0, 32), ("000000000010111", 0, 33),
    ("000000000010110", 0, 34), ("000000000010101", 0, 35),
    ("000000000010100", 0, 36), ("000000000010011", 0, 37),
    ("000000000010010", 0, 38), ("000000000010001", 0, 39),
    ("000000000010000", 0, 40),
    ("000000000011111", 1, 8), ("000000000011110", 1, 9),
    ("000000000011101", 1, 10), ("000000000011100", 1, 11),
    ("000000000011011", 1, 12), ("000000000011010", 1, 13),
    ("000000000011001", 1, 14),
    ("0000000000010011", 1, 15), ("0000000000010010", 1, 16),
    ("0000000000010001", 1, 17), ("0000000000010000", 1, 18),
    ("0000000000010100", 6, 3), ("0000000000011010", 11, 1),
    ("0000000000011001", 12, 1), ("0000000000011000", 13, 1),
    ("0000000000010111", 14, 1), ("0000000000010110", 15, 1),
    ("0000000000010101", 16, 1), ("0000000000011111", 27, 1),
    ("0000000000011110", 28, 1), ("0000000000011101", 29, 1),
    ("0000000000011100", 30, 1), ("0000000000011011", 31, 1),
]


def _lut(entries):
    maxlen = max(len(b) for b, *_ in entries)
    sym = [None] * (1 << maxlen)
    ln = np.zeros(1 << maxlen, np.int32)
    for b, *val in entries:
        base = int(b, 2) << (maxlen - len(b))
        for i in range(1 << (maxlen - len(b))):
            sym[base + i] = val[0] if len(val) == 1 else tuple(val)
            ln[base + i] = len(b)
    return sym, ln, maxlen


_MBA_LUT = _lut(_MBA_TAB)
_MBI_LUT = _lut(_MBTYPE_I)
_MBP_LUT = _lut(_MBTYPE_P)
_MBB_LUT = _lut(_MBTYPE_B)
_CBP_LUT = _lut(_CBP_TAB)
_MOT_LUT = _lut(_MOTION_TAB)
_DCL_LUT = _lut(_DC_LUMA)
_DCC_LUT = _lut(_DC_CHROMA)
_B14_LUT = _lut([(b, (r, l)) for b, r, l in _B14])
_B15_LUT = _lut([(b, (r, l)) for b, r, l in _B15])


class _BR:
    __slots__ = ("d", "p", "n")

    def __init__(self, data):
        self.d = data
        self.p = 0
        self.n = len(data) * 8

    def u(self, nb):
        v = 0
        p = self.p
        d = self.d
        self.p += nb
        while nb > 0:
            byte = d[p >> 3]
            avail = 8 - (p & 7)
            take = min(avail, nb)
            v = (v << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            p += take
            nb -= take
        return v

    def peek(self, nb):
        p = self.p
        v = self.u(min(nb, self.n - self.p))
        v <<= nb - (self.p - p)
        self.p = p
        return v

    def huff(self, lut):
        sym, ln, maxlen = lut
        look = self.peek(maxlen)
        s = sym[look]
        if s is None:
            raise ValueError("mpeg2: invalid VLC")
        self.p += int(ln[look])
        return s

    def left(self):
        return self.n - self.p


def _idct_mat():
    n = np.arange(8)
    k = np.arange(8)
    c = np.where(k == 0, 1 / np.sqrt(2), 1.0)
    return 0.5 * c[None, :] * np.cos((2 * n[:, None] + 1) * k[None, :]
                                     * np.pi / 16)


_IDCT8 = _idct_mat()


def idct2(block):
    return _IDCT8 @ block @ _IDCT8.T


class Mpeg2Decoder:
    """Feed whole elementary-stream chunks; collect display-order frames
    via get_frames()/flush()."""

    def __init__(self):
        self.w = self.h = 0
        self.mb_w = self.mb_h = 0
        self.intra_m = DEFAULT_INTRA_MATRIX.copy()
        self.nonintra_m = np.full(64, 16, np.int32)
        self.progressive = True
        import collections
        self._buf = b""
        self._out = []          # decoded frames in display order
        self._out_pts = []      # per-frame PES pts (display order)
        self.cur_pts = None     # pts of the AU being decoded (set by
                                # the caller per packet; PES pts are
                                # presentation times, so each picture
                                # keeps the pts it arrived with)
        self._pts_q = collections.deque()   # pts per picture START seen:
                                # a picture only fully decodes when the
                                # NEXT start code delimits it, so the
                                # association must queue, not overwrite
        self._fwd = None        # (y,u,v) reference planes
        self._bwd = None
        self._pending_ref = None   # decoded ref awaiting display slot
        self._pending_pts = None
        self.frame_rate = (30000, 1001)
        self.aspect_code = 0    # aspect_ratio_information (0: none seen)
        self.mpeg2 = False      # a sequence extension follows the header
        self.display_size = None    # sequence_display_extension's

    @property
    def sar(self):
        """The sample aspect ratio (num, den) the last sequence header
        gives, or None where it gives none (no header, a reserved code,
        an MPEG-1 header, whose code is a pel aspect this decoder does
        not take).  1 is square, 2-4 a display aspect over the display
        extension's size, or the coded size without one (6.3.3)."""
        a = self.aspect_code
        if not self.w or not self.mpeg2:
            return None
        if a == 1:
            return (1, 1)
        dw, dh = self.display_size or (self.w, self.h)
        if a not in DISPLAY_ASPECTS or not dw or not dh:
            return None
        n, d = DISPLAY_ASPECTS[a]
        f = Fraction(n * dh, d * dw)
        return (f.numerator, f.denominator)

    # -- stream chop -------------------------------------------------------
    def decode(self, data: bytes):
        """Convenience: decode a whole ES, return display-order frames."""
        self.feed(data)
        return self.flush()

    def feed(self, data: bytes):
        # queue the caller-set pts once per picture start in this chunk
        # (PES semantics: pts applies to the first AU starting in the
        # packet; later pictures in the same chunk have no pts)
        nstart = data.count(b"\x00\x00\x01\x00")
        if nstart:
            self._pts_q.append(self.cur_pts)
            self._pts_q.extend([None] * (nstart - 1))
        self.cur_pts = None
        self._buf += data
        # split into picture units at picture/sequence start codes
        self._process(final=False)

    def get_frames(self):
        out = self._out
        self._out = []
        self._out_pts = []
        return out

    def get_frames_with_pts(self):
        out = list(zip(self._out, self._out_pts))
        self._out = []
        self._out_pts = []
        return out

    def flush(self):
        self._process(final=True)
        if self._pending_ref is not None:
            self._out.append(self._pending_ref)
            self._out_pts.append(self._pending_pts)
            self._pending_ref = None
            self._pending_pts = None
        return self.get_frames()

    def flush_with_pts(self):
        self._process(final=True)
        if self._pending_ref is not None:
            self._out.append(self._pending_ref)
            self._out_pts.append(self._pending_pts)
            self._pending_ref = None
            self._pending_pts = None
        return self.get_frames_with_pts()

    def _process(self, final):
        buf = self._buf
        # find picture start codes; decode each complete picture unit
        pos = 0
        starts = []
        i = 0
        while True:
            i = buf.find(b"\x00\x00\x01", i)
            if i < 0:
                break
            starts.append((i, buf[i + 3] if i + 3 < len(buf) else None))
            i += 3
        pic_starts = [i for i, c in starts if c == START_PICTURE]
        # sequence-level headers before first picture
        ends = pic_starts[1:] + ([len(buf)] if final else [])
        consumed = 0
        for k, ps in enumerate(pic_starts):
            if k >= len(ends):
                break
            pe = ends[k]
            # headers preceding this picture (seq/gop/ext)
            self._parse_headers(buf[consumed:ps])
            self._decode_picture(buf[ps:pe])
            consumed = pe
        if final:
            self._parse_headers(buf[consumed:])
            consumed = len(buf)
        self._buf = buf[consumed:]

    # -- headers -----------------------------------------------------------
    def _sequence_ext_fields(self, br):
        """The sequence extension's frame_rate_extension_n/_d and the
        sequence display extension's size (6.2.2.3, 6.2.2.4)."""
        ext_id = br.u(4)
        if ext_id == 1:
            self.mpeg2 = True
            br.u(8 + 1 + 2 + 2 + 2)   # profile/level .. vertical size ext
            br.u(12 + 1 + 8 + 1)      # bit rate, vbv, low_delay
            n, d = br.u(2), br.u(5)
            if n or d:
                f = Fraction(self.frame_rate[0] * (n + 1),
                             self.frame_rate[1] * (d + 1))
                self.frame_rate = (f.numerator, f.denominator)
        elif ext_id == 2:
            br.u(3)                   # video_format
            if br.u(1):               # colour_description
                br.u(24)
            dw = br.u(14)
            br.u(1)
            self.display_size = (dw, br.u(14))

    def _parse_headers(self, data: bytes):
        i = 0
        while True:
            i = data.find(b"\x00\x00\x01", i)
            if i < 0 or i + 4 > len(data):
                return
            code = data[i + 3]
            br = _BR(data[i + 4:i + 4 + 256])
            if code == START_EXT:
                self._sequence_ext_fields(_BR(data[i + 4:i + 4 + 256]))
            if code == START_SEQ:
                self.w = br.u(12)
                self.h = br.u(12)
                self.aspect_code = br.u(4)
                self.mpeg2 = False
                self.display_size = None
                self.frame_rate = FRAME_RATES.get(br.u(4), (30000, 1001))
                br.u(18)              # bit_rate
                br.u(1)
                br.u(10)              # vbv
                br.u(1)               # constrained
                if br.u(1):
                    m = np.array([br.u(8) for _ in range(64)], np.int32)
                    self.intra_m[ZIGZAG] = m
                if br.u(1):
                    m = np.array([br.u(8) for _ in range(64)], np.int32)
                    self.nonintra_m[ZIGZAG] = m
                self.mb_w = (self.w + 15) // 16
                self.mb_h = (self.h + 15) // 16
            elif code == START_EXT:
                ext_id = br.u(4)
                if ext_id == 1:       # sequence extension
                    br.u(8)           # profile/level
                    self.progressive = bool(br.u(1))
                    br.u(2)           # chroma format
                    self.w |= br.u(2) << 12
                    self.h |= br.u(2) << 12
                    self.mb_w = (self.w + 15) // 16
                    # an interlaced sequence codes whole field pairs of
                    # MB rows (6.3.3: 2 * ceil(h / 32))
                    self.mb_h = (self.h + 15) // 16 if self.progressive \
                        else 2 * ((self.h + 31) // 32)
            i += 4

    # -- picture -----------------------------------------------------------
    def _decode_picture(self, data: bytes):
        br = _BR(data[4:])
        br.u(10)                       # temporal_reference
        ptype = br.u(3)
        br.u(16)                       # vbv_delay
        full_pel = [0, 0]
        fcode_mp1 = [7, 7]
        if ptype in (P_TYPE, B_TYPE):
            full_pel[0] = br.u(1)
            fcode_mp1[0] = br.u(3)
        if ptype == B_TYPE:
            full_pel[1] = br.u(1)
            fcode_mp1[1] = br.u(3)
        # picture coding extension
        pcx = data.find(b"\x00\x00\x01\xb5", 4)
        f_code = [[fcode_mp1[0]] * 2, [fcode_mp1[1]] * 2]
        intra_dc_prec = 0
        frame_pred = 1
        conceal = 0
        qscale_type = 0
        intra_vlc = 0
        alt_scan = 0
        prog_frame = 1
        if pcx >= 0:
            bx = _BR(data[pcx + 4:pcx + 12])
            if bx.u(4) == 8:           # picture coding extension id
                f_code = [[bx.u(4), bx.u(4)], [bx.u(4), bx.u(4)]]
                intra_dc_prec = bx.u(2)
                pic_struct = bx.u(2)
                if pic_struct != 3:
                    raise NotImplementedError("mpeg2: field pictures")
                bx.u(1)                # top_field_first
                frame_pred = bx.u(1)
                conceal = bx.u(1)
                qscale_type = bx.u(1)
                intra_vlc = bx.u(1)
                alt_scan = bx.u(1)
                bx.u(1)                # repeat_first_field
                bx.u(1)                # chroma_420_type
                prog_frame = bx.u(1)
        del conceal, prog_frame
        st = {"type": ptype, "f_code": f_code,
              "dc_prec": intra_dc_prec, "frame_pred": frame_pred,
              "qscale_type": qscale_type, "intra_vlc": intra_vlc,
              "scan": ALT_SCAN if alt_scan else ZIGZAG}
        W, H = self.mb_w * 16, self.mb_h * 16
        y = np.zeros((H, W), np.uint8)
        u = np.zeros((H // 2, W // 2), np.uint8)
        v = np.zeros((H // 2, W // 2), np.uint8)
        # decode slices
        i = 0
        while True:
            i = data.find(b"\x00\x00\x01", i)
            if i < 0:
                break
            code = data[i + 3]
            if START_SLICE_FIRST <= code <= START_SLICE_LAST:
                j = data.find(b"\x00\x00\x01", i + 3)
                end = j if j > 0 else len(data)
                self._decode_slice(data[i + 4:end], code - 1, st,
                                   (y, u, v))
            i += 4
        frame = (y[:self.h, :self.w], u[:self.h // 2, :self.w // 2],
                 v[:self.h // 2, :self.w // 2])
        pic_pts = self._pts_q.popleft() if self._pts_q else None
        if ptype in (I_TYPE, P_TYPE):
            # reorder: previous ref becomes displayable
            if self._pending_ref is not None:
                self._out.append(self._pending_ref)
                self._out_pts.append(self._pending_pts)
            self._pending_ref = frame
            self._pending_pts = pic_pts
            self._fwd = self._bwd
            self._bwd = (y, u, v)
            if self._fwd is None:
                self._fwd = self._bwd
        else:
            self._out.append(frame)
            self._out_pts.append(pic_pts)

    # -- slice -------------------------------------------------------------
    def _decode_slice(self, data: bytes, mb_row, st, planes):
        br = _BR(data)
        qsc = br.u(5)
        while br.u(1):                 # extra slice info
            br.u(8)
        qscale = (QSCALE_NONLINEAR[qsc] if st["qscale_type"] else 2 * qsc)
        mb_x = -1
        dc_reset = 1 << (7 + st["dc_prec"])
        dc_pred = [dc_reset] * 3
        pmv = np.zeros((2, 2), np.int32)   # [list][xy] predictors
        last_mb = {"mb_type": None, "mv": np.zeros((2, 2), np.int32)}
        ptype = st["type"]
        first = True
        # slice ends when only zero padding remains (the VLC design
        # guarantees 23 consecutive zeros can't occur mid-slice)
        while br.left() > 0 and br.peek(min(23, br.left())) != 0:
            # macroblock_address_increment
            inc = 0
            while True:
                s = br.huff(_MBA_LUT)
                if s == -1:
                    inc += 33
                    continue
                inc += s
                break
            if first:
                mb_x += inc
                first = False
                skipped = 0
            else:
                skipped = inc - 1
                mb_x += inc
            if mb_x >= self.mb_w:
                break
            # skipped MBs
            for k in range(skipped, 0, -1):
                sx = mb_x - k
                self._recon_skipped(sx, mb_row, st, planes, pmv, last_mb)
                dc_pred = [dc_reset] * 3
                if ptype == P_TYPE:
                    pmv[:] = 0
            qscale_ref = [qscale]
            self._decode_mb(br, mb_x, mb_row, st, planes, pmv, dc_pred,
                            dc_reset, last_mb, qscale_ref)
            qscale = qscale_ref[0]

    def _recon_skipped(self, mb_x, mb_row, st, planes, pmv, last_mb):
        y, u, v = planes
        ptype = st["type"]
        if ptype == P_TYPE:
            # zero motion copy from the most recent anchor
            self._mc(planes, mb_x, mb_row, (0, 0), self._bwd, None, None)
        else:
            # B skipped: same prediction type + mvs as previous MB
            mv = last_mb["mv"]
            fwd = self._fwd if last_mb["mb_type"][1] else None
            bwd = self._bwd if last_mb["mb_type"][2] else None
            self._mc(planes, mb_x, mb_row,
                     tuple(mv[0]) if fwd is not None else None,
                     fwd, tuple(mv[1]) if bwd is not None else None, bwd,
                     b_mode=True)

    def _motion_vector(self, br, fc, pred):
        code = br.huff(_MOT_LUT)
        if code != 0:
            sign = br.u(1)
        else:
            sign = 0
        r = fc - 1
        if code == 0:
            delta = 0
        else:
            if r:
                resid = br.u(r)
                delta = ((code - 1) << r) + resid + 1
            else:
                delta = code
            if sign:
                delta = -delta
        rng = 1 << (fc + 3)
        v = pred + delta
        if v >= rng:
            v -= 2 * rng
        elif v < -rng:
            v += 2 * rng
        return v

    def _decode_mb(self, br, mb_x, mb_row, st, planes, pmv, dc_pred,
                   dc_reset, last_mb, qscale_ref):
        ptype = st["type"]
        lut = {I_TYPE: _MBI_LUT, P_TYPE: _MBP_LUT,
               B_TYPE: _MBB_LUT}[ptype]
        quant, mf, mb_bwd, pattern, intra = br.huff(lut)
        mtype = (quant, mf, mb_bwd, pattern, intra)
        if not intra and not st["frame_pred"] and (mf or mb_bwd):
            fmt = br.u(2)
            if fmt != 2:
                raise NotImplementedError("mpeg2: field motion")
        field_dct = 0
        if not st["frame_pred"] and (intra or pattern):
            field_dct = br.u(1)        # dct_type: 1 = field DCT
        if quant:
            qsc = br.u(5)
            qscale_ref[0] = (QSCALE_NONLINEAR[qsc] if st["qscale_type"]
                             else 2 * qsc)
        qscale = qscale_ref[0]
        mv = np.zeros((2, 2), np.int32)
        if mf:
            mv[0, 0] = self._motion_vector(br, st["f_code"][0][0],
                                           pmv[0, 0])
            mv[0, 1] = self._motion_vector(br, st["f_code"][0][1],
                                           pmv[0, 1])
            pmv[0] = mv[0]
        if mb_bwd:
            mv[1, 0] = self._motion_vector(br, st["f_code"][1][0],
                                           pmv[1, 0])
            mv[1, 1] = self._motion_vector(br, st["f_code"][1][1],
                                           pmv[1, 1])
            pmv[1] = mv[1]
        if intra:
            pmv[:] = 0
        elif ptype == P_TYPE and not mf:
            pmv[:] = 0
            mv[:] = 0
        cbp = 0
        if pattern:
            cbp = br.huff(_CBP_LUT)
        elif intra:
            cbp = 63
        # prediction
        if not intra:
            if ptype == P_TYPE:
                # P forward reference = most recent decoded anchor
                self._mc(planes, mb_x, mb_row, tuple(mv[0]), self._bwd,
                         None, None)
            else:
                fwd = self._fwd if mf else None
                bwd = self._bwd if mb_bwd else None
                if fwd is None and bwd is None:
                    fwd = self._fwd    # shouldn't happen in valid streams
                self._mc(planes, mb_x, mb_row,
                         tuple(mv[0]) if fwd is not None else None, fwd,
                         tuple(mv[1]) if bwd is not None else None, bwd,
                         b_mode=True)
            dc_pred[0] = dc_pred[1] = dc_pred[2] = dc_reset
        # blocks
        scan = st["scan"]
        for blk in range(6):
            if not (cbp & (32 >> blk)):
                continue
            coef = np.zeros(64, np.int32)
            if intra:
                comp = 0 if blk < 4 else (1 if blk == 4 else 2)
                sz = br.huff(_DCL_LUT if blk < 4 else _DCC_LUT)
                if sz:
                    diff = br.u(sz)
                    if diff < (1 << (sz - 1)):
                        diff -= (1 << sz) - 1
                else:
                    diff = 0
                dc_pred[comp] += diff
                coef[0] = dc_pred[comp] << (3 - st["dc_prec"])
                self._coef_run(br, coef, scan, 1,
                               _B15_LUT if st["intra_vlc"] else _B14_LUT,
                               first=False)
            else:
                self._coef_run(br, coef, scan, 0, _B14_LUT, first=True)
            # dequant — spec divisions truncate toward zero (7.4.2.2)
            m = self.intra_m if intra else self.nonintra_m
            q = coef.astype(np.int64)
            sgn = np.sign(q)
            if intra:
                mag = (np.abs(q[1:]) * m[1:] * qscale) // 16
                q[1:] = sgn[1:] * mag
            else:
                mag = ((2 * np.abs(q) + (q != 0)) * m * qscale) // 32
                q = sgn * mag
            q = np.clip(q, -2048, 2047)
            # mismatch control (7.4.4): even sum → toggle F[63] parity
            if int(q.sum()) % 2 == 0:
                q[63] += -1 if (int(q[63]) % 2 != 0) else 1
            blkpix = np.round(idct2(q.reshape(8, 8).astype(np.float64)))
            self._add_block(planes, mb_x, mb_row, blk, blkpix, intra,
                            field_dct)
        last_mb["mb_type"] = (quant, mf, mb_bwd, pattern, intra)
        last_mb["mv"] = mv.copy()
        if intra:
            last_mb["mv"] = np.zeros((2, 2), np.int32)

    def _coef_run(self, br, coef, scan, start, lut, first):
        i = start
        # first coefficient special case for B14: "1s" means (0, ±1)
        if first:
            if br.peek(6) == 0b000001:
                br.u(6)
                run, lvl = self._escape_rl(br)
                coef[scan[i + run]] = lvl
                i += run + 1
            elif br.peek(1) == 1:
                br.u(1)
                s = br.u(1)
                coef[scan[i]] = -1 if s else 1
                i += 1
            else:
                run, lvl = br.huff(lut)
                s = br.u(1)
                coef[scan[i + run]] = -lvl if s else lvl
                i += run + 1
        while True:
            # EOB: B14 "10", B15 "0110"
            if lut is _B14_LUT:
                if br.peek(2) == 0b10:
                    br.u(2)
                    return
            else:
                if br.peek(4) == 0b0110:
                    br.u(4)
                    return
            if br.peek(6) == 0b000001:      # escape
                br.u(6)
                run, lvl = self._escape_rl(br)
                if i + run > 63:
                    raise ValueError("mpeg2: run overflow")
                coef[scan[i + run]] = lvl
                i += run + 1
                continue
            run, lvl = br.huff(lut)
            s = br.u(1)
            if i + run > 63:
                raise ValueError("mpeg2: run overflow")
            coef[scan[i + run]] = -lvl if s else lvl
            i += run + 1

    @staticmethod
    def _escape_rl(br):
        run = br.u(6)
        lvl = br.u(12)
        if lvl >= 2048:
            lvl -= 4096
        return run, lvl

    # -- pixels ------------------------------------------------------------
    @staticmethod
    def _half_pel(ref, y0, x0, h, w, mvx, mvy, cdiv):
        """Half-pel MC from plane ref at block (y0, x0) size (h, w)."""
        fx, fy = mvx >> 1, mvy >> 1
        hx, hy = mvx & 1, mvy & 1
        H, W = ref.shape
        ys = np.clip(np.arange(y0 + fy, y0 + fy + h + 1), 0, H - 1)
        xs = np.clip(np.arange(x0 + fx, x0 + fx + w + 1), 0, W - 1)
        win = ref[np.ix_(ys, xs)].astype(np.int32)
        a = win[:h, :w]
        if not hx and not hy:
            return a
        if hx and not hy:
            return (a + win[:h, 1:w + 1] + 1) >> 1
        if hy and not hx:
            return (a + win[1:h + 1, :w] + 1) >> 1
        return (a + win[:h, 1:w + 1] + win[1:h + 1, :w]
                + win[1:h + 1, 1:w + 1] + 2) >> 2

    def _mc(self, planes, mb_x, mb_row, mv0, fwd, mv1=None, bwd=None,
            b_mode=False):
        y, u, v = planes
        x0, y0 = mb_x * 16, mb_row * 16
        preds = []
        for mv, ref in ((mv0, fwd), (mv1, bwd)):
            if ref is None or mv is None:
                continue
            py = self._half_pel(ref[0], y0, x0, 16, 16, mv[0], mv[1], 1)
            cmx = int(mv[0] / 2)       # truncation toward 0 (7.6.3.7)
            cmy = int(mv[1] / 2)
            cu = self._half_pel(ref[1], y0 // 2, x0 // 2, 8, 8, cmx, cmy,
                                2)
            cv = self._half_pel(ref[2], y0 // 2, x0 // 2, 8, 8, cmx, cmy,
                                2)
            preds.append((py, cu, cv))
        if not preds:
            return
        if len(preds) == 2:
            py = (preds[0][0] + preds[1][0] + 1) >> 1
            cu = (preds[0][1] + preds[1][1] + 1) >> 1
            cv = (preds[0][2] + preds[1][2] + 1) >> 1
        else:
            py, cu, cv = preds[0]
        y[y0:y0 + 16, x0:x0 + 16] = np.clip(py, 0, 255)
        u[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.clip(cu, 0, 255)
        v[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.clip(cv, 0, 255)

    def _add_block(self, planes, mb_x, mb_row, blk, blkpix, intra,
                   field_dct=0):
        y, u, v = planes
        step = 1
        if blk < 4:
            x0 = mb_x * 16 + (blk & 1) * 8
            if field_dct:
                # field DCT (6.1.3, Figure 6-13): luma blocks 0-1 hold the
                # top field's lines of the MB, 2-3 the bottom field's
                y0 = mb_row * 16 + (blk >> 1)
                step = 2
            else:
                y0 = mb_row * 16 + (blk >> 1) * 8
            tgt = y
        else:
            x0 = mb_x * 8
            y0 = mb_row * 8
            tgt = u if blk == 4 else v
        rows = slice(y0, y0 + 8 * step, step)
        base = 0 if intra else tgt[rows, x0:x0 + 8].astype(np.int32)
        tgt[rows, x0:x0 + 8] = np.clip(base + blkpix, 0, 255)


def sequence_info(es: bytes):
    """The first sequence header of an MPEG-1/2 elementary stream, read
    with the extensions that follow it: {"width", "height", "sar",
    "frame_rate"} ("sar" None where the header gives none), or None
    where the stream holds no whole sequence header."""
    i = es.find(b"\x00\x00\x01\xb3")
    if i < 0:
        return None
    j = es.find(b"\x00\x00\x01\x00", i)
    dec = Mpeg2Decoder()
    try:
        dec._parse_headers(es[i:j if j > 0 else len(es)])
    except IndexError:          # cut inside the header
        return None
    if not dec.w or not dec.h:
        return None
    return {"width": dec.w, "height": dec.h, "sar": dec.sar,
            "frame_rate": dec.frame_rate}
