"""MPEG-1 Layer II (MP2) audio decoder — DVB broadcast / DVD audio.

Role of decavcodec.c's MPEG-audio personality (HandBrake decodes MP2
via libavcodec): frame header parse, the four ISO 11172-3 B.2
allocation tables, scalefactor select info, grouped/ungrouped sample
requantisation ((2c - n + 1)/n linear levels × scalefactor), joint
(intensity) stereo above the bound, and the 32-subband polyphase
synthesis filterbank (ISO figure A.2) with the table-B.3 window
(extracted into mp2_tables.py).

Layer I frames (384 samples, 15-step uniform alloc) are also decoded —
the same filterbank applies.
"""
from __future__ import annotations

import numpy as np

from .mp2_tables import ENWINDOW

_BITRATES_L2 = [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                256, 320, 384]
_BITRATES_L1 = [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352,
                384, 416, 448]
_SRATES = [44100, 48000, 32000]

# scalefactors: 2.0 * 2^(-idx/3)
_SCF = [2.0 * 2.0 ** (-i / 3.0) for i in range(63)] + [1e-20]

# steps → (bits, grouped)
_QBITS = {3: (5, True), 5: (7, True), 7: (3, False), 9: (10, True),
          15: (4, False), 31: (5, False), 63: (6, False),
          127: (7, False), 255: (8, False), 511: (9, False),
          1023: (10, False), 2047: (11, False), 4095: (12, False),
          8191: (13, False), 16383: (14, False), 32767: (15, False),
          65535: (16, False)}

# ISO 11172-3 table B.2 allocation tables: list of (nbal, steps-list)
# per subband.  Index 0 in each steps list means "no allocation".
_STEPS_A0 = [3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
             16383, 32767, 65535]
_STEPS_A1 = [3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
             8191, 65535]
_STEPS_A2 = [3, 5, 7, 9, 15, 31, 65535]
_STEPS_A3 = [3, 5, 65535]
_STEPS_C0 = [3, 5, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
             8191, 16383, 32767]
_STEPS_C1 = [3, 5, 9, 15, 31, 63, 127]


def _table_a(sblimit):
    t = []
    for sb in range(sblimit):
        if sb < 3:
            t.append((4, _STEPS_A0))
        elif sb < 11:
            t.append((4, _STEPS_A1))
        elif sb < 23:
            t.append((3, _STEPS_A2))
        else:
            t.append((2, _STEPS_A3))
    return t


def _table_c(sblimit):
    t = []
    for sb in range(sblimit):
        if sb < 2:
            t.append((4, _STEPS_C0))
        else:
            t.append((3, _STEPS_C1))
    return t


_TABLES = [_table_a(27), _table_a(30), _table_c(8), _table_c(12)]


def _select_table(sr, kbps, nch):
    """ff_mpa_l2_select_table logic (ISO 2-B.1 table selection)."""
    per_ch = kbps // nch
    if (sr == 48000 and per_ch >= 56) or (56 <= per_ch <= 80):
        return 0
    if sr != 48000 and per_ch >= 96:
        return 1
    if sr != 32000 and per_ch <= 48:
        return 2
    return 3


class _BR:
    __slots__ = ("d", "pos")

    def __init__(self, data):
        self.d = data
        self.pos = 0

    def read(self, n):
        v = 0
        p = self.pos
        d = self.d
        for _ in range(n):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v


def _build_window():
    w = np.zeros(512)
    for i in range(257):
        v = ENWINDOW[i] / 65536.0
        w[i] = v
        if i:
            w[512 - i] = v if (i & 63) == 0 else -v
    return w


class _Synth:
    """ISO figure A.2 synthesis subband filter, one per channel."""

    def __init__(self, nmat, window):
        self.V = np.zeros(1024)
        self.N = nmat
        self.D = window

    def run(self, S):
        self.V[64:] = self.V[:-64]
        self.V[:64] = self.N @ S
        U = np.empty(512)
        for i in range(8):
            U[i * 64:i * 64 + 32] = self.V[i * 128:i * 128 + 32]
            U[i * 64 + 32:i * 64 + 64] = self.V[i * 128 + 96:
                                                i * 128 + 128]
        W = U * self.D
        return W.reshape(16, 32).sum(axis=0)


class Mp2Decoder:
    """feed(bytes) → list of (1152|384, ch) float32 frames (streaming
    sync on 0xFFE); decode(bytes) for whole buffers."""

    def __init__(self):
        self._buf = b""
        self.sample_rate = 0
        self.channels = 0
        i = np.arange(64)[:, None]
        k = np.arange(32)[None, :]
        self._nmat = np.cos((16 + i) * (2 * k + 1) * np.pi / 64.0)
        self._window = _build_window()
        self._synth = None

    def decode(self, data: bytes):
        return self.feed(data)

    def feed(self, data: bytes):
        self._buf += bytes(data)
        out = []
        while True:
            i = self._find_sync(self._buf)
            if i < 0:
                self._buf = self._buf[-3:]
                return out
            if len(self._buf) - i < 4:     # header not complete yet
                self._buf = self._buf[i:]
                return out
            hdr = self._parse_header(self._buf, i)
            if hdr is None:
                self._buf = self._buf[i + 1:]
                continue
            size = hdr["size"]
            if len(self._buf) - i < size:
                self._buf = self._buf[i:]
                return out
            frame = self._buf[i:i + size]
            self._buf = self._buf[i + size:]
            try:
                pcm = self._decode_frame(frame, hdr)
            except (IndexError, ValueError):
                continue
            if pcm is not None:
                out.append(pcm)

    @staticmethod
    def _find_sync(b):
        for i in range(len(b) - 1):
            if b[i] == 0xFF and (b[i + 1] & 0xF0) == 0xF0:
                return i
        return -1

    @staticmethod
    def _parse_header(b, i):
        if len(b) - i < 4:
            return None
        if b[i] != 0xFF or (b[i + 1] & 0xF8) != 0xF8:
            return None                    # MPEG-1 only (ID bit set)
        layer = 4 - ((b[i + 1] >> 1) & 3)
        if layer not in (1, 2):
            return None
        protection = b[i + 1] & 1
        br_idx = b[i + 2] >> 4
        sr_idx = (b[i + 2] >> 2) & 3
        padding = (b[i + 2] >> 1) & 1
        mode = b[i + 3] >> 6
        mode_ext = (b[i + 3] >> 4) & 3
        if br_idx in (0, 15) or sr_idx == 3:
            return None
        sr = _SRATES[sr_idx]
        kbps = (_BITRATES_L2 if layer == 2 else _BITRATES_L1)[br_idx]
        if layer == 2:
            size = 144 * kbps * 1000 // sr + padding
        else:
            size = (12 * kbps * 1000 // sr + padding) * 4
        return {"layer": layer, "crc": not protection, "kbps": kbps,
                "sr": sr, "mode": mode, "mode_ext": mode_ext,
                "size": size}

    # -- frame -------------------------------------------------------------
    def _decode_frame(self, frame, h):
        nch = 1 if h["mode"] == 3 else 2
        self.sample_rate = h["sr"]
        self.channels = nch
        if self._synth is None or len(self._synth) != nch:
            self._synth = [_Synth(self._nmat, self._window)
                           for _ in range(nch)]
        br = _BR(frame)
        br.pos = 32 + (16 if h["crc"] else 0)
        if h["layer"] == 1:
            return self._layer1(br, h, nch)
        return self._layer2(br, h, nch)

    def _layer2(self, br, h, nch):
        table = _TABLES[_select_table(h["sr"], h["kbps"], nch)]
        sblimit = len(table)
        bound = sblimit
        if h["mode"] == 1:                 # joint stereo
            bound = min((h["mode_ext"] + 1) * 4, sblimit)
        # allocation
        alloc = np.zeros((nch, sblimit), np.int32)
        for sb in range(sblimit):
            nbal, steps = table[sb]
            if sb < bound:
                for c in range(nch):
                    alloc[c, sb] = br.read(nbal)
            else:
                v = br.read(nbal)
                alloc[:, sb] = v
        # scfsi
        scfsi = np.zeros((nch, sblimit), np.int32)
        for sb in range(sblimit):
            for c in range(nch):
                if alloc[c, sb]:
                    scfsi[c, sb] = br.read(2)
        # scalefactors (3 parts of 4 granules each)
        scf = np.zeros((nch, sblimit, 3))
        for sb in range(sblimit):
            for c in range(nch):
                if not alloc[c, sb]:
                    continue
                si = scfsi[c, sb]
                if si == 0:
                    a, b, d = br.read(6), br.read(6), br.read(6)
                elif si == 1:
                    a = br.read(6)
                    b = a
                    d = br.read(6)
                elif si == 2:
                    a = br.read(6)
                    b = d = a
                else:
                    a = br.read(6)
                    b = br.read(6)
                    d = b
                scf[c, sb] = (_SCF[a], _SCF[b], _SCF[d])
        # samples: 12 granules × 3 samples
        sb_samples = np.zeros((nch, 36, 32))
        for gr in range(12):
            for sb in range(sblimit):
                _nbal, steps_l = table[sb]
                for c in range(nch if sb < bound else 1):
                    a = alloc[c, sb]
                    if not a:
                        continue
                    n = steps_l[a - 1]
                    bits, grouped = _QBITS[n]
                    if grouped:
                        code = br.read(bits)
                        vals = [code % n, (code // n) % n,
                                code // (n * n)]
                    else:
                        vals = [br.read(bits) for _ in range(3)]
                    s = scf[c, sb, gr // 4]
                    for k in range(3):
                        v = (2 * vals[k] - n + 1) / n * s
                        sb_samples[c, gr * 3 + k, sb] = v
                    if sb >= bound and nch == 2:
                        s2 = scf[1, sb, gr // 4]
                        for k in range(3):
                            v = (2 * vals[k] - n + 1) / n * s2
                            sb_samples[1, gr * 3 + k, sb] = v
        return self._synthesize(sb_samples, nch, 36)

    def _layer1(self, br, h, nch):
        bound = 32
        if h["mode"] == 1:
            bound = (h["mode_ext"] + 1) * 4
        alloc = np.zeros((nch, 32), np.int32)
        for sb in range(32):
            if sb < bound:
                for c in range(nch):
                    alloc[c, sb] = br.read(4)
            else:
                alloc[:, sb] = br.read(4)
        scf = np.zeros((nch, 32))
        for sb in range(32):
            for c in range(nch):
                if alloc[c, sb]:
                    scf[c, sb] = _SCF[br.read(6)]
        sb_samples = np.zeros((nch, 12, 32))
        for gr in range(12):
            for sb in range(32):
                for c in range(nch if sb < bound else 1):
                    a = alloc[c, sb]
                    if not a:
                        continue
                    nb = a + 1
                    code = br.read(nb)
                    n = (1 << nb) - 1
                    v = (2 * code - n + 1) / n
                    sb_samples[c, gr, sb] = v * scf[c, sb]
                    if sb >= bound and nch == 2:
                        sb_samples[1, gr, sb] = v * scf[1, sb]
        return self._synthesize(sb_samples, nch, 12)

    def _synthesize(self, sb_samples, nch, ngr):
        out = np.zeros((ngr * 32, nch), np.float32)
        for c in range(nch):
            for g in range(ngr):
                out[g * 32:(g + 1) * 32, c] = \
                    self._synth[c].run(sb_samples[c, g])
        return out
