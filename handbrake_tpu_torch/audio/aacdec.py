"""AAC-LC decoder (ISO/IEC 14496-3) — host/NumPy implementation.

Role of decavcodec.c's audio personality (decavcodec.c:367) for AAC
sources: nearly every real-world mp4/ts carries AAC, and re-encoding it
("160 kbps AAC", HandBrake's default audio operation) needs a decode
stage, not passthrough.

Scope: AAC-LC (object type 2), 44.1/48 kHz, mono SCE / stereo CPE /
LFE, long+short window sequences with sine and KBD shapes, all spectral
codebooks 1-11 (tables extracted from libavcodec's binary — normative
ISO constants, tools/extract_aactables.py), M/S stereo, intensity
stereo, TNS, PNS (own noise generator), pulse data.  HE-AAC SBR
extension data is skipped (core decode plays at the core rate).

Conformance: decodes libavcodec's native AAC encoder output to within
float tolerance of libavcodec's own decoder (tests/test_audio.py).
"""
from __future__ import annotations

import math

import numpy as np

from . import aac_tables as TT
from .frames import adts_header

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3
ZERO_HCB, NOISE_HCB, INTENSITY_HCB2, INTENSITY_HCB = 0, 13, 14, 15
SF_OFFSET = 100

# object types whose core this decoder reads: LC, and HE-AAC (SBR) and
# HE-AAC v2 (PS) over an LC core
DECODABLE_AOTS = (2, 5, 29)


class AACUnsupported(ValueError):
    """A tool that AAC-LC does not have (Main's prediction, SSR's gain
    control): every frame of such a stream would fail alike, so it is a
    fault of the track, not a corrupt frame."""


SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350]

# scalefactor band offsets, 44.1/48 kHz (long table extracted; short is
# ISO Table 4.5.28 — 14 bands to 128)
SWB_LONG_48 = TT.SWB_1024_48
SWB_SHORT_48 = [0, 4, 8, 12, 16, 20, 28, 36, 44, 56, 68, 80, 96, 112, 128]
TNS_MAX_BANDS = {48000: (40, 14), 44100: (42, 14)}

_BOOK_DIM = {1: 4, 2: 4, 3: 4, 4: 4, 5: 2, 6: 2, 7: 2, 8: 2, 9: 2,
             10: 2, 11: 2}
_BOOK_UNSIGNED = {1: False, 2: False, 3: True, 4: True, 5: False,
                  6: False, 7: True, 8: True, 9: True, 10: True, 11: True}
_BOOK_MOD = {1: 3, 2: 3, 3: 3, 4: 3, 5: 9, 6: 9, 7: 8, 8: 8, 9: 13,
             10: 13, 11: 17}
_BOOK_OFF = {1: 1, 2: 1, 3: 0, 4: 0, 5: 4, 6: 4, 7: 0, 8: 0, 9: 0,
             10: 0, 11: 0}


def _build_lut(bits, codes):
    """Canonical prefix LUT: maxlen-bit lookahead → (symbol, length)."""
    maxlen = max(bits)
    sym = np.zeros(1 << maxlen, np.int32)
    ln = np.zeros(1 << maxlen, np.int32)
    for s, (b, c) in enumerate(zip(bits, codes)):
        base = c << (maxlen - b)
        n = 1 << (maxlen - b)
        sym[base:base + n] = s
        ln[base:base + n] = b
    return sym, ln, maxlen


_SF_LUT = _build_lut(TT.SF_BITS, TT.SF_CODES)
_SPEC_LUT = {cb: _build_lut(getattr(TT, "B%d_BITS" % cb),
                            getattr(TT, "B%d_CODES" % cb))
             for cb in range(1, 12)}


class _BR:
    """MSB-first bit reader over bytes."""
    __slots__ = ("data", "pos", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.n = len(data) * 8

    def u(self, nbits: int) -> int:
        p = self.pos
        self.pos = p + nbits
        v = 0
        d = self.data
        while nbits > 0:
            byte = d[p >> 3]
            avail = 8 - (p & 7)
            take = min(avail, nbits)
            v = (v << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            p += take
            nbits -= take
        return v

    def peek(self, nbits: int) -> int:
        p = self.pos
        v = self.u(nbits)
        self.pos = p
        return v

    def huff(self, lut) -> int:
        sym, ln, maxlen = lut
        look = self.peek(min(maxlen, max(0, self.n - self.pos))) \
            << max(0, maxlen - (self.n - self.pos))
        s = int(sym[look])
        self.pos += int(ln[look])
        return s

    def left(self) -> int:
        return self.n - self.pos


def _kbd_window(n_half: int, alpha: float) -> np.ndarray:
    """Kaiser-Bessel derived window (left half, n_half samples)."""
    a = math.pi * alpha
    # kaiser of length n_half+1, cumulative sum (ISO 4.6.11.3.3)
    k = np.i0(a * np.sqrt(1.0 - ((np.arange(n_half + 1) - n_half / 2.0)
                                 / (n_half / 2.0)) ** 2))
    c = np.cumsum(k)
    return np.sqrt(c[:n_half] / c[n_half])


def _sine_window(n_half: int) -> np.ndarray:
    return np.sin(np.pi / (2 * n_half) * (np.arange(n_half) + 0.5))


_WIN = {}
for shape in (0, 1):
    for nh in (1024, 128):
        _WIN[(shape, nh)] = (_sine_window(nh) if shape == 0 else
                             _kbd_window(nh, 4.0 if nh == 1024 else 6.0))


def _imdct_mat(N: int) -> np.ndarray:
    n0 = (N / 2 + 1) / 2.0
    n = np.arange(N)[:, None]
    k = np.arange(N // 2)[None, :]
    return (2.0 / N) * np.cos(2 * np.pi / N * (n + n0) * (k + 0.5))


_IMDCT = {2048: _imdct_mat(2048), 256: _imdct_mat(256)}


class _ICS:
    """Per-channel individual channel stream state for one frame."""
    __slots__ = ("window_sequence", "window_shape", "max_sfb", "groups",
                 "num_windows", "sfb_cb", "sf", "coef", "tns",
                 "swb_offset", "num_swb")


class AACDecoder:
    """Stateful raw-block decoder. feed ADTS frames or raw AUs + ASC."""

    def __init__(self, asc: bytes | None = None):
        self.sample_rate = 48000
        self.channels = 2
        self._prev = {}            # channel index -> overlap (1024,)
        self._prev_shape = {}
        self._prev_seq = {}
        self._rng = np.random.default_rng(0x1f2e3d4c)
        if asc:
            self._parse_asc(asc)

    # -- headers -----------------------------------------------------------
    def _parse_asc(self, asc: bytes):
        br = _BR(asc)
        aot = br.u(5)
        if aot == 31:
            aot = 32 + br.u(6)
        sfi = br.u(4)
        sr = br.u(24) if sfi == 15 else SAMPLE_RATES[sfi]
        self.channels = br.u(4)
        self.sample_rate = sr
        self.aot = aot

    # -- public ------------------------------------------------------------
    def decode_frame(self, au: bytes) -> np.ndarray:
        """One access unit (raw block, no ADTS) → (1024, ch) float32."""
        h = adts_header(au)
        if h is not None:
            self.sample_rate = h.sample_rate
            if h.channels:
                self.channels = h.channels
            au = au[h.head:h.size]
        br = _BR(au)
        chans = []
        while br.left() >= 3:
            ide = br.u(3)
            if ide == 7:               # END
                break
            if ide == 0:               # SCE
                br.u(4)                # element_instance_tag
                chans.append(self._decode_ics_output(self._ics(br, False)))
            elif ide == 1:             # CPE
                br.u(4)
                l, r = self._decode_cpe(br)
                chans.append(l)
                chans.append(r)
            elif ide == 3:             # LFE
                br.u(4)
                chans.append(self._decode_ics_output(self._ics(br, False)))
            elif ide == 4:             # DSE
                br.u(4)
                align = br.u(1)
                cnt = br.u(8)
                if cnt == 255:
                    cnt += br.u(8)
                if align:
                    br.pos = (br.pos + 7) & ~7
                br.pos += cnt * 8
            elif ide == 5:             # PCE
                self._skip_pce(br)
            elif ide == 6:             # FIL
                cnt = br.u(4)
                if cnt == 15:
                    cnt += br.u(8) - 1
                br.pos += cnt * 8      # incl. SBR extension — skipped
            else:
                break
        if not chans:
            return np.zeros((1024, self.channels), np.float32)
        n = max(len(c) for c in chans)
        out = np.zeros((n, len(chans)), np.float32)
        for i, c in enumerate(chans):
            out[:len(c), i] = c
        return out

    # -- syntax ------------------------------------------------------------
    def _skip_pce(self, br):
        br.u(4)                        # element_instance_tag
        br.u(2)                        # object_type
        br.u(4)                        # sampling_frequency_index
        nfc = br.u(4)
        nsc = br.u(4)
        nbc = br.u(4)
        nlc = br.u(2)
        nad = br.u(3)
        nvc = br.u(4)
        if br.u(1):
            br.u(4)                    # mono mixdown
        if br.u(1):
            br.u(4)                    # stereo mixdown
        if br.u(1):
            br.u(3)                    # matrix mixdown
        for _ in range(nfc + nsc):
            br.u(1)
            br.u(4)
        for _ in range(nbc):
            br.u(5)
        for _ in range(nlc):
            br.u(4)
        for _ in range(nad):
            br.u(4)
        for _ in range(nvc):
            br.u(3)
        br.pos = (br.pos + 7) & ~7     # byte align
        cmt = br.u(8)
        br.pos += cmt * 8

    def _ics_info(self, br, ics):
        br.u(1)                        # ics_reserved_bit
        ics.window_sequence = br.u(2)
        ics.window_shape = br.u(1)
        if ics.window_sequence == EIGHT_SHORT:
            ics.max_sfb = br.u(4)
            grouping = br.u(7)
            ics.num_windows = 8
            groups = [1]
            for b in range(6, -1, -1):
                if (grouping >> b) & 1:
                    groups[-1] += 1
                else:
                    groups.append(1)
            ics.groups = groups
            ics.swb_offset = SWB_SHORT_48
        else:
            ics.max_sfb = br.u(6)
            if br.u(1):                # predictor_data_present (not LC)
                raise AACUnsupported("aacdec: prediction not supported (LC)")
            ics.num_windows = 1
            ics.groups = [1]
            ics.swb_offset = SWB_LONG_48
        ics.num_swb = len(ics.swb_offset) - 1
        if ics.max_sfb > ics.num_swb:
            raise ValueError("aacdec: max_sfb out of range")

    def _section_data(self, br, ics):
        bits = 3 if ics.window_sequence == EIGHT_SHORT else 5
        esc = (1 << bits) - 1
        ics.sfb_cb = []
        for g in range(len(ics.groups)):
            cbs = [0] * ics.max_sfb
            k = 0
            while k < ics.max_sfb:
                cb = br.u(4)
                run = 0
                while True:
                    inc = br.u(bits)
                    run += inc
                    if inc != esc:
                        break
                if k + run > ics.max_sfb:
                    raise ValueError("aacdec: section overflow")
                for i in range(k, k + run):
                    cbs[i] = cb
                k += run
            ics.sfb_cb.append(cbs)

    def _scale_factor_data(self, br, ics, global_gain):
        sf = global_gain
        nrg = global_gain - 90
        isp = 0
        noise_first = True
        ics.sf = []
        for g in range(len(ics.groups)):
            row = [0.0] * ics.max_sfb
            for k in range(ics.max_sfb):
                cb = ics.sfb_cb[g][k]
                if cb == ZERO_HCB:
                    continue
                if cb in (INTENSITY_HCB, INTENSITY_HCB2):
                    isp += br.huff(_SF_LUT) - 60
                    row[k] = float(isp)
                elif cb == NOISE_HCB:
                    if noise_first:
                        nrg += br.u(9) - 256
                        noise_first = False
                    else:
                        nrg += br.huff(_SF_LUT) - 60
                    row[k] = float(nrg)
                else:
                    sf += br.huff(_SF_LUT) - 60
                    row[k] = float(sf)
            ics.sf.append(row)

    def _tns_data(self, br, ics):
        short = ics.window_sequence == EIGHT_SHORT
        n_filt_bits, len_bits, ord_bits = (1, 4, 3) if short else (2, 6, 5)
        tns = []
        for w in range(ics.num_windows):
            filts = []
            n_filt = br.u(n_filt_bits)
            coef_res = br.u(1) if n_filt else 0
            for _ in range(n_filt):
                length = br.u(len_bits)
                order = br.u(ord_bits)
                if order:
                    direction = br.u(1)
                    compress = br.u(1)
                    coef_bits = coef_res + 3 - compress
                    coefs = [br.u(coef_bits) for _ in range(order)]
                    filts.append((length, order, direction, coef_res,
                                  compress, coefs))
                else:
                    filts.append((length, 0, 0, 0, 0, []))
            tns.append(filts)
        ics.tns = tns

    def _pulse_data(self, br):
        n = br.u(2) + 1
        start_sfb = br.u(6)
        offs = []
        amps = []
        for _ in range(n):
            offs.append(br.u(5))
            amps.append(br.u(4))
        return start_sfb, offs, amps

    def _spectral_data(self, br, ics):
        """→ quantized coefficients, shape (8, 128) or (1, 1024)."""
        nw = ics.num_windows
        size = 128 if nw == 8 else 1024
        q = np.zeros((nw, size), np.float64)
        win0 = 0
        for g, wg in enumerate(ics.groups):
            for k in range(ics.max_sfb):
                cb = ics.sfb_cb[g][k]
                lo = ics.swb_offset[k]
                hi = ics.swb_offset[k + 1]
                if cb == ZERO_HCB or cb >= NOISE_HCB:
                    continue
                dim = _BOOK_DIM[cb]
                mod = _BOOK_MOD[cb]
                off = _BOOK_OFF[cb]
                unsigned = _BOOK_UNSIGNED[cb]
                lut = _SPEC_LUT[cb]
                # coefficients for this sfb across the group's windows
                # are stored consecutively, window-major
                for w in range(win0, win0 + wg):
                    i = lo
                    while i < hi:
                        s = br.huff(lut)
                        vals = []
                        for d in range(dim - 1, -1, -1):
                            vals.append((s // (mod ** d)) % mod - off)
                        if unsigned:
                            for j, v in enumerate(vals):
                                if v and br.u(1):
                                    vals[j] = -v
                        if cb == 11:
                            for j, v in enumerate(vals):
                                if abs(v) == 16:
                                    nbits = 4
                                    while br.u(1):
                                        nbits += 1
                                    word = br.u(nbits)
                                    mag = (1 << nbits) + word
                                    vals[j] = -mag if v < 0 else mag
                        q[w, i:i + dim] = vals
                        i += dim
            win0 += wg
        return q

    # -- tools -------------------------------------------------------------
    @staticmethod
    def _tns_lpc(coefs, coef_res, compress):
        coef_bits = coef_res + 3 - compress
        rng = 1 << (coef_bits - 1)
        c = np.array([(x - (1 << coef_bits)) if x >= rng else x
                      for x in coefs], np.float64)
        iqfac = ((1 << (coef_res + 3 - 1)) - 0.5) / (np.pi / 2.0)
        iqfac_m = ((1 << (coef_res + 3 - 1)) + 0.5) / (np.pi / 2.0)
        tmp = np.sin(np.where(c >= 0, c / iqfac, c / iqfac_m))
        order = len(c)
        a = np.zeros(order + 1)
        a[0] = 1.0
        for m in range(1, order + 1):
            b = a.copy()
            for i in range(1, m):
                b[i] = a[i] + tmp[m - 1] * a[m - i]
            b[m] = tmp[m - 1]
            a = b
        return a                       # a[0]=1, a[1..order]

    def _apply_tns(self, ics, coef):
        if ics.tns is None:
            return
        short = ics.window_sequence == EIGHT_SHORT
        max_order = 7 if short else 12
        mb = TNS_MAX_BANDS.get(self.sample_rate, (40, 14))[1 if short
                                                           else 0]
        for w, filts in enumerate(ics.tns):
            bottom = ics.num_swb
            for (length, order, direction, coef_res, compress,
                 coefs) in filts:
                top = bottom
                bottom = max(0, top - length)
                order = min(order, max_order)
                if order == 0:
                    continue
                lpc = self._tns_lpc(coefs, coef_res, compress)
                start = ics.swb_offset[min(bottom, mb, ics.max_sfb)]
                end = ics.swb_offset[min(top, mb, ics.max_sfb)]
                if end <= start:
                    continue
                # all-pole filter across the band; state is zero outside
                # the band (ffmpeg apply_tns semantics, spec 4.6.9.3)
                x = coef[w]
                if direction:                    # downward in frequency
                    for n in range(end - 1, start - 1, -1):
                        acc = x[n]
                        for i in range(1, order + 1):
                            if n + i < end:
                                acc -= lpc[i] * x[n + i]
                        x[n] = acc
                else:                            # upward
                    for n in range(start, end):
                        acc = x[n]
                        for i in range(1, order + 1):
                            if n - i >= start:
                                acc -= lpc[i] * x[n - i]
                        x[n] = acc

    # -- channel decode ----------------------------------------------------
    def _ics(self, br, common_window, shared_info=None):
        ics = _ICS()
        ics.tns = None
        global_gain = br.u(8)
        if common_window and shared_info is not None:
            for a in ("window_sequence", "window_shape", "max_sfb",
                      "groups", "num_windows", "swb_offset", "num_swb"):
                setattr(ics, a, getattr(shared_info, a))
        else:
            self._ics_info(br, ics)
        self._section_data(br, ics)
        self._scale_factor_data(br, ics, global_gain)
        pulse = None
        if br.u(1):                    # pulse_data_present
            if ics.window_sequence == EIGHT_SHORT:
                raise ValueError("aacdec: pulse with short windows")
            pulse = self._pulse_data(br)
        if br.u(1):                    # tns_data_present
            self._tns_data(br, ics)
        if br.u(1):                    # gain_control_data_present
            raise AACUnsupported("aacdec: gain control not supported")
        q = self._spectral_data(br, ics)
        if pulse is not None:
            start_sfb, offs, amps = pulse
            pos = ics.swb_offset[start_sfb]
            for o, a in zip(offs, amps):
                pos += o
                if pos < q.shape[1]:
                    q[0, pos] += math.copysign(a, q[0, pos]) \
                        if q[0, pos] else a
        ics.coef = self._dequant(ics, q)
        return ics

    def _dequant(self, ics, q):
        coef = np.sign(q) * np.abs(q) ** (4.0 / 3.0)
        win0 = 0
        for g, wg in enumerate(ics.groups):
            for k in range(ics.max_sfb):
                cb = ics.sfb_cb[g][k]
                if cb == ZERO_HCB or cb >= NOISE_HCB:
                    continue
                lo, hi = ics.swb_offset[k], ics.swb_offset[k + 1]
                gain = 2.0 ** (0.25 * (ics.sf[g][k] - SF_OFFSET))
                coef[win0:win0 + wg, lo:hi] *= gain
            win0 += wg
        return coef

    def _fill_noise(self, ics, ms_used=None, other=None):
        """PNS bands: scaled pseudo-random noise (4.6.13)."""
        win0 = 0
        for g, wg in enumerate(ics.groups):
            for k in range(ics.max_sfb):
                if ics.sfb_cb[g][k] != NOISE_HCB:
                    continue
                lo, hi = ics.swb_offset[k], ics.swb_offset[k + 1]
                for w in range(win0, win0 + wg):
                    if (other is not None and ms_used is not None
                            and ms_used[g][k]):
                        ics.coef[w, lo:hi] = other.coef[w, lo:hi]
                        continue
                    v = self._rng.standard_normal(hi - lo)
                    e = math.sqrt(float(np.dot(v, v))) or 1.0
                    scale = 2.0 ** (0.25 * ics.sf[g][k]) / e
                    ics.coef[w, lo:hi] = v * scale
            win0 += wg

    def _decode_cpe(self, br):
        common = br.u(1)
        shared = None
        ms_used = None
        ms_present = 0
        if common:
            shared = _ICS()
            self._ics_info(br, shared)
            ms_present = br.u(2)
        # ms mask needs max_sfb/groups — read after shared info
        if common and ms_present == 1:
            ms_used = [[br.u(1) for _ in range(shared.max_sfb)]
                       for _ in range(len(shared.groups))]
        elif common and ms_present == 2:
            ms_used = [[1] * shared.max_sfb
                       for _ in range(len(shared.groups))]
        L = self._ics(br, common, shared)
        R = self._ics(br, common, shared)
        self._fill_noise(L)
        self._fill_noise(R, ms_used, L)
        if ms_used is not None:
            self._apply_ms(L, R, ms_used)
        self._apply_is(L, R, ms_used, ms_present)
        self._apply_tns(L, L.coef)
        self._apply_tns(R, R.coef)
        return (self._filterbank(L, 0), self._filterbank(R, 1))

    @staticmethod
    def _apply_ms(L, R, ms_used):
        win0 = 0
        for g, wg in enumerate(L.groups):
            for k in range(L.max_sfb):
                cbr = R.sfb_cb[g][k]
                if not ms_used[g][k] or cbr >= NOISE_HCB \
                        or L.sfb_cb[g][k] >= NOISE_HCB:
                    continue
                lo, hi = L.swb_offset[k], L.swb_offset[k + 1]
                for w in range(win0, win0 + wg):
                    m = L.coef[w, lo:hi].copy()
                    s = R.coef[w, lo:hi].copy()
                    L.coef[w, lo:hi] = m + s
                    R.coef[w, lo:hi] = m - s
            win0 += wg

    @staticmethod
    def _apply_is(L, R, ms_used, ms_present):
        win0 = 0
        for g, wg in enumerate(R.groups):
            for k in range(R.max_sfb):
                cb = R.sfb_cb[g][k]
                if cb not in (INTENSITY_HCB, INTENSITY_HCB2):
                    continue
                sign = 1.0 if cb == INTENSITY_HCB else -1.0
                if ms_present == 1 and ms_used and ms_used[g][k]:
                    sign = -sign
                scale = sign * 2.0 ** (-0.25 * R.sf[g][k])
                lo, hi = R.swb_offset[k], R.swb_offset[k + 1]
                for w in range(win0, win0 + wg):
                    R.coef[w, lo:hi] = L.coef[w, lo:hi] * scale
            win0 += wg

    def _decode_ics_output(self, ics, ch=0):
        self._fill_noise(ics)
        self._apply_tns(ics, ics.coef)
        return self._filterbank(ics, ch)

    # -- filterbank --------------------------------------------------------
    def _filterbank(self, ics, ch):
        prev = self._prev.get(ch)
        if prev is None:
            prev = np.zeros(1024)
        pshape = self._prev_shape.get(ch, ics.window_shape)
        seq = ics.window_sequence
        shape = ics.window_shape
        wl_prev = _WIN[(pshape, 1024)]
        wl_cur = _WIN[(shape, 1024)]
        ws_prev = _WIN[(pshape, 128)]
        ws_cur = _WIN[(shape, 128)]

        if seq == EIGHT_SHORT:
            buf = np.zeros(2048)
            for w in range(8):
                t = ics.coef[w] @ _IMDCT[256].T
                win = np.concatenate(
                    [ws_prev if w == 0 else ws_cur, ws_cur[::-1]])
                buf[448 + 128 * w:448 + 128 * w + 256] += t * win
            first = buf[:1024]
            second = buf[1024:]
        else:
            t = ics.coef[0] @ _IMDCT[2048].T
            first = t[:1024].copy()
            second = t[1024:].copy()
            if seq == ONLY_LONG:
                first *= wl_prev
                second *= wl_cur[::-1]
            elif seq == LONG_START:
                first *= wl_prev
                second[:448] *= 1.0
                second[448:576] *= ws_cur[::-1]
                second[576:] = 0.0
            elif seq == LONG_STOP:
                first[:448] = 0.0
                first[448:576] *= ws_prev
                first[576:] *= 1.0
                second *= wl_cur[::-1]
        out = prev + first
        self._prev[ch] = second
        self._prev_shape[ch] = shape
        self._prev_seq[ch] = seq
        # spec-domain spectra are 16-bit-PCM scaled; emit float in [-1, 1]
        # (libavcodec's float output convention — verified 1/32768 exact)
        return (out * (1.0 / 32768.0)).astype(np.float32)
