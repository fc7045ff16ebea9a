"""AC-3 (ATSC A/52) decoder — the dominant DVD / broadcast audio codec.

Role of the reference's decavcodec.c AC-3 personality (HandBrake decodes
AC-3 via libavcodec; this is a from-spec native implementation): sync
frame parse, BSI, per-block exponent decode (D15/D25/D45 grouped),
the full parametric bit-allocation model (psd → banded log-add → excite
→ masking vs hearing threshold → bap), grouped mantissa dequant,
coupling-channel reconstruction, stereo rematrixing, and the 512-point
KBD(α=5) windowed IMDCT with overlap-add.

Tables in ac3_tables.py are extracted from libavcodec rodata /
A/52 spec constants (tools/extract_ac3tables.py).

Dither: bap==0 mantissas are decoder-generated noise when dithflag is
set; the A/52 dither sequence is implementation-defined, so this
decoder substitutes silence there — output differs from other decoders
only inside fully-masked bands (tests use SNR, not bit-exactness).

Block switching (blksw=1 short transforms) is parsed; frames using it
decode the affected channel with the 256-sample dual transform.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import ac3_tables as T

FSCOD_RATES = (48000, 44100, 32000)


class _BR:
    __slots__ = ("d", "pos")

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def read(self, n: int) -> int:
        v = 0
        p = self.pos
        d = self.d
        for _ in range(n):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def skip(self, n: int):
        self.pos += n


def frame_size(fscod: int, frmsizecod: int) -> int:
    """Bytes per syncframe (A/52 table 5.18)."""
    kbps = T.BITRATES[frmsizecod >> 1]
    if fscod == 0:                       # 48 kHz
        return kbps * 4
    if fscod == 2:                       # 32 kHz
        return kbps * 6
    # 44.1 kHz: nominal 1536*kbps/44.1/16 words, LSB selects padding
    words = (320 * kbps * 1000) // 147000
    return 2 * (words + (frmsizecod & 1))


def parse_frame_header(data: bytes, off: int = 0):
    """→ (fscod, frmsizecod, acmod, bsid, size_bytes) or None.
    Handles both AC-3 (bsid ≤ 10) and E-AC-3 (11 < bsid ≤ 16) framing —
    bsid sits at bits 40-44 in both."""
    if len(data) - off < 7 or data[off] != 0x0B or data[off + 1] != 0x77:
        return None
    bsid = data[off + 5] >> 3
    if bsid <= 10:
        fscod = data[off + 4] >> 6
        frmsizecod = data[off + 4] & 0x3F
        if fscod == 3 or frmsizecod >= 38:
            return None
        acmod = data[off + 6] >> 5
        return fscod, frmsizecod, acmod, bsid, \
            frame_size(fscod, frmsizecod)
    if bsid <= 16:                       # E-AC-3
        frmsiz = ((data[off + 2] & 7) << 8) | data[off + 3]
        fscod = data[off + 4] >> 6
        if fscod == 3 and (data[off + 4] >> 4) & 3 == 3:
            return None
        acmod = (data[off + 4] >> 1) & 7
        return fscod, -1, acmod, bsid, (frmsiz + 1) * 2
    return None


_NFCHANS = [2, 1, 2, 3, 3, 4, 4, 5]
_EAC3_BLOCKS = (1, 2, 3, 6)


def _ac3_bsi(data: bytes, off: int) -> dict:
    """An AC-3 syncframe's syncinfo and the head of its BSI (A/52 5.3)."""
    br = _BR(data[off:off + 16])
    br.skip(32)                                # syncword, crc1
    fscod, frmsizecod = br.read(2), br.read(6)
    bsid, bsmod, acmod = br.read(5), br.read(3), br.read(3)
    if (acmod & 1) and acmod != 1:
        br.skip(2)                             # cmixlev
    if acmod & 4:
        br.skip(2)                             # surmixlev
    if acmod == 2:
        br.skip(2)                             # dsurmod
    return {"fscod": fscod, "frmsizecod": frmsizecod, "bsid": bsid,
            "bsmod": bsmod, "acmod": acmod, "lfeon": br.read(1),
            "sample_rate": FSCOD_RATES[fscod],
            "bit_rate": T.BITRATES[frmsizecod >> 1] * 1000,
            "size": frame_size(fscod, frmsizecod)}


def _eac3_bsi(data: bytes, off: int, size: int) -> dict:
    """An E-AC-3 syncframe's BSI up to bsmod (A/52 E.1.2.2): the stream
    type, substream id, rate, blocks, acmod, lfeon, bsid, the dependent
    substream's chanmap (None where it has none) and bsmod (0 where the
    frame carries no informational metadata)."""
    br = _BR(data[off:off + size])
    br.skip(16)                                # syncword
    strmtyp, substreamid = br.read(2), br.read(3)
    br.skip(11)                                # frmsiz
    fscod = br.read(2)
    if fscod == 3:
        rate = FSCOD_RATES[br.read(2)] // 2
        numblkscod = 3
    else:
        rate = FSCOD_RATES[fscod]
        numblkscod = br.read(2)
    acmod, lfeon, bsid = br.read(3), br.read(1), br.read(5)
    out = {"strmtyp": strmtyp, "substreamid": substreamid,
           "fscod": fscod, "sample_rate": rate, "acmod": acmod,
           "lfeon": lfeon, "bsid": bsid, "chanmap": None, "bsmod": 0,
           "size": size,
           "bit_rate": size * 8 * rate // (_EAC3_BLOCKS[numblkscod] * 256)}
    br.skip(5)                                 # dialnorm
    if br.read(1):
        br.skip(8)                             # compr
    if acmod == 0:
        br.skip(5)                             # dialnorm2
        if br.read(1):
            br.skip(8)                         # compr2
    if strmtyp == 1 and br.read(1):
        out["chanmap"] = br.read(16)
    if br.read(1):                             # mixmdate
        if acmod > 2:
            br.skip(2)                         # dmixmod
        if (acmod & 1) and acmod > 2:
            br.skip(6)                         # ltrt/loro cmixlev
        if acmod & 4:
            br.skip(6)                         # ltrt/loro surmixlev
        if lfeon and br.read(1):
            br.skip(5)                         # lfemixlevcod
        if strmtyp == 0:
            if br.read(1):
                br.skip(6)                     # pgmscl
            if acmod == 0 and br.read(1):
                br.skip(6)                     # pgmscl2
            if br.read(1):
                br.skip(6)                     # extpgmscl
            mixdef = br.read(2)
            if mixdef == 1:
                br.skip(5)                     # premix settings
            elif mixdef == 2:
                br.skip(12)
            elif mixdef == 3:
                br.skip(8 * (br.read(5) + 2))
            if acmod < 2:
                if br.read(1):
                    br.skip(14)                # panmean, paninfo
                if acmod == 0 and br.read(1):
                    br.skip(14)
            if br.read(1):                     # frmmixcfginfoe
                if numblkscod == 0:
                    br.skip(5)
                else:
                    for _ in range(_EAC3_BLOCKS[numblkscod]):
                        if br.read(1):
                            br.skip(5)
    if br.read(1):                             # infomdate
        out["bsmod"] = br.read(3)
    return out


def read_bsi(data: bytes) -> Optional[dict]:
    """The stream configuration of the first access unit in ``data``, as
    an mp4 ``dac3``/``dec3`` needs it, or None where no whole syncframe
    is there.

    The first sync word counts whose frame is whole and followed by
    another sync word (or by the end of ``data``).  AC-3: that frame's
    fscod, bsid, bsmod, acmod, lfeon, frmsizecod and bit rate.  E-AC-3:
    ``{"eac3": True, "data_rate": kb/s, "substreams": [...]}``, one entry per independent substream of the first access
    unit (the frames up to the next independent substream 0), each with
    fscod, bsid, bsmod, acmod, lfeon, ``num_dep_sub`` and ``chan_loc``
    (A/52 Table E.1.4 chanmap bits 5-13 of its dependent substreams)."""
    data = bytes(data)
    i = data.find(b"\x0b\x77")
    while i >= 0:
        # a sync word whose frame is whole and, where the data goes on,
        # is followed by the next one (not 0x0B77 inside a payload)
        hdr = parse_frame_header(data, i)
        if hdr is not None and len(data) - i >= hdr[4] and (
                len(data) - i < hdr[4] + 2
                or data[i + hdr[4]:i + hdr[4] + 2] == b"\x0b\x77"):
            break
        i = data.find(b"\x0b\x77", i + 1)
    if i < 0:
        return None
    if hdr[3] <= 10:
        return _ac3_bsi(data, i)
    subs, rate = [], 0
    while True:
        hdr = parse_frame_header(data, i)
        if hdr is None or hdr[3] <= 10 or len(data) - i < hdr[4]:
            break
        f = _eac3_bsi(data, i, hdr[4])
        if f["strmtyp"] != 1 and f["substreamid"] == 0 and subs:
            break                              # the next access unit
        rate += f["bit_rate"]
        if f["strmtyp"] == 1:
            if subs:
                parent = subs[-1]
                parent["num_dep_sub"] += 1
                if f["chanmap"] is not None:
                    parent["chan_loc"] |= (f["chanmap"] >> 2) & 0x1FF
        else:
            subs.append(dict(f, num_dep_sub=0, chan_loc=0))
        i += hdr[4]
    if not subs:
        return None
    return {"eac3": True, "data_rate": rate // 1000, "substreams": subs}

# grouped mantissa quantization levels
_Q3 = np.array([(2 * c - 2) / 3 for c in range(3)], np.float32)
_Q5 = np.array([(2 * c - 4) / 5 for c in range(5)], np.float32)
_Q7 = np.array([(2 * c - 6) / 7 for c in range(7)], np.float32)
_Q11 = np.array([(2 * c - 10) / 11 for c in range(11)], np.float32)
_Q15 = np.array([(2 * c - 14) / 15 for c in range(15)], np.float32)
_QBITS = {6: 5, 7: 6, 8: 7, 9: 8, 10: 9, 11: 10, 12: 11, 13: 12,
          14: 14, 15: 16}


def _kbd_window(n: int, alpha: float) -> np.ndarray:
    """Kaiser-Bessel derived window (A/52 table 7.33 values; computed
    with the same recurrence libavcodec uses: bessel argument
    (alpha*pi/n)*sqrt(i*(n-i)), normalised over n+1 terms)."""
    from numpy import i0
    a = np.arange(n + 1, dtype=np.float64)
    kaiser = i0(np.pi * alpha * np.sqrt(1.0 - (2.0 * a / n - 1.0) ** 2))
    cs = np.cumsum(kaiser)
    return np.sqrt(cs[:n] / cs[n])


class Ac3Decoder:
    """decode(data) → list of (channels, 1536) float32 arrays, one per
    syncframe; or feed packets incrementally via feed()."""

    def __init__(self):
        self._buf = b""
        self.sample_rate = 0
        self.channels = 0
        self._win = _kbd_window(256, 5.0)
        self._imdct = None
        self._imdct_s = None
        self._delay = None
        # per-stream persistent state (exponent/bit-alloc reuse)
        self._st = None

    # -- stream API --------------------------------------------------------
    def feed(self, data: bytes):
        self._buf += bytes(data)
        out = []
        while True:
            i = self._buf.find(b"\x0b\x77")
            if i < 0:
                self._buf = self._buf[-1:]
                return out
            hdr = parse_frame_header(self._buf, i)
            if hdr is None:
                self._buf = self._buf[i + 2:]
                continue
            size = hdr[4]
            if len(self._buf) - i < size:
                self._buf = self._buf[i:]
                return out
            frame = self._buf[i:i + size]
            self._buf = self._buf[i + size:]
            try:
                pcm = self._decode_frame(frame)
            except (IndexError, ValueError):
                continue
            if pcm is not None:
                out.append(pcm)

    def decode(self, data: bytes):
        out = self.feed(data)
        return out

    # -- frame decode ------------------------------------------------------
    def _decode_frame(self, data: bytes):
        if (data[5] >> 3) > 10:
            return self._decode_frame_eac3(data)
        br = _BR(data)
        br.skip(16 + 16)                       # syncword, crc1
        fscod = br.read(2)
        frmsizecod = br.read(6)
        if fscod == 3 or frmsizecod >= 38:
            return None
        self.sample_rate = FSCOD_RATES[fscod]
        bsid = br.read(5)
        if bsid > 10:
            return None
        br.read(3)                             # bsmod
        acmod = br.read(3)
        if (acmod & 1) and acmod != 1:
            br.read(2)                         # cmixlev (3 front chans)
        if acmod & 4:
            br.read(2)                         # surmixlev
        if acmod == 2:
            br.read(2)                         # dsurmod
        lfeon = br.read(1)
        br.read(5)                             # dialnorm
        if br.read(1):
            br.read(8)                         # compr
        if br.read(1):
            br.read(8)                         # langcod
        if br.read(1):
            br.read(7)                         # audprodie: mixlevel+roomtyp
        if acmod == 0:                         # 1+1: duplicate info set
            br.read(5)
            if br.read(1):
                br.read(8)
            if br.read(1):
                br.read(8)
            if br.read(1):
                br.read(7)
        br.read(2)                             # copyrightb, origbs
        if br.read(1):
            br.read(14)                        # timecod1
        if br.read(1):
            br.read(14)                        # timecod2
        if br.read(1):                         # addbsie
            n = br.read(6)
            br.skip((n + 1) * 8)

        nfchans = _NFCHANS[acmod]
        nch = nfchans + lfeon
        self.channels = nch
        if self._st is None or self._st.get("nfchans") != nfchans:
            self._st = {"nfchans": nfchans}
        if self._delay is None or self._delay.shape[0] != nch:
            self._delay = np.zeros((nch, 256), np.float64)

        pcm = np.zeros((nch, 1536), np.float64)
        for blk in range(6):
            coef = self._decode_block(br, blk, acmod, lfeon, fscod)
            if coef is None:
                return None
            # transform per channel
            for c in range(nch):
                x = self._transform(coef[c], self._st["blksw"][c]
                                    if c < nfchans else 0)
                y0 = x[:256] + self._delay[c]
                self._delay[c] = x[256:]
                pcm[c, blk * 256:(blk + 1) * 256] = y0
        # output channel order: match ffmpeg planar layouts
        order = self._output_order(acmod, lfeon)
        return pcm[order].astype(np.float32)

    @staticmethod
    def _output_order(acmod, lfeon):
        # transmission order → FL FR FC LFE BL BR style
        n = _NFCHANS[acmod]
        if acmod == 2 or acmod == 0:
            base = [0, 1]
        elif acmod == 1:
            base = [0]
        elif acmod == 3:                       # L C R → FL FR FC
            base = [0, 2, 1]
        elif acmod == 4:                       # L R S → FL FR BC
            base = [0, 1, 2]
        elif acmod == 5:                       # L C R S → FL FR FC BC
            base = [0, 2, 1, 3]
        elif acmod == 6:                       # L R Ls Rs
            base = [0, 1, 2, 3]
        else:                                  # L C R Ls Rs
            base = [0, 2, 1, 3, 4]
        if not lfeon:
            return base
        # lfe is decoded as the LAST channel; ffmpeg places it after
        # the front channels (index 2 stereo / 3 for 5.1)
        lfe = n
        if acmod == 7:
            return [base[0], base[1], base[2], lfe, base[3], base[4]]
        return [*base, lfe]

    # -- audio block -------------------------------------------------------
    def _decode_block(self, br, blk, acmod, lfeon, fscod):
        st = self._st
        nfchans = _NFCHANS[acmod]
        nch = nfchans + lfeon
        st["blksw"] = [br.read(1) for _ in range(nfchans)]
        dithflag = [br.read(1) for _ in range(nfchans)]
        if br.read(1):
            br.read(8)                         # dynrnge
        if acmod == 0 and br.read(1):
            br.read(8)                         # dynrng2

        # --- coupling strategy ---
        if br.read(1):                         # cplstre
            st["cplinu"] = br.read(1)
            if st["cplinu"]:
                st["chincpl"] = [br.read(1) for _ in range(nfchans)]
                if acmod == 2:
                    st["phsflginu"] = br.read(1)
                cplbegf = br.read(4)
                cplendf = br.read(4)
                if 3 + cplendf - cplbegf < 0:
                    raise ValueError("bad coupling range")
                ncplsubnd = 3 + cplendf - cplbegf
                st["cplstrtmant"] = cplbegf * 12 + 37
                st["cplendmant"] = cplendf * 12 + 73
                st["cplbegf"] = cplbegf
                st["cplbndstrc"] = [0] + [br.read(1)
                                          for _ in range(ncplsubnd - 1)]
        elif blk == 0:
            st["cplinu"] = 0
        cplinu = st.get("cplinu", 0)

        # --- coupling coordinates ---
        if cplinu:
            ncplbnd = sum(1 for v in st["cplbndstrc"] if v == 0)
            st.setdefault("cplco", {})
            phsflg = None
            for ch in range(nfchans):
                if not st["chincpl"][ch]:
                    continue
                if br.read(1):                 # cplcoe
                    mstr = br.read(2)
                    co = np.zeros(ncplbnd, np.float64)
                    for b in range(ncplbnd):
                        exp = br.read(4)
                        mant = br.read(4)
                        if exp == 15:
                            m = mant / 16.0
                        else:
                            m = (mant + 16) / 32.0
                        co[b] = m * 2.0 ** (-exp - 3 * mstr)
                    st["cplco"][ch] = co
            if acmod == 2 and st.get("phsflginu"):
                # phase flags sent when either channel updated coords
                phsflg = [br.read(1) for _ in range(ncplbnd)]
                st["phsflg"] = phsflg

        # --- rematrixing (2/0 only) ---
        if acmod == 2:
            if br.read(1):                     # rematstr
                if cplinu:
                    if st["cplbegf"] == 0:
                        nbnd = 2
                    elif st["cplbegf"] <= 2:
                        nbnd = 3
                    else:
                        nbnd = 4
                else:
                    nbnd = 4
                st["rematflg"] = [br.read(1) for _ in range(nbnd)]
            st.setdefault("rematflg", [])

        # --- exponent strategies ---
        cplexpstr = br.read(2) if cplinu else 0
        chexpstr = [br.read(2) for _ in range(nfchans)]
        lfeexpstr = br.read(1) if lfeon else 0
        for ch in range(nfchans):
            if chexpstr[ch] != 0 and not (cplinu and st["chincpl"][ch]):
                chbwcod = br.read(6)
                st.setdefault("endmant", [0] * nfchans)
                st["endmant"][ch] = (chbwcod + 12) * 3 + 37
        st.setdefault("endmant", [253] * nfchans)
        endmant = list(st["endmant"])
        for ch in range(nfchans):
            if cplinu and st["chincpl"][ch]:
                endmant[ch] = st["cplstrtmant"]

        # --- exponents ---
        st.setdefault("exps", {})
        if cplinu and cplexpstr != 0:
            gs = [0, 1, 2, 4][cplexpstr]
            absexp = br.read(4) << 1
            n = (st["cplendmant"] - st["cplstrtmant"]) // (3 * gs)
            st["exps"]["cpl"] = self._ungroup_exps(
                br, absexp, n, gs, st["cplstrtmant"], st["cplendmant"],
                skip_first=True)
        for ch in range(nfchans):
            if chexpstr[ch] != 0:
                gs = [0, 1, 2, 4][chexpstr[ch]]
                absexp = br.read(4)
                n = (endmant[ch] + 3 * gs - 2) // (3 * gs)
                st["exps"][ch] = self._ungroup_exps(
                    br, absexp, n, gs, 0, endmant[ch])
                br.read(2)                     # gainrng
        if lfeon and lfeexpstr != 0:
            absexp = br.read(4)
            st["exps"]["lfe"] = self._ungroup_exps(br, absexp, 2, 1, 0, 7)

        # --- bit allocation parameters ---
        if br.read(1):                         # baie
            st["sdcy"] = T.SLOWDEC[br.read(2)]
            st["fdcy"] = T.FASTDEC[br.read(2)]
            st["sgain"] = T.SLOWGAIN[br.read(2)]
            st["dbknee"] = T.DBPBTAB[br.read(2)]
            st["floor"] = T.FLOORTAB[br.read(3)]
        if br.read(1):                         # snroffste
            csnr = br.read(6)
            st.setdefault("snroff", {})
            st.setdefault("fgain", {})
            if cplinu:
                st["snroff"]["cpl"] = (((csnr - 15) << 4)
                                       + br.read(4)) << 2
                st["fgain"]["cpl"] = T.FASTGAIN[br.read(3)]
            for ch in range(nfchans):
                st["snroff"][ch] = (((csnr - 15) << 4) + br.read(4)) << 2
                st["fgain"][ch] = T.FASTGAIN[br.read(3)]
            if lfeon:
                st["snroff"]["lfe"] = (((csnr - 15) << 4)
                                       + br.read(4)) << 2
                st["fgain"]["lfe"] = T.FASTGAIN[br.read(3)]
        if cplinu and br.read(1):              # cplleake
            st["cplfleak"] = (br.read(3) << 8) + 768
            st["cplsleak"] = (br.read(3) << 8) + 768
        if br.read(1):                         # deltbaie
            st.setdefault("dba", {})
            keys = (["cpl"] if cplinu else []) + list(range(nfchans))
            codes = {k: br.read(2) for k in keys}
            for k, code in codes.items():
                if code == 1:                  # new info follows
                    nseg = br.read(3) + 1
                    segs = []
                    for _ in range(nseg):
                        segs.append((br.read(5), br.read(4), br.read(3)))
                    st["dba"][k] = segs
                elif code == 2:                # no delta allocation
                    st["dba"].pop(k, None)
        if br.read(1):                         # skiple
            n = br.read(9)
            br.skip(n * 8)

        # --- run bit allocation + unpack mantissas ---
        # grouped-mantissa state is shared across channels within a block
        gstate = {"b1": [], "b2": [], "b4": []}
        coef = np.zeros((nch, 256), np.float64)
        cpl_coef = None
        for ch in range(nfchans):
            exps = st["exps"].get(ch)
            if exps is None:
                raise ValueError("missing exponents")
            bap = self._bit_alloc(
                exps, 0, endmant[ch], fscod, st["fgain"][ch],
                st["snroff"][ch], st, is_cpl=False,
                dba=st.get("dba", {}).get(ch))
            mant = self._unpack_mantissas(br, bap, exps, gstate,
                                          endmant[ch])
            coef[ch, :endmant[ch]] = mant[:endmant[ch]]
            if cplinu and st["chincpl"][ch] and cpl_coef is None:
                # coupling channel decoded after the first coupled ch
                cexps = st["exps"]["cpl"]
                cbap = self._bit_alloc(
                    cexps, st["cplstrtmant"], st["cplendmant"], fscod,
                    st["fgain"]["cpl"], st["snroff"]["cpl"], st,
                    is_cpl=True, dba=st.get("dba", {}).get("cpl"))
                cpl_coef = self._unpack_mantissas(
                    br, cbap, cexps, gstate, st["cplendmant"],
                    start=st["cplstrtmant"])
        if cplinu and cpl_coef is not None:
            self._apply_coupling(coef, cpl_coef, st, nfchans, acmod)
        if acmod == 2 and st.get("rematflg"):
            self._rematrix(coef, st, cplinu, min(endmant))
        if lfeon:
            lexps = st["exps"].get("lfe")
            bap = self._bit_alloc(lexps, 0, 7, fscod, st["fgain"]["lfe"],
                                  st["snroff"]["lfe"], st, is_cpl=False,
                                  dba=None)
            coef[nch - 1, :7] = self._unpack_mantissas(br, bap, lexps,
                                                       gstate, 7)[:7]
        return coef

    # -- E-AC-3 (ETSI TS 102 366 annex E) ---------------------------------
    def _decode_frame_eac3(self, data: bytes):
        """E-AC-3 frames are recognised and sized (parse_frame_header),
        so mixed AC-3/E-AC-3 streams stay in sync, and the BSI is parsed
        for stream info — but block decode is not implemented: the
        E-AC-3 audblk syntax (LUT exponent strategies, converter fields,
        forced block-0 strategies) was only partially reverse-verified
        against libavcodec output and shipping a misaligned parser would
        produce garbage audio.  Raising keeps feed() skipping frames
        safely.  (The ac3_tables.FRM_EXPSTR table for the LUT strategy
        path is already extracted for when this lands.)"""
        br = _BR(data)
        br.skip(16)
        br.read(2 + 3 + 11)                    # strmtyp/substreamid/frmsiz
        fscod = br.read(2)
        if fscod != 3:
            self.sample_rate = FSCOD_RATES[fscod]
        br.read(2)                             # numblkscod
        acmod = br.read(3)
        lfeon = br.read(1)
        self.channels = _NFCHANS[acmod] + lfeon
        raise ValueError("eac3 block decode not supported")

    # -- exponents ---------------------------------------------------------
    @staticmethod
    def _ungroup_exps(br, absexp, ngrps, gs, start, end,
                      skip_first=False):
        exps = np.zeros(256, np.int32)
        dexps = []
        for _ in range(ngrps):
            g = br.read(7)
            dexps += [g // 25, (g % 25) // 5, g % 5]
        e = absexp
        out = [e]
        for d in dexps:
            e += d - 2
            out += [e] * gs
        if skip_first:
            out = out[1:]                      # cplabsexp seeds, no bin
            arr = np.array(out[:end - start], np.int32)
            exps[start:end] = arr
        else:
            arr = np.array(out[:end - start], np.int32)
            exps[start:end] = arr
        return exps

    # -- bit allocation (A/52 7.2.2) --------------------------------------
    def _bit_alloc(self, exps, start, end, fscod, fgain, snroffset, st,
                   is_cpl, dba=None):
        sdecay, fdecay = st["sdcy"], st["fdcy"]
        sgain, dbknee, floor = st["sgain"], st["dbknee"], st["floor"]
        psd = 3072 - (exps[start:end] << 7)
        # banded psd via log-add
        bndstrt = T.MASKTAB[start]
        bndend = T.MASKTAB[end - 1] + 1
        nb = bndend - bndstrt
        # full 50-band arrays: the spec's excite recursion peeks one
        # band past the active range (guarded comparisons stay in-bounds)
        bndpsd = np.zeros(51, np.int64)
        j = start
        for k in range(bndstrt, bndend):
            lastbin = min(T.BNDTAB[k] + T.BNDSZ[k], end)
            v = int(psd[j - start])
            j += 1
            while j < lastbin:
                v = self._logadd(v, int(psd[j - start]))
                j += 1
            bndpsd[k - bndstrt] = v
        excite = np.zeros(51, np.int64)
        if not is_cpl:
            # the LFE channel (7-bin) skips the lowcomp peek only at its
            # final band — matching deployed decoders (libavcodec), which
            # differ here from a literal "bndend != bin+3" spec reading
            is_lfe = (start == 0 and end == 7)

            def guard(b):
                return not (is_lfe and b == 6)
            lowcomp = 0
            lowcomp = self._lowcomp(lowcomp, bndpsd[0], bndpsd[1], 0)
            excite[0] = bndpsd[0] - fgain - lowcomp
            lowcomp = self._lowcomp(lowcomp, bndpsd[1], bndpsd[2], 1)
            excite[1] = bndpsd[1] - fgain - lowcomp
            begin = 7
            fastleak = slowleak = 0
            for b in range(2, 7):
                if guard(b):
                    lowcomp = self._lowcomp(lowcomp, bndpsd[b],
                                            bndpsd[b + 1], b)
                fastleak = int(bndpsd[b]) - fgain
                slowleak = int(bndpsd[b]) - sgain
                excite[b] = fastleak - lowcomp
                if guard(b) and bndpsd[b] <= bndpsd[b + 1]:
                    begin = b + 1
                    break
            for b in range(begin, min(bndend, 22)):
                if guard(b):
                    lowcomp = self._lowcomp(lowcomp, bndpsd[b],
                                            bndpsd[b + 1], b)
                fastleak = max(fastleak - fdecay,
                               int(bndpsd[b]) - fgain)
                slowleak = max(slowleak - sdecay,
                               int(bndpsd[b]) - sgain)
                excite[b] = max(fastleak - lowcomp, slowleak)
            begin = 22
        else:
            begin = bndstrt
            fastleak = st.get("cplfleak", 768)
            slowleak = st.get("cplsleak", 768)
        for b in range(max(begin, bndstrt), bndend):
            i = b - bndstrt
            fastleak = max(fastleak - fdecay,
                           int(bndpsd[i]) - fgain)
            slowleak = max(slowleak - sdecay,
                           int(bndpsd[i]) - sgain)
            excite[i] = max(fastleak, slowleak)
        mask = np.zeros(nb, np.int64)
        for b in range(nb):
            v = int(excite[b])
            bp = int(bndpsd[b])
            if bp < dbknee:
                v += (dbknee - bp) >> 2
            mask[b] = max(v, T.HTH[b + bndstrt][fscod])
        if dba:
            band = 0
            for (offst, ln, ba) in dba:
                band += offst                  # offsets are cumulative
                if ba >= 4:
                    delta = (ba - 3) << 7
                else:
                    delta = (ba - 4) << 7
                for b in range(band, min(band + ln, bndend)):
                    if b >= bndstrt:
                        mask[b - bndstrt] += delta
                band += ln
        bap = np.zeros(end - start, np.int32)
        j = start
        k = bndstrt
        while j < end:
            lastbin = min(T.BNDTAB[k] + T.BNDSZ[k], end)
            m = int(mask[k - bndstrt]) - snroffset - floor
            if m < 0:
                m = 0
            m &= 0x1FE0
            m += floor
            while j < lastbin:
                a = (int(psd[j - start]) - m) >> 5
                a = min(63, max(0, a))
                bap[j - start] = T.BAPTAB[a]
                j += 1
            k += 1
        return bap

    @staticmethod
    def _logadd(a, b):
        c = a - b
        address = min(abs(c) >> 1, 255)
        if c >= 0:
            return a + T.LATAB[address]
        return b + T.LATAB[address]

    @staticmethod
    def _lowcomp(a, b0, b1, bin_):
        if bin_ < 7:
            if b0 + 256 == b1:
                return 384
            if b0 > b1:
                return max(0, a - 64)
        elif bin_ < 20:
            if b0 + 256 == b1:
                return 320
            if b0 > b1:
                return max(0, a - 64)
        else:
            return max(0, a - 128)
        return a

    # -- mantissas ---------------------------------------------------------
    def _unpack_mantissas(self, br, bap, exps, gstate, end, start=0):
        out = np.zeros(256, np.float64)
        for i in range(start, end):
            b = int(bap[i - start])
            e = int(exps[i])
            if b == 0:
                m = 0.0                        # dither substituted
            elif b == 1:
                if not gstate["b1"]:
                    g = br.read(5)
                    gstate["b1"] = [_Q3[g // 9], _Q3[(g % 9) // 3],
                                    _Q3[g % 3]]
                m = gstate["b1"].pop(0)
            elif b == 2:
                if not gstate["b2"]:
                    g = br.read(7)
                    gstate["b2"] = [_Q5[g // 25], _Q5[(g % 25) // 5],
                                    _Q5[g % 5]]
                m = gstate["b2"].pop(0)
            elif b == 3:
                m = _Q7[br.read(3)]
            elif b == 4:
                if not gstate["b4"]:
                    g = br.read(7)
                    gstate["b4"] = [_Q11[g // 11], _Q11[g % 11]]
                m = gstate["b4"].pop(0)
            elif b == 5:
                m = _Q15[br.read(4)]
            else:
                nbits = _QBITS[b]
                v = br.read(nbits)
                if v >= (1 << (nbits - 1)):
                    v -= 1 << nbits
                m = v / float(1 << (nbits - 1))
            out[i] = m * 2.0 ** (-e)
        return out[:256]

    # -- coupling ----------------------------------------------------------
    def _apply_coupling(self, coef, cpl_coef, st, nfchans, acmod):
        s, e = st["cplstrtmant"], st["cplendmant"]
        # expand band structure: subbands of 12 bins, cplbndstrc merges
        bnd_of_sub = []
        b = -1
        for v in st["cplbndstrc"]:
            if v == 0:
                b += 1
            bnd_of_sub.append(b)
        phs = st.get("phsflg")
        for ch in range(nfchans):
            if not st["chincpl"][ch]:
                continue
            co = st.get("cplco", {}).get(ch)
            if co is None:
                continue
            for sub, bb in enumerate(bnd_of_sub):
                lo = s + sub * 12
                hi = min(lo + 12, e)
                g = co[bb] * 8.0               # A/52 7.4.3 scale factor
                if ch == 1 and phs and bb < len(phs) and phs[bb]:
                    g = -g
                coef[ch, lo:hi] = cpl_coef[lo:hi] * g

    @staticmethod
    def _rematrix(coef, st, cplinu, endmant):
        end = st["cplstrtmant"] if cplinu else endmant
        starts = [13, 25, 37, 61]
        ends = [25, 37, 61, end]
        for b, f in enumerate(st["rematflg"]):
            if not f:
                continue
            lo, hi = starts[b], min(ends[b], end)
            if hi <= lo:
                continue
            l_ = coef[0, lo:hi] + coef[1, lo:hi]
            r_ = coef[0, lo:hi] - coef[1, lo:hi]
            coef[0, lo:hi] = l_
            coef[1, lo:hi] = r_

    # -- transform ---------------------------------------------------------
    def _transform(self, X, blksw):
        if self._imdct is None:
            # oddly-stacked MDCT, window length M: x[n] =
            # sum X[k] cos(2pi/M (n + 1/2 + M/4)(k + 1/2))
            M = 512
            n = np.arange(M)[:, None]
            k = np.arange(M // 2)[None, :]
            self._imdct = np.cos(
                2 * np.pi / M * (n + 0.5 + M / 4) * (k + 0.5))
            M2 = 256
            n2 = np.arange(M2)[:, None]
            k2 = np.arange(M2 // 2)[None, :]
            self._imdct_s = np.cos(
                2 * np.pi / M2 * (n2 + 0.5 + M2 / 4) * (k2 + 0.5))
        w = self._win
        if not blksw:
            xt = self._imdct @ X[:256]
        else:
            # two 256-sample transforms from even/odd coefficients
            a = self._imdct_s @ X[0:256:2]
            b = self._imdct_s @ X[1:256:2]
            xt = np.zeros(512, np.float64)
            xt[0:128] = a[0:128]
            xt[128:256] = b[0:128]
            xt[256:384] = a[128:256]
            xt[384:512] = b[128:256]
        # A/52 7.9.4 inverse transform carries a -(2/N_used) factor;
        # with the unit-scale matrix above that collapses to -2 after
        # the windowed overlap-add normalisation
        return -2.0 * xt * np.concatenate([w, w[::-1]])
