"""ISO-BMFF (MP4/MOV) demuxer — host-native box parser (reference:
libhb/stream.c uses libavformat for this; ours is a from-scratch reader
matching mux/mp4.py's writer and standard mp4 files).

Parses moov sample tables (stts/ctts/stss/stsc/stsz/stco|co64) into flat
per-track sample lists, converts avcC/hvcC length-prefixed video samples to
annex-B for the decoders, and yields packets in interleaved dts order.
"""
from __future__ import annotations

import struct
from fractions import Fraction
from typing import Optional

from ..core.buffer import Buffer, FrameType, CLOCK
from ..mux.nal import avcc_to_annexb
from .common import DemuxError, TrackInfo, read_vui_sar, to_90k


def _iter_boxes(data: bytes, start: int = 0, end: Optional[int] = None):
    """Yield (type, payload_start, payload_end) over a box sequence."""
    end = len(data) if end is None else end
    i = start
    while i + 8 <= end:
        size = struct.unpack(">I", data[i:i + 4])[0]
        typ = data[i + 4:i + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[i + 8:i + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - i
        if size < hdr:
            break
        yield typ, i + hdr, min(i + size, end)
        i += size


def _find(data: bytes, path: list, start=0, end=None):
    """First box at nested path; returns (payload_start, payload_end)."""
    if not path:
        return start, end if end is not None else len(data)
    for typ, ps, pe in _iter_boxes(data, start, end):
        if typ == path[0]:
            if len(path) == 1:
                return ps, pe
            # fullbox children (meta) need a 4-byte version skip; not needed
            # for the containers we walk (moov/trak/mdia/minf/stbl)
            return _find(data, path[1:], ps, pe)
    return None


def _find_all(data: bytes, typ: bytes, start, end):
    return [(ps, pe) for t, ps, pe in _iter_boxes(data, start, end)
            if t == typ]


class _SampleTable:
    __slots__ = ("offsets", "sizes", "dts", "durations", "cts_offsets",
                 "sync", "rate")

    def __init__(self):
        self.rate = None           # samples a second, where stts has one
        self.offsets = []
        self.sizes = []
        self.dts = []
        self.durations = []
        self.cts_offsets = []
        self.sync = set()


class MP4Demuxer:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.tracks: list[TrackInfo] = []
        self._samples: list[_SampleTable] = []
        self.duration = 0          # 90 kHz
        self.chapters: list = []   # (start_90k, title)
        self.metadata: dict = {}
        self._parse_moov()
        self._cursor = [0] * len(self.tracks)

    # -- parse ---------------------------------------------------------------
    def _read_moov(self) -> bytes:
        self.f.seek(0)
        while True:
            hdr = self.f.read(8)
            if len(hdr) < 8:
                raise DemuxError("no moov box found")
            size = struct.unpack(">I", hdr[:4])[0]
            typ = hdr[4:8]
            if size == 1:
                size = struct.unpack(">Q", self.f.read(8))[0] - 8
            elif size == 0:
                size = None
            if typ == b"moov":
                return self.f.read((size - 8) if size else None)
            if size is None:
                raise DemuxError("no moov box found")
            self.f.seek(size - 8, 1)

    def _parse_moov(self):
        moov = self._read_moov()
        mv = _find(moov, [b"mvhd"])
        movie_timescale = CLOCK
        if mv:
            ver = moov[mv[0]]
            if ver == 1:
                movie_timescale, dur = struct.unpack(
                    ">IQ", moov[mv[0] + 20:mv[0] + 32])
            else:
                movie_timescale, dur = struct.unpack(
                    ">II", moov[mv[0] + 12:mv[0] + 20])
            self.duration = to_90k(dur, movie_timescale)
        for tps, tpe in _find_all(moov, b"trak", 0, len(moov)):
            self._parse_trak(moov, tps, tpe)
        self._parse_udta(moov)

    def _parse_udta(self, moov: bytes):
        ud = _find(moov, [b"udta"])
        if not ud:
            return
        ch = _find(moov, [b"chpl"], ud[0], ud[1])
        if ch:
            p = ch[0] + 4 + 4   # fullbox ver/flags + reserved count dword
            n = moov[p]
            p += 1
            for _ in range(n):
                ts100, tlen = struct.unpack(">QB", moov[p:p + 9])
                p += 9
                title = moov[p:p + tlen].decode("utf-8", "replace")
                p += tlen
                self.chapters.append((ts100 * 9 // 10000, title))

    def _parse_trak(self, moov: bytes, tps: int, tpe: int):
        mdia = _find(moov, [b"mdia"], tps, tpe)
        if not mdia:
            return
        mdhd = _find(moov, [b"mdhd"], mdia[0], mdia[1])
        hdlr = _find(moov, [b"hdlr"], mdia[0], mdia[1])
        stbl = _find(moov, [b"minf", b"stbl"], mdia[0], mdia[1])
        if not (mdhd and hdlr and stbl):
            return
        ver = moov[mdhd[0]]
        if ver == 1:
            timescale = struct.unpack(
                ">I", moov[mdhd[0] + 20:mdhd[0] + 24])[0]
            lang_off = mdhd[0] + 32
        else:
            timescale = struct.unpack(
                ">I", moov[mdhd[0] + 12:mdhd[0] + 16])[0]
            lang_off = mdhd[0] + 20
        lc = struct.unpack(">H", moov[lang_off:lang_off + 2])[0]
        lang = "".join(chr(((lc >> s) & 0x1F) + 0x60) for s in (10, 5, 0))
        handler = moov[hdlr[0] + 8:hdlr[0] + 12]
        kind = {b"vide": "video", b"soun": "audio",
                b"text": "subtitle", b"sbtl": "subtitle",
                b"subt": "subtitle"}.get(handler)
        if kind is None:
            return
        ti = TrackInfo(kind=kind, codec="", timescale=timescale,
                       language=lang if lang.isalpha() else "und")
        self._parse_stsd(moov, stbl, ti)
        st = self._parse_sample_tables(moov, stbl, timescale)
        if kind == "video" and st.rate is not None:
            ti.frame_rate = (st.rate.numerator, st.rate.denominator)
        if ti.codec == "mp3" and st.offsets:
            # objectTypeIndication 0x6B/0x69 names MPEG audio of any
            # layer: the first frame's layer bits tell Layer II (and I)
            # from Layer III
            self.f.seek(st.offsets[0])
            head = self.f.read(min(4, st.sizes[0]))
            if len(head) >= 2 and head[0] == 0xFF \
                    and (head[1] & 0xE0) == 0xE0 \
                    and (head[1] >> 1) & 3 in (2, 3):
                ti.codec = "mp2"
        self.tracks.append(ti)
        self._samples.append(st)

    def _parse_stsd(self, moov: bytes, stbl, ti: TrackInfo):
        sd = _find(moov, [b"stsd"], stbl[0], stbl[1])
        if not sd:
            return
        p = sd[0] + 8  # ver/flags + entry_count
        for typ, ps, pe in _iter_boxes(moov, p, sd[1]):
            fourcc = typ.decode("latin1")
            if ti.kind == "video":
                ti.codec = {"avc1": "h264", "avc3": "h264", "hvc1": "hevc",
                            "hev1": "hevc", "av01": "av1",
                            "mp4v": "mpeg4"}.get(fourcc, fourcc)
                ti.width, ti.height = struct.unpack(
                    ">HH", moov[ps + 24:ps + 28])
                pasp = False
                for ct, cs, ce in _iter_boxes(moov, ps + 78, pe):
                    if ct in (b"avcC", b"hvcC", b"av1C"):
                        ti.extradata = moov[cs:ce]
                        if ct == b"avcC" and len(ti.extradata) > 4:
                            ti.nal_length_size = \
                                (ti.extradata[4] & 0x03) + 1
                        elif ct == b"hvcC" and len(ti.extradata) > 21:
                            ti.nal_length_size = \
                                (ti.extradata[21] & 0x03) + 1
                    elif ct == b"pasp" and ce - cs >= 8:
                        ti.par_num, ti.par_den = struct.unpack(
                            ">II", moov[cs:cs + 8])
                        pasp = True
                if not pasp:
                    # no pasp: the stream's VUI (the reference reads none)
                    read_vui_sar(ti, ti.extradata, "mp4")
            elif ti.kind == "audio":
                ti.codec = {"mp4a": "aac", "sowt": "pcm_s16le",
                            "lpcm": "pcm_s16le", "ac-3": "ac3",
                            "ec-3": "eac3", "Opus": "opus", "fLaC": "flac",
                            ".mp3": "mp3"}.get(fourcc, fourcc)
                ti.channels, = struct.unpack(">H", moov[ps + 16:ps + 18])
                ti.sample_rate = struct.unpack(
                    ">I", moov[ps + 24:ps + 28])[0] >> 16
                for ct, cs, ce in _iter_boxes(moov, ps + 28, pe):
                    if ct == b"esds":
                        ti.extradata = self._parse_esds(moov[cs:ce])
                        oti = self._esds_oti(moov[cs:ce])
                        if oti in (0x6B, 0x69):  # MPEG audio, layer below
                            ti.codec = "mp3"
                        elif oti == 0x40:
                            ti.codec = "aac"
                    elif ct in (b"dOps", b"dac3", b"dec3"):
                        ti.extradata = moov[cs:ce]
                    elif ct == b"dfLa":
                        ti.extradata = moov[cs + 4:ce]
            else:
                ti.codec = {"tx3g": "tx3g", "text": "text",
                            "wvtt": "webvtt"}.get(fourcc, fourcc)
            break  # first sample entry only

    @staticmethod
    def _esds_oti(esds: bytes) -> int:
        """objectTypeIndication from the DecoderConfig descriptor
        (0x40 = AAC, 0x6B/0x69 = MPEG layer III)."""
        i = 4

        def read_desc(i):
            tag = esds[i]
            i += 1
            ln = 0
            while True:
                b = esds[i]
                i += 1
                ln = (ln << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            return tag, ln, i

        try:
            while i < len(esds):
                tag, ln, i = read_desc(i)
                if tag == 0x03:
                    i += 3
                elif tag == 0x04:
                    return esds[i]
                else:
                    i += ln
        except IndexError:
            pass
        return 0

    @staticmethod
    def _parse_esds(esds: bytes) -> bytes:
        """Extract the AudioSpecificConfig (tag 0x05) payload."""
        i = 4  # fullbox ver/flags

        def read_desc(i):
            tag = esds[i]
            i += 1
            ln = 0
            while True:
                b = esds[i]
                i += 1
                ln = (ln << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            return tag, ln, i

        try:
            while i < len(esds):
                tag, ln, i = read_desc(i)
                if tag == 0x03:        # ES descriptor: skip ES_ID + flags
                    i += 3
                elif tag == 0x04:      # DecoderConfig: skip 13 fixed bytes
                    i += 13
                elif tag == 0x05:
                    return esds[i:i + ln]
                else:
                    i += ln
        except IndexError:
            pass
        return b""

    def _parse_sample_tables(self, moov: bytes, stbl, timescale: int):
        st = _SampleTable()

        def full(name):
            r = _find(moov, [name], stbl[0], stbl[1])
            return (r[0] + 4, r[1]) if r else None

        # stsz
        r = full(b"stsz")
        if r:
            uniform, count = struct.unpack(">II", moov[r[0]:r[0] + 8])
            if uniform:
                st.sizes = [uniform] * count
            else:
                st.sizes = list(struct.unpack(
                    f">{count}I", moov[r[0] + 8:r[0] + 8 + 4 * count]))
        n = len(st.sizes)
        # stts → dts + durations (in 90 kHz)
        r = full(b"stts")
        dts_native = []
        durs_native = []
        if r:
            cnt, = struct.unpack(">I", moov[r[0]:r[0] + 4])
            t = 0
            p = r[0] + 4
            for _ in range(cnt):
                c, d = struct.unpack(">II", moov[p:p + 8])
                p += 8
                for _ in range(c):
                    dts_native.append(t)
                    durs_native.append(d)
                    t += d
        st.dts = [to_90k(t, timescale) for t in dts_native[:n]]
        st.durations = [to_90k(d, timescale) for d in durs_native[:n]]
        # one duration for every sample (the last may be cut short): the
        # rate the container states, as libavformat reads it
        if n and durs_native[0] and len(set(durs_native[:max(1, n - 1)])) \
                == 1:
            st.rate = Fraction(timescale, durs_native[0])
        # ctts
        r = full(b"ctts")
        st.cts_offsets = [0] * n
        if r:
            cnt, = struct.unpack(">I", moov[r[0]:r[0] + 4])
            p = r[0] + 4
            i = 0
            for _ in range(cnt):
                c = struct.unpack(">I", moov[p:p + 4])[0]
                o = struct.unpack(">i", moov[p + 4:p + 8])[0]
                p += 8
                for _ in range(c):
                    if i < n:
                        st.cts_offsets[i] = to_90k(o, timescale)
                    i += 1
        # stss
        r = full(b"stss")
        if r:
            cnt, = struct.unpack(">I", moov[r[0]:r[0] + 4])
            st.sync = set(struct.unpack(
                f">{cnt}I", moov[r[0] + 4:r[0] + 4 + 4 * cnt]))
        else:
            st.sync = set(range(1, n + 1))   # all sync
        # stco / co64
        r = full(b"stco")
        chunk_offsets = []
        if r:
            cnt, = struct.unpack(">I", moov[r[0]:r[0] + 4])
            chunk_offsets = list(struct.unpack(
                f">{cnt}I", moov[r[0] + 4:r[0] + 4 + 4 * cnt]))
        else:
            r = full(b"co64")
            if r:
                cnt, = struct.unpack(">I", moov[r[0]:r[0] + 4])
                chunk_offsets = list(struct.unpack(
                    f">{cnt}Q", moov[r[0] + 4:r[0] + 4 + 8 * cnt]))
        # stsc → samples per chunk runs
        r = full(b"stsc")
        runs = []
        if r:
            cnt, = struct.unpack(">I", moov[r[0]:r[0] + 4])
            p = r[0] + 4
            for _ in range(cnt):
                first, spc, _desc = struct.unpack(">III", moov[p:p + 12])
                p += 12
                runs.append((first, spc))
        # expand chunk map → per-sample file offsets
        st.offsets = [0] * n
        si = 0
        for ci, coff in enumerate(chunk_offsets):
            spc = 1
            for first, s in runs:
                if ci + 1 >= first:
                    spc = s
                else:
                    break
            off = coff
            for _ in range(spc):
                if si >= n:
                    break
                st.offsets[si] = off
                off += st.sizes[si]
                si += 1
        return st

    # -- read ----------------------------------------------------------------
    def n_samples(self, track: int) -> int:
        return len(self._samples[track].sizes)

    def read_sample(self, track: int, idx: int) -> Buffer:
        ti = self.tracks[track]
        st = self._samples[track]
        self.f.seek(st.offsets[idx])
        data = self.f.read(st.sizes[idx])
        if ti.kind == "video" and ti.codec in ("h264", "hevc"):
            data = avcc_to_annexb(data, ti.nal_length_size)
        dts = st.dts[idx]
        pts = dts + st.cts_offsets[idx]
        b = Buffer(data=data, stream_id=track, track_kind=ti.kind,
                   pts=pts, dts=dts, duration=st.durations[idx])
        b.stop = pts + st.durations[idx]
        if (idx + 1) in st.sync:
            b.frametype = FrameType.KEY
        return b

    def packets(self, start_indices: Optional[list] = None):
        """Yield (track, Buffer) interleaved by dts across all tracks."""
        cur = list(start_indices or [0] * len(self.tracks))
        while True:
            best, best_dts = -1, None
            for t in range(len(self.tracks)):
                if cur[t] < self.n_samples(t):
                    d = self._samples[t].dts[cur[t]]
                    if best_dts is None or d < best_dts:
                        best, best_dts = t, d
            if best < 0:
                return
            yield best, self.read_sample(best, cur[best])
            cur[best] += 1

    def seek(self, pts_90k: int) -> list:
        """Per-track start indices at/before pts, video snapped to sync."""
        out = []
        for t, st in enumerate(self._samples):
            idx = 0
            for i, d in enumerate(st.dts):
                if d <= pts_90k:
                    idx = i
                else:
                    break
            if self.tracks[t].kind == "video":
                while idx > 0 and (idx + 1) not in st.sync:
                    idx -= 1
            out.append(idx)
        return out

    def track_duration(self, track: int) -> int:
        st = self._samples[track]
        if not st.dts:
            return 0
        return st.dts[-1] + (st.durations[-1] if st.durations else 0)

    def close(self):
        self.f.close()


def probe_is_mp4(head: bytes) -> bool:
    return len(head) >= 8 and head[4:8] in (b"ftyp", b"moov", b"mdat",
                                            b"wide", b"free")
