"""MP4/MOV muxer — host-native isobmff writer (reference: muxavformat.c
via libavformat; here a from-scratch box writer).

Layout: ftyp, mdat (size patched on finalize), moov with one trak per
track; video = avc1+avcC (H.264), audio = mp4a+esds (AAC; MP3 and MP2
with objectTypeIndication 0x6B), sowt, ac-3+dac3, ec-3+dec3, Opus+dOps
or fLaC+dfLa, text subtitles = tx3g. Sample tables: stts (durations),
stss (sync), ctts (reorder offsets), stsc/stsz/stco. 90 kHz video
timescale like the reference; audio timescale = sample rate.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .common import MuxError
from .nal import annexb_to_avcc, build_avcc, extract_sps_pps, \
    strip_parameter_sets

MOVIE_TIMESCALE = 90000
# the sound codecs a sample entry describes: mp4a (AAC; MP3 and MP2 with
# objectTypeIndication 0x6B), sowt, ac-3 + dac3, ec-3 + dec3, Opus, fLaC
AUDIO_CODECS = ("aac", "mp3", "mp2", "pcm_s16le", "lpcm", "ac3", "eac3",
                "opus", "flac")


def box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def fullbox(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(typ, struct.pack(">I", (version << 24) | flags) + payload)


@dataclass
class Sample:
    offset: int
    size: int
    duration: int
    sync: bool
    cts_offset: int = 0


@dataclass
class Track:
    track_id: int
    kind: str                      # video | audio | subtitle
    timescale: int
    codec: str
    width: int = 0
    height: int = 0
    sample_rate: int = 48000
    channels: int = 2
    extradata: bytes = b""         # avcC / esds payload / etc.
    mastering: bytes = b""         # mdcv payload (HDR static metadata)
    cll: bytes = b""               # clli payload
    color: dict = field(default_factory=dict)      # colr nclx
    language: str = "und"
    samples: list = field(default_factory=list)
    first_pts: int = 0
    name: str = ""
    par: tuple = (1, 1)            # pixel aspect: a pasp box unless 1:1


class MP4Writer:
    """Create with a path, add tracks, write samples (any order between
    tracks; within a track pts must be monotonic in dts order), finalize().
    """

    def __init__(self, path: str, brand: bytes = b"isom"):
        self.f = open(path, "wb")
        self.tracks: list[Track] = []
        self.chapters: list = []   # (start_ticks_90k, title)
        self.metadata: dict = {}
        self._wrote_header = False
        self._mdat_start = 0

    # -- track setup ----------------------------------------------------------
    def add_video_track(self, codec: str = "h264", width: int = 0,
                        height: int = 0, timescale: int = MOVIE_TIMESCALE,
                        extradata: bytes = b"",
                        language: str = "und", par=(1, 1)) -> int:
        t = Track(len(self.tracks) + 1, "video", timescale, codec,
                  width=width, height=height, extradata=extradata,
                  language=language, par=tuple(par))
        self.tracks.append(t)
        return len(self.tracks) - 1

    def add_audio_track(self, codec: str = "aac", sample_rate: int = 48000,
                        channels: int = 2, extradata: bytes = b"",
                        language: str = "und") -> int:
        """A sound track of one of AUDIO_CODECS; another codec raises
        MuxError naming it (no sample entry would describe it)."""
        if codec not in AUDIO_CODECS:
            raise MuxError(f"mp4: no sample entry for {codec!r} audio "
                           f"(it carries {', '.join(AUDIO_CODECS)})")
        t = Track(len(self.tracks) + 1, "audio", sample_rate, codec,
                  sample_rate=sample_rate, channels=channels,
                  extradata=extradata, language=language)
        self.tracks.append(t)
        return len(self.tracks) - 1

    def add_subtitle_track(self, codec: str = "tx3g",
                           timescale: int = MOVIE_TIMESCALE,
                           language: str = "und") -> int:
        t = Track(len(self.tracks) + 1, "subtitle", timescale, codec,
                  language=language)
        self.tracks.append(t)
        return len(self.tracks) - 1

    # -- sample IO -------------------------------------------------------------
    def _header(self):
        if self._wrote_header:
            return
        self.f.write(box(b"ftyp",
                         b"isom" + struct.pack(">I", 512)
                         + b"isomiso2avc1mp41"))
        self._mdat_start = self.f.tell()
        self.f.write(struct.pack(">I", 8) + b"mdat")
        self._wrote_header = True

    def write_sample(self, track_idx: int, data: bytes, duration: int,
                     sync: bool = True, cts_offset: int = 0,
                     annexb: bool = False):
        self._header()
        t = self.tracks[track_idx]
        if annexb and t.codec in ("h264", "hevc"):
            if not t.extradata and t.codec == "h264":
                sps, pps = extract_sps_pps(data)
                if sps and pps:
                    t.extradata = build_avcc(sps, pps)
            elif not t.extradata and t.codec == "hevc":
                from .nal import build_hvcc, extract_vps_sps_pps
                vps, sps, pps = extract_vps_sps_pps(data)
                if vps and sps and pps:
                    t.extradata = build_hvcc(vps[0], sps[0], pps[0])
            data = annexb_to_avcc(strip_parameter_sets(data, t.codec))
        if t.codec == "av1" and not t.extradata:
            from ..codecs.av1 import obu as av1_obu
            for ot, payload in av1_obu.parse_obus(data):
                if ot == av1_obu.OBU_SEQUENCE_HEADER:
                    t.extradata = av1_obu.build_av1c(
                        av1_obu.obu(ot, payload))
                    break
        off = self.f.tell()
        self.f.write(data)
        t.samples.append(Sample(off, len(data), duration, sync, cts_offset))

    def add_chapter(self, start_90k: int, title: str):
        self.chapters.append((start_90k, title))

    # -- finalize ---------------------------------------------------------------
    def finalize(self):
        end = self.f.tell()
        # patch mdat size
        self.f.seek(self._mdat_start)
        self.f.write(struct.pack(">I", end - self._mdat_start))
        self.f.seek(end)
        self.f.write(self._moov())
        self.f.close()

    # -- box builders ------------------------------------------------------------
    def _moov(self) -> bytes:
        dur_movie = 0
        traks = b""
        for t in self.tracks:
            if not t.samples:
                continue
            tdur = sum(s.duration for s in t.samples)
            dur_movie = max(dur_movie,
                            tdur * MOVIE_TIMESCALE // t.timescale)
            traks += self._trak(t)
        mvhd = fullbox(b"mvhd", 0, 0, struct.pack(
            ">IIIII", 0, 0, MOVIE_TIMESCALE, dur_movie, 0x00010000)
            + struct.pack(">HHII", 0x0100, 0, 0, 0)
            + _identity_matrix()
            + b"\x00" * 24
            + struct.pack(">I", len(self.tracks) + 1))
        udta = self._udta()
        return box(b"moov", mvhd + traks + udta)

    def _udta(self) -> bytes:
        if not self.metadata and not self.chapters:
            return b""
        payload = b""
        if self.chapters:
            chpl = struct.pack(">B", len(self.chapters))
            for start, title in self.chapters:
                tb = title.encode("utf-8")[:255]
                # chpl timestamps are in 100ns units
                chpl += struct.pack(">QB", start * 10000 // 9, len(tb)) + tb
            payload += fullbox(b"chpl", 1, 0, b"\x00" * 4 + chpl)
        if self.metadata:
            ilst = b""
            keys = {"title": b"\xa9nam", "artist": b"\xa9ART",
                    "album": b"\xa9alb", "comment": b"\xa9cmt",
                    "genre": b"\xa9gen", "date": b"\xa9day",
                    "encoder": b"\xa9too"}
            for k, v in self.metadata.items():
                if k not in keys:
                    continue
                vb = str(v).encode("utf-8")
                data = fullbox(b"data", 0, 1, b"\x00" * 4 + vb)
                ilst += box(keys[k], data)
            hdlr = fullbox(b"hdlr", 0, 0,
                           b"\x00" * 4 + b"mdir" + b"appl" + b"\x00" * 9)
            payload += box(b"meta", b"\x00" * 4 + hdlr + box(b"ilst", ilst))
        return box(b"udta", payload)

    def _trak(self, t: Track) -> bytes:
        tdur = sum(s.duration for s in t.samples)
        dur_mv = tdur * MOVIE_TIMESCALE // t.timescale
        flags = 0x7 if t.kind != "subtitle" else 0x6
        tkhd = fullbox(b"tkhd", 0, flags, struct.pack(
            ">IIIII", 0, 0, t.track_id, 0, dur_mv)
            + b"\x00" * 8
            + struct.pack(">HHHH", 0,
                          0x0100 if t.kind == "audio" else 0, 0, 0)
            + _identity_matrix()
            + struct.pack(">II", t.width << 16, t.height << 16))
        mdhd = fullbox(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, t.timescale, tdur,
            _lang_code(t.language), 0))
        handler, hname = {
            "video": (b"vide", b"VideoHandler"),
            "audio": (b"soun", b"SoundHandler"),
            "subtitle": (b"text", b"SubtitleHandler"),
        }[t.kind]
        hdlr = fullbox(b"hdlr", 0, 0, b"\x00" * 4 + handler + b"\x00" * 12
                       + hname + b"\x00")
        minf = self._minf(t)
        mdia = box(b"mdia", mdhd + hdlr + minf)
        return box(b"trak", tkhd + mdia)

    def _minf(self, t: Track) -> bytes:
        if t.kind == "video":
            hdr = fullbox(b"vmhd", 0, 1, b"\x00" * 8)
        elif t.kind == "audio":
            hdr = fullbox(b"smhd", 0, 0, b"\x00" * 4)
        else:
            hdr = fullbox(b"nmhd", 0, 0, b"")
        dref = fullbox(b"dref", 0, 0, struct.pack(">I", 1)
                       + fullbox(b"url ", 0, 1, b""))
        dinf = box(b"dinf", dref)
        stbl = self._stbl(t)
        return box(b"minf", hdr + dinf + stbl)

    def _stbl(self, t: Track) -> bytes:
        stsd = fullbox(b"stsd", 0, 0,
                       struct.pack(">I", 1) + self._sample_entry(t))
        # stts: run-length durations
        runs = []
        for s in t.samples:
            if runs and runs[-1][1] == s.duration:
                runs[-1][0] += 1
            else:
                runs.append([1, s.duration])
        stts = fullbox(b"stts", 0, 0, struct.pack(">I", len(runs))
                       + b"".join(struct.pack(">II", c, d)
                                  for c, d in runs))
        out = stsd + stts
        # stss: sync table (omit if everything is sync)
        syncs = [i + 1 for i, s in enumerate(t.samples) if s.sync]
        if len(syncs) != len(t.samples):
            out += fullbox(b"stss", 0, 0, struct.pack(">I", len(syncs))
                           + b"".join(struct.pack(">I", i) for i in syncs))
        # ctts (version 1, signed) when any reorder offset present
        if any(s.cts_offset for s in t.samples):
            cruns = []
            for s in t.samples:
                if cruns and cruns[-1][1] == s.cts_offset:
                    cruns[-1][0] += 1
                else:
                    cruns.append([1, s.cts_offset])
            out += fullbox(b"ctts", 1, 0, struct.pack(">I", len(cruns))
                           + b"".join(struct.pack(">Ii", c, o)
                                      for c, o in cruns))
        # stsc: one sample per chunk (chunk == sample; simple & valid)
        out += fullbox(b"stsc", 0, 0, struct.pack(">I", 1)
                       + struct.pack(">III", 1, 1, 1))
        out += fullbox(b"stsz", 0, 0, struct.pack(">II", 0, len(t.samples))
                       + b"".join(struct.pack(">I", s.size)
                                  for s in t.samples))
        # stco / co64
        if t.samples and t.samples[-1].offset > 0xFFFFFFFF:
            out += fullbox(b"co64", 0, 0,
                           struct.pack(">I", len(t.samples))
                           + b"".join(struct.pack(">Q", s.offset)
                                      for s in t.samples))
        else:
            out += fullbox(b"stco", 0, 0,
                           struct.pack(">I", len(t.samples))
                           + b"".join(struct.pack(">I", s.offset)
                                      for s in t.samples))
        return box(b"stbl", out)

    def _sample_entry(self, t: Track) -> bytes:
        if t.kind == "video":
            fourcc = {"h264": b"avc1", "hevc": b"hvc1",
                      "av1": b"av01"}[t.codec]
            body = (b"\x00" * 6 + struct.pack(">H", 1)
                    + b"\x00" * 16
                    + struct.pack(">HH", t.width, t.height)
                    + struct.pack(">II", 0x00480000, 0x00480000)
                    + b"\x00" * 4
                    + struct.pack(">H", 1)
                    + b"\x00" * 32
                    + struct.pack(">H", 0x18)
                    + struct.pack(">h", -1))
            cfg = {"h264": b"avcC", "hevc": b"hvcC", "av1": b"av1C"}
            if t.extradata:
                body += box(cfg[t.codec], t.extradata)
            if t.par != (1, 1):
                # PixelAspectRatioBox (ISO/IEC 14496-12 12.1.4)
                body += box(b"pasp", struct.pack(">II", *t.par))
            # HDR metadata boxes (muxavformat.c track setup analog)
            if t.color:
                from ..codecs.hdr import colr_payload
                body += box(b"colr", colr_payload(t.color))
            if t.mastering:
                body += box(b"mdcv", t.mastering[:24])
            if t.cll:
                body += box(b"clli", t.cll[:4])
            return box(fourcc, body)
        if t.kind == "audio":
            body = (b"\x00" * 6 + struct.pack(">H", 1)
                    + b"\x00" * 8
                    + struct.pack(">HH", t.channels, 16)
                    + b"\x00" * 4
                    + struct.pack(">I", t.sample_rate << 16))
            if t.codec == "aac":
                return box(b"mp4a", body + self._esds(t))
            if t.codec in ("mp3", "mp2"):
                # MPEG-1 layers II and III ride mp4a + esds with
                # objectTypeIndication 0x6B, no DecSpecificInfo
                return box(b"mp4a", body + self._esds(t, oti=0x6B))
            if t.codec in ("pcm_s16le", "lpcm"):
                return box(b"sowt", body)
            if t.codec == "ac3":
                return box(b"ac-3", body + box(b"dac3", t.extradata))
            if t.codec == "eac3":
                return box(b"ec-3", body + box(b"dec3", t.extradata))
            if t.codec == "opus":
                return box(b"Opus", body + box(b"dOps", t.extradata))
            if t.codec == "flac":
                return box(b"fLaC", body
                           + fullbox(b"dfLa", 0, 0, t.extradata))
            raise AssertionError(t.codec)     # refused by add_audio_track
        # subtitle tx3g
        ftab = box(b"ftab", struct.pack(">HH", 1, 1)
                   + bytes([5]) + b"Serif")
        body = (b"\x00" * 6 + struct.pack(">H", 1)
                + struct.pack(">I", 0)
                + struct.pack(">bb", 1, -1)
                + b"\x00" * 4
                + struct.pack(">HHHH", 0, 0, 0, 0)
                + struct.pack(">IHBB", 0, 1, 0, 12)
                + b"\xff\xff\xff\xff" + ftab)
        return box(b"tx3g", body)

    def _esds(self, t: Track, oti: int = 0x40) -> bytes:
        asc = t.extradata or b"\x11\x90"  # AAC-LC 48k stereo default

        def desc(tag, payload):
            ln = len(payload)
            size = b""
            while True:
                b7 = ln & 0x7F
                ln >>= 7
                size = bytes([b7 | (0x80 if size else 0)]) + size
                if ln == 0:
                    break
            return bytes([tag]) + size + payload

        dec_specific = desc(0x05, asc) if oti == 0x40 else b""
        dec_config = desc(0x04, bytes([oti, 0x15]) + b"\x00\x00\x00"
                          + struct.pack(">II", 0, 0) + dec_specific)
        sl = desc(0x06, b"\x02")
        es = desc(0x03, struct.pack(">HB", t.track_id, 0)
                  + dec_config + sl)
        return fullbox(b"esds", 0, 0, es)


def dac3(bsi: dict) -> bytes:
    """The AC3SpecificBox payload (ETSI TS 102 366 F.4) of an AC-3
    stream's BSI (``audio.ac3dec.read_bsi``): fscod, bsid, bsmod, acmod,
    lfeon, bit_rate_code and 5 reserved bits."""
    v = (bsi["fscod"] << 22) | (bsi["bsid"] << 17) | (bsi["bsmod"] << 14) \
        | (bsi["acmod"] << 11) | (bsi["lfeon"] << 10) \
        | ((bsi["frmsizecod"] >> 1) << 5)
    return v.to_bytes(3, "big")


def dec3(info: dict) -> bytes:
    """The EC3SpecificBox payload (ETSI TS 102 366 F.6) of an E-AC-3
    stream's first access unit (``audio.ac3dec.read_bsi``): data_rate and
    num_ind_sub, then per independent substream fscod, bsid, asvc 0,
    bsmod, acmod, lfeon, num_dep_sub and chan_loc (a reserved bit where
    it has no dependent substream)."""
    subs = info["substreams"]
    bits = [(min(info["data_rate"], 8191), 13), (len(subs) - 1, 3)]
    for s in subs:
        bits += [(s["fscod"], 2), (s["bsid"], 5), (0, 1), (0, 1),
                 (s["bsmod"], 3), (s["acmod"], 3), (s["lfeon"], 1), (0, 3),
                 (s["num_dep_sub"], 4)]
        bits.append((s["chan_loc"], 9) if s["num_dep_sub"] else (0, 1))
    v, n = 0, 0
    for val, width in bits:
        v, n = (v << width) | val, n + width
    return v.to_bytes(n // 8, "big")


def _identity_matrix() -> bytes:
    return struct.pack(">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                       0x40000000)


def _lang_code(lang: str) -> int:
    if len(lang) != 3:
        lang = "und"
    c = 0
    for ch in lang:
        c = (c << 5) | (ord(ch) - 0x60)
    return c
