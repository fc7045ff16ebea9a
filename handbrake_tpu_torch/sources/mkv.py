"""Matroska/WebM demuxer — host-native EBML parser (reference path:
libhb/stream.c via libavformat; ours reads mux/mkv.py output and standard
Matroska files: SimpleBlock and BlockGroup, lacing supported).
"""
from __future__ import annotations

import struct
from fractions import Fraction
from typing import Optional

from ..codecs.vui import display_size
from ..core.buffer import Buffer, FrameType
from ..mux.nal import avcc_to_annexb
from .common import DemuxError, TrackInfo, vui_sar

_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TRACKS = 0x1654AE6B
_CLUSTER = 0x1F43B675
_CHAPTERS = 0x1043A770

_CODEC_MAP = {
    "V_MPEG4/ISO/AVC": "h264",
    "V_MPEGH/ISO/HEVC": "hevc",
    "V_AV1": "av1",
    "V_VP9": "vp9",
    "V_VP8": "vp8",
    "V_THEORA": "theora",
    "V_MPEG2": "mpeg2",
    "V_MPEG4/ISO/ASP": "mpeg4",
    "V_FFV1": "ffv1",
    "V_PRORES": "prores",
    "A_AAC": "aac",
    "A_OPUS": "opus",
    "A_FLAC": "flac",
    "A_VORBIS": "vorbis",
    "A_AC3": "ac3",
    "A_EAC3": "eac3",
    "A_MPEG/L3": "mp3",
    "A_MPEG/L2": "mp2",
    "A_PCM/INT/LIT": "pcm_s16le",
    "A_TRUEHD": "truehd",
    "A_DTS": "dts",
    "S_TEXT/UTF8": "srt",
    "S_TEXT/ASS": "ass",
    "S_HDMV/PGS": "pgs",
    "S_VOBSUB": "vobsub",
}


def _read_id(f) -> Optional[int]:
    b0 = f.read(1)
    if not b0:
        return None
    v = b0[0]
    if v & 0x80:
        length = 1
    elif v & 0x40:
        length = 2
    elif v & 0x20:
        length = 3
    elif v & 0x10:
        length = 4
    else:
        raise DemuxError("bad EBML id")
    out = v
    for _ in range(length - 1):
        out = (out << 8) | f.read(1)[0]
    return out


def _read_size(f):
    b0 = f.read(1)
    if not b0:
        return None
    v = b0[0]
    length = 0
    for i in range(8):
        if v & (0x80 >> i):
            length = i + 1
            break
    if length == 0:
        raise DemuxError("bad EBML size")
    out = v & (0xFF >> length)
    unknown = out == (0xFF >> length)
    for _ in range(length - 1):
        b = f.read(1)[0]
        out = (out << 8) | b
        unknown = unknown and b == 0xFF
    return None if unknown else out


def _vint_at(data: bytes, i: int):
    """(value, nbytes) of an EBML vint with marker bits stripped."""
    v = data[i]
    length = 0
    for k in range(8):
        if v & (0x80 >> k):
            length = k + 1
            break
    out = v & (0xFF >> length)
    for j in range(1, length):
        out = (out << 8) | data[i + j]
    return out, length


def _uint(data: bytes) -> int:
    return int.from_bytes(data, "big")


def _float(data: bytes) -> float:
    if len(data) == 4:
        return struct.unpack(">f", data)[0]
    if len(data) == 8:
        return struct.unpack(">d", data)[0]
    return 0.0


def _children(data: bytes):
    """Iterate (id, payload) pairs inside a master element payload."""
    i = 0
    n = len(data)
    while i < n:
        # id
        v = data[i]
        idlen = 1 if v & 0x80 else 2 if v & 0x40 else 3 if v & 0x20 else 4
        eid = _uint(data[i:i + idlen])
        i += idlen
        size, slen = _vint_at(data, i)
        i += slen
        yield eid, data[i:i + size]
        i += size


class MKVDemuxer:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.tracks: list[TrackInfo] = []
        self._tnum_to_idx: dict = {}
        self.timestamp_scale = 1000000   # ns per tick → ms default
        self.duration = 0                # 90 kHz
        self.chapters: list = []
        self.metadata: dict = {}
        self._cluster_offsets: list = []
        self._parse_headers()

    def _parse_headers(self):
        eid = _read_id(self.f)
        if eid != 0x1A45DFA3:
            raise DemuxError("not an EBML file")
        size = _read_size(self.f)
        self.f.seek(size, 1)
        eid = _read_id(self.f)
        if eid != _SEGMENT:
            raise DemuxError("no Segment")
        _read_size(self.f)   # often unknown-size
        self._segment_start = self.f.tell()
        # walk top-level elements; stop scanning headers at first cluster
        while True:
            pos = self.f.tell()
            eid = _read_id(self.f)
            if eid is None:
                break
            size = _read_size(self.f)
            if eid == _CLUSTER:
                self._cluster_offsets.append(pos)
                if size is None:
                    break
                self.f.seek(size, 1)
                continue
            if size is None:
                break
            payload = self.f.read(size)
            if eid == _INFO:
                self._parse_info(payload)
            elif eid == _TRACKS:
                self._parse_tracks(payload)
            elif eid == _CHAPTERS:
                self._parse_chapters(payload)

    def _parse_info(self, data: bytes):
        dur = 0.0
        for eid, p in _children(data):
            if eid == 0x2AD7B1:
                self.timestamp_scale = _uint(p)
            elif eid == 0x4489:
                dur = _float(p)
        # duration is in timestamp-scale ticks
        self.duration = int(dur * self.timestamp_scale * 9 / 100000)

    def _parse_tracks(self, data: bytes):
        for eid, p in _children(data):
            if eid != 0xAE:
                continue
            ti = TrackInfo(kind="video", codec="")
            tnum = 0
            dd_ns = 0
            display = {0x54B2: 0}     # DisplayWidth/Height/Unit
            for ceid, cp in _children(p):
                if ceid == 0xD7:
                    tnum = _uint(cp)
                elif ceid == 0x83:
                    ti.kind = {1: "video", 2: "audio",
                               17: "subtitle"}.get(_uint(cp), "video")
                elif ceid == 0x86:
                    cid = cp.decode("latin1")
                    ti.codec = _CODEC_MAP.get(cid, cid)
                elif ceid == 0x63A2:
                    ti.extradata = cp
                elif ceid == 0x22B59C:
                    ti.language = cp.decode("latin1")[:3] or "und"
                elif ceid == 0x23E383:
                    dd_ns = _uint(cp)
                elif ceid == 0xE0:    # video
                    for veid, vp in _children(cp):
                        if veid == 0xB0:
                            ti.width = _uint(vp)
                        elif veid == 0xBA:
                            ti.height = _uint(vp)
                        elif veid in (0x54B0, 0x54BA, 0x54B2):
                            display[veid] = _uint(vp)
                elif ceid == 0xE1:    # audio
                    for aeid, ap in _children(cp):
                        if aeid == 0xB5:
                            ti.sample_rate = int(_float(ap))
                        elif aeid == 0x9F:
                            ti.channels = _uint(ap)
            if dd_ns:
                ti.frame_rate = (1000000000, dd_ns)
            if ti.kind == "video":
                # the display size in pixels (DisplayUnit 0) gives the
                # pixel aspect, and the stream's VUI its exact value where
                # the two agree to the rounding of the display width (the
                # reference reads neither)
                sar = vui_sar(ti, ti.extradata, "mkv")
                dw, dh = display.get(0x54B0), display.get(0x54BA)
                if dw and dh and not display[0x54B2] and ti.width \
                        and ti.height and not (sar and display_size(
                            ti.width, ti.height, *sar) == (dw, dh)):
                    f = Fraction(dw * ti.height, dh * ti.width)
                    sar = (f.numerator, f.denominator)
                if sar:
                    ti.par_num, ti.par_den = sar
            if ti.codec == "h264" and len(ti.extradata) > 4:
                ti.nal_length_size = (ti.extradata[4] & 0x03) + 1
            self._tnum_to_idx[tnum] = len(self.tracks)
            self.tracks.append(ti)

    def _parse_chapters(self, data: bytes):
        for eid, p in _children(data):
            if eid != 0x45B9:
                continue
            for ceid, cp in _children(p):
                if ceid != 0xB6:
                    continue
                start_ns, title = 0, ""
                for aeid, ap in _children(cp):
                    if aeid == 0x91:
                        start_ns = _uint(ap)
                    elif aeid == 0x80:
                        for deid, dp in _children(ap):
                            if deid == 0x85:
                                title = dp.decode("utf-8", "replace")
                self.chapters.append((start_ns * 9 // 100000, title))

    # -- packets --------------------------------------------------------------
    def packets(self, start_cluster: int = 0):
        """Yield (track_idx, Buffer) in storage order."""
        if not self._cluster_offsets:
            return
        self.f.seek(self._cluster_offsets[start_cluster])
        while True:
            eid = _read_id(self.f)
            if eid is None:
                return
            size = _read_size(self.f)
            if eid != _CLUSTER:
                if size is None:
                    return
                self.f.seek(size, 1)
                continue
            end = None if size is None else self.f.tell() + size
            cluster_ts = 0
            while end is None or self.f.tell() < end:
                pos = self.f.tell()
                ceid = _read_id(self.f)
                if ceid is None:
                    return
                csize = _read_size(self.f)
                if ceid == _CLUSTER:
                    self.f.seek(pos)
                    break
                if csize is None:
                    return
                payload = self.f.read(csize)
                if ceid == 0xE7:
                    cluster_ts = _uint(payload)
                elif ceid == 0xA3:   # SimpleBlock
                    yield from self._emit_block(payload, cluster_ts, None)
                elif ceid == 0xA0:   # BlockGroup
                    blk, bdur = None, None
                    for geid, gp in _children(payload):
                        if geid == 0xA1:
                            blk = gp
                        elif geid == 0x9B:
                            bdur = _uint(gp)
                    if blk is not None:
                        yield from self._emit_block(blk, cluster_ts, bdur)

    def _emit_block(self, blk: bytes, cluster_ts: int, dur_ticks):
        tnum, n = _vint_at(blk, 0)
        rel = struct.unpack(">h", blk[n:n + 2])[0]
        flags = blk[n + 2]
        i = n + 3
        lacing = (flags >> 1) & 0x3
        frames = []
        if lacing == 0:
            frames = [blk[i:]]
        else:
            cnt = blk[i] + 1
            i += 1
            sizes = []
            if lacing == 2:      # fixed
                total = len(blk) - i
                sizes = [total // cnt] * cnt
            elif lacing == 1:    # Xiph
                for _ in range(cnt - 1):
                    s = 0
                    while blk[i] == 255:
                        s += 255
                        i += 1
                    s += blk[i]
                    i += 1
                    sizes.append(s)
                sizes.append(len(blk) - i - sum(sizes))
            else:                # EBML lacing
                s, ln = _vint_at(blk, i)
                i += ln
                sizes.append(s)
                for _ in range(cnt - 2):
                    d, ln = _vint_at(blk, i)
                    # signed delta
                    d -= (1 << (7 * ln - 1)) - 1
                    i += ln
                    s += d
                    sizes.append(s)
                sizes.append(len(blk) - i - sum(sizes))
            for s in sizes:
                frames.append(blk[i:i + s])
                i += s
        idx = self._tnum_to_idx.get(tnum)
        if idx is None:
            return
        ti = self.tracks[idx]
        ts_ms = (cluster_ts + rel) * self.timestamp_scale // 1000000
        pts = ts_ms * 90
        dur = None
        if dur_ticks is not None:
            dur = dur_ticks * self.timestamp_scale * 9 // 100000
        elif ti.frame_rate:
            dur = 90000 * ti.frame_rate[1] // ti.frame_rate[0]
        for data in frames:
            if ti.kind == "video" and ti.codec in ("h264", "hevc"):
                data = avcc_to_annexb(data, ti.nal_length_size)
            b = Buffer(data=data, stream_id=idx, track_kind=ti.kind,
                       pts=pts, dts=pts, duration=dur)
            if dur:
                b.stop = pts + dur
            if flags & 0x80:
                b.frametype = FrameType.KEY
            yield idx, b
            if dur:
                pts += dur

    def seek(self, pts_90k: int) -> int:
        """Return a cluster index at/before pts (clusters start on video
        keyframes in our writer; standard files need Cues — best effort)."""
        return 0

    def close(self):
        self.f.close()


def probe_is_mkv(head: bytes) -> bool:
    return head[:4] == b"\x1aE\xdf\xa3"
