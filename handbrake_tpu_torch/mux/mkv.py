"""Matroska/WebM muxer — host-native EBML writer (reference: muxavformat.c
mkv path via libavformat; here from-scratch EBML).

Elements written: EBML header, Segment{Info, Tracks, Chapters?, Cluster*,
Cues}. Video codec ids: V_MPEG4/ISO/AVC (avcC private data), V_MPEGH/
ISO/HEVC, V_AV1; audio: A_AAC, A_OPUS, A_FLAC, A_PCM/INT/LIT; subs:
S_TEXT/UTF8. Timestamps in ms (TimestampScale 1e6), clusters cut every
~2 s with relative SimpleBlock timestamps — the muxcommon interleave-chunk
idea on the container side.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .common import MuxError

# the CodecID of each sound codec the writer carries
AUDIO_CODEC_IDS = {"aac": "A_AAC", "opus": "A_OPUS", "flac": "A_FLAC",
                   "vorbis": "A_VORBIS", "ac3": "A_AC3", "eac3": "A_EAC3",
                   "mp3": "A_MPEG/L3", "mp2": "A_MPEG/L2",
                   "pcm_s16le": "A_PCM/INT/LIT",
                   "truehd": "A_TRUEHD", "dts": "A_DTS"}


def ebml_id(i: int) -> bytes:
    if i >= 0x10000000:
        return struct.pack(">I", i)
    if i >= 0x200000:
        return struct.pack(">I", i)[1:]
    if i >= 0x4000:
        return struct.pack(">H", i)
    return bytes([i])


def vint(n: int) -> bytes:
    """EBML size coding."""
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            b = n | (1 << (7 * length))
            return b.to_bytes(length, "big")
    raise ValueError("size too large")


def elem(eid: int, payload: bytes) -> bytes:
    return ebml_id(eid) + vint(len(payload)) + payload


def uint_e(eid: int, v: int) -> bytes:
    b = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    return elem(eid, b)


def float_e(eid: int, v: float) -> bytes:
    return elem(eid, struct.pack(">d", v))


def str_e(eid: int, s: str) -> bytes:
    return elem(eid, s.encode("utf-8"))


@dataclass
class MKTrack:
    number: int
    kind: str
    codec_id: str
    width: int = 0
    height: int = 0
    sample_rate: int = 48000
    channels: int = 2
    private: bytes = b""
    language: str = "und"
    default_duration_ns: int = 0
    display: tuple = ()        # DisplayWidth/Height where PAR is not 1:1


class MKVWriter:
    CLUSTER_MS = 2000

    def __init__(self, path: str, webm: bool = False):
        self.f = open(path, "wb")
        self.webm = webm
        self.tracks: list[MKTrack] = []
        self.chapters: list = []
        self._clusters: list = []
        self._cluster_ts = None
        self._cluster_buf = bytearray()
        self._cues: list = []           # (ts_ms, track, cluster_offset)
        self._seg_payload_start = 0
        self._duration_ms = 0
        self._started = False

    def add_video_track(self, codec: str = "h264", width: int = 0,
                        height: int = 0, private: bytes = b"",
                        fps: float = 0.0, language: str = "und",
                        par=(1, 1)) -> int:
        cid = {"h264": "V_MPEG4/ISO/AVC", "hevc": "V_MPEGH/ISO/HEVC",
               "av1": "V_AV1", "vp9": "V_VP9", "vp8": "V_VP8",
               "theora": "V_THEORA", "mpeg2": "V_MPEG2",
               "mpeg4": "V_MPEG4/ISO/ASP", "ffv1": "V_FFV1",
               "prores": "V_PRORES"}[codec]
        dd = int(1e9 / fps) if fps else 0
        t = MKTrack(len(self.tracks) + 1, "video", cid, width=width,
                    height=height, private=private, language=language,
                    default_duration_ns=dd)
        if tuple(par) != (1, 1):
            from ..codecs.vui import display_size
            t.display = display_size(width, height, *par)
        self.tracks.append(t)
        return len(self.tracks) - 1

    def add_audio_track(self, codec: str = "aac", sample_rate: int = 48000,
                        channels: int = 2, private: bytes = b"",
                        language: str = "und") -> int:
        if codec not in AUDIO_CODEC_IDS:
            raise MuxError(f"mkv: no CodecID for {codec!r} audio (it "
                           f"carries {', '.join(AUDIO_CODEC_IDS)})")
        cid = AUDIO_CODEC_IDS[codec]
        t = MKTrack(len(self.tracks) + 1, "audio", cid,
                    sample_rate=sample_rate, channels=channels,
                    private=private, language=language)
        self.tracks.append(t)
        return len(self.tracks) - 1

    def add_subtitle_track(self, codec: str = "srt",
                           language: str = "und",
                           private: bytes = b"") -> int:
        cid = {"srt": "S_TEXT/UTF8", "ass": "S_TEXT/ASS",
               "pgs": "S_HDMV/PGS", "vobsub": "S_VOBSUB"}[codec]
        t = MKTrack(len(self.tracks) + 1, "subtitle", cid,
                    private=private, language=language)
        self.tracks.append(t)
        return len(self.tracks) - 1

    def add_chapter(self, start_90k: int, title: str):
        self.chapters.append((start_90k, title))

    # -- writing ----------------------------------------------------------------
    def _start(self):
        if self._started:
            return
        doc = "webm" if self.webm else "matroska"
        ebml = (uint_e(0x4286, 1) + uint_e(0x42F7, 1) + uint_e(0x42F2, 4)
                + uint_e(0x42F3, 8) + str_e(0x4282, doc)
                + uint_e(0x4287, 4) + uint_e(0x4285, 2))
        self.f.write(elem(0x1A45DFA3, ebml))
        # Segment with unknown size (8-byte all-ones vint)
        self.f.write(ebml_id(0x18538067) + b"\x01" + b"\xff" * 7)
        self._seg_payload_start = self.f.tell()
        # Info
        info = (uint_e(0x2AD7B1, 1000000)
                + str_e(0x4D80, "handbrake-tpu")
                + str_e(0x5741, "handbrake-tpu")
                + float_e(0x4489, 0.0))  # duration patched on finalize
        self._info_off = self.f.tell()
        self.f.write(elem(0x1549A966, info))
        self._info_len = self.f.tell() - self._info_off
        # Tracks
        trks = b""
        for t in self.tracks:
            ttype = {"video": 1, "audio": 2, "subtitle": 17}[t.kind]
            te = (uint_e(0xD7, t.number) + uint_e(0x73C5, t.number)
                  + uint_e(0x83, ttype)
                  + str_e(0x86, t.codec_id)
                  + str_e(0x22B59C, t.language))
            if t.private:
                te += elem(0x63A2, t.private)
            if t.default_duration_ns:
                te += uint_e(0x23E383, t.default_duration_ns)
            if t.kind == "video":
                # DisplayWidth/DisplayHeight in pixels (DisplayUnit 0)
                te += elem(0xE0, uint_e(0xB0, t.width)
                           + uint_e(0xBA, t.height)
                           + b"".join(uint_e(e, v) for e, v in
                                      zip((0x54B0, 0x54BA), t.display)))
            elif t.kind == "audio":
                te += elem(0xE1, float_e(0xB5, float(t.sample_rate))
                           + uint_e(0x9F, t.channels))
            trks += elem(0xAE, te)
        self.f.write(elem(0x1654AE6B, trks))
        if self.chapters and not self.webm:
            atoms = b""
            for i, (start, title) in enumerate(self.chapters):
                atoms += elem(0xB6,
                              uint_e(0x73C4, i + 1)
                              + uint_e(0x91, start * 1000000 // 90)
                              + elem(0x80, str_e(0x85, title)
                                     + str_e(0x437C, "und")))
            ed = elem(0x45B9, uint_e(0x45BD, 0) + uint_e(0x45DB, 1)
                      + uint_e(0x45DD, 0) + atoms)
            self.f.write(elem(0x1043A770, ed))
        self._started = True

    def write_sample(self, track_idx: int, data: bytes, pts_90k: int,
                     duration_90k: int = 0, sync: bool = True,
                     annexb: bool = False):
        t0 = self.tracks[track_idx]
        if annexb and t0.codec_id in ("V_MPEG4/ISO/AVC",
                                      "V_MPEGH/ISO/HEVC"):
            from .nal import (annexb_to_avcc, build_avcc, build_hvcc,
                              extract_sps_pps, extract_vps_sps_pps,
                              strip_parameter_sets)
            is_hevc = t0.codec_id == "V_MPEGH/ISO/HEVC"
            if not t0.private and not is_hevc:
                sps, pps = extract_sps_pps(data)
                if sps and pps:
                    t0.private = build_avcc(sps, pps)
            elif not t0.private and is_hevc:
                vps, sps, pps = extract_vps_sps_pps(data)
                if vps and sps and pps:
                    t0.private = build_hvcc(vps[0], sps[0], pps[0])
            data = annexb_to_avcc(
                strip_parameter_sets(data, "hevc" if is_hevc else "h264"))
        if t0.codec_id == "V_AV1" and not t0.private:
            from ..codecs.av1 import obu as av1_obu
            for ot, payload in av1_obu.parse_obus(data):
                if ot == av1_obu.OBU_SEQUENCE_HEADER:
                    t0.private = av1_obu.build_av1c(
                        av1_obu.obu(ot, payload))
                    break
        self._start()
        ts_ms = pts_90k // 90
        t = self.tracks[track_idx]
        if (self._cluster_ts is None
                or ts_ms - self._cluster_ts >= self.CLUSTER_MS
                or ts_ms < self._cluster_ts):
            self._flush_cluster()
            self._cluster_ts = ts_ms
            if t.kind == "video" and sync:
                pass
        rel = ts_ms - self._cluster_ts
        flags = 0x80 if sync else 0x00
        blk = vint(t.number) + struct.pack(">h", rel) + bytes([flags]) \
            + data
        if t.kind == "subtitle" and duration_90k:
            bg = elem(0xA1, vint(t.number) + struct.pack(">h", rel)
                      + bytes([0x00]) + data) \
                + uint_e(0x9B, duration_90k // 90)
            self._cluster_buf += elem(0xA0, bg)
        else:
            self._cluster_buf += elem(0xA3, blk)
        if t.kind == "video" and sync:
            self._cues.append((ts_ms, t.number))
        self._duration_ms = max(self._duration_ms,
                                ts_ms + duration_90k // 90)

    def _flush_cluster(self):
        if self._cluster_ts is None or not self._cluster_buf:
            self._cluster_buf = bytearray()
            return
        payload = uint_e(0xE7, self._cluster_ts) + bytes(self._cluster_buf)
        off = self.f.tell() - self._seg_payload_start
        for i, entry in enumerate(self._cues):
            if len(entry) == 2:            # 3-tuples already have their
                self._cues[i] = (*entry, off)  # cluster offset patched
        self.f.write(elem(0x1F43B675, payload))
        self._cluster_buf = bytearray()
        self._cluster_ts = None

    def finalize(self):
        self._start()
        self._flush_cluster()
        # Cues
        cues = b""
        for entry in self._cues:
            if len(entry) != 3:
                continue
            ts, tn, off = entry
            cp = (uint_e(0xB3, ts)
                  + elem(0xB7, uint_e(0xF7, tn) + uint_e(0xF1, off)))
            cues += elem(0xBB, cp)
        if cues:
            self.f.write(elem(0x1C53BB6B, cues))
        # patch duration in Info
        end = self.f.tell()
        self.f.seek(self._info_off)
        info = (uint_e(0x2AD7B1, 1000000)
                + str_e(0x4D80, "handbrake-tpu")
                + str_e(0x5741, "handbrake-tpu")
                + float_e(0x4489, float(self._duration_ms)))
        patched = elem(0x1549A966, info)
        assert len(patched) == self._info_len
        self.f.write(patched)
        self.f.seek(end)
        self.f.close()
