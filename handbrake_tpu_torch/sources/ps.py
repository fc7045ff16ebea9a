"""MPEG program-stream (PS) demuxer — the DVD/VOB container path
(reference: demuxmpeg.c hb_demux_ps + hb_ts_stream_decode's PS sibling).

Parses pack headers (0x000001BA), skips system headers, and reassembles
PES packets per stream id: video 0xE0-0xEF, MPEG audio 0xC0-0xDF, and
private-stream-1 (0xBD) substreams (AC-3 0x80-0x87, DTS 0x88-0x8F, LPCM
0xA0-0xAF with their 1-4 byte substream preambles; an AC-3 or DTS track
takes its rate and channels from its first frame).  Video codec is
sniffed from the ES (H.264 NALs vs MPEG-2 sequence headers).  Exposes
the same interface as TSDemuxer: tracks / duration / packets() / seek()
/ close().
"""
from __future__ import annotations

import os
from typing import Optional

from ..core.buffer import Buffer, FrameType
from ..utils.logging import log
from .common import (DemuxError, TrackInfo, read_audio_header,
                     read_mpeg2_header, read_stream_rate, read_vui_sar)

PACK_START = 0xBA
SYSTEM_HDR = 0xBB
PADDING = 0xBE
PRIVATE1 = 0xBD
PROGRAM_END = 0xB9


def probe_is_ps(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    return head[:4] == b"\x00\x00\x01\xba"


def _pts_from(b: bytes, off: int) -> int:
    return (((b[off] >> 1) & 7) << 30) | (b[off + 1] << 22) \
        | ((b[off + 2] >> 1) << 15) | (b[off + 3] << 7) \
        | (b[off + 4] >> 1)


class PSDemuxer:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.size = os.path.getsize(path)
        self.tracks: list = []
        self.duration = 0
        self._sid_to_track: dict = {}
        self._scan()

    # -- low-level walk ----------------------------------------------------
    def _pes_iter(self, start_byte=0, with_meta=False):
        """Yield (stream_id, substream_id|None, pts|None, payload[,
        lpcm_header_byte]) — the meta slot carries byte 5 of a DVD LPCM
        substream preamble (quant/rate/channels, declpcm.c layout)."""
        f = self.f
        f.seek(start_byte)
        buf = b""
        pos = 0
        while True:
            if len(buf) - pos < 6:
                chunk = f.read(1 << 16)
                if not chunk:
                    return
                buf = buf[pos:] + chunk
                pos = 0
                continue
            idx = buf.find(b"\x00\x00\x01", pos)
            if idx < 0 or idx + 4 > len(buf):
                pos = max(pos, len(buf) - 3)
                chunk = f.read(1 << 16)
                if not chunk:
                    return
                buf = buf[pos:] + chunk
                pos = 0
                continue
            sid = buf[idx + 3]
            if sid == PACK_START:
                # MPEG-2 pack: 10 bytes + stuffing; MPEG-1: 8 bytes
                if idx + 5 > len(buf):
                    pos = idx
                    buf = buf[pos:] + (f.read(1 << 16) or b"")
                    pos = 0
                    continue
                if (buf[idx + 4] >> 6) == 1:          # MPEG-2 '01'
                    if idx + 14 > len(buf):
                        buf = buf[idx:] + (f.read(1 << 16) or b"")
                        idx = 0
                    stuff = buf[idx + 13] & 7
                    pos = idx + 14 + stuff
                else:                                 # MPEG-1 '0010'
                    pos = idx + 12
                continue
            if sid == PROGRAM_END:
                pos = idx + 4
                continue
            if sid < 0xBB:                            # stray start code
                pos = idx + 4
                continue
            # PES with explicit length
            while idx + 6 > len(buf):
                chunk = f.read(1 << 16)
                if not chunk:
                    return
                buf += chunk
            plen = (buf[idx + 4] << 8) | buf[idx + 5]
            end = idx + 6 + plen
            while end > len(buf):
                chunk = f.read(1 << 16)
                if not chunk:
                    return
                buf += chunk
            body = buf[idx + 6:end]
            pos = end
            if sid in (SYSTEM_HDR, PADDING) or not body:
                continue
            pts, payload = self._parse_pes_body(body)
            sub = None
            meta = None
            if sid == PRIVATE1 and payload:
                sub = payload[0]
                if 0x80 <= sub <= 0x8F:       # AC-3, DTS: 3 more bytes
                    payload = payload[4:]
                elif 0xA0 <= sub <= 0xAF:             # LPCM: 6 more bytes
                    if len(payload) > 5:
                        meta = payload[5]
                    payload = payload[7:]
                else:
                    payload = payload[1:]
            if with_meta:
                yield sid, sub, pts, payload, meta
            else:
                yield sid, sub, pts, payload

    @staticmethod
    def _parse_pes_body(body: bytes):
        """→ (pts | None, es payload). Handles MPEG-2 and MPEG-1 PES."""
        if len(body) >= 3 and (body[0] >> 6) == 2:     # MPEG-2 PES
            flags = body[1]
            hlen = body[2]
            pts = None
            if flags & 0x80 and len(body) >= 8:
                pts = _pts_from(body, 3)
            return pts, body[3 + hlen:]
        # MPEG-1: skip stuffing, optional STD, then PTS/DTS marker
        i = 0
        while i < len(body) and body[i] == 0xFF:
            i += 1
        if i + 1 < len(body) and (body[i] >> 6) == 1:  # STD buffer bits
            i += 2
        if i + 4 < len(body) and (body[i] >> 4) in (2, 3):
            pts = _pts_from(body, i)
            i += 5 if (body[i] >> 4) == 2 else 10
            return pts, body[i:]
        if i < len(body) and body[i] == 0x0F:
            i += 1
        return None, body[i:]

    # -- scan --------------------------------------------------------------
    def _scan(self):
        seen: dict = {}
        first_pts: dict = {}
        last_pts: dict = {}
        lpcm_hdrs: dict = {}
        n = 0
        for sid, sub, pts, payload, meta in self._pes_iter(with_meta=True):
            n += 1
            if n > 4000 and seen:
                break
            key = (sid, sub)
            if key not in seen:
                seen[key] = bytearray()
            if meta is not None and key not in lpcm_hdrs:
                lpcm_hdrs[key] = meta
            if len(seen[key]) < (1 << 17):
                seen[key] += payload
            if pts is not None:
                first_pts.setdefault(key, pts)
                last_pts[key] = pts
        if not seen:
            raise DemuxError("no PES streams in program stream")

        def classify(key, es):
            sid, sub = key
            if 0xE0 <= sid <= 0xEF:
                if b"\x00\x00\x01\xb3" in es[:4096]:
                    return "video", "mpeg2"
                return "video", "h264"
            if 0xC0 <= sid <= 0xDF:
                return "audio", "mp2"
            if sub is not None and 0x80 <= sub <= 0x87:
                return "audio", "ac3"
            if sub is not None and 0x88 <= sub <= 0x8F:
                return "audio", "dts"
            if sub is not None and 0xA0 <= sub <= 0xAF:
                return "audio", "lpcm"
            if sub is not None and 0x20 <= sub <= 0x3F:
                return "subtitle", "vobsub"   # DVD subpicture streams
            return None, None

        # DVD LPCM audio frame header (declpcm.c:410 role): byte 5 of the
        # substream preamble carries quant/rate/channels
        self._lpcm_hdr = {}
        for key, hdr in lpcm_hdrs.items():
            quant = (hdr >> 6) & 3
            rate = (hdr >> 4) & 3
            ch = (hdr & 7) + 1
            self._lpcm_hdr[key] = {
                "bits": {0: 16, 1: 20, 2: 24}.get(quant, 16),
                "rate": {0: 48000, 1: 96000, 2: 44100,
                         3: 32000}.get(rate, 48000),
                "channels": ch}

        ordered = sorted(seen.items(),
                         key=lambda kv: 0 if 0xE0 <= kv[0][0] <= 0xEF
                         else 1)
        for key, es in ordered:
            kind, codec = classify(key, bytes(es))
            if kind is None:
                continue
            ti = TrackInfo(kind=kind, codec=codec)
            if codec == "lpcm" and key in self._lpcm_hdr:
                h = self._lpcm_hdr[key]
                ti.sample_rate = h["rate"]
                ti.channels = h["channels"]
                ti.extradata = bytes([h["bits"]])
            elif codec in ("ac3", "dts"):
                read_audio_header(ti, es, "ps")
            self._sid_to_track[key] = len(self.tracks)
            self.tracks.append(ti)
        # the head scan only covers the first few seconds of a real VOB;
        # parse the file tail for each stream's final PTS so duration is
        # the true span (HandBrake's stream.c duration probe does the same)
        if self.size > (1 << 21):
            tail_seen = 0
            for sid, sub, pts, _payload in self._pes_iter(
                    self.size - (1 << 21)):
                if pts is not None and (sid, sub) in first_pts:
                    if pts >= first_pts[(sid, sub)]:
                        last_pts[(sid, sub)] = pts
                tail_seen += 1
                if tail_seen > 40000:
                    break
        spans = [last_pts[k] - first_pts[k] for k in first_pts
                 if k in last_pts and last_pts[k] >= first_pts[k]]
        self.duration = max(spans) if spans else 0
        self._fill_video_info()

    def _fill_video_info(self):
        vids = [i for i, t in enumerate(self.tracks) if t.kind == "video"]
        if not vids:
            return
        ti = self.tracks[vids[0]]
        es = bytearray()
        for trk, buf in self.packets():
            if trk == vids[0] and buf.data:
                es += buf.data
                if len(es) > (1 << 18):
                    break
        if ti.codec == "h264":
            where = "ps: stream {:#04x}".format(next(
                k[0] for k, v in self._sid_to_track.items() if v == vids[0]))
            try:
                from ..codecs.h264.bits import ebsp_to_rbsp, split_annexb
                from ..codecs.h264.syntax import SPS
                for nal in split_annexb(bytes(es)):
                    if (nal[0] & 0x1F) == 7:
                        sps = SPS.parse(ebsp_to_rbsp(nal[1:]))
                        ti.width = sps.width
                        ti.height = sps.height
                        break
            except (IndexError, ValueError) as e:
                log(f"{where}: the h264 SPS gives no picture size "
                    f"({e or 'cut short'}); the track keeps 0x0")
            # the rate the stream states (the reference labels every
            # H.264 track 30000/1001)
            ti.frame_rate = (30000, 1001)
            read_stream_rate(ti, es, where)
            read_vui_sar(ti, es, "ps")
        elif ti.codec == "mpeg2":
            # size, pixel aspect and rate from the sequence header (the
            # reference reads the size alone and labels every track
            # 30000/1001)
            read_mpeg2_header(ti, es, "ps")
        if ti.frame_rate is None:
            ti.frame_rate = (30000, 1001)

    # -- packet iteration --------------------------------------------------
    def packets(self, start_state=None):
        """Iterate (track, Buffer): one Buffer per PES payload, durations
        inferred by one-packet lookahead (same policy as TSDemuxer)."""
        held = {}
        last_dur = {}
        for sid, sub, pts, payload in self._pes_iter():
            key = (sid, sub)
            trk = self._sid_to_track.get(key)
            if trk is None or not payload:
                continue
            b = Buffer(data=payload, pts=pts)
            b.track_kind = self.tracks[trk].kind
            if b.track_kind == "video":
                b.frametype = FrameType.KEY
            if b.track_kind == "subtitle":
                # SPUs carry their own display window; holding them for
                # duration lookahead would delay a lone subpicture to EOF
                yield trk, b
                continue
            prev = held.get(trk)
            if prev is not None:
                if prev.pts is not None and b.pts is not None \
                        and b.pts > prev.pts:
                    prev.duration = b.pts - prev.pts
                    prev.stop = prev.pts + prev.duration
                    last_dur[trk] = prev.duration
                elif last_dur.get(trk):
                    prev.duration = last_dur[trk]
                    if prev.pts is not None:
                        prev.stop = prev.pts + prev.duration
                yield trk, prev
            held[trk] = b
        for trk, prev in held.items():
            if last_dur.get(trk) and prev.pts is not None:
                prev.duration = last_dur[trk]
                prev.stop = prev.pts + prev.duration
            yield trk, prev

    def stream_track(self, stream_id: int, substream=None):
        """The index of the track of PES stream ``stream_id`` (of private
        stream 1's ``substream``), or None where it has no track."""
        return self._sid_to_track.get((stream_id, substream))

    def seek(self, pts):
        return None                      # restart from byte 0 (linear)

    def close(self):
        self.f.close()
