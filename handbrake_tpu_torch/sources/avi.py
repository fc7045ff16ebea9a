"""AVI (RIFF) demuxer — the container OpenCV/cameras write MJPEG into.

Role of the reference's libavformat AVI path consumed through stream.c's
ffmpeg_open (stream.c:279): walk RIFF hdrl (avih/strl) for stream types
and rates, then iterate movi chunks ('NNdc'/'NNwb') as packets.  Only the
structures HandBrake actually consumes are implemented: video (MJPG/raw)
and PCM audio tracks, idx1 ignored (sequential read).

The port also reads MPEG-4 part 2 video (XVID, DIVX, DX50, FMP4, MP4V),
which libavcodec decodes.  AVI keeps one timestamp a chunk, in decode
order; with B-frames the demuxer gives each VOP its display time, read
from the VOP coding types, holding an anchor back until the next one is
seen (the reference reads no MPEG-4 in AVI).  A packed bitstream
(DivX's P-VOP and B-VOP in one chunk, then a chunk with an empty VOP)
leaves a chunk's time to two VOPs, so it is refused by name.
"""
from __future__ import annotations

import struct
from fractions import Fraction

from ..core.buffer import Buffer
from ..utils.logging import log
from .common import CLOCK, DemuxError, TrackInfo

_VID_CODECS = {b"MJPG": "mjpeg", b"mjpg": "mjpeg", b"\x00\x00\x00\x00": "rawvideo",
               b"XVID": "mpeg4", b"DIVX": "mpeg4", b"DX50": "mpeg4",
               b"FMP4": "mpeg4", b"MP4V": "mpeg4"}


def _vop_is_b(data: bytes) -> bool:
    """An MPEG-4 part 2 chunk whose first VOP is a B-VOP
    (vop_coding_type 2)."""
    i = data.find(b"\x00\x00\x01\xb6")
    return 0 <= i < len(data) - 4 and data[i + 4] >> 6 == 2


class _DisplayOrder:
    """One MPEG-4 track's chunks in decode order, each stamped with the
    decode-order frame time, restamped with display times: a B-VOP shows
    at the next free time and an anchor after the B-VOPs that follow it,
    so each anchor is held until the next one arrives."""

    def __init__(self):
        self.times, self.held = [], []

    def push(self, item) -> list:
        b = item[1]
        if b.data.count(b"\x00\x00\x01\xb6") > 1:
            raise DemuxError("mpeg4 in AVI: a packed bitstream (several "
                             "VOPs in one chunk) is not supported")
        self.times.append((b.pts, b.duration))
        out = []
        if not _vop_is_b(b.data) and self.held:
            out = self.flush()
        self.held.append(item)
        return out

    def flush(self) -> list:
        held, self.held = self.held, []
        for _trk, b in held[1:] + held[:1]:
            b.pts, b.duration = self.times.pop(0)
            b.stop = b.pts + b.duration
        return held


# The port also lists MPEG audio (WAVEFORMATEX tag 0x50, "mp2"; 0x55,
# "mp3"), AC-3 (0x2000) and DTS (0x2001) tracks, which the reference lists
# as "unknown"; any other tag but PCM stays "unknown" and is logged.  Such
# a track's chunks carry timestamps as libavformat's avidec gives them:
# where the stream header's dwSampleSize is 0 a chunk is one frame, at
# dwScale/dwRate seconds a chunk; else the bytes before a chunk at the
# format's nAvgBytesPerSec.  The job cuts the chunks into whole frames.
_AUD_CODECS = {0x50: "mp2", 0x55: "mp3", 0x2000: "ac3", 0x2001: "dts"}


def probe_is_avi(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(12)
    return len(head) == 12 and head[:4] == b"RIFF" and head[8:12] == b"AVI "


class AVIDemuxer:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.tracks = []
        self._stream_map = {}      # avi stream index → track index
        self._rates = {}           # avi stream index → Fraction fps
        # avi stream index → (dwScale, dwRate, dwSampleSize) of a sound
        # stream, then its nAvgBytesPerSec where it is framed
        self._clock = {}
        self._movi = None          # (offset, size)
        self.duration = 0
        self.chapters = []
        self._parse()

    def _parse(self):
        f = self.f
        riff, size, fourcc = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or fourcc != b"AVI ":
            raise DemuxError("not an AVI")
        end = 8 + size
        self._walk(12, end, None)
        if self._movi is None or not self.tracks:
            raise DemuxError("no movi/streams in AVI")

    def _walk(self, off, end, ctx):
        f = self.f
        stream_idx = [len(self._stream_map)]
        while off + 8 <= end:
            f.seek(off)
            cid, csz = struct.unpack("<4sI", f.read(8))
            body = off + 8
            if cid == b"LIST":
                ltype = f.read(4)
                if ltype == b"movi":
                    self._movi = (body + 4, csz - 4)
                else:
                    self._walk(body + 4, body + csz, ltype)
            elif cid == b"strh":
                data = f.read(csz)
                fcc_type = data[0:4]
                handler = data[4:8]
                scale, rate = struct.unpack("<II", data[20:28])
                length = struct.unpack("<I", data[32:36])[0]
                sidx = len(self._stream_map) + len(
                    [1 for t in self.tracks if False])
                sidx = self._next_sidx = getattr(self, "_next_sidx", 0)
                if fcc_type == b"vids":
                    codec = _VID_CODECS.get(handler, None)
                    if codec is None:
                        codec = _VID_CODECS.get(handler.upper(), "unknown")
                    fps = Fraction(rate, scale) if scale else Fraction(25, 1)
                    ti = TrackInfo(kind="video", codec=codec,
                                   frame_rate=(fps.numerator,
                                               fps.denominator))
                    self._stream_map[sidx] = len(self.tracks)
                    self._rates[sidx] = fps
                    self.tracks.append(ti)
                    if fps:
                        self.duration = int(length * CLOCK / float(fps))
                elif fcc_type == b"auds":
                    ti = TrackInfo(kind="audio", codec="pcm")
                    self._stream_map[sidx] = len(self.tracks)
                    self._rates[sidx] = Fraction(rate, max(1, scale))
                    self._clock[sidx] = (scale, rate, struct.unpack(
                        "<I", data[44:48])[0] if len(data) >= 48 else 0)
                    self.tracks.append(ti)
                else:
                    self._stream_map[sidx] = -1
                self._next_sidx = sidx + 1
            elif cid == b"strf":
                data = f.read(csz)
                # BITMAPINFOHEADER for the latest video track
                if self.tracks and self.tracks[-1].kind == "video" \
                        and len(data) >= 24:
                    w, h = struct.unpack("<ii", data[4:12])
                    self.tracks[-1].width = w
                    self.tracks[-1].height = abs(h)
                    if self.tracks[-1].codec == "unknown":
                        # the strh handler left blank: biCompression
                        self.tracks[-1].codec = _VID_CODECS.get(
                            data[16:20].upper(), "unknown")
                elif self.tracks and self.tracks[-1].kind == "audio" \
                        and len(data) >= 16:
                    fmt, ch, srate = struct.unpack("<HHI", data[0:8])
                    bits = struct.unpack("<H", data[14:16])[0]
                    t = self.tracks[-1]
                    t.channels = ch
                    t.sample_rate = srate
                    t.codec = ("pcm_s16le" if bits == 16 else "pcm_u8") \
                        if fmt == 1 else _AUD_CODECS.get(fmt, "unknown")
                    sidx = self._next_sidx - 1
                    if t.codec in _AUD_CODECS.values():
                        self._clock[sidx] += struct.unpack(
                            "<I", data[8:12])
                    elif t.codec == "unknown":
                        log(f"avi: stream {sidx}: sound of WAVEFORMATEX tag "
                            f"{fmt:#06x}, which the port neither decodes "
                            f"nor copies; listed as unknown")
            off = body + csz + (csz & 1)

    # -- packets -------------------------------------------------------------
    def packets(self, start_state=None):
        order = {i: _DisplayOrder() for i, t in enumerate(self.tracks)
                 if t.codec == "mpeg4"}
        for trk, b in self._chunks(start_state):
            if trk in order:
                yield from order[trk].push((trk, b))
            else:
                yield trk, b
        for o in order.values():
            yield from o.flush()

    def _chunks(self, start_state=None):
        f = self.f
        off, size = self._movi
        end = off + size
        counts = {}
        sizes = {}                 # bytes of each stream's chunks so far
        pos = off if not start_state else start_state
        while pos + 8 <= end:
            f.seek(pos)
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            cid, csz = struct.unpack("<4sI", hdr)
            pos_next = pos + 8 + csz + (csz & 1)
            if cid == b"LIST":
                pos = pos + 12          # descend into rec  lists
                continue
            try:
                sidx = int(cid[:2])
            except ValueError:
                pos = pos_next
                continue
            kind = cid[2:4]
            trk = self._stream_map.get(sidx, -1)
            if trk < 0 or kind not in (b"dc", b"db", b"wb"):
                pos = pos_next
                continue
            data = f.read(csz)
            n = counts.get(sidx, 0)
            counts[sidx] = n + 1
            ti = self.tracks[trk]
            b = Buffer(data=data)
            b.track_kind = ti.kind
            b.stream_id = trk
            if ti.kind == "video":
                fps = self._rates[sidx]
                b.pts = int(n * CLOCK / float(fps))
                b.dts = b.pts
                b.duration = int((n + 1) * CLOCK / float(fps)) - b.pts
                b.stop = b.pts + b.duration
            else:
                b.pts = self._sound_pts(sidx, n, sizes.get(sidx, 0))
                sizes[sidx] = sizes.get(sidx, 0) + csz
            yield trk, b
            pos = pos_next

    def _sound_pts(self, sidx: int, n: int, before: int):
        """The 90 kHz pts of chunk ``n`` of framed sound stream ``sidx``,
        after ``before`` bytes of it (None for PCM, as the reference)."""
        clock = self._clock.get(sidx, ())
        if len(clock) < 4:
            return None
        scale, rate, sample_size, avg = clock
        if not sample_size and rate:
            return n * CLOCK * scale // rate
        return before * CLOCK // avg if avg else None

    def seek(self, pts):
        return None

    def close(self):
        self.f.close()
