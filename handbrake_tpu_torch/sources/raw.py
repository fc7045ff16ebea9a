"""Raw sources: YUV4MPEG2 (.y4m) and annex-B elementary streams (.264/.h264).

Y4M is the canonical lossless test/bench input (the reference reads it via
libavformat). The ES reader feeds the H.264 decoder directly, splitting on
access-unit boundaries (first-slice detection via first_mb_in_slice == 0).
"""
from __future__ import annotations

import re
from fractions import Fraction

import numpy as np

from ..core.buffer import (Buffer, FrameType, PIX_FMTS, CLOCK)
from .common import DemuxError, TrackInfo, read_stream_rate, read_vui_sar


class Y4MReader:
    """Uncompressed planar frames; packets() yields raw-frame Buffers."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        header = self.f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise DemuxError("not a y4m file")
        self.width = self.height = 0
        self.rate = Fraction(30000, 1001)
        self.par = (1, 1)
        self.interlaced = False
        cs = "420"
        for tok in header.split()[1:]:
            k, v = tok[0], tok[1:]
            if k == "W":
                self.width = int(v)
            elif k == "H":
                self.height = int(v)
            elif k == "F":
                n, d = v.split(":")
                self.rate = Fraction(int(n), int(d))
            elif k == "A" and ":" in v:
                n, d = v.split(":")
                if int(n) and int(d):
                    self.par = (int(n), int(d))
            elif k == "I":
                self.interlaced = v in ("t", "b")
            elif k == "C":
                cs = v
        m = re.match(r"(\d{3})(p(\d+))?", cs)
        depth = int(m.group(3)) if m and m.group(3) else 8
        sub = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}.get(
            m.group(1) if m else "420", (2, 2))
        name = {(2, 2): "yuv420p", (2, 1): "yuv422p",
                (1, 1): "yuv444p"}[sub]
        if depth > 8:
            name += f"{depth}"
        self.pix_fmt = PIX_FMTS[name]
        self._frame_start = self.f.tell()
        self._bytes_per_frame = self._frame_bytes()
        self.tracks = [TrackInfo(
            kind="video", codec="rawvideo", width=self.width,
            height=self.height, par_num=self.par[0], par_den=self.par[1],
            frame_rate=(self.rate.numerator, self.rate.denominator),
            bit_depth=depth)]
        # count frames by file size (FRAME headers are fixed "FRAME\n")
        import os
        fsize = os.fstat(self.f.fileno()).st_size
        per = self._bytes_per_frame + 6
        self.n_frames = max(0, (fsize - self._frame_start) // per)
        self.duration = int(self.n_frames * CLOCK
                            * self.rate.denominator / self.rate.numerator)

    def _frame_bytes(self) -> int:
        fmt = self.pix_fmt
        bps = 1 if fmt.bit_depth <= 8 else 2
        sw, sh = fmt.subsampling
        cw = (self.width + sw - 1) // sw
        ch = (self.height + sh - 1) // sh
        return bps * (self.width * self.height + 2 * cw * ch)

    def packets(self, start_frame: int = 0):
        fmt = self.pix_fmt
        dt = np.dtype("<u2") if fmt.bit_depth > 8 else np.uint8
        sw, sh = fmt.subsampling
        cw = (self.width + sw - 1) // sw
        ch = (self.height + sh - 1) // sh
        tick = Fraction(CLOCK) / self.rate
        self.f.seek(self._frame_start
                    + start_frame * (self._bytes_per_frame + 6))
        i = start_frame
        while True:
            hdr = self.f.readline()
            if not hdr or not hdr.startswith(b"FRAME"):
                return
            raw = self.f.read(self._bytes_per_frame)
            if len(raw) < self._bytes_per_frame:
                return
            a = np.frombuffer(raw, dt)
            ys = self.width * self.height
            cs = cw * ch
            planes = [a[:ys].reshape(self.height, self.width),
                      a[ys:ys + cs].reshape(ch, cw),
                      a[ys + cs:ys + 2 * cs].reshape(ch, cw)]
            if fmt.bit_depth > 8:
                planes = [p.astype(np.uint16) for p in planes]
            pts = int(i * tick)
            b = Buffer(planes=planes, pix_fmt=fmt, pts=pts,
                       duration=int((i + 1) * tick) - pts,
                       frametype=FrameType.KEY)
            b.stop = pts + b.duration
            yield 0, b
            i += 1

    def seek(self, pts_90k: int) -> int:
        tick = CLOCK * self.rate.denominator / self.rate.numerator
        return max(0, min(self.n_frames - 1, int(pts_90k / tick)))

    def close(self):
        self.f.close()


class AnnexBReader:
    """H.264/HEVC elementary stream → access-unit packets.

    The frame rate is the one the stream's SPS (HEVC: or VPS) states, as
    libavcodec's decoders read it; where it states none, ``fps`` (25 like
    libavformat).  The reader's ``fps``, ``duration`` and every access
    unit's pts follow it (the reference labels every stream ``fps``).
    """

    def __init__(self, path: str, codec: str = "h264",
                 fps: Fraction = Fraction(25, 1)):
        self.path = path
        self.codec = codec
        self.fps = fps
        with open(path, "rb") as f:
            self.data = f.read()
        if b"\x00\x00\x01" not in self.data[:4096]:
            raise DemuxError("no start codes")
        self.aus = self._split_access_units()
        self.n_frames = len(self.aus)
        self.tracks = [TrackInfo(
            kind="video", codec=codec,
            frame_rate=(fps.numerator, fps.denominator))]
        self._probe_geometry()
        self.duration = int(self.n_frames * CLOCK
                            * self.fps.denominator / self.fps.numerator)

    def _probe_geometry(self):
        """Parse the first SPS for dimensions/rate (scan info() role)."""
        from ..codecs.h264.bits import ebsp_to_rbsp, split_annexb
        from ..utils.logging import log
        try:
            for nal in split_annexb(self.data[:1 << 16]):
                if self.codec == "h264" and (nal[0] & 0x1F) == 7:
                    from ..codecs.h264.syntax import SPS
                    sps = SPS.parse(ebsp_to_rbsp(nal[1:]))
                    self.tracks[0].width = sps.width
                    self.tracks[0].height = sps.height
                    break
                if self.codec == "hevc" and ((nal[0] >> 1) & 0x3F) == 33:
                    from ..codecs.hevc.syntax import SPS as HSPS
                    sps = HSPS.parse(ebsp_to_rbsp(nal[2:]))
                    # the picture's size, not the coded size (the
                    # reference takes the coded size, 32-aligned)
                    self.tracks[0].width = sps.width - sps.crop_right
                    self.tracks[0].height = sps.height - sps.crop_bottom
                    break
        except (AssertionError, IndexError, ValueError) as e:
            log(f"annex-B: the {self.codec} SPS gives no picture size "
                f"({e or 'cut short'}); the track keeps 0x0")
        # the rate and pixel aspect of the SPS's VUI (the reference reads
        # neither)
        rate = read_stream_rate(self.tracks[0], self.data[:1 << 16],
                                "annex-B:")
        if rate is not None:
            self.fps = rate
        read_vui_sar(self.tracks[0], self.data[:1 << 16], "annex-B")

    def _split_access_units(self) -> list:
        """Split on slice NALs whose first_mb_in_slice == 0 (H.264) or
        first_slice_segment_in_pic_flag (HEVC)."""
        from ..codecs.h264.bits import split_annexb
        aus = []
        cur = []
        for nal in split_annexb(self.data):
            if not nal:
                continue
            if self.codec == "h264":
                t = nal[0] & 0x1F
                is_slice = t in (1, 5)
                # first_mb_in_slice==0 → ue(v) starts with bit 1
                first = is_slice and len(nal) > 1 and bool(nal[1] & 0x80)
            else:
                t = (nal[0] >> 1) & 0x3F
                is_slice = t <= 21
                first = is_slice and len(nal) > 2 and bool(nal[2] & 0x80)
            if first and any((n[0] & 0x1F if self.codec == "h264"
                              else (n[0] >> 1) & 0x3F) in
                             ((1, 5) if self.codec == "h264"
                              else tuple(range(22))) for n in cur):
                aus.append(cur)
                cur = []
            cur.append(nal)
        if cur:
            aus.append(cur)
        return aus

    def packets(self, start_frame: int = 0):
        tick = Fraction(CLOCK) / self.fps
        for i in range(start_frame, len(self.aus)):
            au = self.aus[i]
            data = b"".join(b"\x00\x00\x00\x01" + n for n in au)
            pts = int(i * tick)
            key = any((n[0] & 0x1F) == 5 for n in au) \
                if self.codec == "h264" else True
            b = Buffer(data=data, pts=pts, dts=pts,
                       duration=int((i + 1) * tick) - pts,
                       frametype=FrameType.KEY if key
                       else FrameType.UNKNOWN)
            b.stop = pts + b.duration
            yield 0, b

    def seek(self, pts_90k: int) -> int:
        tick = CLOCK * self.fps.denominator / self.fps.numerator
        idx = max(0, min(self.n_frames - 1, int(pts_90k / tick)))
        # snap back to IDR
        while idx > 0 and not any((n[0] & 0x1F) == 5 for n in self.aus[idx]):
            idx -= 1
        return idx

    def close(self):
        pass
