"""Video decoder registry — the decavcodec.c "one work object, many
codecs" role (SURVEY.md §2.3). Each decoder consumes compressed packet
Buffers and yields raw-frame Buffers with propagated timing.

The port has the raw-video decoder (y4m sources), the H.264 decoder
(the native ``hbdec264.cpp``, through ``h264/native_decoder.py``), the
MPEG-2 decoder (host numpy, ``mpeg2.py``) and the MJPEG decoder (the
native ``hbdecmjpeg.cpp``).  HEVC and AV1 raise NotImplementedError
(ROADMAP item 1.9), and so do the libavcodec personality's codecs (item
1.10).  Unlike the reference, no decoder falls back or drops a frame
without a word: a native library that does not build raises, and so
does an MJPEG frame that does not decode.
"""
from __future__ import annotations

from ..core.buffer import Buffer, PIX_FMTS


class VideoDecoder:
    """Base: feed(buf) -> list[Buffer(frames)]; flush() at EOF."""

    def feed(self, buf: Buffer) -> list:
        raise NotImplementedError

    def flush(self) -> list:
        return []

    def info(self) -> dict:
        """Geometry/format info once headers are seen (w->info hook)."""
        return {}


class H264VideoDecoder(VideoDecoder):
    def __init__(self, extradata: bytes = b""):
        # universal native decoder (hbdec264.cpp: CAVLC+CABAC, all intra
        # modes / partition shapes, multi-ref, deblock); no fallback
        from .h264.native_decoder import NativeH264Decoder
        self.dec = NativeH264Decoder()
        self._info: dict = {}
        if extradata:
            self._feed_avcc_config(extradata)

    def _feed_avcc_config(self, avcc: bytes):
        """Parse SPS/PPS out of an avcC box payload."""
        if len(avcc) < 7 or avcc[0] != 1:
            return
        i = 5
        nsps = avcc[i] & 0x1F
        i += 1
        for _ in range(nsps):
            ln = int.from_bytes(avcc[i:i + 2], "big")
            i += 2
            self.dec.decode_nal(avcc[i:i + ln])
            i += ln
        npps = avcc[i]
        i += 1
        for _ in range(npps):
            ln = int.from_bytes(avcc[i:i + 2], "big")
            i += 2
            self.dec.decode_nal(avcc[i:i + ln])
            i += ln

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        frames = self.dec.decode(buf.data)
        out = []
        for (y, u, v) in frames:
            fb = Buffer(planes=[y, u, v],
                        pix_fmt=PIX_FMTS["yuv420p"]).copy_props(buf)
            fb.data = None
            out.append(fb)
        if self.dec.sps is not None and not self._info:
            sps = self.dec.sps
            self._info = {"width": sps.width_mbs * 16 - sps.crop_right,
                          "height": sps.height_mbs * 16 - sps.crop_bottom,
                          "pix_fmt": "yuv420p",
                          "vui_timing": sps.vui_timing, "sar": sps.sar}
        return out

    def info(self) -> dict:
        return dict(self._info)


class MJPEGVideoDecoder(VideoDecoder):
    """Motion-JPEG (native hbdecmjpeg.cpp): per-frame baseline JPEG with
    in-stream tables — the decavcodec.c MJPEG personality.  Where the
    reference drops a frame without a word (a header that does not
    parse, a chroma subsampling it does not take, a failed decode), the
    port raises ValueError naming the packet's pts."""

    def __init__(self, extradata: bytes = b""):
        import ctypes

        import numpy as np

        from ..native import get_mjpeg_lib
        self.lib = get_mjpeg_lib()
        self._np = np
        self._ct = ctypes
        self._info: dict = {}

    def _u8p(self, a):
        return a.ctypes.data_as(self._ct.POINTER(self._ct.c_uint8))

    def feed(self, buf: Buffer) -> list:
        np, ct = self._np, self._ct
        if not buf.data:
            return []
        data = np.frombuffer(buf.data, np.uint8)
        w = ct.c_int(); h = ct.c_int(); hs = ct.c_int(); vs = ct.c_int()
        if self.lib.hbdecmjpeg_info(self._u8p(data), data.size,
                                    ct.byref(w), ct.byref(h),
                                    ct.byref(hs), ct.byref(vs)):
            raise ValueError(f"mjpeg: the frame at pts {buf.pts} has no "
                             f"baseline JPEG header")
        W, H = w.value, h.value
        if (hs.value, vs.value) not in ((2, 2), (1, 1), (2, 1)):
            raise ValueError(
                f"mjpeg: the frame at pts {buf.pts} has chroma sampling "
                f"{hs.value}x{vs.value} (4:2:0, 4:2:2 and 4:4:4 only)")
        cw = (W + hs.value - 1) // hs.value
        ch = (H + vs.value - 1) // vs.value
        y = np.empty((H, W), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        if self.lib.hbdecmjpeg_decode(self._u8p(data), data.size,
                                      self._u8p(y), self._u8p(u),
                                      self._u8p(v)):
            raise ValueError(f"mjpeg: the frame at pts {buf.pts} does not "
                             f"decode")
        if (hs.value, vs.value) == (1, 1):       # 4:4:4 → 4:2:0
            u = ((u[0::2, 0::2].astype(np.uint16)
                  + u[1::2, 0::2] + u[0::2, 1::2] + u[1::2, 1::2] + 2)
                 >> 2).astype(np.uint8)
            v = ((v[0::2, 0::2].astype(np.uint16)
                  + v[1::2, 0::2] + v[0::2, 1::2] + v[1::2, 1::2] + 2)
                 >> 2).astype(np.uint8)
        elif (hs.value, vs.value) == (2, 1):     # 4:2:2 → 4:2:0
            u = ((u[0::2].astype(np.uint16) + u[1::2] + 1) >> 1).astype(
                np.uint8)
            v = ((v[0::2].astype(np.uint16) + v[1::2] + 1) >> 1).astype(
                np.uint8)
        if not self._info:
            self._info = {"width": W, "height": H, "pix_fmt": "yuv420p"}
        fb = Buffer(planes=[y, u, v],
                    pix_fmt=PIX_FMTS["yuv420p"]).copy_props(buf)
        fb.data = None
        return [fb]

    def info(self) -> dict:
        return dict(self._info)


class RawVideoDecoder(VideoDecoder):
    """Identity: sources like y4m already yield raw frames."""

    def feed(self, buf: Buffer) -> list:
        return [buf] if buf.planes is not None else []


class Mpeg2VideoDecoder(VideoDecoder):
    """MPEG-2 (codecs/mpeg2.py): streaming ES decode with B-frame
    display-order reorder.  PES pts are PRESENTATION times, so each
    picture keeps the pts of the packet it arrived in — an anchor held
    for reorder is emitted later with its own pts, not the pts of the
    packet that released it."""

    def __init__(self, extradata: bytes = b""):
        from .mpeg2 import Mpeg2Decoder
        self.dec = Mpeg2Decoder()
        if extradata:
            self.dec.feed(bytes(extradata))
        self._info: dict = {}

    def _wrap(self, frames, buf):
        out = []
        # frame duration comes from the sequence-header frame rate, NOT
        # the demux packet delta: with B pictures the packets arrive in
        # decode order, so packet-delta durations are garbage
        # (decavcodec.c:2333 compute_frame_duration role)
        dur = None
        if self.dec.w and self.dec.frame_rate and self.dec.frame_rate[0]:
            fr = self.dec.frame_rate
            dur = int(round(90000 * fr[1] / fr[0]))
        for item in frames:
            (y, u, v), pts = item if len(item) == 2 else (item, None)
            fb = Buffer(planes=[y, u, v],
                        pix_fmt=PIX_FMTS["yuv420p"]).copy_props(buf)
            fb.pts = pts
            if dur:
                fb.duration = dur
            fb.stop = (pts + fb.duration) if pts is not None \
                and fb.duration else None
            fb.data = None
            out.append(fb)
        if self.dec.w and not self._info:
            fr = self.dec.frame_rate
            self._info = {"width": self.dec.w, "height": self.dec.h,
                          "pix_fmt": "yuv420p",
                          "vui_timing": (fr[1], 2 * fr[0]),
                          "sar": (1, 1)}
        return out

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        self.dec.cur_pts = buf.pts
        self.dec.feed(bytes(buf.data))
        return self._wrap(self.dec.get_frames_with_pts(), buf)

    def flush(self) -> list:
        return self._wrap(self.dec.flush_with_pts(),
                          Buffer(track_kind="video"))

    def info(self) -> dict:
        return dict(self._info)


# decoded by a later slice of the port: each names its ROADMAP item
_LATER = {"hevc": "item 1.9 (the HEVC decoder and encoder)",
          "av1": "item 1.9 (the AV1 decoder and encoder)"}
_LATER.update({c: "item 1.10 (the libavcodec catalog)" for c in (
    "vp9", "vp8", "theora", "mpeg4", "ffv1", "prores")})


def create_video_decoder(codec: str, extradata: bytes = b"",
                         width: int = 0, height: int = 0) -> VideoDecoder:
    if codec == "mjpeg":
        return MJPEGVideoDecoder(extradata)
    if codec == "h264":
        return H264VideoDecoder(extradata)
    if codec in ("mpeg2", "mpeg2video"):
        return Mpeg2VideoDecoder(extradata)
    if codec == "rawvideo":
        return RawVideoDecoder()
    if codec in _LATER:
        raise NotImplementedError(
            f"no {codec} decoder in the port yet: ROADMAP {_LATER[codec]}")
    raise ValueError(f"no decoder for codec {codec!r}")
