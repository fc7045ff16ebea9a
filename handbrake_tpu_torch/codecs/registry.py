"""Video decoder registry — the decavcodec.c "one work object, many
codecs" role (SURVEY.md §2.3). Each decoder consumes compressed packet
Buffers and yields raw-frame Buffers with propagated timing.

The port has the raw-video decoder (y4m sources), the H.264 decoder
(the native ``hbdec264.cpp``, through ``h264/native_decoder.py``), the
MPEG-2 decoder (host numpy, ``mpeg2.py``), the MJPEG decoder (the native
``hbdecmjpeg.cpp``) and the HEVC and AV1 decoders (host numpy,
``hevc/decoder.py`` and ``av1/decoder.py``).  The libavcodec
personality's codecs raise NotImplementedError (ROADMAP item 1.10).
Unlike the reference, no decoder falls back or drops a frame without a
word: a native library that does not build raises, and so does an MJPEG
frame that does not decode.  An HEVC stream beyond the native decoder's
subset (SAO, scaling lists, CU quadtrees, NxN intra, B slices, ...)
raises ValueError naming the feature; the reference switches such a
stream to libavcodec without a word (``ResilientHEVCDecoder``), which is
item 1.10.  A 10- or 12-bit stream's frames carry their bit depth (the
reference labels them 8-bit).
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


class HEVCVideoDecoder(VideoDecoder):
    def __init__(self, extradata: bytes = b""):
        from .hevc.decoder import HEVCDecoder
        self.dec = HEVCDecoder()
        self._info: dict = {}
        if extradata:
            self._feed_hvcc_config(extradata)

    def _decode(self, data: bytes) -> list:
        """The native decoder; its parsers' assertions, which name the
        feature (``hevc/syntax.py``, ``hevc/decoder.py``), become a
        stated error."""
        try:
            return self.dec.decode(data)
        except AssertionError as e:
            raise ValueError(
                f"hevc: the stream is beyond the native decoder's subset "
                f"({e or 'unsupported syntax'}); decoding it needs the "
                f"libavcodec personality, ROADMAP item 1.10") from e

    def _feed_hvcc_config(self, hvcc: bytes):
        """Parse VPS/SPS/PPS NALs out of an hvcC box payload."""
        if len(hvcc) < 23 or hvcc[0] != 1:
            return
        i = 22
        n_arrays = hvcc[i]
        i += 1
        for _ in range(n_arrays):
            if i + 3 > len(hvcc):
                return
            n_nals = int.from_bytes(hvcc[i + 1:i + 3], "big")
            i += 3
            for _ in range(n_nals):
                ln = int.from_bytes(hvcc[i:i + 2], "big")
                i += 2
                self._decode(b"\x00\x00\x00\x01" + hvcc[i:i + ln])
                i += ln

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        frames = self._decode(buf.data)
        fmt = PIX_FMTS[{8: "yuv420p", 10: "yuv420p10",
                        12: "yuv420p12"}[self.dec.bd]]
        out = []
        for (y, u, v) in frames:
            fb = Buffer(planes=[y, u, v], pix_fmt=fmt).copy_props(buf)
            fb.data = None
            out.append(fb)
        sps = self.dec.sps
        if sps is not None and not self._info:
            self._info = {"width": sps.width - sps.crop_right,
                          "height": sps.height - sps.crop_bottom,
                          "pix_fmt": fmt.name}
        return out

    def info(self) -> dict:
        return dict(self._info)


class AV1VideoDecoder(VideoDecoder):
    def __init__(self, extradata: bytes = b""):
        from .av1.decoder import AV1Decoder
        self.dec = AV1Decoder()
        if extradata and len(extradata) > 4:
            # av1C: 4 config bytes then the sequence header OBU
            self.dec.decode(extradata[4:])

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        out = []
        for (y, u, v) in self.dec.decode(buf.data):
            fb = Buffer(planes=[y.astype("uint8"), u.astype("uint8"),
                                v.astype("uint8")],
                        pix_fmt=PIX_FMTS["yuv420p"]).copy_props(buf)
            fb.data = None
            out.append(fb)
        return out

    def info(self) -> dict:
        if self.dec.seq:
            return {"width": self.dec.seq["width"],
                    "height": self.dec.seq["height"],
                    "pix_fmt": "yuv420p"}
        return {}


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
_LATER = {c: "item 1.10 (the libavcodec catalog)" for c in (
    "vp9", "vp8", "theora", "mpeg4", "ffv1", "prores")}


def create_video_decoder(codec: str, extradata: bytes = b"",
                         width: int = 0, height: int = 0) -> VideoDecoder:
    if codec == "mjpeg":
        return MJPEGVideoDecoder(extradata)
    if codec == "h264":
        return H264VideoDecoder(extradata)
    if codec == "hevc":
        return HEVCVideoDecoder(extradata)
    if codec == "av1":
        return AV1VideoDecoder(extradata)
    if codec in ("mpeg2", "mpeg2video"):
        return Mpeg2VideoDecoder(extradata)
    if codec == "rawvideo":
        return RawVideoDecoder()
    if codec in _LATER:
        raise NotImplementedError(
            f"no {codec} decoder in the port yet: ROADMAP {_LATER[codec]}")
    raise ValueError(f"no decoder for codec {codec!r}")
