"""Video decoder registry — the decavcodec.c "one work object, many
codecs" role (SURVEY.md §2.3). Each decoder consumes compressed packet
Buffers and yields raw-frame Buffers with propagated timing.

The port has the raw-video decoder (y4m sources), the H.264 decoder
(the native ``hbdec264.cpp``, through ``h264/native_decoder.py``), the
MPEG-2 decoder (host numpy, ``mpeg2.py``), the MJPEG decoder (the native
``hbdecmjpeg.cpp``) and the HEVC and AV1 decoders (host numpy,
``hevc/decoder.py`` and ``av1/decoder.py``).  VP8/9, Theora, MPEG-4
part 2, FFV1 and ProRes decode through the system libavcodec
(``avcodec.py``, ``AVFallbackVideoDecoder``), each frame with its own
packet's timestamps; where the library is missing they raise ValueError
naming the codec and what was not found.  Unlike the reference, no
decoder falls back or drops a frame without a word: a native library
that does not build raises, and so does an MJPEG frame that does not
decode.  An HEVC stream beyond the native decoder's subset (SAO, scaling
lists, CU quadtrees, NxN intra, B slices, ...) switches to libavcodec,
with a log line, if the native decoder says so before its first frame:
the packets seen so far are replayed from the first one
(``ResilientHEVCDecoder``).  After a frame, or without the library, it
raises ValueError naming the feature (the reference switches at any
error, and after a frame starts libavcodec mid-stream).  A 10- or
12-bit stream's frames carry their bit depth (the reference labels them
8-bit).

A resume may skip the decode ahead of a keyframe: ``random_access``
says whether a fresh decoder fed from a packet on gives the frames from
the one that packet carries on as this decoder does (an H.264 IDR; an
MPEG-2 I picture after a sequence header whose quantiser matrices this
decoder holds; every y4m frame), and ``prime`` takes the
stream headers of a packet whose decode is skipped.  The others give no
such packet, and a resume decodes them from the start.
"""
from __future__ import annotations

from ..core.buffer import Buffer, PIX_FMTS


def _start_codes(data: bytes):
    """(offset of the byte after each 00 00 01, that byte) in order."""
    i = data.find(b"\x00\x00\x01")
    while 0 <= i < len(data) - 3:
        yield i + 3, data[i + 3]
        i = data.find(b"\x00\x00\x01", i + 3)


class VideoDecoder:
    """Base: feed(buf) -> list[Buffer(frames)]; flush() at EOF."""

    def feed(self, buf: Buffer) -> list:
        raise NotImplementedError

    def random_access(self, buf: Buffer) -> bool:
        """Whether a fresh decoder fed from this packet on gives every
        frame from the one it carries on as this one does (asked before
        the packet is fed)."""
        return False

    def prime(self, buf: Buffer) -> None:
        """A packet whose decode a resume skips: keep the stream headers
        it carries."""

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

    def random_access(self, buf: Buffer) -> bool:
        """An IDR access unit: it resets every reference, and the
        decoder gives each picture out as it is decoded."""
        for _i, b in _start_codes(bytes(buf.data or b"")):
            if b & 0x1F in (1, 5):          # the first slice
                return b & 0x1F == 5
        return False

    def prime(self, buf: Buffer) -> None:
        """The sequence and picture parameter sets, in stream order."""
        data = bytes(buf.data or b"")
        sc = list(_start_codes(data))
        for k, (i, b) in enumerate(sc):
            if b & 0x1F in (7, 8):
                end = sc[k + 1][0] - 3 if k + 1 < len(sc) else len(data)
                self.dec.send_nal(data[i:end].rstrip(b"\x00"))

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


def _hvcc_nals(hvcc: bytes) -> list:
    """The VPS/SPS/PPS NAL units of an hvcC box payload, each with an
    annex-B start code."""
    out = []
    if len(hvcc) < 23 or hvcc[0] != 1:
        return out
    i = 22
    n_arrays = hvcc[i]
    i += 1
    for _ in range(n_arrays):
        if i + 3 > len(hvcc):
            return out
        n_nals = int.from_bytes(hvcc[i + 1:i + 3], "big")
        i += 3
        for _ in range(n_nals):
            ln = int.from_bytes(hvcc[i:i + 2], "big")
            i += 2
            out.append(b"\x00\x00\x00\x01" + hvcc[i:i + ln])
            i += ln
    return out


class BeyondSubset(ValueError):
    """The native HEVC decoder's stated refusal of a feature it does not
    implement (its parsers' assertions name the feature)."""

    def __init__(self, e):
        from . import avcodec
        gone = avcodec.missing()
        super().__init__(
            f"hevc: the stream is beyond the native decoder's subset "
            f"({e or 'unsupported syntax'}); decoding it needs the "
            f"libavcodec personality (ROADMAP item 1.10)"
            + (f", and libavcodec is missing ({gone})" if gone else ""))


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
            raise BeyondSubset(e) from e

    def _feed_hvcc_config(self, hvcc: bytes):
        """Parse VPS/SPS/PPS NALs out of an hvcC box payload."""
        for nal in _hvcc_nals(hvcc):
            self._decode(nal)

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

    def random_access(self, buf: Buffer) -> bool:
        return buf.planes is not None


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
                          "sar": self.dec.sar or (1, 1)}
        return out

    def random_access(self, buf: Buffer) -> bool:
        """The packet's first picture is an I picture after a sequence
        header in the same packet, and a quantiser matrix that header
        does not load is the default here too (this decoder keeps a
        matrix a header does not load; a fresh one has the default).
        Pictures after it in display order refer to nothing before it;
        the B pictures ahead of it in display order (an open GOP) are
        the caller's to drop."""
        import numpy as np

        from .mpeg2 import DEFAULT_INTRA_MATRIX, I_TYPE
        data = bytes(buf.data or b"")
        seq = None
        for i, code in _start_codes(data):
            if code == 0xB3:
                seq = i + 1
            elif code == 0x00:
                if seq is None or i + 2 >= len(data) \
                        or (data[i + 2] >> 3) & 7 != I_TYPE:
                    return False
                break
        else:
            return False
        # 62 bits of header, then load_intra_quantiser_matrix, its 64
        # bytes, and load_non_intra_quantiser_matrix
        if seq + 72 > len(data):
            return False
        load_intra = (data[seq + 7] >> 1) & 1
        load_non_intra = data[seq + 71 if load_intra else seq + 7] & 1
        return ((load_intra or np.array_equal(self.dec.intra_m,
                                              DEFAULT_INTRA_MATRIX))
                and (load_non_intra or bool((self.dec.nonintra_m
                                             == 16).all())))

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


class AVFallbackVideoDecoder(VideoDecoder):
    """libavcodec video personality (decavcodec.c:1709 role) for the
    codecs without native decoders: VP8/VP9, Theora, MPEG-4 ASP, FFV1,
    ProRes, and an HEVC stream beyond the native subset.  Each packet
    goes in with its pts and each frame comes out with its own, carrying
    the timing of the packet it came in; the reference stamps a frame
    with the packet fed when it came out, so behind B-frames every frame
    takes the next packet's pts and the one flushed at the end none."""

    def __init__(self, codec: str, extradata: bytes = b"",
                 width: int = 0, height: int = 0):
        from . import avcodec
        avcodec.require(f"{codec}: decoding it", ValueError)
        self.dec = avcodec.AVVideoDecoder(
            codec, extradata=bytes(extradata or b""), width=width,
            height=height)
        self._info: dict = {}
        self._fed: dict = {}          # pts -> its packet, until its frame

    def _wrap(self, frames):
        out = []
        for (y, u, v), pts in frames:
            if not self._info:
                self._info = {"width": y.shape[1], "height": y.shape[0],
                              "pix_fmt": "yuv420p"}
            fb = Buffer(planes=[y, u, v], pix_fmt=PIX_FMTS["yuv420p"])
            pkt = self._fed.pop(pts, None)
            if pkt is not None:
                fb.copy_props(pkt)
            if pts is not None:
                # frames come out in display order: a packet fed with an
                # earlier pts that has not come out never will (an
                # invisible VP8/VP9 alt-ref, a frame the decoder dropped)
                for p in [p for p in self._fed if p < pts]:
                    del self._fed[p]
            fb.pts = pts
            fb.data = None
            out.append(fb)
        return out

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        if buf.pts is not None:
            self._fed[buf.pts] = buf
        return self._wrap(self.dec.decode(bytes(buf.data), buf.pts))

    def flush(self) -> list:
        return self._wrap(self.dec.flush())

    def info(self) -> dict:
        return dict(self._info)


class ResilientHEVCDecoder(VideoDecoder):
    """HEVC input of any profile the system libavcodec takes: the native
    decoder (``hevc/decoder.py``) decodes the subset it implements.
    Where it states that the stream is beyond that subset before it has
    emitted a frame, the decoder switches to libavcodec, says so in the
    log, and replays the packets seen so far from the first one.  Where
    it says so after a frame, the switch would start libavcodec
    mid-stream, so the error is raised, naming the frame."""

    def __init__(self, extradata: bytes = b""):
        self.extradata = bytes(extradata or b"")
        self._buffered: list = []        # packets until the first frame
        self._frames = 0                 # frames out of the native decoder
        self.inner = None
        try:
            self.inner = HEVCVideoDecoder(self.extradata)
        except BeyondSubset as e:
            self._switch(e)

    def _switch(self, why):
        from ..utils.logging import log
        log(f"hevc: switching to the libavcodec decoder before the first "
            f"frame, replaying {len(self._buffered)} packet(s): {why}")
        self.inner = AVFallbackVideoDecoder("hevc")
        hdrs = b"".join(_hvcc_nals(self.extradata))
        if hdrs:
            # the packets reach the decoder in annex-B, so the parameter
            # sets go in that way, not as an hvcC
            self.inner.feed(Buffer(track_kind="video", data=hdrs))

    def _native(self, call, buf=None):
        try:
            return call()
        except BeyondSubset as e:
            if self._frames:
                at = "at the end of the stream" if buf is None else \
                    f"in the packet at pts {buf.pts}"
                raise ValueError(
                    f"hevc: frame {self._frames + 1} ({at}) is beyond the "
                    f"native decoder's subset after {self._frames} frames "
                    f"decoded natively; libavcodec would start mid-stream "
                    f"there, so the job stops ({e})") from e
            self._switch(e)
            out = []
            for b in self._buffered:
                out += self.inner.feed(b)
            self._buffered.clear()
            return out if buf is not None else out + self.inner.flush()

    def feed(self, buf: Buffer) -> list:
        if isinstance(self.inner, AVFallbackVideoDecoder):
            return self.inner.feed(buf)
        if not self._frames:
            self._buffered.append(buf)
        out = self._native(lambda: self.inner.feed(buf), buf)
        if not isinstance(self.inner, AVFallbackVideoDecoder):
            self._frames += len(out)
            if out:
                self._buffered.clear()
        return out

    def flush(self) -> list:
        return self._native(self.inner.flush)

    def info(self) -> dict:
        return self.inner.info()


_AV_VIDEO = ("vp9", "vp8", "theora", "mpeg4", "ffv1", "prores")


def create_video_decoder(codec: str, extradata: bytes = b"",
                         width: int = 0, height: int = 0) -> VideoDecoder:
    if codec == "mjpeg":
        return MJPEGVideoDecoder(extradata)
    if codec == "h264":
        return H264VideoDecoder(extradata)
    if codec == "hevc":
        from .avcodec import available
        if available():
            return ResilientHEVCDecoder(extradata)
        return HEVCVideoDecoder(extradata)
    if codec == "av1":
        return AV1VideoDecoder(extradata)
    if codec in ("mpeg2", "mpeg2video"):
        return Mpeg2VideoDecoder(extradata)
    if codec == "rawvideo":
        return RawVideoDecoder()
    if codec in _AV_VIDEO:
        return AVFallbackVideoDecoder(codec, extradata,
                                      width=width, height=height)
    raise ValueError(f"no decoder for codec {codec!r}")
