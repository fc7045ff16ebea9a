"""Video decoder registry — the decavcodec.c "one work object, many
codecs" role (SURVEY.md §2.3). Each decoder consumes compressed packet
Buffers and yields raw-frame Buffers with propagated timing.

The port has the raw-video decoder (y4m sources) and the H.264 decoder
(the native ``hbdec264.cpp``, through ``h264/native_decoder.py``): every
other codec raises NotImplementedError, since its decoder is a later
slice.  Unlike the reference, the H.264 decoder has no fallback to a
pure-Python decoder: a native library that does not build raises.
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


class RawVideoDecoder(VideoDecoder):
    """Identity: sources like y4m already yield raw frames."""

    def feed(self, buf: Buffer) -> list:
        return [buf] if buf.planes is not None else []


def create_video_decoder(codec: str, extradata: bytes = b"",
                         width: int = 0, height: int = 0) -> VideoDecoder:
    if codec == "rawvideo":
        return RawVideoDecoder()
    if codec == "h264":
        return H264VideoDecoder(extradata)
    raise NotImplementedError(
        f"no decoder for codec {codec!r} in the port yet (raw video and "
        f"H.264 only)")
