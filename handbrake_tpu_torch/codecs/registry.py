"""Video decoder registry — the decavcodec.c "one work object, many
codecs" role (SURVEY.md §2.3). Each decoder consumes compressed packet
Buffers and yields raw-frame Buffers with propagated timing.

The port has the raw-video decoder only (y4m sources): every other codec
raises NotImplementedError, since its decoder is a later slice.
"""
from __future__ import annotations

from ..core.buffer import Buffer


class VideoDecoder:
    """Base: feed(buf) -> list[Buffer(frames)]; flush() at EOF."""

    def feed(self, buf: Buffer) -> list:
        raise NotImplementedError

    def flush(self) -> list:
        return []

    def info(self) -> dict:
        """Geometry/format info once headers are seen (w->info hook)."""
        return {}


class RawVideoDecoder(VideoDecoder):
    """Identity: sources like y4m already yield raw frames."""

    def feed(self, buf: Buffer) -> list:
        return [buf] if buf.planes is not None else []


def create_video_decoder(codec: str, extradata: bytes = b"",
                         width: int = 0, height: int = 0) -> VideoDecoder:
    if codec == "rawvideo":
        return RawVideoDecoder()
    raise NotImplementedError(
        f"no decoder for codec {codec!r} in the port yet (raw video only)")
