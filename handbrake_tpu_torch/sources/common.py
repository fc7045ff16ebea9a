"""Source/demuxer common types (reference: libhb/stream.c's probe + title
scan surface, internal.h:320 demux table).

A Demuxer exposes:
  * ``tracks`` — list of TrackInfo (kind, codec, geometry/rate, extradata)
  * ``packets()`` — iterator of (track_index, Buffer) in storage order with
    90 kHz pts/dts/duration (the reader.c clock rebase is done here)
  * ``seek(pts)`` — best-effort keyframe seek (hb_stream_seek analog)
  * ``duration`` — 90 kHz ticks
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.buffer import CLOCK


@dataclasses.dataclass
class TrackInfo:
    kind: str                      # video | audio | subtitle
    codec: str                     # h264 | hevc | av1 | aac | pcm_s16le | ...
    timescale: int = CLOCK
    # video
    width: int = 0
    height: int = 0
    par_num: int = 1
    par_den: int = 1
    frame_rate: Optional[tuple] = None   # (num, den) if known
    bit_depth: int = 8
    # audio
    sample_rate: int = 48000
    channels: int = 2
    # codec config (avcC/hvcC/esds-ASC payload etc., codec-native form)
    extradata: bytes = b""
    language: str = "und"
    name: str = ""
    nal_length_size: int = 4       # for length-prefixed video samples


def to_90k(v: int, timescale: int) -> int:
    return v * CLOCK // timescale


class DemuxError(Exception):
    pass
