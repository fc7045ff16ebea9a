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


def read_mpeg2_header(ti: TrackInfo, es: bytes, where: str):
    """An MPEG-2 track's size, pixel aspect and frame rate from the
    first sequence header in ``es`` (``codecs/mpeg2.sequence_info``).
    Where there is none, or it gives no aspect, the track keeps what it
    has (1:1, and the caller's 30000/1001) and the log says so."""
    from ..codecs.mpeg2 import sequence_info
    from ..utils.logging import log
    info = sequence_info(bytes(es))
    if info is None:
        log(f"{where}: no MPEG-2 sequence header in the first {len(es)} "
            f"bytes of the video; the track keeps {ti.par_num}:{ti.par_den} "
            f"and the default frame rate")
        return
    ti.width, ti.height = info["width"], info["height"]
    ti.frame_rate = info["frame_rate"]
    if info["sar"] is None:
        log(f"{where}: the MPEG-2 sequence header gives no pixel aspect; "
            f"the track keeps {ti.par_num}:{ti.par_den}")
    else:
        ti.par_num, ti.par_den = info["sar"]


def vui_sar(ti: TrackInfo, data: bytes, where: str):
    """The pixel aspect of an H.264 or HEVC track's SPS VUI (``data``: an
    avcC/hvcC payload or an annex-B stream), or None.  An SPS that cannot
    be read gives None, with a log line."""
    from ..codecs.vui import stream_vui
    from ..utils.logging import log
    try:
        return stream_vui(ti.codec, bytes(data))["sar"]
    except ValueError as e:
        log(f"{where}: {e}; the track keeps {ti.par_num}:{ti.par_den}")
        return None


def read_stream_rate(ti: TrackInfo, data: bytes, where: str):
    """An H.264 or HEVC track's frame rate from the timing its stream
    states (``codecs/vui.stream_rate``; ``data``: an avcC/hvcC payload
    or an annex-B stream), set on ``ti`` and returned as a Fraction.
    Where the stream states none, states a zero term, or its SPS or VPS
    cannot be read, the track keeps its ``frame_rate`` and None is
    returned.  One log line either way, ``where`` naming the track."""
    from ..codecs.vui import stream_rate
    from ..utils.logging import log
    keep = "{}/{}".format(*ti.frame_rate) if ti.frame_rate else "no rate"
    try:
        rate, source = stream_rate(ti.codec, bytes(data))
    except ValueError as e:
        log(f"{where} {ti.codec}: {e}; the track keeps {keep} fps")
        return None
    if rate is None:
        log(f"{where} {ti.codec}: {source}; the track keeps {keep} fps")
        return None
    ti.frame_rate = (rate.numerator, rate.denominator)
    log(f"{where} {ti.codec} {rate.numerator}/{rate.denominator} fps from "
        f"{source}")
    return rate


def read_vui_sar(ti: TrackInfo, data: bytes, where: str):
    """The track's pixel aspect from its SPS's VUI where it signals one,
    for a track whose container gives none."""
    sar = vui_sar(ti, data, where)
    if sar is not None:
        ti.par_num, ti.par_den = sar


def read_audio_header(ti: TrackInfo, es: bytes, where: str):
    """An AC-3 or DTS track's rate and channels from its first frame in
    ``es``; where there is none, the track keeps what it has and the log
    says so."""
    from ..utils.logging import log
    if ti.codec == "dts":
        from ..audio.frames import dts_header
        f = dts_header(bytes(es), max(0, bytes(es).find(
            b"\x7f\xfe\x80\x01")))
        h = None if f is None else {"sample_rate": f.sample_rate,
                                    "channels": f.channels}
    else:
        from ..audio.ac3dec import read_bsi
        bsi = read_bsi(bytes(es))
        h = None if bsi is None or "eac3" in bsi else {
            "sample_rate": bsi["sample_rate"],
            "channels": [2, 1, 2, 3, 3, 4, 4, 5][bsi["acmod"]]
            + bsi["lfeon"]}
    if h is None:
        log(f"{where}: no whole {ti.codec} frame in the first {len(es)} "
            f"bytes of the track; it keeps {ti.sample_rate} Hz, "
            f"{ti.channels} channels")
        return
    ti.sample_rate, ti.channels = h["sample_rate"], h["channels"]
