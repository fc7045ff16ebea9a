"""Title model — result of a source scan (hb_title_t analog, common.h).

``to_json`` emits the reference's TitleSet JSON shape (hb_title_set_to_json,
hb_json.c) so frontends that consume scan JSON keep working.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..core.buffer import CLOCK


@dataclasses.dataclass
class Chapter:
    name: str = ""
    duration: int = 0  # 90 kHz ticks

    def to_json(self):
        s = self.duration // CLOCK
        return {"Name": self.name, "Duration": {"Ticks": self.duration,
                "Hours": s // 3600, "Minutes": (s % 3600) // 60,
                "Seconds": s % 60}}


@dataclasses.dataclass
class AudioTrack:
    track: int = 0
    codec: str = "pcm"
    sample_rate: int = 48000
    channels: int = 2
    channel_layout: str = "stereo"
    bitrate: int = 0
    language: str = "und"
    name: str = ""

    def to_json(self):
        return {"TrackNumber": self.track + 1, "Codec": self.codec,
                "SampleRate": self.sample_rate, "Channels": self.channels,
                "ChannelLayoutName": self.channel_layout,
                "BitRate": self.bitrate, "Language": self.language,
                "LanguageCode": self.language, "Name": self.name}


@dataclasses.dataclass
class SubtitleTrack:
    track: int = 0
    source: str = "srt"       # srt|ssa|pgs|vobsub|cc|tx3g|dvb
    language: str = "und"
    name: str = ""
    path: Optional[str] = None

    def to_json(self):
        return {"TrackNumber": self.track + 1, "Source": self.source,
                "Language": self.language, "LanguageCode": self.language,
                "Name": self.name}


@dataclasses.dataclass
class Title:
    index: int = 1
    path: str = ""
    name: str = ""
    container: str = ""        # mp4|mkv|y4m|ts|raw264...
    duration: int = 0          # 90 kHz ticks
    width: int = 0
    height: int = 0
    par_num: int = 1
    par_den: int = 1
    pix_fmt_name: str = "yuv420p"
    vrate_num: int = 30000
    vrate_den: int = 1001
    video_codec: str = ""
    interlaced: bool = False
    crop: tuple = (0, 0, 0, 0)  # autocrop top/bottom/left/right
    nframes: int = 0
    color: dict = dataclasses.field(default_factory=lambda: {
        "Primaries": 1, "Transfer": 1, "Matrix": 1, "Range": 1})
    audio: List[AudioTrack] = dataclasses.field(default_factory=list)
    subtitles: List[SubtitleTrack] = dataclasses.field(default_factory=list)
    chapters: List[Chapter] = dataclasses.field(default_factory=list)
    metadata: dict = dataclasses.field(default_factory=dict)
    # engine-private: how to re-open this source
    _source_kind: str = "file"

    def fps(self) -> float:
        return self.vrate_num / self.vrate_den

    def to_json(self) -> dict:
        s = self.duration // CLOCK
        return {
            "Index": self.index,
            "Path": self.path,
            "Name": self.name or self.path,
            "Type": 0,
            "Duration": {"Ticks": self.duration, "Hours": s // 3600,
                         "Minutes": (s % 3600) // 60, "Seconds": s % 60},
            "Geometry": {"Width": self.width, "Height": self.height,
                         "PAR": {"Num": self.par_num, "Den": self.par_den}},
            "FrameRate": {"Num": self.vrate_num, "Den": self.vrate_den},
            "VideoCodec": self.video_codec,
            "InterlaceDetected": self.interlaced,
            "Crop": list(self.crop),
            "LooseCrop": list(self.crop),
            "Color": dict(self.color),
            "AudioList": [a.to_json() for a in self.audio],
            "SubtitleList": [st.to_json() for st in self.subtitles],
            "ChapterList": [c.to_json() for c in self.chapters],
            "MetaData": {k: v for k, v in self.metadata.items()
                         if not k.startswith("__")},
        }


def title_set_to_json(titles: List[Title], main_feature: int = 0) -> dict:
    return {"MainFeature": main_feature,
            "TitleList": [t.to_json() for t in titles]}
