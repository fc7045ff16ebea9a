"""Job model + JSON codec. The job JSON schema (hb_json.c:635-692) is the
compatibility surface between frontends and the engine; we accept and emit the
same keys:

  SequenceID, Destination{Mux, File, Options, ChapterMarkers, ChapterList,
  InlineParameterSets, AlignAVStart}, Source{Path, Title, Angle,
  Range{Type in chapter|time|frame|preview, Start, End}}, PAR{Num,Den},
  Video{Encoder, Quality | Bitrate + MultiPass, Preset, Tune, Profile, Level,
  Options, ColorRange/Primaries/Transfer/Matrix, QSV...}, Audio{CopyMask,
  FallbackEncoder, AudioList[...]}, Subtitle{Search, SubtitleList[...]},
  Metadata, Filters{FilterList[{ID, Settings}]}
"""
from __future__ import annotations

import copy
import dataclasses
import json
from typing import List, Optional

# Filter IDs — numeric values kept stable with the reference enum
# (common.h:1729-1777); enum order IS pipeline order.
FILTER_DETELECINE = 1
FILTER_COMB_DETECT = 2
FILTER_DECOMB = 3
FILTER_YADIF = 4
FILTER_BWDIF = 18
FILTER_VFR = 5
FILTER_DEBLOCK = 6
FILTER_DENOISE = 7       # hqdn3d
FILTER_NLMEANS = 8
FILTER_CHROMA_SMOOTH = 19
FILTER_RENDER_SUB = 9
FILTER_CROP_SCALE = 10
FILTER_ROTATE = 11
FILTER_GRAYSCALE = 12
FILTER_PAD = 13
FILTER_LAPSHARP = 14
FILTER_UNSHARP = 15
FILTER_AVFILTER = 16
FILTER_MT_FRAME = 17
FILTER_COLORSPACE = 20
FILTER_FORMAT = 21
FILTER_BM3D = 22
FILTER_DEBAND = 23
FILTER_RPU = 24

# Pipeline ordering (the enum order contract): framerate-changing filters first,
# then quality filters, then geometry, then FORMAT/RPU last.
FILTER_ORDER = [
    FILTER_DETELECINE, FILTER_COMB_DETECT, FILTER_DECOMB, FILTER_YADIF,
    FILTER_BWDIF, FILTER_VFR, FILTER_DEBLOCK, FILTER_DENOISE, FILTER_BM3D,
    FILTER_NLMEANS, FILTER_CHROMA_SMOOTH, FILTER_RENDER_SUB, FILTER_ROTATE,
    FILTER_CROP_SCALE, FILTER_LAPSHARP, FILTER_UNSHARP, FILTER_GRAYSCALE,
    FILTER_PAD, FILTER_COLORSPACE, FILTER_AVFILTER, FILTER_FORMAT, FILTER_RPU,
]
FILTER_NAMES = {
    FILTER_DETELECINE: "detelecine", FILTER_COMB_DETECT: "comb_detect",
    FILTER_DECOMB: "decomb", FILTER_YADIF: "yadif", FILTER_BWDIF: "bwdif",
    FILTER_VFR: "vfr", FILTER_DEBLOCK: "deblock", FILTER_DENOISE: "hqdn3d",
    FILTER_NLMEANS: "nlmeans", FILTER_CHROMA_SMOOTH: "chroma_smooth",
    FILTER_RENDER_SUB: "render_sub", FILTER_CROP_SCALE: "crop_scale",
    FILTER_ROTATE: "rotate", FILTER_GRAYSCALE: "grayscale", FILTER_PAD: "pad",
    FILTER_LAPSHARP: "lapsharp", FILTER_UNSHARP: "unsharp",
    FILTER_AVFILTER: "avfilter", FILTER_MT_FRAME: "mt_frame",
    FILTER_COLORSPACE: "colorspace", FILTER_FORMAT: "format",
    FILTER_BM3D: "bm3d", FILTER_DEBAND: "deband", FILTER_RPU: "rpu",
}


@dataclasses.dataclass
class RangeSpec:
    type: str = "chapter"   # chapter|time|frame|preview
    start: int = 1
    end: int = 0            # 0 = to the end


@dataclasses.dataclass
class AudioJobTrack:
    track: int = 0          # source track index (0-based internally)
    encoder: str = "aac"
    bitrate: int = 160
    quality: Optional[float] = None
    mixdown: str = "stereo"
    samplerate: int = 0     # 0 = same as source
    gain: float = 0.0
    drc: float = 0.0
    # dynamics processors (acompressor/agate analogs, audio/dsp.py):
    # 0 = off; compressor value = ratio, gate value = threshold dB (<0)
    compressor: float = 0.0
    gate: float = 0.0
    name: str = ""


@dataclasses.dataclass
class SubtitleJobTrack:
    track: int = -1         # -1 = import
    burn: bool = False
    default: bool = False
    forced: bool = False
    import_file: Optional[str] = None
    import_format: str = "SRT"
    language: str = "und"
    offset: int = 0
    cc: bool = False        # CEA-608 captions from the video stream


@dataclasses.dataclass
class FilterSpec:
    id: int = 0
    settings: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Job:
    sequence_id: int = 0
    # Source
    path: str = ""
    title: int = 1
    # anamorphic geometry request (hb_geometry_settings_t; resolved at
    # work time via job/geometry.py set_anamorphic_size2)
    anamorphic_mode: Optional[int] = None   # 0 none 1 strict 2 loose 3 custom
    modulus: int = 2
    max_width: int = 0
    max_height: int = 0
    keep_display_aspect: bool = True
    angle: int = 0
    range: RangeSpec = dataclasses.field(default_factory=RangeSpec)
    # Destination
    mux: str = "mp4"            # mp4|mkv|webm|y4m
    file: str = ""
    chapter_markers: bool = False
    inline_parameter_sets: bool = False
    align_av_start: bool = False
    chapter_names: List[str] = dataclasses.field(default_factory=list)
    # Picture
    par_num: int = 1
    par_den: int = 1
    # Video
    vcodec: str = "h264_tpu"
    quality: Optional[float] = 22.0   # CRF/CQ; None → bitrate mode
    vbitrate: Optional[int] = None
    multipass: bool = False
    # B-frames between anchors (encx264.c bframes role). 0 = I/P only
    # (the device CABAC path); >0 routes H.264 through the host
    # B-pyramid walker (codecs/h264/encoder_b.py, CAVLC).
    bframes: int = 0
    # GOP-boundary checkpointing (SURVEY §5 — our improvement over the
    # reference, which cannot resume a killed encode): checkpoint=True
    # journals muxed samples + RC state to <dest>.ckpt at every IDR;
    # resume=True replays a journal and restarts at the last complete
    # GOP.  Byte-identical tails need stateless-across-GOP filters.
    checkpoint: bool = False
    resume: bool = False
    turbo_first_pass: bool = False
    encoder_preset: str = "medium"
    encoder_tune: str = ""
    encoder_profile: str = "auto"
    encoder_level: str = "auto"
    encoder_options: str = ""
    color: dict = dataclasses.field(default_factory=dict)
    # Audio
    audio_copy_mask: List[str] = dataclasses.field(default_factory=list)
    audio_fallback: str = "aac"
    audio: List[AudioJobTrack] = dataclasses.field(default_factory=list)
    # Subtitles
    subtitle_search: dict = dataclasses.field(default_factory=dict)
    subtitles: List[SubtitleJobTrack] = dataclasses.field(default_factory=list)
    # Metadata + filters
    metadata: dict = dataclasses.field(default_factory=dict)
    filters: List[FilterSpec] = dataclasses.field(default_factory=list)
    # GOP-parallel encode: shard the video into N keyframe-aligned chunks
    # over the device mesh (parallel/gop.py; SURVEY §2.8.3).  0/1 = off.
    gop_parallel: int = 0
    # Tile-parallel filters: shard the expensive spatial filters
    # (NLMeans) across N devices with ppermute halo exchange
    # (parallel/mesh.py; SURVEY §2.8.2 taskset analog).  0/1 = off.
    tile_parallel: int = 0
    # Engine-internal (interjob analog)
    pass_id: int = 0           # -1 subtitle scan, 1 analysis, 0/2 final
    pass_count: int = 1
    interjob: dict = dataclasses.field(default_factory=dict)

    def clone(self) -> "Job":
        return copy.deepcopy(self)

    # ---- JSON codec ----
    def to_json(self) -> dict:
        d = {
            "SequenceID": self.sequence_id,
            "Destination": {
                "Mux": self.mux, "File": self.file,
                "InlineParameterSets": self.inline_parameter_sets,
                "AlignAVStart": self.align_av_start,
                "ChapterMarkers": self.chapter_markers,
                "ChapterList": [{"Name": n} for n in self.chapter_names],
                "Options": {},
            },
            "Source": {
                "Path": self.path, "Title": self.title, "Angle": self.angle,
                "Range": {"Type": self.range.type, "Start": self.range.start,
                          "End": self.range.end},
            },
            "PAR": {"Num": self.par_num, "Den": self.par_den},
            **({"Geometry": {
                "AnamorphicMode": self.anamorphic_mode,
                "Modulus": self.modulus, "MaxWidth": self.max_width,
                "MaxHeight": self.max_height,
                "KeepDisplayAspect": self.keep_display_aspect}}
               if self.anamorphic_mode is not None else {}),
            "Video": {
                "Encoder": self.vcodec,
                "Preset": self.encoder_preset, "Tune": self.encoder_tune,
                "Profile": self.encoder_profile, "Level": self.encoder_level,
                "Options": self.encoder_options,
                **({"GopParallel": self.gop_parallel}
                   if self.gop_parallel else {}),
                **({"TileParallel": self.tile_parallel}
                   if self.tile_parallel else {}),
                **({"Quality": self.quality} if self.quality is not None else
                   {"Bitrate": self.vbitrate, "MultiPass": self.multipass,
                    "Turbo": self.turbo_first_pass}),
                **{("Color" + k): v for k, v in self.color.items()},
            },
            "Audio": {
                "CopyMask": list(self.audio_copy_mask),
                "FallbackEncoder": self.audio_fallback,
                "AudioList": [
                    {"Track": a.track + 1, "Encoder": a.encoder,
                     "Bitrate": a.bitrate, "Mixdown": a.mixdown,
                     "Samplerate": a.samplerate, "Gain": a.gain,
                     "DRC": a.drc, "Name": a.name,
                     "Compressor": a.compressor, "Gate": a.gate,
                     **({"Quality": a.quality} if a.quality is not None else {})}
                    for a in self.audio],
            },
            "Subtitle": {
                "Search": dict(self.subtitle_search),
                "SubtitleList": [
                    {"Track": s.track + 1, "Burn": s.burn, "Default": s.default,
                     "Forced": s.forced, "Language": s.language,
                     **({"CC": True} if s.cc else {}),
                     "Offset": s.offset,
                     **({"Import": {"Filename": s.import_file,
                                    "Format": s.import_format}}
                        if s.import_file else {})}
                    for s in self.subtitles],
            },
            "Metadata": dict(self.metadata),
            "Filters": {"FilterList": [
                {"ID": f.id, "Settings": dict(f.settings)} for f in self.filters]},
        }
        return d

    @staticmethod
    def from_json(d: dict) -> "Job":
        if isinstance(d, str):
            d = json.loads(d)
        j = Job()
        j.sequence_id = d.get("SequenceID", 0)
        dest = d.get("Destination", {})
        j.mux = dest.get("Mux", "mp4")
        j.file = dest.get("File", "")
        j.chapter_markers = bool(dest.get("ChapterMarkers", False))
        j.inline_parameter_sets = bool(dest.get("InlineParameterSets", False))
        j.align_av_start = bool(dest.get("AlignAVStart", False))
        j.chapter_names = [c.get("Name", "") for c in dest.get("ChapterList", [])]
        src = d.get("Source", {})
        j.path = src.get("Path", "")
        j.title = src.get("Title", 1)
        j.angle = src.get("Angle", 0)
        r = src.get("Range", {})
        j.range = RangeSpec(r.get("Type", "chapter"), r.get("Start", 1),
                            r.get("End", 0))
        par = d.get("PAR", {})
        j.par_num = par.get("Num", 1)
        j.par_den = par.get("Den", 1)
        geo = d.get("Geometry", {})
        if geo:
            j.anamorphic_mode = geo.get("AnamorphicMode")
            j.modulus = geo.get("Modulus", 2)
            j.max_width = geo.get("MaxWidth", 0)
            j.max_height = geo.get("MaxHeight", 0)
            j.keep_display_aspect = bool(geo.get("KeepDisplayAspect",
                                                 True))
        v = d.get("Video", {})
        j.vcodec = v.get("Encoder", "h264_tpu")
        if "Quality" in v:
            j.quality, j.vbitrate = v["Quality"], None
        elif "Bitrate" in v:
            j.quality, j.vbitrate = None, v["Bitrate"]
            j.multipass = bool(v.get("MultiPass", False))
            j.turbo_first_pass = bool(v.get("Turbo", False))
        j.encoder_preset = v.get("Preset", "medium")
        j.encoder_tune = v.get("Tune", "") or ""
        j.encoder_profile = v.get("Profile", "auto") or "auto"
        j.encoder_level = v.get("Level", "auto") or "auto"
        j.encoder_options = v.get("Options", "") or ""
        j.gop_parallel = int(v.get("GopParallel", 0) or 0)
        j.tile_parallel = int(v.get("TileParallel", 0) or 0)
        j.color = {k[len("Color"):]: val for k, val in v.items()
                   if k.startswith("Color")}
        a = d.get("Audio", {})
        j.audio_copy_mask = list(a.get("CopyMask", []))
        j.audio_fallback = a.get("FallbackEncoder", "aac")
        j.audio = [AudioJobTrack(
            track=t.get("Track", 1) - 1, encoder=t.get("Encoder", "aac"),
            bitrate=t.get("Bitrate", 160), quality=t.get("Quality"),
            mixdown=t.get("Mixdown", "stereo"),
            samplerate=t.get("Samplerate", 0), gain=t.get("Gain", 0.0),
            drc=t.get("DRC", 0.0), name=t.get("Name", ""),
            compressor=t.get("Compressor", 0.0), gate=t.get("Gate", 0.0))
            for t in a.get("AudioList", [])]
        s = d.get("Subtitle", {})
        j.subtitle_search = dict(s.get("Search", {}))
        j.subtitles = []
        for t in s.get("SubtitleList", []):
            st = SubtitleJobTrack(
                track=t.get("Track", 0) - 1, burn=bool(t.get("Burn", False)),
                default=bool(t.get("Default", False)),
                forced=bool(t.get("Forced", False)),
                cc=bool(t.get("CC", False)),
                language=t.get("Language", "und"), offset=t.get("Offset", 0))
            imp = t.get("Import")
            if imp:
                st.import_file = imp.get("Filename")
                st.import_format = imp.get("Format", "SRT")
            j.subtitles.append(st)
        j.metadata = dict(d.get("Metadata", {}))
        flt = d.get("Filters", {})
        j.filters = [FilterSpec(f.get("ID", 0), dict(f.get("Settings", {}) or {}))
                     for f in flt.get("FilterList", [])]
        j.filters.sort(key=lambda f: FILTER_ORDER.index(f.id)
                       if f.id in FILTER_ORDER else 999)
        return j


def job_to_json_str(job: Job) -> str:
    return json.dumps(job.to_json(), indent=2)
