"""Preset engine — hierarchical builtin presets + preset→job application.

Modeled on preset.c semantics: presets are dicts of `Picture*/Video*/Audio*/
Subtitle*` keys organized into folders; ``preset_to_job`` (hb_preset_job_init
analog) combines a preset with a scanned Title into a Job. Builtin presets are
generated programmatically (our own catalog, same folder taxonomy as the
reference: General / Web / Devices / Matroska / Hardware / Professional).
"""
from __future__ import annotations

import copy
import json
import os
from typing import List, Optional

from . import schema as S
from . import param
from .schema import Job, FilterSpec, AudioJobTrack, RangeSpec
from .title import Title

PRESET_VERSION = (1, 0, 0)


def _preset(name, desc, *, w=0, h=0, vcodec="h264_tpu", quality=22.0,
            vbitrate=None, preset_speed="medium", vprofile="auto",
            vlevel="auto", mux="mp4", fps=0, pfr=True, abitrate=160,
            aencoder="aac", amixdown="stereo", deint=None, deint_preset=None,
            denoise=None, denoise_preset=None, chapter_markers=True,
            web_optimized=False, folder=None):
    return {
        "PresetName": name, "PresetDescription": desc, "Type": 0,
        "Default": False, "Folder": False,
        "FileFormat": mux, "ChapterMarkers": chapter_markers,
        "Optimize": web_optimized, "AlignAVStart": web_optimized,
        "PictureWidth": w, "PictureHeight": h,
        "PicturePAR": "auto", "PictureUseMaximumSize": True,
        "PictureAllowUpscaling": False,
        "PictureAutoCrop": True, "PictureTopCrop": 0, "PictureBottomCrop": 0,
        "PictureLeftCrop": 0, "PictureRightCrop": 0,
        "VideoEncoder": vcodec,
        "VideoQualityType": 2 if vbitrate is None else 1,
        "VideoQualitySlider": quality, "VideoAvgBitrate": vbitrate or 0,
        "VideoMultiPass": vbitrate is not None, "VideoTurboMultiPass": False,
        "VideoPreset": preset_speed, "VideoTune": "",
        "VideoProfile": vprofile, "VideoLevel": vlevel, "VideoOptionExtra": "",
        "VideoFramerate": str(fps) if fps else "auto",
        "VideoFramerateMode": "pfr" if pfr else "vfr",
        "VideoColorRange": "auto",
        "PictureDeinterlaceFilter": deint or "off",
        "PictureDeinterlacePreset": deint_preset or "default",
        "PictureCombDetectPreset": "default" if deint == "decomb" else "off",
        "PictureDenoiseFilter": denoise or "off",
        "PictureDenoisePreset": denoise_preset or "medium",
        "PictureDenoiseTune": "none",
        "PictureSharpenFilter": "off", "PictureSharpenPreset": "medium",
        "PictureDeblockPreset": "off", "PictureDebandPreset": "off",
        "PictureDetelecine": "off", "PictureColorspacePreset": "off",
        "PicturePadMode": "none", "PictureRotate": "disable=1",
        "AudioEncoderFallback": "aac",
        "AudioCopyMask": ["copy:aac", "copy:ac3"],
        "AudioLanguageList": ["und"], "AudioTrackSelectionBehavior": "first",
        "AudioList": [{
            "AudioEncoder": aencoder, "AudioBitrate": abitrate,
            "AudioMixdown": amixdown, "AudioSamplerate": "auto",
            "AudioTrackGainSlider": 0.0, "AudioTrackDRCSlider": 0.0,
        }],
        "SubtitleLanguageList": [], "SubtitleTrackSelectionBehavior": "none",
        "SubtitleBurnBehavior": "none",
        "MetadataPassthru": True,
        "PresetVersion": ".".join(map(str, PRESET_VERSION)),
    }


def _folder(name, children):
    return {"PresetName": name, "Folder": True, "ChildrenArray": children,
            "Type": 0}


def builtin_presets() -> List[dict]:
    """Builtin preset tree (the reference ships ~120; we generate a catalog
    spanning the same folders — General/Web/Devices/Matroska/Professional)."""
    general = [
        _preset("Very Fast 2160p60 4K", "Fast 4K", w=3840, h=2160, quality=24,
                preset_speed="veryfast", fps=60),
        _preset("Very Fast 1080p30", "Small fast 1080p", w=1920, h=1080,
                quality=24, preset_speed="veryfast", fps=30),
        _preset("Very Fast 720p30", "Small fast 720p", w=1280, h=720,
                quality=24, preset_speed="veryfast", fps=30),
        _preset("Very Fast 576p25", "Small fast PAL", w=720, h=576,
                quality=24, preset_speed="veryfast", fps=25),
        _preset("Very Fast 480p30", "Small fast SD", w=720, h=480,
                quality=24, preset_speed="veryfast", fps=30),
        _preset("Fast 2160p60 4K", "Fast 4K", w=3840, h=2160, quality=22,
                preset_speed="fast", fps=60),
        _preset("Fast 1080p30", "Standard 1080p", w=1920, h=1080, quality=22,
                preset_speed="fast", fps=30),
        _preset("Fast 720p30", "Standard 720p", w=1280, h=720, quality=22,
                preset_speed="fast", fps=30),
        _preset("Fast 576p25", "Standard PAL", w=720, h=576, quality=22,
                preset_speed="fast", fps=25),
        _preset("Fast 480p30", "Standard SD", w=720, h=480, quality=22,
                preset_speed="fast", fps=30),
        _preset("HQ 2160p60 4K Surround", "High quality 4K", w=3840, h=2160,
                quality=20, preset_speed="slow", fps=60, abitrate=384,
                amixdown="5point1"),
        _preset("HQ 1080p30 Surround", "High quality 1080p", w=1920, h=1080,
                quality=20, preset_speed="slow", fps=30, abitrate=384,
                amixdown="5point1"),
        _preset("HQ 720p30 Surround", "High quality 720p", w=1280, h=720,
                quality=20, preset_speed="slow", fps=30, abitrate=384,
                amixdown="5point1"),
        _preset("HQ 480p30 Surround", "High quality SD", w=720, h=480,
                quality=20, preset_speed="slow", fps=30, abitrate=384,
                amixdown="5point1"),
        _preset("Super HQ 2160p60 4K Surround", "Max quality 4K", w=3840,
                h=2160, quality=18, preset_speed="veryslow", fps=60,
                abitrate=448, amixdown="5point1"),
        _preset("Super HQ 1080p30 Surround", "Max quality 1080p", w=1920,
                h=1080, quality=18, preset_speed="veryslow", fps=30,
                abitrate=448, amixdown="5point1"),
        _preset("Super HQ 720p30 Surround", "Max quality 720p", w=1280, h=720,
                quality=18, preset_speed="veryslow", fps=30, abitrate=448,
                amixdown="5point1"),
    ]
    web = [
        _preset("Creator 2160p60 4K", "Upload 4K", w=3840, h=2160,
                vbitrate=35000, quality=None, preset_speed="slow", fps=60,
                web_optimized=True),
        _preset("Creator 1440p60 2.5K", "Upload 1440p", w=2560, h=1440,
                vbitrate=16000, quality=None, preset_speed="slow", fps=60,
                web_optimized=True),
        _preset("Creator 1080p60", "Upload 1080p", w=1920, h=1080,
                vbitrate=8000, quality=None, preset_speed="slow", fps=60,
                web_optimized=True),
        _preset("Creator 720p60", "Upload 720p", w=1280, h=720, vbitrate=5000,
                quality=None, preset_speed="slow", fps=60, web_optimized=True),
        _preset("Social 25 MB 2 Minutes 1080p30", "Size-capped short",
                w=1920, h=1080, vbitrate=1300, quality=None,
                preset_speed="medium", fps=30, web_optimized=True),
        _preset("Social 25 MB 5 Minutes 360p30", "Size-capped long",
                w=640, h=360, vbitrate=500, quality=None,
                preset_speed="medium", fps=30, web_optimized=True),
        _preset("Email 25 MB 3 Minutes 720p30", "Email-sized", w=1280, h=720,
                vbitrate=900, quality=None, preset_speed="medium", fps=30,
                web_optimized=True),
    ]
    devices = [
        _preset("Apple 2160p60 4K HEVC Surround", "Apple 4K HEVC", w=3840,
                h=2160, vcodec="hevc_tpu", quality=24, fps=60, abitrate=384,
                amixdown="5point1", web_optimized=True),
        _preset("Apple 1080p60 Surround", "Apple 1080p", w=1920, h=1080,
                quality=22, fps=60, abitrate=384, amixdown="5point1",
                web_optimized=True),
        _preset("Android 1080p30", "Android 1080p", w=1920, h=1080,
                quality=22, fps=30),
        _preset("Android 720p30", "Android 720p", w=1280, h=720, quality=22,
                fps=30),
        _preset("Chromecast 2160p60 4K HEVC Surround", "Chromecast 4K",
                w=3840, h=2160, vcodec="hevc_tpu", quality=24, fps=60,
                abitrate=384, amixdown="5point1"),
        _preset("Chromecast 1080p60 Surround", "Chromecast 1080p", w=1920,
                h=1080, quality=22, fps=60, abitrate=384, amixdown="5point1"),
        _preset("Fire TV 2160p60 4K HEVC Surround", "Fire TV 4K", w=3840,
                h=2160, vcodec="hevc_tpu", quality=24, fps=60, abitrate=384,
                amixdown="5point1"),
        _preset("Playstation 1080p30 Surround", "PS 1080p", w=1920, h=1080,
                quality=22, fps=30, abitrate=384, amixdown="5point1"),
        _preset("Roku 2160p60 4K HEVC Surround", "Roku 4K", w=3840, h=2160,
                vcodec="hevc_tpu", quality=24, fps=60, abitrate=384,
                amixdown="5point1"),
        _preset("Xbox 1080p30 Surround", "Xbox 1080p", w=1920, h=1080,
                quality=22, fps=30, abitrate=384, amixdown="5point1"),
    ]
    mkv = [
        _preset("AV1 MKV 2160p60 4K", "AV1 4K", w=3840, h=2160,
                vcodec="av1_tpu", quality=28, mux="mkv", fps=60),
        _preset("H.265 MKV 2160p60 4K", "HEVC 4K", w=3840, h=2160,
                vcodec="hevc_tpu", quality=24, mux="mkv", fps=60),
        _preset("H.265 MKV 1080p30", "HEVC 1080p", w=1920, h=1080,
                vcodec="hevc_tpu", quality=23, mux="mkv", fps=30),
        _preset("H.264 MKV 2160p60 4K", "H.264 4K", w=3840, h=2160,
                quality=22, mux="mkv", fps=60),
        _preset("H.264 MKV 1080p30", "H.264 1080p", w=1920, h=1080,
                quality=22, mux="mkv", fps=30),
        _preset("H.264 MKV 720p30", "H.264 720p", w=1280, h=720, quality=22,
                mux="mkv", fps=30),
        _preset("H.264 MKV 480p30", "H.264 SD", w=720, h=480, quality=22,
                mux="mkv", fps=30),
        _preset("VP9 MKV 2160p60 4K", "VP9 4K", w=3840, h=2160,
                vcodec="vp9", quality=31, mux="mkv", fps=60,
                aencoder="opus", abitrate=192),
    ]
    hq_extra = [
        _preset("HQ 2160p60 4K HEVC Surround", "High quality 4K HEVC",
                w=3840, h=2160, vcodec="hevc_tpu", quality=22,
                preset_speed="slow", fps=60, abitrate=384,
                amixdown="5point1"),
        _preset("HQ 1080p30 HEVC Surround", "High quality 1080p HEVC",
                w=1920, h=1080, vcodec="hevc_tpu", quality=21,
                preset_speed="slow", fps=30, abitrate=384,
                amixdown="5point1"),
        _preset("HQ 576p25 Surround", "High quality PAL", w=720, h=576,
                quality=20, preset_speed="slow", fps=25, abitrate=384,
                amixdown="5point1"),
        _preset("Super HQ 2160p60 4K HEVC Surround", "Max quality 4K HEVC",
                w=3840, h=2160, vcodec="hevc_tpu", quality=20,
                preset_speed="veryslow", fps=60, abitrate=448,
                amixdown="5point1"),
        _preset("Super HQ 576p25 Surround", "Max quality PAL", w=720,
                h=576, quality=18, preset_speed="veryslow", fps=25,
                abitrate=448, amixdown="5point1"),
        _preset("Super HQ 480p30 Surround", "Max quality SD", w=720,
                h=480, quality=18, preset_speed="veryslow", fps=30,
                abitrate=448, amixdown="5point1"),
    ]
    web_extra = [
        _preset("Vimeo YouTube HQ 2160p60 4K", "Upload 4K HQ", w=3840,
                h=2160, vbitrate=40000, quality=None, preset_speed="slow",
                fps=60, web_optimized=True),
        _preset("Vimeo YouTube HQ 1440p60 2.5K", "Upload 1440p HQ",
                w=2560, h=1440, vbitrate=20000, quality=None,
                preset_speed="slow", fps=60, web_optimized=True),
        _preset("Vimeo YouTube HQ 1080p60", "Upload 1080p HQ", w=1920,
                h=1080, vbitrate=12000, quality=None, preset_speed="slow",
                fps=60, web_optimized=True),
        _preset("Vimeo YouTube HQ 720p60", "Upload 720p HQ", w=1280,
                h=720, vbitrate=6000, quality=None, preset_speed="slow",
                fps=60, web_optimized=True),
        _preset("Social 8 MB 3 Minutes 360p30", "Tiny size-capped",
                w=640, h=360, vbitrate=280, quality=None,
                preset_speed="medium", fps=30, web_optimized=True),
        _preset("Social 50 MB 5 Minutes 480p30", "Mid size-capped",
                w=720, h=480, vbitrate=1100, quality=None,
                preset_speed="medium", fps=30, web_optimized=True),
        _preset("Social 100 MB 10 Minutes 480p30", "Long size-capped",
                w=720, h=480, vbitrate=1100, quality=None,
                preset_speed="medium", fps=30, web_optimized=True),
    ]
    devices_extra = [
        _preset("Apple 1080p30 Surround", "Apple 1080p30", w=1920, h=1080,
                quality=22, fps=30, abitrate=384, amixdown="5point1",
                web_optimized=True),
        _preset("Apple 720p30 Surround", "Apple 720p", w=1280, h=720,
                quality=22, fps=30, abitrate=384, amixdown="5point1",
                web_optimized=True),
        _preset("Apple 540p30 Surround", "Apple 540p", w=960, h=540,
                quality=22, fps=30, abitrate=256, amixdown="5point1",
                web_optimized=True),
        _preset("Apple 240p30", "Apple 240p", w=426, h=240, quality=22,
                fps=30, abitrate=128, web_optimized=True),
        _preset("Android 576p25", "Android PAL", w=720, h=576, quality=22,
                fps=25),
        _preset("Android 480p30", "Android SD", w=720, h=480, quality=22,
                fps=30),
        _preset("Amazon Fire 1080p30 Surround", "Fire 1080p", w=1920,
                h=1080, quality=22, fps=30, abitrate=384,
                amixdown="5point1"),
        _preset("Amazon Fire 720p30", "Fire 720p", w=1280, h=720,
                quality=22, fps=30),
        _preset("Chromecast 1080p30 Surround", "Chromecast 1080p30",
                w=1920, h=1080, quality=22, fps=30, abitrate=384,
                amixdown="5point1"),
        _preset("Playstation 2160p60 4K Surround", "PS 4K", w=3840,
                h=2160, quality=24, fps=60, abitrate=384,
                amixdown="5point1"),
        _preset("Playstation 720p30", "PS 720p", w=1280, h=720,
                quality=22, fps=30),
        _preset("Playstation 540p30", "PS 540p", w=960, h=540, quality=22,
                fps=30),
        _preset("Roku 1080p30 Surround", "Roku 1080p", w=1920, h=1080,
                quality=22, fps=30, abitrate=384, amixdown="5point1"),
        _preset("Roku 720p30 Surround", "Roku 720p", w=1280, h=720,
                quality=22, fps=30, abitrate=384, amixdown="5point1"),
        _preset("Roku 576p25", "Roku PAL", w=720, h=576, quality=22,
                fps=25),
        _preset("Roku 480p30", "Roku SD", w=720, h=480, quality=22,
                fps=30),
        _preset("Xbox 720p30", "Xbox 720p", w=1280, h=720, quality=22,
                fps=30),
    ]
    mkv_extra = [
        _preset("AV1 MKV 1080p30", "AV1 1080p", w=1920, h=1080,
                vcodec="av1_tpu", quality=28, mux="mkv", fps=30),
        _preset("AV1 MKV 720p30", "AV1 720p", w=1280, h=720,
                vcodec="av1_tpu", quality=28, mux="mkv", fps=30),
        _preset("H.265 MKV 720p30", "HEVC 720p", w=1280, h=720,
                vcodec="hevc_tpu", quality=23, mux="mkv", fps=30),
        _preset("H.265 MKV 576p25", "HEVC PAL", w=720, h=576,
                vcodec="hevc_tpu", quality=23, mux="mkv", fps=25),
        _preset("H.265 MKV 480p30", "HEVC SD", w=720, h=480,
                vcodec="hevc_tpu", quality=23, mux="mkv", fps=30),
        _preset("H.264 MKV 576p25", "H.264 PAL", w=720, h=576, quality=22,
                mux="mkv", fps=25),
        _preset("H.265 10-bit MKV 2160p60 4K", "HEVC Main-10 4K",
                w=3840, h=2160, vcodec="hevc_tpu", vprofile="main10",
                quality=24, mux="mkv", fps=60),
        _preset("H.265 10-bit MKV 1080p30", "HEVC Main-10 1080p",
                w=1920, h=1080, vcodec="hevc_tpu", vprofile="main10",
                quality=23, mux="mkv", fps=30),
    ]
    # our accelerator folder — the reference's Hardware (QSV/NVENC/VCN)
    # category mapped to the TPU device path + GOP-parallel scale-out
    tpu = [
        _preset("TPU High 2160p60 4K", "Device-path High profile 4K",
                w=3840, h=2160, quality=22, vprofile="high", fps=60),
        _preset("TPU High 1080p30", "Device-path High profile 1080p",
                w=1920, h=1080, quality=22, vprofile="high", fps=30),
        _preset("TPU High 720p30", "Device-path High profile 720p",
                w=1280, h=720, quality=22, vprofile="high", fps=30),
        _preset("TPU HEVC 2160p60 4K", "Device-path HEVC 4K", w=3840,
                h=2160, vcodec="hevc_tpu", quality=24, fps=60),
        _preset("TPU HEVC 10-bit 2160p60 4K", "Device-path HEVC 10-bit",
                w=3840, h=2160, vcodec="hevc_tpu", vprofile="main10",
                quality=24, fps=60),
        _preset("TPU AV1 2160p60 4K", "Device-path AV1 4K", w=3840,
                h=2160, vcodec="av1_tpu", quality=28, fps=60),
    ]
    production = [
        _preset("Production Max", "Max-quality mezzanine", quality=10,
                preset_speed="veryslow", pfr=False),
        _preset("Production Standard", "Standard mezzanine", quality=14,
                preset_speed="slow", pfr=False),
        _preset("Production Proxy 1080p", "Editing proxy", w=1920, h=1080,
                quality=24, preset_speed="ultrafast", pfr=False),
        _preset("Production Proxy 540p", "Small editing proxy", w=960, h=540,
                quality=24, preset_speed="ultrafast", pfr=False),
    ]
    # VP9/Theora and Opus/Vorbis/MP3 are real now (the libavcodec
    # catalog layer, codecs/avcodec.py) — the reference's VP9-MKV and
    # WebM preset families come back as first-class entries
    webm = [
        _preset("WebM 2160p60 4K", "WebM VP9+Opus 4K", w=3840, h=2160,
                vcodec="vp9", quality=31, mux="webm", fps=60,
                aencoder="opus", abitrate=192),
        _preset("WebM 1440p60 2.5K", "WebM VP9+Opus 1440p", w=2560,
                h=1440, vcodec="vp9", quality=31, mux="webm", fps=60,
                aencoder="opus", abitrate=192),
        _preset("WebM 1080p30", "WebM VP9+Opus 1080p", w=1920, h=1080,
                vcodec="vp9", quality=31, mux="webm", fps=30,
                aencoder="opus", abitrate=160),
        _preset("WebM 720p30", "WebM VP9+Opus 720p", w=1280, h=720,
                vcodec="vp9", quality=32, mux="webm", fps=30,
                aencoder="opus", abitrate=128),
        _preset("WebM 480p30", "WebM VP9+Opus SD", w=720, h=480,
                vcodec="vp9", quality=33, mux="webm", fps=30,
                aencoder="opus", abitrate=96),
    ]
    mkv_catalog = [
        _preset("VP9 MKV 1080p30", "VP9 1080p", w=1920, h=1080,
                vcodec="vp9", quality=31, mux="mkv", fps=30,
                aencoder="opus", abitrate=160),
        _preset("VP9 MKV 720p30", "VP9 720p", w=1280, h=720,
                vcodec="vp9", quality=32, mux="mkv", fps=30,
                aencoder="opus", abitrate=128),
        _preset("VP9 MKV 480p30", "VP9 SD", w=720, h=480, vcodec="vp9",
                quality=33, mux="mkv", fps=30, aencoder="opus",
                abitrate=96),
        _preset("Theora MKV 576p25", "Theora+Vorbis PAL", w=720, h=576,
                vcodec="theora", vbitrate=1500, quality=None, mux="mkv",
                fps=25, aencoder="vorbis", abitrate=160),
        _preset("Theora MKV 480p30", "Theora+Vorbis SD", w=720, h=480,
                vcodec="theora", vbitrate=1200, quality=None, mux="mkv",
                fps=30, aencoder="vorbis", abitrate=160),
        _preset("FFV1 MKV Archival", "Lossless FFV1 + FLAC archival",
                vcodec="ffv1", vbitrate=0, quality=None, mux="mkv",
                pfr=False, aencoder="flac", abitrate=0),
        _preset("MPEG-2 MKV 576p25", "Legacy MPEG-2 PAL", w=720, h=576,
                vcodec="mpeg2", vbitrate=6000, quality=None, mux="mkv",
                fps=25, aencoder="mp3", abitrate=192),
        _preset("MPEG-4 MKV 480p30", "Legacy MPEG-4 ASP SD", w=720,
                h=480, vcodec="mpeg4", vbitrate=1800, quality=None,
                mux="mkv", fps=30, aencoder="mp3", abitrate=160),
    ]
    audio_variants = [
        _preset("Fast 1080p30 Opus", "1080p with Opus audio", w=1920,
                h=1080, quality=22, mux="mkv", fps=30, aencoder="opus",
                abitrate=128),
        _preset("Fast 1080p30 MP3", "1080p with MP3 audio", w=1920,
                h=1080, quality=22, fps=30, aencoder="mp3",
                abitrate=192),
        _preset("Fast 1080p30 AC3", "1080p with AC-3 audio", w=1920,
                h=1080, quality=22, fps=30, aencoder="ac3",
                abitrate=192),
        _preset("Fast 1080p30 FLAC", "1080p with lossless audio",
                w=1920, h=1080, quality=22, mux="mkv", fps=30,
                aencoder="flac", abitrate=0),
        _preset("HQ 1080p30 Vorbis Surround", "1080p Vorbis 5.1",
                w=1920, h=1080, quality=20, mux="mkv", fps=30,
                aencoder="vorbis", abitrate=320, amixdown="5point1"),
    ]
    tpu_extra = [
        _preset("TPU High B-frames 1080p30", "IB..BP GOP walker 1080p",
                w=1920, h=1080, quality=22, fps=30),
        _preset("TPU GOP-Parallel 2160p60 4K", "Mesh-sharded 4K encode",
                w=3840, h=2160, quality=22, vprofile="high", fps=60),
        _preset("TPU GOP-Parallel 1080p30", "Mesh-sharded 1080p encode",
                w=1920, h=1080, quality=22, vprofile="high", fps=30),
        _preset("TPU Multi-Host 2160p60 4K", "DCN controller scale-out",
                w=3840, h=2160, quality=22, vprofile="high", fps=60),
    ]
    return [
        _folder("General", general + hq_extra),
        _folder("Web", web + web_extra),
        _folder("Devices", devices + devices_extra),
        _folder("Matroska", mkv + mkv_extra + mkv_catalog),
        _folder("WebM", webm),
        _folder("Audio", audio_variants),
        _folder("Hardware", tpu + tpu_extra),
        _folder("Production", production),
    ]


_BUILTIN = None


def get_builtin() -> List[dict]:
    global _BUILTIN
    if _BUILTIN is None:
        _BUILTIN = builtin_presets()
    return copy.deepcopy(_BUILTIN)


def flatten(tree: List[dict]) -> List[dict]:
    out = []
    for node in tree:
        if node.get("Folder"):
            out.extend(flatten(node.get("ChildrenArray", [])))
        else:
            out.append(node)
    return out


def preset_search(name: str, tree: Optional[List[dict]] = None) -> Optional[dict]:
    """hb_preset_search analog: find by name, optionally 'Folder/Name' path."""
    tree = tree if tree is not None else get_builtin()
    if "/" in name:
        folder, rest = name.split("/", 1)
        for node in tree:
            if node.get("Folder") and node["PresetName"] == folder:
                return preset_search(rest, node.get("ChildrenArray", []))
        return None
    for p in flatten(tree):
        if p["PresetName"] == name:
            return copy.deepcopy(p)
    return None


def import_preset_file(path: str) -> List[dict]:
    """Load a preset export file (GUI json or single preset)."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d, dict) and "PresetList" in d:
        return d["PresetList"]
    if isinstance(d, dict):
        return [d]
    return d


def _parse_framerate(p) -> tuple:
    fr = str(p.get("VideoFramerate", "auto"))
    table = {"23.976": (24000, 1001), "24": (24, 1), "25": (25, 1),
             "29.97": (30000, 1001), "30": (30, 1), "50": (50, 1),
             "59.94": (60000, 1001), "60": (60, 1), "120": (120, 1)}
    if fr in table:
        return table[fr]
    try:
        f = float(fr)
        if abs(f - round(f)) < 1e-6:
            return (int(round(f)), 1)
        return (int(round(f * 1001)), 1001)
    except ValueError:
        return (0, 0)   # auto → same as source


def _same_language(want: str, have: str) -> bool:
    """A language of AudioLanguageList matches a track's: "und" (or
    "any") matches every track, else the two name one ISO 639-2 code."""
    from .lang import to_iso639_2
    if want.strip().lower() in ("und", "any", ""):
        return True
    return to_iso639_2(want) == to_iso639_2(have or "und")


def select_audio(preset: dict, languages: list) -> list:
    """[(source track index, AudioList entry)]: the job's audio outputs
    for a title whose audio tracks have ``languages``, chosen as
    HandBrake's hb_preset_job_add_audio (libhb/preset.c) chooses them.

    ``AudioTrackSelectionBehavior`` "none" selects no track; "first"
    selects, for each language of ``AudioLanguageList`` in order, the
    first track of that language, and "all" every track of it ("und"
    matches any language; an empty list is ["und"]; a track is selected
    once).  Where no language matched, the selection is made again with
    "und".  Every selected track gets every AudioList entry, in the
    list's order; with ``AudioSecondaryEncoderMode`` on (missing: off),
    the tracks after the first get only the first entry."""
    behavior = preset.get("AudioTrackSelectionBehavior", "first")
    entries = list(preset.get("AudioList", []))
    if behavior == "none" or not entries:
        return []
    langs = list(preset.get("AudioLanguageList") or []) or ["und"]

    def pick(langs):
        chosen = []
        for lang in langs:
            hits = [i for i, have in enumerate(languages)
                    if _same_language(lang, have) and i not in chosen]
            chosen += hits[:1] if behavior == "first" else hits
        return chosen

    chosen = pick(langs) or pick(["und"])
    secondary = bool(preset.get("AudioSecondaryEncoderMode", False))
    return [(i, at) for k, i in enumerate(chosen)
            for at in (entries[:1] if secondary and k > 0 else entries)]


def preset_encoders(preset: dict, languages: list = ()) -> Job:
    """The part of preset_to_job that no source decides: the container,
    the video encoder's settings, and the audio outputs that
    ``select_audio`` gives for a title whose audio tracks have
    ``languages`` (none: no outputs; "und" for a track of unknown
    language)."""
    j = Job()
    j.mux = preset.get("FileFormat", "mp4").replace("av_", "")

    # --- video encoder ---
    j.vcodec = preset.get("VideoEncoder", "h264_tpu")
    if preset.get("VideoQualityType", 2) == 2:
        j.quality = float(preset.get("VideoQualitySlider", 22.0))
        j.vbitrate = None
    else:
        j.quality = None
        j.vbitrate = int(preset.get("VideoAvgBitrate", 4000))
        j.multipass = bool(preset.get("VideoMultiPass", False))
        j.turbo_first_pass = bool(preset.get("VideoTurboMultiPass", False))
    j.encoder_preset = preset.get("VideoPreset", "medium")
    j.encoder_tune = preset.get("VideoTune", "")
    j.encoder_profile = preset.get("VideoProfile", "auto")
    j.encoder_level = preset.get("VideoLevel", "auto")
    j.encoder_options = preset.get("VideoOptionExtra", "")

    # --- audio ---
    j.audio_fallback = preset.get("AudioEncoderFallback", "aac")
    j.audio_copy_mask = list(preset.get("AudioCopyMask", []))
    j.audio = []
    for i, at in select_audio(preset, list(languages)):
        j.audio.append(AudioJobTrack(
            track=i, encoder=at.get("AudioEncoder", "aac"),
            bitrate=int(at.get("AudioBitrate", 160)),
            mixdown=at.get("AudioMixdown", "stereo"),
            samplerate=0 if at.get("AudioSamplerate", "auto") == "auto"
            else int(at.get("AudioSamplerate")),
            gain=float(at.get("AudioTrackGainSlider", 0.0)),
            drc=float(at.get("AudioTrackDRCSlider", 0.0))))
    return j


# PicturePAR → the job's anamorphic mode (job/geometry.py)
PICTURE_PAR_MODES = {"off": 0, "strict": 1, "loose": 2, "custom": 3,
                     "auto": 4}


def _picture_par(j: Job, title: Title, preset: dict):
    """The preset's ``PicturePAR`` as the job's anamorphic mode, resolved
    at work time against the source's pixel aspect (the reference reads
    the key and never applies it).  "auto" on a square-pixel title gives
    the preset's scale at 1:1, which is the job as it stands, so such a
    job stays unset, as the reference's."""
    par = preset.get("PicturePAR", "auto")
    if par not in PICTURE_PAR_MODES:
        raise ValueError(f"PicturePAR {par!r}: not one of "
                         f"{', '.join(PICTURE_PAR_MODES)}")
    mode = PICTURE_PAR_MODES[par]
    if par == "auto" and (title.par_num, title.par_den) == (1, 1):
        return
    j.anamorphic_mode = mode
    if par == "custom":
        j.par_num = int(preset.get("PicturePARWidth", 0) or 0)
        j.par_den = int(preset.get("PicturePARHeight", 0) or 0)


def preset_to_job(title: Title, preset: dict) -> Job:
    """hb_preset_job_init analog: preset dict + title → Job."""
    j = preset_encoders(preset, [a.language for a in title.audio])
    j.path = title.path
    j.title = title.index
    j.chapter_markers = bool(preset.get("ChapterMarkers", False))
    j.align_av_start = bool(preset.get("AlignAVStart", False))
    j.inline_parameter_sets = bool(preset.get("InlineParameterSets", False))
    j.range = RangeSpec("chapter", 1, 0)

    # --- picture/filters ---
    filters: List[FilterSpec] = []
    # detelecine
    if preset.get("PictureDetelecine", "off") not in ("off", ""):
        st = param.generate_filter_settings(
            S.FILTER_DETELECINE, preset.get("PictureDetelecine", "default"),
            "", preset.get("PictureDetelecineCustom", ""))
        filters.append(FilterSpec(S.FILTER_DETELECINE, st))
    # deinterlace
    deint = preset.get("PictureDeinterlaceFilter", "off")
    if deint not in ("off", ""):
        if preset.get("PictureCombDetectPreset", "off") not in ("off", ""):
            st = param.generate_filter_settings(
                S.FILTER_COMB_DETECT,
                preset.get("PictureCombDetectPreset", "default"), "",
                preset.get("PictureCombDetectCustom", ""))
            filters.append(FilterSpec(S.FILTER_COMB_DETECT, st))
        fid = {"decomb": S.FILTER_DECOMB, "yadif": S.FILTER_YADIF,
               "deinterlace": S.FILTER_YADIF,
               "bwdif": S.FILTER_BWDIF}.get(deint, S.FILTER_DECOMB)
        st = param.generate_filter_settings(
            fid, preset.get("PictureDeinterlacePreset", "default"), "",
            preset.get("PictureDeinterlaceCustom", ""))
        filters.append(FilterSpec(fid, st))
    # denoise
    dn = preset.get("PictureDenoiseFilter", "off")
    if dn not in ("off", ""):
        fid = {"nlmeans": S.FILTER_NLMEANS, "hqdn3d": S.FILTER_DENOISE,
               "bm3d": S.FILTER_BM3D}.get(dn, S.FILTER_NLMEANS)
        st = param.generate_filter_settings(
            fid, preset.get("PictureDenoisePreset", "medium"),
            preset.get("PictureDenoiseTune", ""),
            preset.get("PictureDenoiseCustom", ""))
        filters.append(FilterSpec(fid, st))
    # chroma smooth / sharpen / deblock / deband
    if preset.get("PictureChromaSmoothPreset", "off") not in ("off", ""):
        st = param.generate_filter_settings(
            S.FILTER_CHROMA_SMOOTH,
            preset.get("PictureChromaSmoothPreset"),
            preset.get("PictureChromaSmoothTune", ""),
            preset.get("PictureChromaSmoothCustom", ""))
        filters.append(FilterSpec(S.FILTER_CHROMA_SMOOTH, st))
    sharpen = preset.get("PictureSharpenFilter", "off")
    if sharpen not in ("off", ""):
        fid = {"unsharp": S.FILTER_UNSHARP,
               "lapsharp": S.FILTER_LAPSHARP}.get(sharpen, S.FILTER_UNSHARP)
        st = param.generate_filter_settings(
            fid, preset.get("PictureSharpenPreset", "medium"),
            preset.get("PictureSharpenTune", ""),
            preset.get("PictureSharpenCustom", ""))
        filters.append(FilterSpec(fid, st))
    if preset.get("PictureDeblockPreset", "off") not in ("off", ""):
        st = param.generate_filter_settings(
            S.FILTER_DEBLOCK, preset.get("PictureDeblockPreset"),
            preset.get("PictureDeblockTune", ""),
            preset.get("PictureDeblockCustom", ""))
        filters.append(FilterSpec(S.FILTER_DEBLOCK, st))
    if preset.get("PictureDebandPreset", "off") not in ("off", ""):
        st = param.generate_filter_settings(
            S.FILTER_DEBAND, preset.get("PictureDebandPreset"),
            "", preset.get("PictureDebandCustom", ""))
        filters.append(FilterSpec(S.FILTER_DEBAND, st))
    # rotate
    rot = preset.get("PictureRotate", "disable=1")
    if rot and "disable=1" not in rot:
        filters.append(FilterSpec(S.FILTER_ROTATE, param._parse_custom(rot)))

    # crop + scale (geometry computed like hb_set_anamorphic_size2)
    crop = (list(title.crop) if preset.get("PictureAutoCrop", True) else
            [preset.get("PictureTopCrop", 0), preset.get("PictureBottomCrop", 0),
             preset.get("PictureLeftCrop", 0), preset.get("PictureRightCrop", 0)])
    src_w = title.width - crop[2] - crop[3]
    src_h = title.height - crop[0] - crop[1]
    max_w = preset.get("PictureWidth", 0) or 0
    max_h = preset.get("PictureHeight", 0) or 0
    out_w, out_h = src_w, src_h
    if max_w or max_h:
        scale = min((max_w / src_w) if max_w else 1e9,
                    (max_h / src_h) if max_h else 1e9)
        if scale < 1.0 or preset.get("PictureAllowUpscaling", False):
            out_w = int(src_w * scale) & ~1
            out_h = int(src_h * scale) & ~1
    out_w, out_h = max(2, out_w & ~1), max(2, out_h & ~1)
    filters.append(FilterSpec(S.FILTER_CROP_SCALE, {
        "crop-top": crop[0], "crop-bottom": crop[1], "crop-left": crop[2],
        "crop-right": crop[3], "width": out_w, "height": out_h}))
    _picture_par(j, title, preset)

    # pad
    if preset.get("PicturePadMode", "none") not in ("none", ""):
        filters.append(FilterSpec(S.FILTER_PAD, {
            "width": preset.get("PicturePadWidth", out_w),
            "height": preset.get("PicturePadHeight", out_h),
            "color": preset.get("PicturePadColor", "black")}))

    # colorspace
    if preset.get("PictureColorspacePreset", "off") not in ("off", ""):
        filters.append(FilterSpec(S.FILTER_COLORSPACE, param._parse_custom(
            preset.get("PictureColorspaceCustom", ""))))

    # framerate shaping
    num, den = _parse_framerate(preset)
    mode = {"vfr": 0, "cfr": 1, "pfr": 2}.get(
        preset.get("VideoFramerateMode", "vfr"), 0)
    vfr = {"mode": mode}
    if num:
        vfr["rate-num"], vfr["rate-den"] = num, den
    filters.append(FilterSpec(S.FILTER_VFR, vfr))
    filters.sort(key=lambda f: S.FILTER_ORDER.index(f.id))
    j.filters = filters

    # grayscale flag
    if preset.get("VideoGrayScale", False):
        j.filters.insert(0, FilterSpec(S.FILTER_GRAYSCALE, {}))

    # chapters passthru
    if j.chapter_markers and title.chapters:
        j.chapter_names = [c.name or f"Chapter {i+1}"
                           for i, c in enumerate(title.chapters)]
    j.metadata = dict(title.metadata) if preset.get("MetadataPassthru", True) else {}
    return j
