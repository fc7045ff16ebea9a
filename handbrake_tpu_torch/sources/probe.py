"""Source probe — open a path as the right demuxer (reference:
hb_stream_open stream.c:826 deciding custom TS/PS parser vs ffmpeg_open;
batch.c for directories).

``open_source(path)`` returns an object with .tracks / .packets() / .seek /
.duration / .close(). ``scan_paths`` expands a directory into per-file
sources (hb_batch_init analog, batch.c).

The port opens y4m, annex-B H.264 and HEVC, mp4, Matroska/WebM, AVI,
MPEG-PS (VOB) and TS/m2ts files, and DVD-Video and Blu-ray folders,
routed as the reference routes them.
"""
from __future__ import annotations

import os

from .common import DemuxError
from .mkv import MKVDemuxer, probe_is_mkv
from .mp4 import MP4Demuxer, probe_is_mp4
from .raw import AnnexBReader, Y4MReader

_VIDEO_EXTS = {".mp4", ".m4v", ".mov", ".mkv", ".webm", ".y4m", ".264", ".avi",
               ".h264", ".avc", ".265", ".h265", ".hevc", ".ts", ".m2ts"}


def open_source(path: str):
    if not os.path.exists(path):
        raise DemuxError(f"no such file: {path}")
    if os.path.isdir(path):
        from .dvd import is_dvd_folder, open_dvd_title
        if is_dvd_folder(path):
            return open_dvd_title(path)[0]
        from .bd import is_bd_folder, open_bd_title
        if is_bd_folder(path):
            return open_bd_title(path)[0]
        raise DemuxError(f"directory is not a DVD/Blu-ray: {path}")
    with open(path, "rb") as f:
        head = f.read(16)
    if probe_is_mp4(head):
        return MP4Demuxer(path)
    if probe_is_mkv(head):
        return MKVDemuxer(path)
    if head.startswith(b"YUV4MPEG2"):
        return Y4MReader(path)
    if head.startswith(b"RIFF") and head[8:12] == b"AVI ":
        from .avi import AVIDemuxer
        return AVIDemuxer(path)
    if head.startswith(b"\x00\x00\x01\xba"):
        from .ps import PSDemuxer
        return PSDemuxer(path)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".ts", ".m2ts", ".mts"):
        from .ts import TSDemuxer
        return TSDemuxer(path)
    if ext in (".mpg", ".mpeg", ".vob", ".ps"):
        from .ps import PSDemuxer
        return PSDemuxer(path)
    if head and head[0] == 0x47:
        from .ts import TSDemuxer, probe_is_ts
        if probe_is_ts(path):
            return TSDemuxer(path)
    if ext in (".265", ".h265", ".hevc"):
        return AnnexBReader(path, codec="hevc")
    if b"\x00\x00\x01" in head or ext in (".264", ".h264", ".avc"):
        return AnnexBReader(path, codec="h264")
    raise DemuxError(f"unrecognized container: {path}")


def scan_paths(path: str) -> list:
    """Directory → sorted list of media file paths (batch.c:268);
    a DVD-Video folder is one source (dvd.c role)."""
    if os.path.isdir(path):
        from .dvd import is_dvd_folder
        from .bd import is_bd_folder
        if is_dvd_folder(path) or is_bd_folder(path):
            return [path]
        out = []
        for name in sorted(os.listdir(path)):
            p = os.path.join(path, name)
            if os.path.isfile(p) \
                    and os.path.splitext(name)[1].lower() in _VIDEO_EXTS:
                out.append(p)
        return out
    return [path]
