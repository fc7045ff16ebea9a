"""Source probe — open a path as the right demuxer (reference:
hb_stream_open stream.c:826 deciding custom TS/PS parser vs ffmpeg_open;
batch.c for directories).

``open_source(path)`` returns an object with .tracks / .packets() / .seek /
.duration / .close(). ``scan_paths`` expands a directory into per-file
sources (hb_batch_init analog, batch.c).

The port opens y4m, annex-B H.264, mp4 and Matroska/WebM.  AVI,
MPEG-PS/TS, HEVC elementary streams and DVD/Blu-ray folders raise
NotImplementedError: their demuxers are later slices.
"""
from __future__ import annotations

import os

from .common import DemuxError
from .mkv import MKVDemuxer, probe_is_mkv
from .mp4 import MP4Demuxer, probe_is_mp4
from .raw import AnnexBReader, Y4MReader

_VIDEO_EXTS = {".mp4", ".m4v", ".mov", ".mkv", ".webm", ".y4m", ".264", ".avi",
               ".h264", ".avc", ".265", ".h265", ".hevc", ".ts", ".m2ts"}


def _unported(what: str, path: str):
    raise NotImplementedError(
        f"{what} sources are not ported yet ({path}); the port opens y4m, "
        f"annex-B H.264, mp4 and Matroska/WebM")


def open_source(path: str):
    if not os.path.exists(path):
        raise DemuxError(f"no such file: {path}")
    if os.path.isdir(path):
        _unported("DVD/Blu-ray folder", path)
    with open(path, "rb") as f:
        head = f.read(16)
    if probe_is_mp4(head):
        return MP4Demuxer(path)
    if probe_is_mkv(head):
        return MKVDemuxer(path)
    if head.startswith(b"YUV4MPEG2"):
        return Y4MReader(path)
    if head.startswith(b"RIFF") and head[8:12] == b"AVI ":
        _unported("AVI", path)
    ext = os.path.splitext(path)[1].lower()
    if head.startswith(b"\x00\x00\x01\xba") or ext in (
            ".ts", ".m2ts", ".mts", ".mpg", ".mpeg", ".vob", ".ps") \
            or (head and head[0] == 0x47):
        _unported("MPEG program/transport stream", path)
    if ext in (".265", ".h265", ".hevc"):
        _unported("HEVC elementary stream", path)
    if b"\x00\x00\x01" in head or ext in (".264", ".h264", ".avc"):
        return AnnexBReader(path, codec="h264")
    raise DemuxError(f"unrecognized container: {path}")


def _is_disc_folder(path: str) -> bool:
    """A DVD-Video (VIDEO_TS) or Blu-ray (BDMV) folder, or its parent."""
    name = os.path.basename(os.path.normpath(path)).upper()
    return name in ("VIDEO_TS", "BDMV") or any(
        os.path.isdir(os.path.join(path, d)) for d in ("VIDEO_TS", "BDMV"))


def scan_paths(path: str) -> list:
    """Directory → sorted list of media file paths (batch.c:268); a disc
    folder is one source, which open_source refuses."""
    if os.path.isdir(path):
        if _is_disc_folder(path):
            return [path]
        out = []
        for name in sorted(os.listdir(path)):
            p = os.path.join(path, name)
            if os.path.isfile(p) \
                    and os.path.splitext(name)[1].lower() in _VIDEO_EXTS:
                out.append(p)
        return out
    return [path]
