"""Blu-ray folder scan (reference: libhb/bd.c hb_bd_* — MPLS playlist
walk without libbluray).

Parses BDMV/PLAYLIST/*.mpls (MPLS0100/0200/0300): the PlayList section
(play items → clip ids + in/out times in 45 kHz ticks) and the
PlayListMark section (type-1 entry marks → chapters), then exposes each
playlist as a title over the concatenation of its
BDMV/STREAM/<clip>.m2ts files through the TS demuxer (192-byte m2ts
packets are auto-detected there).

Multi-angle items, subpaths (PiP/secondary audio) and the index/movie
object layer are out of scope — like the reference, titles come from
playlists directly.
"""
from __future__ import annotations

import os
import struct
from typing import List

from .dvd import _ConcatFile

_TICKS = 45000                         # mpls timestamps per second


class BdTitle:
    def __init__(self, playlist: str, duration_s: float,
                 chapter_times: list, clip_paths: list):
        self.playlist = playlist       # e.g. "00000.mpls"
        self.duration_s = duration_s
        self.chapter_times = chapter_times
        self.clip_paths = clip_paths


def is_bd_folder(path: str) -> bool:
    bd = path if os.path.basename(path).upper() == "BDMV" \
        else os.path.join(path, "BDMV")
    return os.path.isdir(os.path.join(bd, "PLAYLIST"))


def _parse_mpls(data: bytes, stream_dir: str):
    if data[:4] != b"MPLS":
        raise ValueError("not an mpls")
    pl_start, mark_start = struct.unpack(">II", data[8:16])
    # PlayList section
    n_items = struct.unpack(">H", data[pl_start + 6:pl_start + 8])[0]
    pos = pl_start + 10
    clips = []
    item_starts = []                   # cumulative start of each item, s
    item_ins = []                      # clip-local in_time per item, s
    total = 0.0
    for _ in range(n_items):
        ln = struct.unpack(">H", data[pos:pos + 2])[0]
        clip = data[pos + 2:pos + 7].decode("ascii", "replace")
        codec = data[pos + 7:pos + 11]
        in_t, out_t = struct.unpack(">II", data[pos + 14:pos + 22])
        if codec == b"M2TS":
            p = os.path.join(stream_dir, clip + ".m2ts")
            if os.path.isfile(p):
                clips.append(p)
        item_starts.append(total)
        item_ins.append(in_t / _TICKS)
        total += max(0, out_t - in_t) / _TICKS
        pos += 2 + ln
    # PlayListMark section: 14-byte entries, type 1 = entry mark
    chapters = []
    if mark_start and mark_start + 6 <= len(data):
        n_marks = struct.unpack(
            ">H", data[mark_start + 4:mark_start + 6])[0]
        mp = mark_start + 6
        for _ in range(n_marks):
            mtype = data[mp + 1]
            item_ref = struct.unpack(">H", data[mp + 2:mp + 4])[0]
            ts = struct.unpack(">I", data[mp + 4:mp + 8])[0]
            if mtype == 1 and item_ref < n_items:
                # mark timestamps are on the clip timeline: subtract the
                # item's in_time, offset by its start in the playlist
                chapters.append(item_starts[item_ref]
                                + ts / _TICKS - item_ins[item_ref])
            mp += 14
    return clips, total, sorted(chapters)


def scan_bd(path: str) -> List[BdTitle]:
    bd = path if os.path.basename(path).upper() == "BDMV" \
        else os.path.join(path, "BDMV")
    pl_dir = os.path.join(bd, "PLAYLIST")
    stream_dir = os.path.join(bd, "STREAM")
    titles = []
    for name in sorted(os.listdir(pl_dir)):
        if not name.lower().endswith(".mpls"):
            continue
        with open(os.path.join(pl_dir, name), "rb") as f:
            data = f.read()
        try:
            clips, dur, chapters = _parse_mpls(data, stream_dir)
        except (ValueError, struct.error):
            continue
        if clips:
            titles.append(BdTitle(name, dur, chapters, clips))
    # longest playlist first (hb_bd_main_feature heuristic)
    titles.sort(key=lambda t: -t.duration_s)
    return titles


def open_bd_title(path: str, title_index: int = 1):
    """→ (TSDemuxer over the playlist's m2ts clips, BdTitle)."""
    from .ts import TSDemuxer
    titles = scan_bd(path)
    if not titles:
        raise ValueError("no BD playlists")
    t = titles[min(max(title_index, 1), len(titles)) - 1]
    d = TSDemuxer.__new__(TSDemuxer)
    d.path = t.clip_paths[0]
    d.f = _ConcatFile(t.clip_paths)
    d._detect_packet_size()
    d.tracks = []
    d._pid_to_track = {}
    d._pes_buf = {}
    d._pes_meta = {}
    d.duration = 0
    d.chapters = [(int(s * 90000), f"Chapter {i + 1}")
                  for i, s in enumerate(t.chapter_times)]
    d._scan()
    if not d.duration and t.duration_s:
        d.duration = int(t.duration_s * 90000)
    if not d.chapters:
        d.chapters = [(int(s * 90000), f"Chapter {i + 1}")
                      for i, s in enumerate(t.chapter_times)]
    return d, t
