"""SRT (SubRip) parser — decsrtsub.c semantics.

Handles: UTF-8/UTF-16 BOMs with Latin-1 fallback (the reference iconv's
from a user codeset, decsrtsub.c:~60), index lines (optional/ignored),
`HH:MM:SS,mmm --> HH:MM:SS,mmm` timing (dot or comma millis, loose
whitespace), multi-line cues, markup tags stripped for text output,
overlapping cues preserved (the renderer/muxer decides layering), and a
fixed pts offset (job SubtitleJobTrack.offset, ms).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

from ..core.buffer import CLOCK

_TIME = re.compile(
    r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")
_TAG = re.compile(r"<[^>]{1,64}>|\{\\[^}]{0,64}\}")


@dataclasses.dataclass
class SubEvent:
    pts: int                 # 90 kHz
    stop: int                # 90 kHz
    text: str                # plain text, markup stripped, \n line breaks

    @property
    def duration(self) -> int:
        return self.stop - self.pts


def _decode_bytes(data: bytes, codeset: Optional[str] = None) -> str:
    if data.startswith(b"\xef\xbb\xbf"):
        return data[3:].decode("utf-8", "replace")
    if data.startswith(b"\xff\xfe"):
        return data.decode("utf-16-le", "replace")
    if data.startswith(b"\xfe\xff"):
        return data.decode("utf-16-be", "replace")
    for cs in ([codeset] if codeset else []) + ["utf-8", "latin-1"]:
        try:
            return data.decode(cs)
        except (UnicodeDecodeError, LookupError):
            continue
    return data.decode("utf-8", "replace")


def _ticks(h, m, s, frac) -> int:
    ms = int(frac.ljust(3, "0")[:3])
    return ((int(h) * 3600 + int(m) * 60 + int(s)) * 1000 + ms) * CLOCK // 1000


_VTT_TIME = re.compile(
    r"(?:(\d+):)?(\d+):(\d+)[.,](\d+)\s*-->\s*(?:(\d+):)?(\d+):(\d+)[.,](\d+)")
_SSA_TIME = re.compile(r"(\d+):(\d+):(\d+)[.:](\d+)")


def parse_srt(data: bytes, codeset: Optional[str] = None,
              offset_ms: int = 0) -> List[SubEvent]:
    """Parse an SRT file into pts-ordered SubEvents (90 kHz)."""
    text = _decode_bytes(data, codeset).replace("\r\n", "\n").replace(
        "\r", "\n")
    off = offset_ms * CLOCK // 1000
    events: List[SubEvent] = []
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line:
            continue
        m = _TIME.search(line)
        if m is None:
            # index line (or garbage) — timing expected on the next line
            if i < len(lines):
                m = _TIME.search(lines[i])
                if m is None:
                    continue
                i += 1
            else:
                break
        start = _ticks(m.group(1), m.group(2), m.group(3), m.group(4)) + off
        stop = _ticks(m.group(5), m.group(6), m.group(7), m.group(8)) + off
        body = []
        while i < len(lines) and lines[i].strip() != "":
            body.append(_TAG.sub("", lines[i]).rstrip())
            i += 1
        txt = "\n".join(body).strip()
        if txt and stop > start >= 0:
            events.append(SubEvent(pts=start, stop=stop, text=txt))
    events.sort(key=lambda e: e.pts)
    return events


def parse_ssa(data: bytes, codeset: Optional[str] = None,
              offset_ms: int = 0) -> List[SubEvent]:
    """SSA/ASS parser (decssasub.c semantics, text output only).

    Reads the [Events] section's own `Format:` line to locate the
    Start/End/Text columns (files reorder them), times are
    H:MM:SS.cc centiseconds, `{\\...}` override blocks are stripped,
    `\\N`/`\\n` break lines and `\\h` is a hard space."""
    text = _decode_bytes(data, codeset).replace("\r\n", "\n").replace(
        "\r", "\n")
    off = offset_ms * CLOCK // 1000
    fields = ["layer", "start", "end", "style", "name", "marginl",
              "marginr", "marginv", "effect", "text"]
    events: List[SubEvent] = []
    in_events = False
    for line in text.split("\n"):
        s = line.strip()
        low = s.lower()
        if low.startswith("["):
            in_events = low.startswith("[events")
            continue
        if not in_events or not s:
            continue
        if low.startswith("format:"):
            fields = [f.strip().lower() for f in s[7:].split(",")]
            continue
        if not low.startswith("dialogue:"):
            continue
        body = s[9:].strip()
        # Text is the last field: split only len(fields)-1 times
        parts = body.split(",", len(fields) - 1)
        if len(parts) < len(fields):
            continue
        row = dict(zip(fields, parts))
        ms = _SSA_TIME.match(row.get("start", "").strip())
        me = _SSA_TIME.match(row.get("end", "").strip())
        if not ms or not me:
            continue
        start = _ticks(ms.group(1), ms.group(2), ms.group(3),
                       ms.group(4).ljust(2, "0")[:2] + "0") + off
        stop = _ticks(me.group(1), me.group(2), me.group(3),
                      me.group(4).ljust(2, "0")[:2] + "0") + off
        txt = _TAG.sub("", row["text"])
        txt = txt.replace("\\N", "\n").replace("\\n", "\n") \
            .replace("\\h", " ").strip()
        if txt and stop > start >= 0:
            events.append(SubEvent(pts=start, stop=stop, text=txt))
    events.sort(key=lambda e: e.pts)
    return events


def parse_vtt(data: bytes, codeset: Optional[str] = None,
              offset_ms: int = 0) -> List[SubEvent]:
    """WebVTT parser (the reference's IMPORTVTT source role).

    Cue ids are optional, hours are optional in timestamps, cue
    settings after the timing line are ignored, NOTE/STYLE/REGION
    blocks are skipped, and `<...>` markup (incl. voice/timestamps)
    is stripped for text output."""
    text = _decode_bytes(data, codeset).replace("\r\n", "\n").replace(
        "\r", "\n")
    off = offset_ms * CLOCK // 1000
    events: List[SubEvent] = []
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        s = lines[i].strip()
        if s.startswith(("NOTE", "STYLE", "REGION", "WEBVTT")):
            i += 1
            while i < len(lines) and lines[i].strip():
                i += 1
            continue
        m = _VTT_TIME.search(s)
        i += 1
        if m is None:
            continue
        start = _ticks(m.group(1) or "0", m.group(2), m.group(3),
                       m.group(4)) + off
        stop = _ticks(m.group(5) or "0", m.group(6), m.group(7),
                      m.group(8)) + off
        body = []
        while i < len(lines) and lines[i].strip() != "":
            body.append(_TAG.sub("", lines[i]).rstrip())
            i += 1
        txt = "\n".join(body).strip()
        if txt and stop > start >= 0:
            events.append(SubEvent(pts=start, stop=stop, text=txt))
    events.sort(key=lambda e: e.pts)
    return events


def parse_textsub(data: bytes, fmt: Optional[str] = None,
                  codeset: Optional[str] = None,
                  offset_ms: int = 0) -> List[SubEvent]:
    """Dispatch on declared format or content sniff (SRT/SSA/VTT)."""
    f = (fmt or "").strip().lower()
    if f in ("ssa", "ass"):
        return parse_ssa(data, codeset, offset_ms)
    if f in ("vtt", "webvtt"):
        return parse_vtt(data, codeset, offset_ms)
    # declared SRT (the schema default) still sniffs: the magic lines
    # below are invalid SRT, so a mislabeled import can't regress
    head = _decode_bytes(data[:4096], codeset).lstrip("﻿").lstrip()
    if head.startswith("WEBVTT"):
        return parse_vtt(data, codeset, offset_ms)
    low = head.lower()
    if "[script info]" in low or "[events]" in low:
        return parse_ssa(data, codeset, offset_ms)
    return parse_srt(data, codeset, offset_ms)
