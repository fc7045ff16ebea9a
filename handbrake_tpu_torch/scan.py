"""Title scan (reference: libhb/scan.c ScanFunc + DecodePreviews).

Opens the source (batch dir → per-file titles, else single stream —
scan.c:150-256), builds a Title per stream, decodes N spaced preview
frames through the real decoder, and derives:
  * geometry / PAR / frame rate (decoder info hook, scan.c:651)
  * interlacing verdict (hb_detect_comb analog, hb.c:1088)
  * autocrop via dark row/column scan + per-preview median (scan.c:443-569)
Previews can be kept for GUI use (hb_save_preview analog).

The counterpart of ``handbrake_tpu/scan.py``.  Previews decode for raw
sources (y4m), H.264 (the native decoder), MPEG-2, HEVC and AV1 (host
numpy), MJPEG (native) and the libavcodec catalog's (VP8/9, Theora,
MPEG-4 part 2, FFV1, ProRes, and HEVC beyond the native subset) ones.
Where libavcodec is missing, a catalog source's scan raises ValueError
naming the codec and what was not found (the reference scans it without
previews).  CEA-608 captions in an H.264 stream (GA94 SEI) are found in
its first 256 KiB and listed as a "cc" subtitle track; a malformed caption
payload leaves them undetected (the reference skips any error there).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .core.buffer import CLOCK
from .codecs.registry import create_video_decoder
from .job.title import AudioTrack, Chapter, SubtitleTrack, Title
from .sources.probe import open_source, scan_paths
from .utils.logging import log


def detect_comb(y: np.ndarray, threshold: int = 16,
                color_diff: int = 8) -> bool:
    """Interlace detection on one luma plane (hb_detect_comb semantics:
    a pixel combs when both field-neighbours differ strongly from it in
    the same direction)."""
    if y.shape[0] < 3:
        return False
    up = y[:-2].astype(np.int32)
    mid = y[1:-1].astype(np.int32)
    down = y[2:].astype(np.int32)
    d1 = mid - up
    d2 = mid - down
    comb = (np.abs(d1) > threshold) & (np.abs(d2) > threshold) \
        & (np.sign(d1) == np.sign(d2))
    frac = comb.mean()
    return bool(frac > 0.005)


def autocrop_one(y: np.ndarray, max_luma: int = 24) -> tuple:
    """(top, bottom, left, right) dark-border crop for one luma plane.
    A row/column is 'dark' when its 95th-percentile luma stays under
    max_luma (tolerates logos/noise like the reference's slope checks)."""
    h, w = y.shape
    row_dark = np.percentile(y, 95, axis=1) < max_luma
    col_dark = np.percentile(y, 95, axis=0) < max_luma
    top = 0
    while top < h // 4 and row_dark[top]:
        top += 1
    bottom = 0
    while bottom < h // 4 and row_dark[h - 1 - bottom]:
        bottom += 1
    left = 0
    while left < w // 4 and col_dark[left]:
        left += 1
    right = 0
    while right < w // 4 and col_dark[w - 1 - right]:
        right += 1
    # even alignment (chroma subsampling)
    return (top & ~1, bottom & ~1, left & ~1, right & ~1)


def _median_crop(crops: list) -> tuple:
    if not crops:
        return (0, 0, 0, 0)
    arr = np.array(crops)
    return tuple(int(v) for v in np.median(arr, axis=0).astype(int))


def scan_title(path: str, index: int = 1, preview_count: int = 10,
               keep_previews: bool = False) -> Optional[Title]:
    """Scan one file into a Title (DecodePreviews analog)."""
    try:
        src = open_source(path)
    except NotImplementedError:
        raise
    except Exception as e:  # noqa: BLE001 — unreadable file → no title
        log(f"scan: cannot open {path}: {e}")
        return None
    t = Title(index=index, path=path,
              name=path.rsplit("/", 1)[-1].rsplit(".", 1)[0])
    t.container = type(src).__name__.replace("Demuxer", "").replace(
        "Reader", "").lower()
    t.duration = getattr(src, "duration", 0)
    video_track = None
    for i, ti in enumerate(src.tracks):
        if ti.kind == "video" and video_track is None:
            video_track = i
            t.video_codec = ti.codec
            t.width, t.height = ti.width, ti.height
            t.par_num, t.par_den = ti.par_num, ti.par_den
            if ti.frame_rate:
                t.vrate_num, t.vrate_den = ti.frame_rate
        elif ti.kind == "audio":
            t.audio.append(AudioTrack(
                track=len(t.audio), codec=ti.codec,
                sample_rate=ti.sample_rate, channels=ti.channels,
                channel_layout="stereo" if ti.channels == 2 else
                f"{ti.channels}ch", language=ti.language))
        elif ti.kind == "subtitle":
            t.subtitles.append(SubtitleTrack(
                track=len(t.subtitles), source=ti.codec,
                language=ti.language))
    for (start, name) in getattr(src, "chapters", []):
        t.chapters.append(Chapter(name=name, duration=0))
    _fill_chapter_durations(t, getattr(src, "chapters", []))
    if video_track is None:
        src.close()
        return None
    # CEA-608 detection (scan-time preview decode role): GA94 cc_data in
    # the first seconds of the video ES → a discoverable "cc" track
    vti = src.tracks[video_track]
    if vti.codec in ("mpeg2", "mpeg2video", "h264"):
        es = bytearray()
        for trk, buf in src.packets():
            if trk == video_track and buf.data:
                es += buf.data
                if len(es) > (1 << 18):
                    break
        from .subtitles.cea608 import extract_cc_h264, extract_cc_mpeg2
        try:
            pairs = (extract_cc_h264(bytes(es)) if vti.codec == "h264"
                     else extract_cc_mpeg2(bytes(es)))
        except (ValueError, IndexError):
            pairs = []      # a malformed caption payload: no track
        if pairs:
            t.subtitles.append(SubtitleTrack(
                track=len(t.subtitles), source="cc", language="und"))
    # --- decode previews ---
    try:
        previews = _decode_previews(src, video_track, preview_count)
    except Exception:
        src.close()
        raise
    crops = []
    comb_votes = 0
    for y, u, v in previews:
        if t.width == 0:
            t.height, t.width = y.shape
        crops.append(autocrop_one(np.asarray(y)))
        if detect_comb(np.asarray(y)):
            comb_votes += 1
    t.crop = _median_crop(crops)
    t.interlaced = comb_votes > len(previews) // 2 if previews else False
    t.nframes = getattr(src, "n_frames", 0)
    if not t.nframes and t.duration and t.vrate_num:
        t.nframes = t.duration * t.vrate_num // (t.vrate_den * CLOCK)
    if keep_previews:
        t.metadata["__previews__"] = previews
    src.close()
    return t


def _fill_chapter_durations(t: Title, raw_chapters: list):
    for i, ch in enumerate(t.chapters):
        start = raw_chapters[i][0]
        end = raw_chapters[i + 1][0] if i + 1 < len(raw_chapters) \
            else t.duration
        ch.duration = max(0, end - start)


def _decode_previews(src, video_track: int, preview_count: int) -> list:
    """Decode up to preview_count frames spaced through the title."""
    ti = src.tracks[video_track]
    previews = []
    dec = create_video_decoder(ti.codec, ti.extradata,
                               width=ti.width, height=ti.height)
    duration = getattr(src, "duration", 0)
    # spaced seek points like the reference (N seeks); for short/raw
    # sources a single pass is cheaper
    seek_pts = [duration * (k + 1) // (preview_count + 1)
                for k in range(preview_count)] if duration else [0]
    seen = 0
    for pts in seek_pts:
        state = src.seek(pts) if hasattr(src, "seek") else None
        got = None
        count = 0
        try:
            it = src.packets(state) if state is not None else src.packets()
            for trk, buf in it:
                if trk != video_track:
                    continue
                if buf.planes is not None:
                    got = (np.asarray(buf.planes[0]),
                           np.asarray(buf.planes[1]),
                           np.asarray(buf.planes[2]))
                else:
                    frames = dec.feed(buf)
                    if frames:
                        f = frames[-1]
                        got = tuple(np.asarray(p) for p in f.planes)
                count += 1
                if got is not None and count >= 1:
                    break
        except Exception:  # noqa: BLE001 — corrupt region: try harder
            pass
        if got is None:
            # retry ladder (scan.c:298-313): fresh decoder, read further
            # past the corruption, tolerate per-packet decode errors
            try:
                dec2 = create_video_decoder(ti.codec, ti.extradata,
                                            width=ti.width, height=ti.height)
                state = src.seek(pts) if hasattr(src, "seek") else None
                it = src.packets(state) if state is not None \
                    else src.packets()
                tried = 0
                for trk, buf in it:
                    if trk != video_track:
                        continue
                    tried += 1
                    if tried > 64:
                        break
                    try:
                        if buf.planes is not None:
                            got = tuple(np.asarray(p)
                                        for p in buf.planes[:3])
                            break
                        frames = dec2.feed(buf)
                        if frames:
                            got = tuple(np.asarray(p)
                                        for p in frames[-1].planes)
                            break
                    except Exception:  # noqa: BLE001 — keep reading
                        continue
            except Exception:  # noqa: BLE001 — give up on this preview
                pass
        if got is not None:
            previews.append(got)
            seen += 1
        if seen >= preview_count:
            break
    return previews


def scan(path: str, title_index: int = 0,
         preview_count: int = 10, keep_previews: bool = False) -> List[Title]:
    """hb_scan analog: path (file or directory) → list of Titles."""
    paths = scan_paths(path)
    titles = []
    for i, p in enumerate(paths):
        if title_index and i + 1 != title_index and len(paths) > 1:
            continue
        t = scan_title(p, index=i + 1, preview_count=preview_count,
                       keep_previews=keep_previews)
        if t is not None:
            titles.append(t)
    return titles
