"""DVD-Video folder scan (reference: libhb/dvd.c hb_dvdread_* — IFO
walk without libdvdread).

Parses VIDEO_TS.IFO (VMGI: title search pointer table TT_SRPT) and each
VTS_xx_0.IFO (VTSI: program chain table VTS_PGCIT for playback time,
chapter/program map, and the 16-color subpicture CLUT that feeds
subtitles/vobsub.py), then exposes every title as a PSDemuxer over the
concatenated VTS_xx_[1..9].VOB menuless program stream.

Structures implemented (DVD-Video part 3 layout, offsets in bytes):
  VMGI  0x00 "DVDVIDEO-VMG", 0xC4 TT_SRPT start sector
  TT_SRPT  u16 count, u16 pad, u32 end; 12-byte entries
           (type, angles, nr_ptts, parental, vts_nr, vts_ttn, vts_sect)
  VTSI  0x00 "DVDVIDEO-VTS", 0xCC VTS_PGCIT start sector, 0x200 the
        VTS video attributes (byte 0: MPEG version, NTSC/PAL, display
        aspect 0 = 4:3 / 3 = 16:9; byte 1 bits 3-2: picture size)
  VTS_PGCIT u16 count, u16 pad, u32 end; 8-byte srp entries
           (category u32, pgc offset u32 from table start)
  PGC   0x02 nr_programs, 0x03 nr_cells, 0x04 playback time (BCD
        hh:mm:ss:ff + frame-rate bits), 0xA4 16x4-byte 0YCrCb palette,
        0xE6 program map offset, 0xE8 cell playback info offset
  VTSI  0x203 the number of audio streams, 0x204 their attributes, 8
        bytes each (byte 0: coding mode 0 AC-3 / 2-3 MPEG / 4 LPCM / 6
        DTS, language type 1 = code present; byte 1: rate, channels - 1;
        bytes 2-3: the ISO 639-1 code)

The audio attributes go to the tracks of their stream numbers (substream
0x80 + i AC-3, 0x88 + i DTS, 0xA0 + i LPCM, stream 0xC0 + i MPEG): the
language is the IFO's, the codec and channels the stream's, and the log
says where the two disagree and which listed stream the VOBs never carry
(``apply_audio_attributes``; the reference reads no attributes).

Cells/angles beyond the first PGC and menu domains are out of scope.

The video attributes go to the title's video track (``open_dvd_title``):
the IFO's display aspect decides the track's pixel aspect where it names
the stream's picture size, and the log says where it and the sequence
header disagree (the reference reads no attributes).
"""
from __future__ import annotations

import os
from fractions import Fraction
from typing import List, NamedTuple, Optional

_SECTOR = 2048
# the VTS video attributes' codes
_STANDARDS = {0: "NTSC", 1: "PAL"}
_ASPECTS = {0: (4, 3), 3: (16, 9)}
_WIDTHS = {0: 720, 1: 704, 2: 352, 3: 352}
# the frame rates each standard's MPEG-2 stream may carry
_STANDARD_RATES = {"NTSC": ((30000, 1001), (24000, 1001)),
                   "PAL": ((25, 1),)}

# the audio attributes' coding modes, and the stream each one's stream
# number i is carried in: (stream id, substream id or None) at i = 0
_AUDIO_CODECS = {0: "ac3", 2: "mp2", 3: "mp2", 4: "lpcm", 6: "dts"}
_AUDIO_STREAMS = {"ac3": (0xBD, 0x80), "dts": (0xBD, 0x88),
                  "lpcm": (0xBD, 0xA0), "mp2": (0xC0, None)}


def _bcd(v: int) -> int:
    return (v >> 4) * 10 + (v & 0x0F)


def _playback_seconds(b: bytes) -> float:
    """4-byte PGC playback time: BCD hh mm ss, frames byte with the
    frame-rate code in bits 7-6 (11=30fps/10=25fps)."""
    h, m, s = _bcd(b[0]), _bcd(b[1]), _bcd(b[2])
    rate = 30.0 if (b[3] >> 6) == 3 else 25.0
    f = _bcd(b[3] & 0x3F)
    return h * 3600 + m * 60 + s + f / rate


class AudioAttributes(NamedTuple):
    """One audio stream's attributes (VTSI_MAT 0x204 + 8 i)."""
    codec: Optional[str]            # ac3 | mp2 | lpcm | dts; None: other
    channels: int
    sample_rate: int
    language: str                   # ISO 639-2, "und" where none is given

    @classmethod
    def parse(cls, attr: bytes) -> "AudioAttributes":
        from ..job.lang import to_iso639_2
        code = attr[2:4].decode("latin-1", "replace").strip("\x00 ")
        lang = to_iso639_2(code) if (attr[0] >> 2) & 3 == 1 and code \
            else "und"
        return cls(_AUDIO_CODECS.get(attr[0] >> 5), (attr[1] & 7) + 1,
                   96000 if (attr[1] >> 4) & 3 == 1 else 48000, lang)


class VideoAttributes(NamedTuple):
    """A VTS's video attributes (VTSI_MAT 0x200)."""
    standard: str                   # NTSC | PAL
    display_aspect: Optional[tuple]     # (4, 3), (16, 9); None: reserved
    picture_size: tuple             # the (width, height) they describe

    @classmethod
    def parse(cls, attr: bytes) -> "VideoAttributes":
        a, b = attr[0], attr[1]
        standard = _STANDARDS.get((a >> 4) & 3, "NTSC")
        size = (b >> 2) & 3
        lines = 576 if standard == "PAL" else 480
        return cls(standard, _ASPECTS.get((a >> 2) & 3),
                   (_WIDTHS[size], lines // 2 if size == 3 else lines))


class DvdTitle:
    def __init__(self, vts: int, ttn: int, duration_s: float,
                 chapter_times: list, palette: list, vob_paths: list):
        self.vts = vts
        self.ttn = ttn
        self.duration_s = duration_s
        self.chapter_times = chapter_times     # start offsets, seconds
        self.palette = palette                 # 16 RGB ints (vobsub)
        self.vob_paths = vob_paths

    @property
    def video(self) -> VideoAttributes:
        """The title's VTS video attributes, read from its IFO."""
        ifo = os.path.join(os.path.dirname(self.vob_paths[0]),
                           f"VTS_{self.vts:02d}_0.IFO")
        with open(ifo, "rb") as f:
            f.seek(0x200)
            return VideoAttributes.parse(f.read(2).ljust(2, b"\x00"))

    @property
    def audio(self) -> List[AudioAttributes]:
        """The title's VTS audio attributes, one a stream, from its IFO."""
        ifo = os.path.join(os.path.dirname(self.vob_paths[0]),
                           f"VTS_{self.vts:02d}_0.IFO")
        with open(ifo, "rb") as f:
            f.seek(0x202)
            head = f.read(2 + 8 * 8).ljust(66, b"\x00")
        n = min(8, int.from_bytes(head[:2], "big"))
        return [AudioAttributes.parse(head[2 + 8 * i:10 + 8 * i])
                for i in range(n)]


def _yuv_palette_to_rgb(entries: list) -> list:
    out = []
    for v in entries:
        # studio-range BT.601 (DVD CLUT luma is 16-235)
        y = (((v >> 16) & 0xFF) - 16) * 255.0 / 219.0
        cr = (((v >> 8) & 0xFF) - 128) * 255.0 / 224.0
        cb = ((v & 0xFF) - 128) * 255.0 / 224.0
        r = max(0, min(255, round(y + 1.402 * cr)))
        g = max(0, min(255, round(y - 0.344136 * cb - 0.714136 * cr)))
        b = max(0, min(255, round(y + 1.772 * cb)))
        out.append((r << 16) | (g << 8) | b)
    return out


def is_dvd_folder(path: str) -> bool:
    vt = path if os.path.basename(path).upper() == "VIDEO_TS" \
        else os.path.join(path, "VIDEO_TS")
    return os.path.isfile(os.path.join(vt, "VIDEO_TS.IFO"))


def scan_dvd(path: str) -> List[DvdTitle]:
    """VIDEO_TS folder (or its parent) → list of DvdTitle."""
    vt = path if os.path.basename(path).upper() == "VIDEO_TS" \
        else os.path.join(path, "VIDEO_TS")
    with open(os.path.join(vt, "VIDEO_TS.IFO"), "rb") as f:
        vmg = f.read()
    if not vmg.startswith(b"DVDVIDEO-VMG"):
        raise ValueError("not a VMG IFO")
    srpt_off = int.from_bytes(vmg[0xC4:0xC8], "big") * _SECTOR
    n_titles = int.from_bytes(vmg[srpt_off:srpt_off + 2], "big")
    titles = []
    for t in range(n_titles):
        e = srpt_off + 8 + t * 12
        nr_ptts = int.from_bytes(vmg[e + 2:e + 4], "big")
        vts_nr = vmg[e + 6]
        vts_ttn = vmg[e + 7]
        ti = _scan_vts(vt, vts_nr, vts_ttn, nr_ptts)
        if ti is not None:
            titles.append(ti)
    return titles


def _scan_vts(vt: str, vts_nr: int, ttn: int,
              nr_ptts: int) -> Optional[DvdTitle]:
    ifo = os.path.join(vt, f"VTS_{vts_nr:02d}_0.IFO")
    if not os.path.isfile(ifo):
        return None
    with open(ifo, "rb") as f:
        vtsi = f.read()
    if not vtsi.startswith(b"DVDVIDEO-VTS"):
        return None
    pgcit_off = int.from_bytes(vtsi[0xCC:0xD0], "big") * _SECTOR
    n_pgcs = int.from_bytes(vtsi[pgcit_off:pgcit_off + 2], "big")
    if ttn < 1 or ttn > n_pgcs:
        ttn = 1
    srp = pgcit_off + 8 + (ttn - 1) * 8
    pgc = pgcit_off + int.from_bytes(vtsi[srp + 4:srp + 8], "big")
    duration = _playback_seconds(vtsi[pgc + 4:pgc + 8])
    n_programs = vtsi[pgc + 2]
    palette = _yuv_palette_to_rgb(
        [int.from_bytes(vtsi[pgc + 0xA4 + 4 * i:pgc + 0xA8 + 4 * i],
                        "big") for i in range(16)])
    # chapters: program map (cell numbers) + cell playback table times
    pm_off = pgc + int.from_bytes(vtsi[pgc + 0xE6:pgc + 0xE8], "big")
    cp_off = pgc + int.from_bytes(vtsi[pgc + 0xE8:pgc + 0xEA], "big")
    n_cells = vtsi[pgc + 3]
    cell_dur = []
    for c in range(n_cells):
        cb = cp_off + c * 24                 # cell playback info, 24 B
        cell_dur.append(_playback_seconds(vtsi[cb + 4:cb + 8]))
    chapter_times = []
    acc = 0.0
    cell_starts = []
    for d in cell_dur:
        cell_starts.append(acc)
        acc += d
    for p in range(min(n_programs, max(1, nr_ptts))):
        entry_cell = vtsi[pm_off + p] if pm_off + p < len(vtsi) else 1
        idx = max(1, entry_cell) - 1
        chapter_times.append(cell_starts[idx]
                             if idx < len(cell_starts) else 0.0)
    vobs = []
    for k in range(1, 10):
        p = os.path.join(vt, f"VTS_{vts_nr:02d}_{k}.VOB")
        if os.path.isfile(p):
            vobs.append(p)
    if not vobs:
        return None
    return DvdTitle(vts_nr, ttn, duration, chapter_times, palette, vobs)


def apply_audio_attributes(d, t: DvdTitle):
    """The title's audio tracks (demuxer ``d``) against the IFO's audio
    attributes: each listed stream i finds its track through the stream
    of its coding mode, or failing that through another mode's stream of
    number i; the track takes the IFO's language and keeps the stream's
    codec and channels, with a log line where the IFO says otherwise.  A
    listed stream that the VOBs never carry gets no track, and a log
    line."""
    from ..utils.logging import log

    def track(codec, i):
        sid, sub = _AUDIO_STREAMS[codec]
        return d.stream_track(sid + i) if sub is None \
            else d.stream_track(sid, sub + i)

    for i, a in enumerate(t.audio):
        ifo = (f"{a.codec or 'an unknown coding mode'}, {a.channels} ch, "
               f"{a.language}")
        order = ([a.codec] if a.codec else []) + [
            c for c in _AUDIO_STREAMS if c != a.codec]
        idx = next((track(c, i) for c in order
                    if track(c, i) is not None), None)
        if idx is None:
            log(f"dvd: the IFO lists audio stream {i + 1} ({ifo}) that the "
                f"VOBs never carry; it gets no track")
            continue
        ti = d.tracks[idx]
        ti.language = a.language
        if a.codec != ti.codec:
            log(f"dvd: audio stream {i + 1} is {ti.codec} in the VOBs, "
                f"{a.codec or 'an unknown coding mode'} in the IFO; the "
                f"stream's codec is kept")
        if a.channels != ti.channels:
            log(f"dvd: audio stream {i + 1} ({ti.codec}) has "
                f"{ti.channels} channels in the VOBs, {a.channels} in the "
                f"IFO; the stream's count is kept")


def apply_video_attributes(ti, t: DvdTitle):
    """The title's video track against the IFO's video attributes.  The
    IFO's display aspect sets the pixel aspect where the attributes name
    the track's picture size; a sequence header that says otherwise is
    overruled, with a log line.  A header's frame rate is kept, with a
    log line where it is not one of the IFO standard's.  Without a
    header (the track 0x0) the IFO gives the rate and the aspect."""
    from ..utils.logging import log
    v = t.video
    if v.display_aspect is None:
        log(f"dvd: VTS {t.vts}'s video attributes hold a reserved display "
            f"aspect code; the track keeps {ti.par_num}:{ti.par_den}")
        return
    w, h = v.picture_size
    n, d = v.display_aspect
    par = Fraction(n * h, d * w)
    ifo = f"{v.standard} {w}x{h} {n}:{d}"
    if not ti.width:
        ti.frame_rate = _STANDARD_RATES[v.standard][0]
        ti.par_num, ti.par_den = par.numerator, par.denominator
        log(f"dvd: no sequence header read; the IFO's attributes ({ifo}) "
            f"give {ti.frame_rate[0]}/{ti.frame_rate[1]} fps and pixel "
            f"aspect {ti.par_num}:{ti.par_den}")
        return
    if ti.frame_rate not in _STANDARD_RATES[v.standard]:
        log(f"dvd: the sequence header's {ti.frame_rate[0]}/"
            f"{ti.frame_rate[1]} fps is not {v.standard}'s (the IFO's "
            f"attributes: {ifo}); the header's rate is kept")
    if (ti.width, ti.height) != (w, h):
        log(f"dvd: the IFO's attributes ({ifo}) do not describe the "
            f"{ti.width}x{ti.height} stream; its sequence header's pixel "
            f"aspect {ti.par_num}:{ti.par_den} is kept")
        return
    if (ti.par_num, ti.par_den) != (par.numerator, par.denominator):
        log(f"dvd: the sequence header's pixel aspect {ti.par_num}:"
            f"{ti.par_den} disagrees with the IFO's display aspect "
            f"({ifo}); the IFO's {par.numerator}:{par.denominator} is "
            f"taken")
        ti.par_num, ti.par_den = par.numerator, par.denominator


class _ConcatFile:
    """Read-only file object over the concatenation of several files
    (a multi-VOB VTS behaves as one program stream)."""

    def __init__(self, paths):
        self.paths = paths
        self.sizes = [os.path.getsize(p) for p in paths]
        self.total = sum(self.sizes)
        self._fs = [open(p, "rb") for p in paths]
        self.pos = 0

    def seek(self, off, whence=0):
        if whence == 2:
            off = self.total + off
        elif whence == 1:
            off = self.pos + off
        self.pos = max(0, min(self.total, off))
        return self.pos

    def tell(self):
        return self.pos

    def read(self, n=-1):
        if n < 0:
            n = self.total - self.pos
        out = bytearray()
        while n > 0 and self.pos < self.total:
            i, off = 0, self.pos
            while off >= self.sizes[i]:
                off -= self.sizes[i]
                i += 1
            f = self._fs[i]
            f.seek(off)
            chunk = f.read(min(n, self.sizes[i] - off))
            if not chunk:
                break
            out += chunk
            self.pos += len(chunk)
            n -= len(chunk)
        return bytes(out)

    def close(self):
        for f in self._fs:
            f.close()


def open_dvd_title(path: str, title_index: int = 1):
    """→ (PSDemuxer over the title's VOBs, DvdTitle)."""
    from .ps import PSDemuxer
    titles = scan_dvd(path)
    if not titles:
        raise ValueError("no DVD titles")
    t = titles[min(max(title_index, 1), len(titles)) - 1]
    d = PSDemuxer.__new__(PSDemuxer)
    d.path = t.vob_paths[0]
    d.f = _ConcatFile(t.vob_paths)
    d.size = d.f.total
    d.tracks = []
    d.duration = 0
    d._sid_to_track = {}
    d._scan()
    vids = [ti for ti in d.tracks if ti.kind == "video"]
    if vids:
        apply_video_attributes(vids[0], t)
    if not d.duration and t.duration_s:
        d.duration = int(t.duration_s * 90000)
    apply_audio_attributes(d, t)
    # IFO CLUT → vobsub tracks (decvobsub palette source)
    for ti in d.tracks:
        if ti.kind == "subtitle" or ti.codec == "vobsub":
            ti.extradata = ("palette: " + ", ".join(
                f"{c:06x}" for c in t.palette)).encode()
    d.chapters = [(int(s * 90000), f"Chapter {i + 1}")
                  for i, s in enumerate(t.chapter_times)]
    return d, t
