"""Builders of disc and stream sources around elementary streams: MPEG-2
program-stream packs (VOB), DVD-Video IFOs, MPEG transport streams
(188-byte TS and 192-byte m2ts), Blu-ray MPLS playlists and AVI files,
with the substream headers the port's demuxers read
(``sources/{ps,dvd,ts,bd,avi}.py``).
The port's disc tests and ``chip_smoke.py`` build their sources with them
from the committed fixtures (``tests/data/torch_sources/``) and the
port's own encoders.

Host code with no dependency beyond numpy.  ``FIXTURES`` is the fixture
directory of a checkout of the repository.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data", "torch_sources")


# PES payload bytes a pack carries at most (a DVD pack is 2048 bytes)
PS_CHUNK = 2000
SECTOR = 2048


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def split_pictures(es: bytes) -> list:
    """An MPEG-2 elementary stream cut into access units: each picture
    with the sequence and GOP headers that precede it."""
    pics = []
    i = 0
    while True:
        i = es.find(b"\x00\x00\x01\x00", i)
        if i < 0:
            break
        pics.append(i)
        i += 4
    cuts = [0]
    for prev, cur in zip(pics, pics[1:]):
        hdrs = [j for j in (es.find(b"\x00\x00\x01\xb3", prev + 4, cur),
                            es.find(b"\x00\x00\x01\xb8", prev + 4, cur))
                if j >= 0]
        cuts.append(min(hdrs) if hdrs else cur)
    return [es[a:b] for a, b in zip(cuts, cuts[1:] + [len(es)])]


def picture_types(es: bytes) -> list:
    """The coding type (1 I, 2 P, 3 B) of each picture, in stream order."""
    out = []
    i = 0
    while True:
        i = es.find(b"\x00\x00\x01\x00", i)
        if i < 0:
            return out
        out.append((es[i + 5] >> 3) & 7)
        i += 4


def display_pts(types: list, first: int, ticks: int) -> list:
    """Each picture's presentation time in stream order: an anchor (I or
    P) shows after the B pictures that follow it in the stream."""
    order = []
    pending = None
    for k, t in enumerate(types):
        if t == 3:
            order.append(k)
        else:
            if pending is not None:
                order.append(pending)
            pending = k
    if pending is not None:
        order.append(pending)
    pts = [0] * len(types)
    for shown, k in enumerate(order):
        pts[k] = first + shown * ticks
    return pts


def cc_user_data(pairs) -> bytes:
    """ATSC A/53 caption user data (GA94, cc_data) carrying CEA-608
    byte pairs of field 1."""
    trips = b"".join(bytes([0xFC, a, b]) for a, b in pairs)
    cc = bytes([0x40 | len(pairs), 0xFF]) + trips
    return b"\x00\x00\x01\xb2GA94\x03" + cc + b"\xff"


def cea608_popon(text: str) -> list:
    """CEA-608 pairs that load ``text`` into the pop-on buffer: RCL
    (doubled), ENM, a PAC on row 1, then the characters.  EOC (0x14,
    0x2F) shows it and EDM (0x14, 0x2C) clears it."""
    pairs = [(0x14, 0x20), (0x14, 0x20), (0x14, 0x2E), (0x14, 0x40)]
    data = text.encode("ascii")
    for i in range(0, len(data), 2):
        pairs.append((data[i], data[i + 1] if i + 1 < len(data) else 0))
    return pairs


def insert_user_data(au: bytes, user: bytes) -> bytes:
    """An MPEG-2 access unit with ``user`` after its picture header (and
    its picture coding extension), before the first slice."""
    i = au.find(b"\x00\x00\x01\x00")
    j = i + 4
    while True:
        j = au.find(b"\x00\x00\x01", j)
        if j < 0 or 0x01 <= au[j + 3] <= 0xAF:
            break
        j += 4
    j = len(au) if j < 0 else j
    return au[:j] + user + au[j:]


# ---------------------------------------------------------------------------
# MPEG-2 program stream (VOB)
# ---------------------------------------------------------------------------
def pack_header() -> bytes:
    """An MPEG-2 pack header (14 bytes, SCR 0, no stuffing)."""
    return b"\x00\x00\x01\xba" + bytes([0x44, 0, 4, 0, 4, 1, 0, 1, 0x89,
                                         0xF8])


def _ts33(pts: int, marker: int) -> bytes:
    v = pts & ((1 << 33) - 1)
    return bytes([marker | (((v >> 30) & 7) << 1) | 1, (v >> 22) & 0xFF,
                  (((v >> 15) & 0x7F) << 1) | 1, (v >> 7) & 0xFF,
                  ((v & 0x7F) << 1) | 1])


def ps_pes(sid: int, payload: bytes, pts=None) -> bytes:
    """One MPEG-2 PES packet with an explicit length (PS)."""
    ext = _ts33(pts, 0x20) if pts is not None else b""
    body = bytes([0x80, 0x80 if pts is not None else 0, len(ext)]) + ext \
        + payload
    return b"\x00\x00\x01" + bytes([sid]) + len(body).to_bytes(2, "big") \
        + body


def ac3_sub(payload: bytes) -> bytes:
    """Private stream 1 AC-3 substream 0x80: id, frame count, first
    access."""
    return bytes([0x80, 1, 0, 1]) + payload


def lpcm_sub(payload: bytes, stream: int = 0) -> bytes:
    """Private stream 1 DVD LPCM substream 0xA0 + ``stream``: id, frame
    count, first access, emphasis/frame number, quantization/rate/channels
    (16-bit, 48 kHz, stereo), dynamic range: the 7 bytes PSDemuxer
    strips, byte 5 its header."""
    return bytes([0xA0 + stream, 1, 0, 4, 0, 0x01, 0x80]) + payload


def dts_sub(payload: bytes, stream: int = 0) -> bytes:
    """Private stream 1 DTS substream 0x88 + ``stream``: id, frame count,
    first access (the 4 bytes PSDemuxer strips, as for AC-3)."""
    return bytes([0x88 + stream, 1, 0, 1]) + payload


def pack_bits(fields) -> bytes:
    """(value, width) fields, most significant bit first, zero-padded to
    a whole byte."""
    v, n = 0, 0
    for val, width in fields:
        v, n = (v << width) | val, n + width
    return (v << (-n) % 8).to_bytes((n + 7) // 8, "big")


def dts_core_frame(amode: int = 9, lff: int = 1, sfreq: int = 13,
                   rate: int = 15, size: int = 1024,
                   samples: int = 512, fill: int = 0) -> bytes:
    """One DTS core frame (ETSI TS 102 114 5.3.1): the frame header of
    these fields (AMODE 9 + LFF 1: 5.1; SFREQ 13: 48 kHz; RATE 15: 768
    kb/s; ``size`` bytes; ``samples`` a frame) and a payload of the byte
    ``fill``.  It describes a stream; it decodes to nothing."""
    fields = [(1, 1), (31, 5), (0, 1), (samples // 32 - 1, 7),
              (size - 1, 14), (amode, 6), (sfreq, 4), (rate, 5), (0, 1),
              (0, 1), (0, 1), (0, 1), (0, 1), (0, 3), (0, 1), (0, 1),
              (lff, 2), (0, 1), (0, 1), (7, 4), (0, 2), (6, 3), (0, 1),
              (0, 1), (0, 4)]
    head = b"\x7f\xfe\x80\x01" + pack_bits(fields)
    return head + bytes([fill]) * (size - len(head))


def dts_exss(size: int, fill: int = 0, wide: bool = False,
             asset=None, xll: bool = False) -> bytes:
    """One DTS extension substream (ETSI TS 102 114 7.5), as DTS-HD puts
    one after each core frame and DTS Express sends alone: the sync word
    0x64582025, substream index 0, a header whose size fields are 8 and
    16 bits (12 and 20 with ``wide``), then ``size`` bytes in all of the
    byte ``fill``.  Without ``asset`` the 16-byte header carries no
    static fields; with ``asset`` = (sample rate, channels, samples a
    frame) it carries them (reference clock 48 kHz, one presentation
    and one asset) and the first asset descriptor says nuMaxSampleRate
    and nuTotalNumChs; with ``xll`` its nuCodingMode 0 and
    nuCoreExtensionMask name a lossless (XLL) component, as a DTS-HD
    Master Audio asset's do, of the asset's bytes.  It frames a stream;
    it decodes to nothing."""
    bits = (12, 20) if wide else (8, 16)
    if asset is None:
        fields = [(0, 8), (0, 2), (int(wide), 1), (15, bits[0]),
                  (size - 1, bits[1])]
        head = (b"\x64\x58\x20\x25" + pack_bits(fields)).ljust(16,
                                                                 b"\x00")
        return head + bytes([fill]) * (size - len(head))
    rate, channels, samples = asset
    rates = (8000, 16000, 32000, 64000, 128000, 22050, 44100, 88200,
             176400, 352800, 12000, 24000, 48000, 96000, 192000, 384000)
    hsize = 32
    head = (b"\x64\x58\x20\x25" + pack_bits([
        (0, 8), (0, 2), (int(wide), 1), (hsize - 1, bits[0]),
        (size - 1, bits[1]),
        (1, 1), (2, 2), (samples * 48000 // rate // 512 - 1, 3), (0, 1),
        (0, 3), (0, 3), (1, 1), (1, 8), (0, 1), (size - hsize - 1, bits[1]),
        (12, 9), (0, 3), (0, 1), (0, 1), (0, 1), (23, 5),
        (rates.index(rate), 4), (channels - 1, 8),
        # no speaker map (representation 0), DRC or dialog normalization;
        # then the coding mode and components (0x20: XLL) and the XLL
        # component's size, no sync word
        (0, 1), (0, 3), (0, 1), (0, 1)]
        + ([(0, 2), (0x20, 12), (size - hsize - 1, bits[1]), (0, 1)]
           if xll else []))).ljust(hsize, b"\x00")
    return head + bytes([fill]) * (size - len(head))


# AAC channel layouts a program config element can give: (front, side,
# back: is_cpe of each element), LFE elements
AAC_LAYOUTS = {"5.1": ((0, 1), (), (1,), 1), "7.1": ((0, 1, 1), (), (1,), 1)}


def _pce_fields(layout) -> list:
    """program_config_element() after its id, up to its byte alignment:
    tag 0, LC, 48 kHz, the layout's elements, no mixdowns."""
    front, side, back, lfe = layout
    f = [(0, 4), (1, 2), (3, 4), (len(front), 4), (len(side), 4),
         (len(back), 4), (lfe, 2), (0, 3), (0, 4), (0, 3)]
    tags = {0: 0, 1: 0}
    for cpe in front + side + back:
        f += [(cpe, 1), (tags[cpe], 4)]
        tags[cpe] += 1
    return f + [(t, 4) for t in range(lfe)]


def _aligned(fields, start: int = 0) -> list:
    """``fields`` padded with zero bits to a byte boundary counted from
    ``start`` bits before them."""
    return fields + [(0, -(start + sum(w for _v, w in fields)) % 8)]


def aac_pce_config(layout) -> bytes:
    """The AudioSpecificConfig of an LC 48 kHz stream of ``layout``:
    channelConfiguration 0 and the program config element (no comment),
    as libavformat's aac_adtstoasc writes it."""
    return pack_bits([(2, 5), (3, 4), (0, 4), (0, 3)]
                     + _aligned(_pce_fields(layout)) + [(0, 8)])


def adts_pce_frame(layout, gain: int = 100, pce: bool = True) -> bytes:
    """An ADTS frame (MPEG-4 LC, 48 kHz, no CRC) whose
    channel_configuration is 0 and whose raw data block opens with the
    layout's program config element (without it where not ``pce``),
    then each element of the layout, silent (global gain ``gain``, a
    long window, max_sfb 0), then END.  It frames and decodes to
    silence."""
    front, side, back, lfe = layout
    f = _aligned([(5, 3)] + _pce_fields(layout)) + [(0, 8)] if pce else []
    ics = [(gain, 8), (0, 4), (0, 6), (0, 1), (0, 3)]
    tags = {0: 0, 1: 0}
    for cpe in front + side + back:
        f += [(cpe, 3), (tags[cpe], 4)] + ([(0, 1)] if cpe else []) \
            + ics * (1 + cpe)
        tags[cpe] += 1
    for t in range(lfe):
        f += [(3, 3), (t, 4)] + ics
    raw = pack_bits(f + [(7, 3)])
    n = 7 + len(raw)
    return pack_bits([(0xFFF, 12), (0, 1), (0, 2), (1, 1), (1, 2), (3, 4),
                      (0, 1), (0, 3), (0, 4), (n, 13), (0x7FF, 11),
                      (0, 2)]) + raw


def spu_sub(spu: bytes) -> bytes:
    """Private stream 1 subpicture (VobSub) substream 0x20."""
    return bytes([0x20]) + spu


def build_ps(units, packs=()) -> bytes:
    """A program stream of ``units``, each (at, stream id, data, wrap,
    pts), and of whole ``packs`` (at, bytes: ``sector_packs``), in the
    order of ``at`` (a video unit's decode time, an audio or subpicture
    unit's pts; ties keep the given order, packs first).  Each unit's
    data is cut into chunks of at most PS_CHUNK bytes, each a pack and a
    PES packet whose payload is ``wrap(chunk)`` (a private stream 1
    substream header) or the chunk; the first carries ``pts``."""
    items = list(packs)
    for at, sid, data, wrap, pts in units:
        for off in range(0, max(1, len(data)), PS_CHUNK):
            part = data[off:off + PS_CHUNK]
            items.append((at, pack_header() + ps_pes(
                sid, wrap(part) if wrap else part,
                pts if off == 0 else None)))
    return b"".join(p for _at, p in sorted(items, key=lambda u: u[0])) \
        + b"\x00\x00\x01\xb9"


def es_pieces(frames, pts, cuts) -> list:
    """The elementary stream of ``frames`` (``pts``: each frame's) cut at
    the byte offsets ``cuts``: (pts, payload, frames that begin in it,
    offset of the first of them) a piece, its pts that of the first
    frame that begins in it, or None where none does (ISO/IEC 13818-1
    2.4.3.7).  A frame whose pts is None (a partial frame where the
    stream was cut) begins nowhere."""
    es = b"".join(frames)
    starts = np.cumsum([0] + [len(f) for f in frames[:-1]]).tolist()
    out = []
    for a, b in zip([0, *cuts], [*cuts, len(es)]):
        inside = [k for k, s in enumerate(starts)
                  if a <= s < b and pts[k] is not None]
        out.append((pts[inside[0]] if inside else None, es[a:b],
                    len(inside), starts[inside[0]] - a if inside else 0))
    return out


def sector_packs(sid: int, frames, pts, substream=None) -> list:
    """A sound stream laid out as a DVD authoring tool lays it out: the
    frames' bytes cut into 2048-byte packs with no frame alignment, each
    one PES packet of stream ``sid`` (private stream 1 with
    ``substream``, an AC-3 0x80-0x87 or DTS 0x88-0x8F id: its header's
    frame count and first access unit pointer filled from the payload),
    with a PTS only where a frame begins in it: that frame's.  A piece of
    ``frames`` whose pts is None (a partial frame where the stream was
    cut) begins no frame.  A packet that would begin a frame in the 5
    bytes a PTS takes ends before it, and a pack is filled with PES
    header stuffing or a padding packet.  Returns build_ps ``packs``:
    (at, pack), ``at`` the pts of the last frame begun at or before the
    pack's first byte (before the first: the first frame's)."""
    es = b"".join(frames)
    ends = np.cumsum([len(f) for f in frames]).tolist()
    begun = [(e - len(f), t) for f, e, t in zip(frames, ends, pts)
             if t is not None]
    starts = [b for b, _t in begun] + [len(es)]
    pts = [t for _b, t in begun]
    room = SECTOR - 14 - 9 - (4 if substream is not None else 0)
    out = []
    off = 0
    while off < len(es):
        nxt = next((s for s in starts[:-1] if s >= off), None)
        if nxt is not None and nxt < off + room - 5:
            n, stamp = min(room - 5, len(es) - off), True
        elif nxt is not None and nxt < off + room:
            n, stamp = nxt - off, False       # the frame starts the next
        else:
            n, stamp = min(room, len(es) - off), False
        payload = es[off:off + n]
        inside = [k for k, s in enumerate(starts[:-1]) if off <= s < off + n]
        if substream is not None:
            ptr = starts[inside[0]] - off + 1 if inside else 0
            payload = bytes([substream, len(inside), ptr >> 8,
                             ptr & 0xFF]) + payload
        head = 9 + (5 if stamp else 0) + len(payload) + 14
        stuff = SECTOR - head if SECTOR - head < 6 else 0
        ext = (_ts33(pts[inside[0]], 0x20) if stamp else b"") \
            + b"\xff" * stuff
        body = bytes([0x80, 0x80 if stamp else 0, len(ext)]) + ext + payload
        pack = pack_header() + b"\x00\x00\x01" + bytes([sid]) \
            + len(body).to_bytes(2, "big") + body
        if len(pack) < SECTOR:
            pad = SECTOR - len(pack) - 6
            pack += b"\x00\x00\x01\xbe" + pad.to_bytes(2, "big") \
                + b"\xff" * pad
        at = pts[max([k for k, s in enumerate(starts[:-1]) if s <= off]
                     or [0])]
        out.append((at, pack))
        off += n
    return out


def video_units(es: bytes, first: int, ticks: int, sid: int = 0xE0,
                user=None) -> list:
    """build_ps units of an MPEG-2 stream: one a picture in stream
    order, at its decode time, with its presentation time; ``user``
    maps a picture's stream index to user data put before its slices."""
    aus = split_pictures(es)
    pts = display_pts(picture_types(es), first, ticks)
    return [(first + (k - 1) * ticks, sid,
             insert_user_data(au, user[k]) if user and k in user else au,
             None, pts[k]) for k, au in enumerate(aus)]


def s16be_lpcm(pcm: np.ndarray) -> bytes:
    """float (n, ch) → big-endian 16-bit samples, as DVD LPCM holds them."""
    return np.clip(np.round(pcm * 32767), -32768, 32767).astype(
        ">i2").tobytes()


# ---------------------------------------------------------------------------
# DVD-Video IFOs
# ---------------------------------------------------------------------------
def _bcd(v):
    return ((v // 10) << 4) | (v % 10)


def pb_time(seconds, fps=30):
    """A PGC/cell playback time: BCD hh mm ss, frames with the rate."""
    s = int(seconds)
    f = int(round((seconds - s) * fps))
    return bytes([_bcd(s // 3600), _bcd((s % 3600) // 60), _bcd(s % 60),
                  (0xC0 if fps == 30 else 0x40) | _bcd(f)])


def make_vmg(entries) -> bytes:
    """VIDEO_TS.IFO: entries (nr_ptts, vts_nr, vts_ttn), one a title."""
    ifo = bytearray(2048)
    ifo[0:12] = b"DVDVIDEO-VMG"
    ifo[0xC4:0xC8] = (1).to_bytes(4, "big")     # TT_SRPT at sector 1
    srpt = bytearray(8 + 12 * len(entries))
    srpt[0:2] = len(entries).to_bytes(2, "big")
    for i, (ptts, vts, ttn) in enumerate(entries):
        e = 8 + i * 12
        srpt[e] = 0x38                          # playback type
        srpt[e + 1] = 1                         # angles
        srpt[e + 2:e + 4] = ptts.to_bytes(2, "big")
        srpt[e + 6] = vts
        srpt[e + 7] = ttn
    return bytes(ifo) + bytes(srpt).ljust(2048, b"\x00")


def vts_video_attr(standard: str = "NTSC", aspect=(4, 3),
                   size: int = 0) -> bytes:
    """A VTS's video attributes (VTSI_MAT 0x200): MPEG-2, the standard
    ("NTSC", "PAL"), the display aspect ((4, 3) or (16, 9)) and the
    picture size code (0: 720 wide, 1: 704, 2: 352, 3: 352 x half)."""
    return bytes([(1 << 6) | ({"NTSC": 0, "PAL": 1}[standard] << 4)
                  | ({(4, 3): 0, (16, 9): 3}[tuple(aspect)] << 2),
                  size << 2])


def vts_audio_attr(codec: str, channels: int, language: str = "",
                   sample_rate: int = 48000) -> bytes:
    """One audio stream's attributes (VTSI_MAT 0x204 + 8 i): the coding
    mode of ``codec`` (ac3, mp2, lpcm, dts), the channels, the rate and
    the ISO 639-1 code ``language`` ("": none given)."""
    mode = {"ac3": 0, "mp2": 2, "lpcm": 4, "dts": 6}[codec]
    return (bytes([(mode << 5) | ((1 if language else 0) << 2),
                   ((1 if sample_rate == 96000 else 0) << 4)
                   | (channels - 1)])
            + (language or "").encode("latin-1").ljust(2, b"\x00")
            + bytes(4))


def make_vts(duration_s, cell_secs, palette_yuv, video_attr=b"\x00\x00",
             fps=30, audio_attrs=()) -> bytes:
    """VTS_xx_0.IFO: one PGC of ``cell_secs`` cells, one program each,
    with its playback time (at ``fps``, 30 or 25), a 16-entry 0YCrCb
    palette, the video attributes ``video_attr`` (all zero: MPEG-1,
    NTSC, 4:3, 720x480) and the audio attributes ``audio_attrs``
    (``vts_audio_attr``, one a stream)."""
    ifo = bytearray(2048)
    ifo[0:12] = b"DVDVIDEO-VTS"
    ifo[0xCC:0xD0] = (1).to_bytes(4, "big")     # VTS_PGCIT at sector 1
    ifo[0x200:0x202] = video_attr
    ifo[0x202:0x204] = len(audio_attrs).to_bytes(2, "big")
    for i, a in enumerate(audio_attrs):
        ifo[0x204 + 8 * i:0x20C + 8 * i] = a
    n_cells = len(cell_secs)
    pgc = bytearray(0x100 + n_cells * 24)
    pgc[2] = n_cells                            # programs == cells here
    pgc[3] = n_cells
    pgc[4:8] = pb_time(duration_s, fps)
    for i, v in enumerate(palette_yuv):
        pgc[0xA4 + 4 * i:0xA8 + 4 * i] = v.to_bytes(4, "big")
    pm_off, cp_off = 0xF0, 0x100
    pgc[0xE6:0xE8] = pm_off.to_bytes(2, "big")
    pgc[0xE8:0xEA] = cp_off.to_bytes(2, "big")
    for p in range(n_cells):
        pgc[pm_off + p] = p + 1                 # program p → cell p+1
    for c, dur in enumerate(cell_secs):
        pgc[cp_off + c * 24 + 4:cp_off + c * 24 + 8] = pb_time(dur, fps)
    pgcit = bytearray(16)
    pgcit[0:2] = (1).to_bytes(2, "big")
    pgcit[12:16] = (16).to_bytes(4, "big")      # pgc offset from table
    return bytes(ifo) + (bytes(pgcit) + bytes(pgc)).ljust(2048, b"\x00")


# palette: 0 black, 1 white (0YCrCb), the rest black
WHITE_CARD_PALETTE = [0x108080, 0xEB8080] + [0x108080] * 14


def write_dvd(root: str, ps: bytes, n_vobs: int, cell_secs,
              video_attr=b"\x00\x00", fps=30, audio_attrs=()) -> str:
    """A DVD-Video folder ``root``/VIDEO_TS: title 1 in VTS 1 over
    ``ps`` cut into ``n_vobs`` VOBs at 2048-byte boundaries, with one
    chapter a cell, the VTS's video attributes ``video_attr``
    (``vts_video_attr``) and audio attributes ``audio_attrs``
    (``vts_audio_attr``).  Returns ``root``."""
    vt = os.path.join(root, "VIDEO_TS")
    os.makedirs(vt, exist_ok=True)
    step = ((len(ps) + n_vobs - 1) // n_vobs + 2047) // 2048 * 2048
    for k in range(n_vobs):
        with open(os.path.join(vt, f"VTS_01_{k + 1}.VOB"), "wb") as f:
            f.write(ps[k * step:(k + 1) * step])
    with open(os.path.join(vt, "VTS_01_0.IFO"), "wb") as f:
        f.write(make_vts(sum(cell_secs), cell_secs, WHITE_CARD_PALETTE,
                         video_attr, fps, audio_attrs))
    with open(os.path.join(vt, "VIDEO_TS.IFO"), "wb") as f:
        f.write(make_vmg([(len(cell_secs), 1, 1)]))
    return root


# ---------------------------------------------------------------------------
# MPEG transport stream
# ---------------------------------------------------------------------------
def crc32_mpeg(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) if crc & 0x80000000 \
                else (crc << 1)
            crc &= 0xFFFFFFFF
    return crc


def psi_packet(pid: int, table: bytes, cc: int = 0) -> bytes:
    sec = table + crc32_mpeg(table).to_bytes(4, "big")
    payload = b"\x00" + sec                       # pointer_field
    hdr = bytes([0x47, 0x40 | (pid >> 8), pid & 0xFF, 0x10 | cc])
    return hdr + payload + b"\xff" * (184 - len(payload))


def pat(pmt_pid: int = 0x20, cc: int = 0) -> bytes:
    body = (b"\x00" + (0xB000 | 13).to_bytes(2, "big") + b"\x00\x01"
            + b"\xc1\x00\x00" + b"\x00\x01"
            + bytes([0xE0 | (pmt_pid >> 8), pmt_pid & 0xFF]))
    return psi_packet(0, body, cc)


def pmt(streams, pmt_pid: int = 0x20, cc: int = 0) -> bytes:
    """streams: (stream_type, pid, descriptors bytes)."""
    es = b"".join(bytes([st, 0xE0 | (pid >> 8), pid & 0xFF,
                         0xF0 | (len(d) >> 8), len(d) & 0xFF]) + d
                  for st, pid, d in streams)
    pcr = streams[0][1]
    body = (b"\x02" + (0xB000 | (9 + 4 + len(es))).to_bytes(2, "big")
            + b"\x00\x01\xc1\x00\x00"
            + bytes([0xE0 | (pcr >> 8), pcr & 0xFF]) + b"\xf0\x00" + es)
    return psi_packet(pmt_pid, body, cc)


def lang_descriptor(code: str) -> bytes:
    return bytes([0x0A, 4]) + code.encode("latin-1") + b"\x00"


def ts_pes(stream_id: int, pts, data: bytes, ext=None) -> bytes:
    """A TS-borne PES packet with a pts, or none where ``pts`` is None
    (length 0: unbounded); with ``ext``, a PES extension whose
    PES_extension_flag_2 field carries that stream_id_extension (as a
    Blu-ray's TrueHD PID tells its TrueHD 0x72 and AC-3 0x76 apart)."""
    fields = b"" if pts is None else _ts33(pts, 0x20)
    flags = 0x00 if pts is None else 0x80
    if ext is not None:
        fields += bytes([0x0F, 0x81, ext & 0x7F])
        flags |= 0x01
    return (b"\x00\x00\x01" + bytes([stream_id]) + b"\x00\x00"
            + bytes([0x80, flags, len(fields)]) + fields + data)


def ts_packets(pid: int, pes: bytes, cc: int) -> tuple:
    """A PES packet cut into 188-byte TS packets, the last padded by an
    adaptation field; returns (bytes, next continuity counter)."""
    out = bytearray()
    pos = 0
    first = True
    while pos < len(pes):
        chunk = pes[pos:pos + 184]
        pos += len(chunk)
        flags = (0x40 if first else 0x00) | (pid >> 8)
        if len(chunk) == 184:
            out += bytes([0x47, flags, pid & 0xFF, 0x10 | (cc & 0xF)]) + chunk
        else:
            af_len = 183 - len(chunk)
            af = bytes([af_len]) + (bytes([0]) + b"\xff" * (af_len - 1)
                                    if af_len >= 1 else b"")
            out += bytes([0x47, flags, pid & 0xFF, 0x30 | (cc & 0xF)]) \
                + af + chunk
        cc = (cc + 1) & 0xF
        first = False
    return bytes(out), cc


def build_ts(streams, units) -> bytes:
    """A single-program TS: PAT and PMT (``streams``: (stream_type, pid,
    descriptors)), then ``units`` — (at, pid, stream_id, data, pts), or
    with a sixth member, the PES's stream_id_extension — in the order of
    ``at``, one PES packet each (without a PTS where ``pts`` is None),
    with per-PID continuity counters."""
    out = bytearray(pat() + pmt(streams))
    cc = {}
    for _at, pid, sid, data, pts, *ext in sorted(units, key=lambda u: u[0]):
        pk, cc[pid] = ts_packets(pid, ts_pes(sid, pts, data, *ext),
                                 cc.get(pid, 0))
        out += pk
    return bytes(out)


def pes_units(pid: int, sid: int, frames, pts, cuts, ext=None) -> list:
    """build_ts units of a sound stream whose PES packets are not its
    frames: the frames' bytes cut at the byte offsets ``cuts`` (several
    ADTS access units a PES, an AC-3 frame split across two), each
    piece's PTS that of the first frame beginning in it, or none
    (``es_pieces``); ``at`` the last PTS of the pieces before it (the
    first piece's: the first frame's), so each piece goes out no later
    than the frame its first byte belongs to; with ``ext``, each PES
    carries that stream_id_extension."""
    out = []
    at = pts[0]
    for p, payload, _n, _first in es_pieces(frames, pts, cuts):
        out.append((at, pid, sid, payload, p) + (
            () if ext is None else (ext,)))
        at = p if p is not None else at
    return out


def m2ts_wrap(ts: bytes) -> bytes:
    """188-byte TS → m2ts (a 4-byte arrival timestamp before each)."""
    out = bytearray()
    for i in range(0, len(ts), 188):
        out += (i // 188).to_bytes(4, "big") + ts[i:i + 188]
    return bytes(out)


# ---------------------------------------------------------------------------
# Blu-ray
# ---------------------------------------------------------------------------
def make_mpls(clips, item_ticks, marks) -> bytes:
    """An MPLS playlist: play items (clip id, in 0, out ``item_ticks``
    at 45 kHz) and entry marks (item index, clip-time ticks)."""
    def play_item(clip):
        # clip(5) codec(4) flags(2) stc_id(1) in(4) out(4)
        body = (clip.encode() + b"M2TS" + b"\x00\x00\x00"
                + (0).to_bytes(4, "big") + item_ticks.to_bytes(4, "big")
                + b"\x00" * 8)
        return len(body).to_bytes(2, "big") + body

    items = b"".join(play_item(c) for c in clips)
    playlist = (b"\x00\x00\x00\x00" + b"\x00\x00"
                + len(clips).to_bytes(2, "big") + (0).to_bytes(2, "big")
                + items)
    mk = b"".join(bytes([0, 1]) + item.to_bytes(2, "big")
                  + ticks.to_bytes(4, "big") + b"\xff\xff"
                  + (0).to_bytes(4, "big") for item, ticks in marks)
    marks_sec = b"\x00\x00\x00\x00" + len(marks).to_bytes(2, "big") + mk
    hdr = b"MPLS0200" + (40).to_bytes(4, "big") \
        + (40 + len(playlist)).to_bytes(4, "big") + (0).to_bytes(4, "big")
    return hdr.ljust(40, b"\x00") + playlist + marks_sec


def write_bd(root: str, ts: bytes, n_clips: int, seconds: float,
             marks) -> str:
    """A BDMV folder under ``root``: ``ts`` as m2ts cut into ``n_clips``
    clips at packet boundaries, one playlist over them whose items last
    ``seconds`` / n_clips each, with ``marks`` (item, seconds into the
    item) as chapters.  Returns ``root``."""
    bd = os.path.join(root, "BDMV")
    os.makedirs(os.path.join(bd, "PLAYLIST"), exist_ok=True)
    os.makedirs(os.path.join(bd, "STREAM"), exist_ok=True)
    m2 = m2ts_wrap(ts)
    n_pk = len(m2) // 192
    names = []
    for k in range(n_clips):
        a = k * n_pk // n_clips * 192
        b = (k + 1) * n_pk // n_clips * 192
        names.append(f"{k + 1:05d}")
        with open(os.path.join(bd, "STREAM", names[-1] + ".m2ts"),
                  "wb") as f:
            f.write(m2[a:b])
    ticks = int(round(seconds / n_clips * 45000))
    with open(os.path.join(bd, "PLAYLIST", "00000.mpls"), "wb") as f:
        f.write(make_mpls(names, ticks, [(i, int(round(s * 45000)))
                                         for i, s in marks]))
    return root


# -- AVI (RIFF) ---------------------------------------------------------------
def _riff(cid: bytes, body: bytes) -> bytes:
    return cid + len(body).to_bytes(4, "little") + body \
        + (b"\x00" if len(body) & 1 else b"")


def _riff_list(kind: bytes, *chunks: bytes) -> bytes:
    return _riff(b"LIST", kind + b"".join(chunks))


def _strh(kind: bytes, handler: bytes, scale: int, rate: int, length: int,
          sample_size: int) -> bytes:
    return _riff(b"strh", kind + handler + bytes(12)
                 + b"".join(v.to_bytes(4, "little") for v in (
                     scale, rate, 0, length, 0, 0xFFFFFFFF, sample_size))
                 + bytes(8))


class AviSound(NamedTuple):
    """An AVI sound stream: its WAVEFORMATEX fields and chunks.  With
    ``sample_size`` 0 each chunk is one frame of ``scale`` samples at
    ``rate`` a second (the stream header's dwScale and dwRate); else the
    stream header gives 1 and nAvgBytesPerSec (``avg_bytes``), and a
    chunk's time is the bytes before it at that rate."""
    tag: int
    channels: int
    sample_rate: int
    avg_bytes: int
    chunks: list
    sample_size: int = 0
    scale: int = 1152


def _sound_times(a: AviSound) -> list:
    if not a.sample_size:
        return [k * a.scale / a.sample_rate for k in range(len(a.chunks))]
    out, before = [], 0
    for c in a.chunks:
        out.append(before / a.avg_bytes)
        before += len(c)
    return out


def build_avi(video: list, fps, size, sounds=()) -> bytes:
    """An AVI of MJPEG ``video`` chunks (stream 0, ``00dc``) at ``fps``
    ((num, den) frames a second) of ``size`` (width, height) and one
    sound stream a ``sounds`` entry (``AviSound``; stream i + 1,
    ``0Nwb``), each chunk after the video chunk of the frame it starts
    in, as a muxer interleaves them.  No idx1 (the port's demuxer reads
    the movi list in order)."""
    w, h = size
    num, den = fps
    avih = _riff(b"avih", b"".join(v.to_bytes(4, "little") for v in (
        1000000 * den // num, 0, 0, 0, len(video), 0, 1 + len(sounds), 0,
        w, h, 0, 0, 0, 0)))
    bih = b"".join(v.to_bytes(4, "little") for v in (40, w, h)) \
        + (1).to_bytes(2, "little") + (24).to_bytes(2, "little") \
        + b"MJPG" + (w * h * 3).to_bytes(4, "little") + bytes(16)
    strls = [_riff_list(b"strl", _strh(b"vids", b"MJPG", den, num,
                                       len(video), 0), _riff(b"strf", bih))]
    for a in sounds:
        scale, rate = (a.scale, a.sample_rate) if not a.sample_size \
            else (1, a.avg_bytes)
        wfx = b"".join(v.to_bytes(n, "little") for v, n in (
            (a.tag, 2), (a.channels, 2), (a.sample_rate, 4),
            (a.avg_bytes, 4), (max(1, a.sample_size), 2), (0, 2), (0, 2)))
        strls.append(_riff_list(b"strl", _strh(
            b"auds", bytes(4), scale, rate, len(a.chunks), a.sample_size),
            _riff(b"strf", wfx)))
    times = [_sound_times(a) for a in sounds]
    next_chunk = [0] * len(sounds)
    movi = []
    for i, v in enumerate(video):
        movi.append(_riff(b"00dc", v))
        end = (i + 1) * den / num
        for s, a in enumerate(sounds):
            while next_chunk[s] < len(a.chunks) and (
                    times[s][next_chunk[s]] < end or i == len(video) - 1):
                movi.append(_riff(b"%02dwb" % (s + 1),
                                  a.chunks[next_chunk[s]]))
                next_chunk[s] += 1
    hdrl = _riff_list(b"hdrl", avih, *strls)
    body = b"AVI " + hdrl + _riff_list(b"movi", *movi)
    return b"RIFF" + len(body).to_bytes(4, "little") + body
