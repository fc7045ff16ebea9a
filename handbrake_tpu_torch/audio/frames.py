"""Frame headers of the sound codecs a job copies, and the framer that
cuts a copied track's byte stream into whole frames (the role of
libavcodec's parsers, which HandBrake runs on a passthrough in
decavcodec.c, so that every buffer reaching the muxer is one frame with
its own timestamp).

A program or transport stream hands a track over one PES payload at a
time, and a PES is not a frame: a DVD authoring tool fills 2048-byte
sectors, so frames straddle PES boundaries.  ``Framer`` carries the bytes
across packets and gives each whole frame with its pts: a PES's PTS
belongs to the first frame that begins in that packet (ISO/IEC 13818-1
2.4.3.7), each later frame's is the one before's plus its duration,
counted in samples so that no rounding to 90 kHz adds up.

One reader a codec (``READERS``) gives the frame at a syncword: its byte
length, sample count, sample rate and channel count, or None where the
header does not parse.  A DTS frame takes in the extension substreams
that follow its core (DTS-HD, as on a Blu-ray), as libavcodec's parser
does.  Host code.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from ..core.buffer import CLOCK
from ..utils.logging import log
from .ac3dec import _ac3_bsi, _eac3_bsi, parse_frame_header


class FrameHeader(NamedTuple):
    size: int            # bytes of the frame, header included
    samples: int         # samples a channel
    sample_rate: int
    channels: int
    strmtyp: int = 0     # E-AC-3: 0 independent, 1 dependent, 2 AC-3
    substreamid: int = 0
    profile: int = 1     # ADTS: the AAC profile (1 LC)
    head: int = 0        # ADTS: the header's bytes (7, 9 with the CRC)


class Frame(NamedTuple):
    data: bytes
    pts: Optional[int]   # 90 kHz; None before the stream's first PTS
    stop: Optional[int]
    samples: int
    sample_rate: int
    channels: int


# -- AC-3 and E-AC-3 (ATSC A/52) ---------------------------------------------
_AC3_CHANNELS = (2, 1, 2, 3, 3, 4, 4, 5)
# E-AC-3 chanmap locations (A/52 Table E.1.4) beyond L C R Ls Rs: the
# channels each adds (location 5 Lc/Rc ... 14 LFE2)
_CHANMAP_EXTRA = {5: 2, 6: 2, 7: 1, 8: 1, 9: 2, 10: 2, 11: 2, 12: 1, 13: 2,
                  14: 1}


def ac3_header(data: bytes, off: int = 0) -> Optional[FrameHeader]:
    """An AC-3 (bsid <= 10) or E-AC-3 (bsid 11-16) syncframe at ``off``:
    fscod and frmsizecod (AC-3) or frmsiz (E-AC-3) give the size,
    numblkscod the E-AC-3 samples (AC-3: 1536), acmod and lfeon the
    channels of this substream alone."""
    hdr = parse_frame_header(data, off)
    if hdr is None or len(data) - off < 16:
        return None
    size = hdr[4]
    if hdr[3] <= 10:
        b = _ac3_bsi(data, off)
        return FrameHeader(size, 1536, b["sample_rate"],
                           _AC3_CHANNELS[b["acmod"]] + b["lfeon"], 2)
    if size < 16:
        return None
    b = _eac3_bsi(data, off, size)
    fscod = data[off + 4] >> 6
    blocks = 6 if fscod == 3 else (1, 2, 3, 6)[(data[off + 4] >> 4) & 3]
    ch = _AC3_CHANNELS[b["acmod"]] + b["lfeon"]
    if b["strmtyp"] == 1:
        # a dependent substream: the channels its map adds to the base
        ch = sum(n for loc, n in _CHANMAP_EXTRA.items()
                 if (b["chanmap"] or 0) >> (15 - loc) & 1)
    return FrameHeader(size, 256 * blocks, b["sample_rate"], ch,
                       b["strmtyp"], b["substreamid"])


# -- DTS core (ETSI TS 102 114 5.3.1) ----------------------------------------
DTS_RATES = {1: 8000, 2: 16000, 3: 32000, 6: 11025, 7: 22050, 8: 44100,
             11: 12000, 12: 24000, 13: 48000}
DTS_AMODE_CHANNELS = (1, 2, 2, 2, 2, 3, 3, 4, 4, 5, 6, 6, 6, 7, 8, 8)


def dts_header(data: bytes, off: int = 0) -> Optional[FrameHeader]:
    """A DTS core frame (sync word 0x7FFE8001, 16-bit big-endian) at
    ``off``, with the extension substreams that follow it (DTS-HD) where
    their headers are in ``data``: FSIZE and each extension's size give
    the bytes, NBLKS the samples, SFREQ the rate, AMODE and LFF the
    channels (the core's: an extension's speakers are not read)."""
    if len(data) - off < 11 or data[off:off + 4] != b"\x7f\xfe\x80\x01":
        return None
    v = int.from_bytes(data[off + 4:off + 11], "big")   # the 56 bits after
    nblks = (v >> 42) & 0x7F
    fsize = (v >> 28) & 0x3FFF
    amode = (v >> 22) & 0x3F
    sfreq = (v >> 18) & 0xF
    lff = (v >> 1) & 3
    if sfreq not in DTS_RATES or amode > 15 or lff == 3 or fsize < 95 \
            or nblks < 5:
        return None
    end = off + fsize + 1
    while (n := dts_exss_size(data, end)) is not None:
        end += n
    return FrameHeader(end - off, (nblks + 1) * 32, DTS_RATES[sfreq],
                       DTS_AMODE_CHANNELS[amode] + (1 if lff else 0))


DTS_EXSS_SYNC = b"\x64\x58\x20\x25"
_EXSS_HEAD = 10      # bytes of an extension substream header up to its size


def dts_exss_size(data: bytes, off: int = 0) -> Optional[int]:
    """The bytes of the DTS extension substream at ``off`` (ETSI TS 102
    114 7.5: sync word 0x64582025, 8 user bits, the substream index,
    then its header size and frame size, 8 and 16 bits or, with
    bHeaderSizeType, 12 and 20), or None where there is none whose
    header is whole in ``data``."""
    if len(data) - off < _EXSS_HEAD or data[off:off + 4] != DTS_EXSS_SYNC:
        return None
    v = int.from_bytes(data[off + 4:off + _EXSS_HEAD], "big")   # 48 bits
    if (v >> 37) & 1:
        head, size = ((v >> 25) & 0xFFF) + 1, ((v >> 5) & 0xFFFFF) + 1
    else:
        head, size = ((v >> 29) & 0xFF) + 1, ((v >> 13) & 0xFFFF) + 1
    return size if size >= max(head, _EXSS_HEAD) else None


# -- MPEG audio, layers I-III (ISO/IEC 11172-3, 13818-3 and MPEG 2.5) -------
_MPA_RATES = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000),
              0: (11025, 12000, 8000)}
_MPA_KBPS = {
    (1, 1): (32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416,
             448),
    (1, 2): (32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320,
             384),
    (1, 3): (32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320),
    (2, 1): (32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224,
             256),
    (2, 2): (8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),
}


def mpa_header(data: bytes, off: int = 0) -> Optional[FrameHeader]:
    """An MPEG audio frame at ``off``: the version and layer, the bit
    rate and sample rate indices and the padding bit give the size and
    the samples (384 for layer I; 1152 for II, and for III in MPEG-1;
    576 for III in MPEG-2 and 2.5); the mode gives the channels.  A free
    format frame (bit rate index 0) has no size in its header: None."""
    if len(data) - off < 4 or data[off] != 0xFF \
            or (data[off + 1] & 0xE0) != 0xE0:
        return None
    ver = (data[off + 1] >> 3) & 3          # 3 MPEG-1, 2 MPEG-2, 0 2.5
    layer = 4 - ((data[off + 1] >> 1) & 3)
    br_idx, sr_idx = data[off + 2] >> 4, (data[off + 2] >> 2) & 3
    if ver == 1 or layer == 4 or br_idx in (0, 15) or sr_idx == 3:
        return None
    pad = (data[off + 2] >> 1) & 1
    rate = _MPA_RATES[ver][sr_idx]
    kbps = _MPA_KBPS[(1 if ver == 3 else 2, min(layer, 2)
                      if ver != 3 else layer)][br_idx - 1]
    if layer == 1:
        size, samples = (12 * kbps * 1000 // rate + pad) * 4, 384
    elif layer == 2 or ver == 3:
        size, samples = 144 * kbps * 1000 // rate + pad, 1152
    else:
        size, samples = 72 * kbps * 1000 // rate + pad, 576
    return FrameHeader(size, samples, rate,
                       1 if data[off + 3] >> 6 == 3 else 2)


# -- ADTS AAC (ISO/IEC 13818-7 6.2) -------------------------------------------
ADTS_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050, 16000,
              12000, 11025, 8000, 7350)
# channel_configuration → channels (7: 7.1)
_ADTS_CHANNELS = (0, 1, 2, 3, 4, 5, 6, 8)


def adts_header(data: bytes, off: int = 0) -> Optional[FrameHeader]:
    """An ADTS frame at ``off``: frame_length gives the bytes (its 7- or
    9-byte header included), number_of_raw_data_blocks the samples (1024
    a block), the sampling frequency index the rate, the channel
    configuration the channels (0 where it is 0: a program config
    element in the frame says them)."""
    if len(data) - off < 7 or data[off] != 0xFF \
            or (data[off + 1] & 0xF6) != 0xF0:
        return None
    sfi = (data[off + 2] >> 2) & 0xF
    ch = ((data[off + 2] & 1) << 2) | (data[off + 3] >> 6)
    size = ((data[off + 3] & 3) << 11) | (data[off + 4] << 3) \
        | (data[off + 5] >> 5)
    head = 7 if data[off + 1] & 1 else 9
    if sfi >= len(ADTS_RATES) or size <= head:
        return None
    return FrameHeader(size, 1024 * ((data[off + 6] & 3) + 1),
                       ADTS_RATES[sfi], _ADTS_CHANNELS[ch],
                       profile=data[off + 2] >> 6, head=head)


def adts_payload(frame: bytes) -> bytes:
    """The raw access unit of one whole ADTS frame: the frame less its
    header.  ValueError where ``frame`` is not exactly one ADTS frame of
    one raw data block."""
    h = adts_header(frame)
    if h is None or h.size != len(frame) or h.samples != 1024:
        raise ValueError(f"{len(frame)} bytes are not one whole ADTS frame "
                         f"of one access unit")
    return bytes(frame[h.head:])


def adts_config(h: FrameHeader) -> bytes:
    """The AudioSpecificConfig of an ADTS stream whose first frame's
    header is ``h``: its object type (profile + 1), rate index and
    channel configuration."""
    v = ((h.profile + 1) << 11) | (ADTS_RATES.index(h.sample_rate) << 7) \
        | (_ADTS_CHANNELS.index(h.channels) << 3)
    return v.to_bytes(2, "big")


# bytes every reader can judge a header from
_LOOK = 16
# bytes after a frame that can still belong to it: a DTS extension
# substream's header
_TAIL = {"dts": _EXSS_HEAD}

# the copied codecs of a byte stream: (sync bytes, reader)
READERS = {
    "ac3": (b"\x0b\x77", ac3_header),
    "eac3": (b"\x0b\x77", ac3_header),
    "dts": (b"\x7f\xfe\x80\x01", dts_header),
    "mp2": (b"\xff", mpa_header),
    "mp3": (b"\xff", mpa_header),
    "aac": (b"\xff", adts_header),
}


def read_frame(codec: str, data: bytes, off: int = 0):
    """The header of the ``codec`` frame at ``off``, or None."""
    return READERS[codec][1](data, off)


class Framer:
    """A copied track's byte stream → whole frames, each with its pts.

    ``feed(data, pts)`` takes one packet (``pts`` its PES's, or None) and
    returns the frames it completes; ``flush()`` the rest at the end of
    the stream.  A frame counts once its header parses, its bytes are
    there and, until the framer has locked on, the next syncword follows
    it (or the stream ends): a 0x0B77 inside a payload is not a frame.
    Bytes that are no frame (before the first syncword, after a header
    that does not parse, a partial frame at the end) are dropped, one log
    line each run giving how many.  An E-AC-3 access unit is an
    independent substream 0 frame with the dependent and further
    independent substreams that follow it, as libavcodec's parser keeps
    them; its samples and rate are its first frame's, its channels the
    sum of its substream 0 frame's and its dependent frames' extra
    channels.  A DTS frame is its core with the extension substreams
    that follow it (``dts_header``), so it is given once the bytes after
    it show that no further extension follows.

    ``name`` says in the log which track this is (``quiet``: no log)."""

    def __init__(self, codec: str, name: str = "", quiet: bool = False):
        self.codec = codec
        self.sync, self.read = READERS[codec]
        self.tail = _TAIL.get(codec, 0)
        self.name = name or codec
        self.quiet = quiet
        self._buf = bytearray()
        self._base = 0           # stream offset of _buf[0]
        self._marks = []         # (start, end, pts) of packets with a PTS
        self._locked = False
        self._anchor = None      # (pts, rate) of the last frame given one
        self._since = 0          # samples since the anchor
        self._unit = None        # E-AC-3: [start, bytes, first header, ch]
        self._skipped = 0        # bytes of the run being dropped
        self.frames = 0          # frames given
        self.dropped = 0         # bytes dropped

    # -- input ---------------------------------------------------------------
    def feed(self, data: bytes, pts: Optional[int] = None) -> list:
        start = self._base + len(self._buf)
        if pts is not None and data:
            self._marks.append((start, start + len(data), pts))
        self._buf += data
        return self._cut(end=False)

    def flush(self) -> list:
        out = self._cut(end=True)
        if self._unit is not None:
            out.append(self._give(*self._unit))
            self._unit = None
        self._report()
        if self._buf:
            self._drop(len(self._buf))
            self._report("no whole frame at the end of the stream")
        return out

    # -- cutting -------------------------------------------------------------
    def _drop(self, n: int):
        self._skipped += n
        self.dropped += n
        del self._buf[:n]
        self._base += n

    def _report(self, why: str = ""):
        """One log line for the run of bytes just dropped."""
        if self._skipped and not self.quiet:
            why = why or ("before the first frame" if not self.frames
                          else "no frame: resynced at the next syncword")
            log(f"audio: {self.name} copy: {self._skipped} bytes dropped "
                f"({why})")
        self._skipped = 0

    def _cut(self, end: bool) -> list:
        out = []
        buf = self._buf
        while buf and (end or len(buf) >= _LOOK):
            h = self.read(buf, 0)
            if h is not None and not self._locked and len(buf) >= h.size \
                    + _LOOK and self.read(buf, h.size) is None:
                h = None                  # no frame follows: not a sync
            if h is None:
                self._locked = False
                # the next syncword whose header parses, or that is too
                # near the end to tell
                i = buf.find(self.sync, 1)
                while i > 0 and len(buf) - i >= _LOOK \
                        and self.read(buf, i) is None:
                    i = buf.find(self.sync, i + 1)
                if i < 0 and end:
                    break                 # the tail: flush drops it
                if i < 0:
                    i = len(buf) - (len(self.sync) - 1)
                self._drop(i)
                if i < 1 or (not end and len(buf) < _LOOK):
                    break
                continue
            if len(buf) < h.size or not end and len(buf) < h.size + (
                    self.tail if self._locked else _LOOK):
                break                     # the rest is still to come
            self._report()
            self._locked = True
            start = self._base
            frame = bytes(buf[:h.size])
            del buf[:h.size]
            self._base += h.size
            if self.codec != "eac3":
                out.append(self._give(start, frame, h, h.channels))
            elif self._unit is None or (h.strmtyp != 1
                                        and h.substreamid == 0):
                if self._unit is not None:
                    out.append(self._give(*self._unit))
                self._unit = [start, frame, h, h.channels]
            else:
                self._unit[1] += frame
                if h.strmtyp == 1:
                    self._unit[3] += h.channels
        return out

    def _give(self, start: int, data: bytes, h: FrameHeader,
              channels: int) -> Frame:
        """The frame beginning at stream offset ``start``: the PTS of the
        packet it begins in, if that packet has one and no frame began
        in it before; else the previous frame's end."""
        pts = None
        while self._marks and self._marks[0][1] <= start:
            self._marks.pop(0)           # a packet no frame began in
        if self._marks and self._marks[0][0] <= start:
            pts = self._marks.pop(0)[2]
        if pts is not None:
            self._anchor, self._since = (pts, h.sample_rate), 0
        elif self._anchor is not None and self._anchor[1] != h.sample_rate:
            a, r = self._anchor
            self._anchor = (a + self._since * CLOCK // r, h.sample_rate)
            self._since = 0
        if self._anchor is None:
            pts = stop = None
        else:
            a, r = self._anchor
            pts = a + self._since * CLOCK // r
            self._since += h.samples
            stop = a + self._since * CLOCK // r
        self.frames += 1
        return Frame(bytes(data), pts, stop, h.samples, h.sample_rate,
                     channels)


def first_frame(codec: str, data: bytes) -> Optional[Frame]:
    """The first whole frame (E-AC-3: access unit) of ``data``, the
    head of a stream, or None."""
    f = Framer(codec, quiet=True)
    got = f.feed(bytes(data))
    return (got or f.flush() or [None])[0]
