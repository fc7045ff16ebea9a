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
does; a DTS Express frame is an extension substream with no core.  A
Dolby TrueHD access unit has no syncword at its start: the framer locks
on a unit that carries a major sync and walks the units by their
lengths (``truehd_unit``).  Host code.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from ..core.buffer import CLOCK
from ..utils.logging import log
from .ac3dec import _BR, _ac3_bsi, _eac3_bsi, parse_frame_header


class FrameHeader(NamedTuple):
    size: int            # bytes of the frame, header included
    samples: int         # samples a channel
    sample_rate: int
    channels: int
    strmtyp: int = 0     # E-AC-3: 0 independent, 1 dependent, 2 AC-3
    substreamid: int = 0
    profile: int = 1     # ADTS: the AAC profile (1 LC)
    head: int = 0        # ADTS: the header's bytes (7, 9 with the CRC)
    xll: bool = False    # DTS extension substream: its first asset is
                         # lossless (XLL, DTS-HD Master Audio)


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
    """A DTS frame at ``off``.  A core frame (sync word 0x7FFE8001,
    16-bit big-endian) takes in the extension substreams that follow it
    (DTS-HD) where their headers are in ``data``: FSIZE and each
    extension's size give the bytes, NBLKS the samples, SFREQ the rate,
    AMODE and LFF the channels, or, where the first extension's header
    carries static fields, its first asset's nuTotalNumChs.  Where that
    asset is lossless (XLL: DTS-HD Master Audio), its nuMaxSampleRate is
    the rate, as libavcodec's parser labels it, and the samples are the
    core's at that rate (the frame's duration stays the core's: 512
    samples at 48 kHz are 1024 at 96 kHz); a DTS-HD High Resolution
    frame keeps the core's rate.  At an
    extension substream's sync word the frame is that substream alone
    (DTS Express: no core), its rate, channels and samples from its
    header's static fields (0 where it has none)."""
    if len(data) - off >= _EXSS_HEAD and \
            data[off:off + 4] == DTS_EXSS_SYNC:
        return dts_exss(data, off)
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
    ch = DTS_AMODE_CHANNELS[amode] + (1 if lff else 0)
    rate, samples = DTS_RATES[sfreq], (nblks + 1) * 32
    end = off + fsize + 1
    first, xll = True, False
    while (x := dts_exss(data, end)) is not None:
        if first and x.channels:
            ch = x.channels
        if first and x.xll and x.sample_rate:
            xll = True
            rate, samples = x.sample_rate, samples * x.sample_rate // rate
        first = False
        end += x.size
    return FrameHeader(end - off, samples, rate, ch, xll=xll)


DTS_EXSS_SYNC = b"\x64\x58\x20\x25"
_EXSS_HEAD = 10      # bytes of an extension substream header up to its size
# nuMaxSampleRate (ETSI TS 102 114 Table 7-11), the reference clock
# (Table 7-3)
_EXSS_RATES = (8000, 16000, 32000, 64000, 128000, 22050, 44100, 88200,
               176400, 352800, 12000, 24000, 48000, 96000, 192000, 384000)
_EXSS_CLOCKS = (32000, 44100, 48000)


def dts_exss(data: bytes, off: int = 0) -> Optional[FrameHeader]:
    """The DTS extension substream at ``off`` (ETSI TS 102 114 7.5, read
    as libavcodec's dca_exss.c reads it): sync word 0x64582025, 8 user
    bits, the substream index, then its header size and frame size, 8
    and 16 bits or, with bHeaderSizeType, 12 and 20.  Its bytes and,
    where the header carries static fields, its samples (from
    nuExSSFrameDurationCode at the reference clock), its first asset
    descriptor's nuMaxSampleRate and nuTotalNumChs (0 each where it
    says none) and whether that asset codes XLL (``_asset_xll``); None
    where there is no substream whose first 10 bytes are in
    ``data``."""
    if len(data) - off < _EXSS_HEAD or data[off:off + 4] != DTS_EXSS_SYNC:
        return None
    v = int.from_bytes(data[off + 4:off + _EXSS_HEAD], "big")   # 48 bits
    wide = (v >> 37) & 1
    if wide:
        head, size = ((v >> 25) & 0xFFF) + 1, ((v >> 5) & 0xFFFFF) + 1
    else:
        head, size = ((v >> 29) & 0xFF) + 1, ((v >> 13) & 0xFFFF) + 1
    if size < max(head, _EXSS_HEAD):
        return None
    none = FrameHeader(size, 0, 0, 0)     # the static fields not read
    if len(data) - off < head:
        return none
    b = _BR(bytes(data[off:off + head]))
    try:
        b.skip(32 + 8)
        index = b.read(2)
        b.skip(1 + (12 if wide else 8) + (20 if wide else 16))
        if not b.read(1):         # bStaticFieldsPresent
            return none
        clock = b.read(2)
        duration = 512 * (b.read(3) + 1)
        if b.read(1):             # bTimeStampFlag
            b.skip(36)
        presents, assets = b.read(3) + 1, b.read(3) + 1
        masks = [b.read(index + 1) for _ in range(presents)]
        for m in masks:
            for j in range(index + 1):
                if m >> j & 1:
                    b.skip(8)
        mix = None                # the mixer's outputs' channel counts
        if b.read(1):             # bMixMetadataEnbl
            b.skip(2)
            bits = (b.read(2) + 1) << 2
            mix = [_dca_channels(b.read(bits))
                   for _ in range(b.read(2) + 1)]
        b.skip(assets * (20 if wide else 16))  # nuAssetFsize
        b.skip(9 + 3)             # nuAssetDescriptFsize, nuAssetIndex
        if b.read(1):             # bAssetTypeDescrPresent
            b.skip(4)
        if b.read(1):             # bLanguageDescrPresent
            b.skip(24)
        if b.read(1):             # bInfoTextPresent
            b.skip(8 * (b.read(10) + 1))
        b.skip(5)                 # nuBitResolution
        rate = _EXSS_RATES[b.read(4)]
        channels = b.read(8) + 1
    except IndexError:
        return none
    if clock >= len(_EXSS_CLOCKS):
        return none
    return FrameHeader(size, duration * rate // _EXSS_CLOCKS[clock], rate,
                       channels, xll=_asset_xll(b, channels, mix))


def _dca_channels(mask: int) -> int:
    """The channels of a DTS loudspeaker mask: a bit a speaker, and a
    second for each bit that stands for a pair (libavcodec's
    ff_dca_count_chs_for_mask)."""
    return bin(mask).count("1") + bin(mask & 0xAE66).count("1")


def _asset_xll(b: "_BR", channels: int, mix) -> bool:
    """Whether the asset descriptor whose nuTotalNumChs ``b`` has just
    read codes a lossless (XLL) component: the rest of its static
    fields, its DRC, dialog normalization and mixing metadata (``mix``:
    the mixer outputs' channel counts, None where the header enables no
    mixing metadata) skipped, then nuCodingMode 0 with bit 0x20 of
    nuCoreExtensionMask, or nuCodingMode 1 (ETSI TS 102 114 7.5.3, read
    as libavcodec's dca_exss.c parse_descriptor).  False where the
    descriptor is cut short or does not parse."""
    try:
        stereo = six = False
        if b.read(1):             # bOne2OneMapChannels2Speakers
            stereo = channels > 2 and bool(b.read(1))
            six = channels > 6 and bool(b.read(1))
            bits = 0
            if b.read(1):         # bSpkrMaskEnabled
                bits = (b.read(2) + 1) << 2
                b.skip(bits)
            sets = b.read(3)
            if sets and not bits:
                return False
            speakers = [_dca_channels(b.read(bits)) for _ in range(sets)]
            for n in speakers:
                width = b.read(5) + 1
                for _ in range(n):
                    b.skip(5 * bin(b.read(width)).count("1"))
        else:
            b.skip(3)             # nuRepresentationType
        drc = b.read(1)
        if drc:
            b.skip(8)
        if b.read(1):             # bDialNormPresent
            b.skip(5)
        if drc and stereo:
            b.skip(8)
        if mix is not None and b.read(1):   # bMixMetadataPresent
            b.skip(1 + 6)
            b.skip(8 if b.read(2) == 3 else 3)
            if b.read(1):         # bEnblPerChMainAudioScale
                b.skip(6 * sum(mix))
            else:
                b.skip(6 * len(mix))
            for n in mix:
                for _ in range(channels + 6 * six + 2 * stereo):
                    b.skip(6 * bin(b.read(n)).count("1"))
        mode = b.read(2)          # nuCodingMode
        return mode == 1 or mode == 0 and bool(b.read(12) & 0x20)
    except IndexError:
        return False


def dts_exss_size(data: bytes, off: int = 0) -> Optional[int]:
    """The bytes of the DTS extension substream at ``off``, or None
    where there is none whose header is whole in ``data``."""
    x = dts_exss(data, off)
    return None if x is None else x.size


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


def adts_config(h: FrameHeader, pce: bytes = b"") -> bytes:
    """The AudioSpecificConfig of an ADTS stream whose first frame's
    header is ``h``: its object type (profile + 1), rate index and
    channel configuration, then ``pce``, the program config element
    that gives the channels where the configuration is 0
    (``adts_pce``)."""
    v = ((h.profile + 1) << 11) | (ADTS_RATES.index(h.sample_rate) << 7) \
        | (_ADTS_CHANNELS.index(h.channels) << 3)
    return v.to_bytes(2, "big") + pce


class _Writer:
    """Bits written most significant first."""

    def __init__(self):
        self.v = self.n = 0

    def put(self, v: int, n: int):
        self.v, self.n = (self.v << n) | v, self.n + n

    def data(self) -> bytes:
        self.put(0, -self.n % 8)
        return self.v.to_bytes(self.n // 8, "big")


class ProgramConfig(NamedTuple):
    channels: int        # each SCE 1, each CPE 2, each LFE 1
    config: bytes        # the element as an AudioSpecificConfig ends
    size: int            # bytes of the raw data block it takes


def adts_pce(frame: bytes) -> Optional[ProgramConfig]:
    """The program config element (ISO/IEC 14496-3 4.4.1.1) that opens
    the first raw data block of the ADTS frame ``frame``, as libavformat's
    aac_adtstoasc filter takes it out of a stream whose
    channel_configuration is 0: its channels (the front, side and back
    elements, an SCE 1 and a CPE 2, and the LFE elements), the element
    without its 3-bit id re-packed for an AudioSpecificConfig
    (ff_copy_pce_data: its byte alignment counted from the element's
    start), and the bytes of the block it takes (its comment field ends
    on a byte of the block).  None where the block's first element is
    not a PCE (id 5) or is cut short."""
    h = adts_header(frame)
    if h is None:
        return None
    b, w = _BR(bytes(frame[h.head:h.size])), _Writer()

    def copy(n: int) -> int:
        v = b.read(n)
        w.put(v, n)
        return v
    try:
        if b.read(3) != 5:
            return None
        copy(4 + 2 + 4)           # tag, object type, sampling index
        fsb = [copy(4) for _ in range(3)]   # front, side, back elements
        lfe, assoc, cc = copy(2), copy(3), copy(4)
        for n in (4, 4, 3):       # mono, stereo and matrix mixdowns
            if copy(1):
                copy(n)
        channels = 0
        for _ in range(sum(fsb)):
            channels += 2 if copy(1) else 1     # is_cpe
            copy(4)
        for _ in range(lfe):
            copy(4)
        channels += lfe
        copy(4 * assoc + 5 * cc)
        b.pos = (b.pos + 7) & ~7  # byte_alignment(): of the raw block
        w.put(0, -w.n % 8)        # and of the element in the config
        for _ in range(copy(8)):  # comment_field_bytes
            copy(8)
    except IndexError:
        return None
    return ProgramConfig(channels, w.data(), b.pos // 8)


# -- Dolby TrueHD (MLP FBA) access units --------------------------------------
TRUEHD_SYNC = b"\xf8\x72\x6f\xba"
# speakers each bit of a channel assignment stands for (libavcodec
# mlp_parse.c thd_chancount: L/R, C, LFE, Ls/Rs, Lvh/Rvh, Lc/Rc, Lrs/Rrs,
# Cs, Ts, Lsd/Rsd, Lw/Rw, Cvh, LFE2)
_THD_SPEAKERS = (2, 1, 1, 2, 2, 2, 2, 1, 1, 2, 2, 1, 1)
_THD_HEAD = 4 + 28 + 2 + 30     # a unit's bytes up to the end of the
                                # longest major sync


def _crc16_table(poly: int) -> tuple:
    out = []
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ poly if c & 0x8000 else c << 1) & 0xFFFF
        out.append(c)
    return tuple(out)


_CRC_2D = _crc16_table(0x002D)


def _crc16(data: bytes) -> int:
    c = 0
    for x in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC_2D[(c >> 8) ^ x]
    return c


class TrueHDSync(NamedTuple):
    sample_rate: int
    channels: int
    samples: int         # samples a channel of each access unit
    substreams: int


def truehd_major_sync(data: bytes, off: int = 0) -> Optional[TrueHDSync]:
    """The major sync of the TrueHD access unit at ``off`` (at its byte
    4), read as libavcodec's ff_mlp_read_major_sync reads it, its
    checksum held: the rate from the 4 bits after the sync word, (code &
    8 ? 44100 : 48000) << (code & 7); the channels from the 8-channel
    presentation's 13-bit assignment where it is not 0, else the
    6-channel presentation's 5 bits, each bit counting its speakers; 40
    samples a unit at 44.1 or 48 kHz, twice that at 88.2 or 96, four
    times at 176.4 or 192; the number of substreams.  None where the
    unit carries none, or its header is not whole in ``data``."""
    s = off + 4
    if len(data) - s < 28 or data[s:s + 4] != TRUEHD_SYNC:
        return None
    size = 28 + (2 + 2 * (data[s + 26] >> 4) if data[s + 25] & 1 else 0)
    if len(data) - s < size:
        return None
    check = _crc16(data[s:s + size - 4]) \
        ^ int.from_bytes(data[s + size - 4:s + size - 2], "big")
    if check != int.from_bytes(data[s + size - 2:s + size], "big"):
        return None
    v = int.from_bytes(data[s + 4:s + 8], "big")
    code = v >> 28
    if code == 0xF:
        return None
    assign = (v & 0x1FFF) or (v >> 15) & 0x1F
    return TrueHDSync((44100 if code & 8 else 48000) << (code & 7),
                      sum(n for i, n in enumerate(_THD_SPEAKERS)
                          if assign >> i & 1),
                      40 << (code & 7), data[s + 16] >> 4)


def truehd_unit(data: bytes, off: int = 0) -> Optional[FrameHeader]:
    """The TrueHD access unit at ``off`` that carries a major sync: its
    bytes (twice the 12-bit access_unit_length after the check nibble),
    samples, rate and channels.  None where there is no such unit whose
    major sync is whole in ``data``."""
    m = truehd_major_sync(data, off)
    if m is None:
        return None
    size = 2 * (((data[off] & 0xF) << 8) | data[off + 1])
    if size < 4 + 28:
        return None
    return FrameHeader(size, m.samples, m.sample_rate, m.channels)


def truehd_parity(unit: bytes, substreams: int) -> bool:
    """The check nibble of a TrueHD unit without a major sync: the
    parity of its 4-byte header and of each substream's 2- or 4-byte
    directory entry, as libavcodec's mlp parser checks it."""
    x, p = 0, 0
    for i in range(-1, substreams):
        if p + 2 > len(unit):
            return False
        x ^= unit[p] ^ unit[p + 1]
        p += 2
        if i < 0 or unit[p - 2] & 0x80:
            if p + 2 > len(unit):
                return False
            x ^= unit[p] ^ unit[p + 1]
            p += 2
    return ((x >> 4) ^ x) & 0xF == 0xF


# bytes every reader can judge a header from
_LOOK = 16
# bytes after a frame that can still belong to it: a DTS extension
# substream's header
_TAIL = {"dts": _EXSS_HEAD}

# the copied codecs of a byte stream: (sync words, reader).  TrueHD's
# "sync" is the major sync at byte 4 of the units that carry one.
READERS = {
    "ac3": ((b"\x0b\x77",), ac3_header),
    "eac3": ((b"\x0b\x77",), ac3_header),
    "dts": ((b"\x7f\xfe\x80\x01", DTS_EXSS_SYNC), dts_header),
    "truehd": ((TRUEHD_SYNC,), truehd_unit),
    "mp2": ((b"\xff",), mpa_header),
    "mp3": ((b"\xff",), mpa_header),
    "aac": ((b"\xff",), adts_header),
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
    it show that no further extension follows; until the framer has
    locked on, a frame counts only where the next begins with the same
    syncword, so the extension substream of a core that was cut off is
    no DTS Express frame.  A TrueHD stream starts at the first unit that
    carries a major sync; each unit after it is taken by its length
    while its check nibble holds (``truehd_parity``), and where it does
    not, the framer looks for the next major sync.

    ``name`` says in the log which track this is (``quiet``: no log)."""

    def __init__(self, codec: str, name: str = "", quiet: bool = False):
        self.codec = codec
        self.syncs, self.read = READERS[codec]
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
        self._major = None       # TrueHD: the last major sync read
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
            thd = self.codec == "truehd"
            why = why or (
                f"before the first {'major sync' if thd else 'frame'}"
                if not self.frames else "no frame: resynced at the next "
                + ("major sync" if thd else "syncword"))
            log(f"audio: {self.name} copy: {self._skipped} bytes dropped "
                f"({why})")
        self._skipped = 0

    def _find(self, buf, start: int) -> int:
        """The offset of the first syncword at or after ``start``, or
        -1."""
        found = [i for i in (buf.find(w, start) for w in self.syncs)
                 if i >= 0]
        return min(found) if found else -1

    def _word(self, buf, off: int) -> int:
        """Which syncword ``buf`` holds at ``off`` (-1: none)."""
        return next((k for k, w in enumerate(self.syncs)
                     if buf.startswith(w, off)), -1)

    def _cut(self, end: bool) -> list:
        if self.codec == "truehd":
            return self._cut_units(end)
        out = []
        buf = self._buf
        while buf and (end or len(buf) >= _LOOK):
            h = self.read(buf, 0)
            if h is not None and not self._locked and len(buf) >= h.size \
                    + _LOOK and (self.read(buf, h.size) is None
                                 or self._word(buf, h.size)
                                 != self._word(buf, 0)):
                h = None                  # no frame follows: not a sync
            if h is None:
                self._locked = False
                # the next syncword whose header parses, or that is too
                # near the end to tell
                i = self._find(buf, 1)
                while i > 0 and len(buf) - i >= _LOOK \
                        and self.read(buf, i) is None:
                    i = self._find(buf, i + 1)
                if i < 0 and end:
                    break                 # the tail: flush drops it
                if i < 0:
                    i = len(buf) - (max(map(len, self.syncs)) - 1)
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

    def _cut_units(self, end: bool) -> list:
        """TrueHD: the units from the first one that carries a major
        sync, each taken by its length."""
        out = []
        buf = self._buf
        while buf:
            if self._major is None:
                # the first unit whose major sync reads, or one whose
                # header is still to come
                j = buf.find(TRUEHD_SYNC, 4)
                while j >= 0 and (end or len(buf) - j + 4 >= _THD_HEAD) \
                        and truehd_major_sync(buf, j - 4) is None:
                    j = buf.find(TRUEHD_SYNC, j + 1)
                if j < 0:
                    self._drop(len(buf) if end else
                               max(0, len(buf) - _THD_HEAD))
                    break
                self._drop(j - 4)
            if len(buf) < 4:
                break
            size = 2 * (((buf[0] & 0xF) << 8) | buf[1])
            if size >= 4 and len(buf) < size:
                break                     # the rest is still to come
            m = truehd_major_sync(buf) if size >= 4 + 28 else None
            if m is None and (self._major is None or size < 4
                              or not truehd_parity(buf[:size],
                                                   self._major.substreams)):
                self._major = None        # lost: look for a major sync
                self._drop(1)
                continue
            if m is not None:
                self._major = m
            self._report()
            start = self._base
            unit = bytes(buf[:size])
            del buf[:size]
            self._base += size
            out.append(self._give(start, unit, FrameHeader(
                size, self._major.samples, self._major.sample_rate,
                self._major.channels), self._major.channels))
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
        elif self._anchor is not None and self._anchor[1] != h.sample_rate \
                and self._anchor[1] and h.sample_rate:
            a, r = self._anchor
            self._anchor = (a + self._since * CLOCK // r, h.sample_rate)
            self._since = 0
        if self._anchor is None or not h.sample_rate:
            pts = stop = None             # no clock: the header says no rate
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
