"""NAL bitstream utilities (reference: nal_units.c, extradata.c,
bitstream.c — annex-B ↔ length-prefixed conversion and codec-config boxes).
"""
from __future__ import annotations

import struct


def split_annexb(data: bytes) -> list:
    """Split an annex-B stream into raw NAL payloads (no start codes)."""
    nals = []
    i = 0
    n = len(data)
    # find first start code
    while i < n - 3:
        if data[i:i + 3] == b"\x00\x00\x01":
            i += 3
            break
        if data[i:i + 4] == b"\x00\x00\x00\x01":
            i += 4
            break
        i += 1
    else:
        return []
    start = i
    while i < n - 3:
        if data[i:i + 3] == b"\x00\x00\x01":
            end = i
            while end > start and data[end - 1] == 0:
                end -= 1
            nals.append(data[start:end])
            i += 3
            start = i
        else:
            i += 1
    nals.append(data[start:])
    return [x for x in nals if x]


def annexb_to_avcc(data: bytes, length_size: int = 4) -> bytes:
    """Annex-B frame → length-prefixed (ISO/IEC 14496-15) sample."""
    out = bytearray()
    for nal in split_annexb(data):
        out += len(nal).to_bytes(length_size, "big")
        out += nal
    return bytes(out)


def avcc_to_annexb(data: bytes, length_size: int = 4) -> bytes:
    out = bytearray()
    i = 0
    while i + length_size <= len(data):
        ln = int.from_bytes(data[i:i + length_size], "big")
        i += length_size
        out += b"\x00\x00\x00\x01" + data[i:i + ln]
        i += ln
    return bytes(out)


def extract_sps_pps(data: bytes) -> tuple:
    """(sps_list, pps_list) from an annex-B H.264 stream."""
    sps, pps = [], []
    for nal in split_annexb(data):
        t = nal[0] & 0x1F
        if t == 7:
            sps.append(nal)
        elif t == 8:
            pps.append(nal)
    return sps, pps


def strip_parameter_sets(data: bytes, codec: str = "h264") -> bytes:
    """Remove parameter-set/AUD NALs (they live in avcC/hvcC for mp4)."""
    out = bytearray()
    for nal in split_annexb(data):
        if codec == "hevc":
            t = (nal[0] >> 1) & 0x3F
            if t in (32, 33, 34, 35):       # VPS/SPS/PPS/AUD
                continue
        else:
            t = nal[0] & 0x1F
            if t in (7, 8, 9):              # SPS/PPS/AUD
                continue
        out += b"\x00\x00\x00\x01" + nal
    return bytes(out)


def extract_vps_sps_pps(data: bytes) -> tuple:
    """(vps_list, sps_list, pps_list) from an annex-B HEVC stream."""
    vps, sps, pps = [], [], []
    for nal in split_annexb(data):
        t = (nal[0] >> 1) & 0x3F
        if t == 32:
            vps.append(nal)
        elif t == 33:
            sps.append(nal)
        elif t == 34:
            pps.append(nal)
    return vps, sps, pps


def build_avcc(sps_list: list, pps_list: list,
               length_size: int = 4) -> bytes:
    """avcC box payload (hb_set_h264_extradata analog, extradata.c:32)."""
    sps = sps_list[0]
    out = bytearray()
    out += bytes([1, sps[1], sps[2], sps[3]])  # ver, profile, compat, level
    out += bytes([0xFC | (length_size - 1)])
    out += bytes([0xE0 | len(sps_list)])
    for s in sps_list:
        out += struct.pack(">H", len(s)) + s
    out += bytes([len(pps_list)])
    for p in pps_list:
        out += struct.pack(">H", len(p)) + p
    return bytes(out)


def build_hvcc(vps: bytes, sps: bytes, pps: bytes,
               length_size: int = 4) -> bytes:
    """hvcC payload (ISO/IEC 14496-15 8.3.3.1; hb_set_h265_extradata
    analog, extradata.c). The general profile_tier_level (12 bytes) sits
    byte-aligned at offset 3 of the SPS NAL (2-byte header + 1 byte of
    sps_video_parameter_set_id/max_sub_layers/temporal_id_nesting), so it
    is copied verbatim from the SPS our encoder emitted."""
    ptl = sps[3:15] if len(sps) >= 15 else bytes(12)
    out = bytearray()
    out += bytes([1])                         # configurationVersion
    out += ptl                                # space/tier/idc, compat,
    #                                           constraints, level_idc
    out += struct.pack(">H", 0xF000)          # min_spatial_segmentation
    out += bytes([0xFC])                      # parallelismType
    out += bytes([0xFC | 1])                  # chromaFormat 4:2:0
    out += bytes([0xF8])                      # bitDepthLumaMinus8
    out += bytes([0xF8])                      # bitDepthChromaMinus8
    out += struct.pack(">H", 0)               # avgFrameRate
    # constantFrameRate=0, numTemporalLayers=1, temporalIdNested=1
    out += bytes([(1 << 3) | (1 << 2) | (length_size - 1)])
    out += bytes([3])                         # numOfArrays
    for t, nal in ((32, vps), (33, sps), (34, pps)):
        out += bytes([0x80 | t])              # array_completeness=1
        out += struct.pack(">H", 1)
        out += struct.pack(">H", len(nal)) + nal
    return bytes(out)
