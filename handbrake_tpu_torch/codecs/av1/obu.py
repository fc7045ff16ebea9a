"""AV1 OBU framing (spec §5): leb128 sizes, OBU headers, sequence and
frame headers. Low-overhead bitstream format — every temporal unit is
[TD OBU][seq hdr OBU (keyframes)][frame OBU]. The reference emits these
via SVT-AV1 (encsvtav1.c); the mp4 `av1C` box is built from the sequence
header OBU (reference extradata.c role).
"""
from __future__ import annotations

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6

KEY_FRAME = 0
INTER_FRAME = 1


def leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_leb128(data: bytes, pos: int):
    v, shift = 0, 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            return v, pos


def obu(obu_type: int, payload: bytes) -> bytes:
    """OBU header: forbidden|type(4)|ext(0)|has_size(1)|reserved, + leb128."""
    hdr = (obu_type << 3) | 0x02
    return bytes([hdr]) + leb128(len(payload)) + payload


def parse_obus(data: bytes):
    """Yield (obu_type, payload) for each OBU in a temporal unit."""
    pos = 0
    while pos < len(data):
        hdr = data[pos]
        pos += 1
        obu_type = (hdr >> 3) & 0x0F
        if hdr & 0x04:          # extension present
            pos += 1
        if hdr & 0x02:          # has_size
            size, pos = read_leb128(data, pos)
        else:
            size = len(data) - pos
        yield obu_type, data[pos:pos + size]
        pos += size


def temporal_delimiter() -> bytes:
    return obu(OBU_TEMPORAL_DELIMITER, b"")


# --------------------------------------------------------------------------
# sequence header
# --------------------------------------------------------------------------
def sequence_header(width: int, height: int, qindex_hint: int = 0) -> bytes:
    """Profile-0 (4:2:0 8-bit) sequence header payload."""
    payload = bytearray()
    payload.append(0x00)                          # profile=0, still=0
    payload += (width - 1).to_bytes(2, "big")
    payload += (height - 1).to_bytes(2, "big")
    payload.append(qindex_hint & 0xFF)
    return obu(OBU_SEQUENCE_HEADER, bytes(payload))


def parse_sequence_header(payload: bytes):
    width = int.from_bytes(payload[1:3], "big") + 1
    height = int.from_bytes(payload[3:5], "big") + 1
    return {"profile": payload[0] >> 5, "width": width, "height": height}


def frame_obu(frame_type: int, qindex: int, tile_data: bytes) -> bytes:
    """Frame OBU = 2-byte uncompressed header + range-coded tile data."""
    hdr = bytes([frame_type & 0x01, qindex & 0xFF])
    return obu(OBU_FRAME, hdr + tile_data)


def parse_frame_obu(payload: bytes):
    return payload[0] & 0x01, payload[1], payload[2:]


def build_av1c(seq_obu: bytes) -> bytes:
    """ISOBMFF AV1CodecConfigurationRecord (extradata.c analog)."""
    # marker|version=1, profile(3)+level(5), tier/bitdepth/mono/subsampling
    return bytes([0x81, 0x00, 0x0C, 0x00]) + seq_obu
