"""Helpers of the port's pixel-aspect tests: the SPS with its VUI aspect
taken out (an H.264 or HEVC SPS that says 1:1 as the JAX package writes
it), and the boxes of an mp4 and the elements of a Matroska file as flat
lists, so two files compare field by field apart from the fields that
carry the aspect."""
from handbrake_tpu_torch.codecs import vui
from handbrake_tpu_torch.codecs.h264.bits import (BitReader, ebsp_to_rbsp,
                                                  rbsp_to_ebsp)


def sar_of(codec: str, data: bytes):
    """The VUI aspect of the first SPS in an avcC/hvcC or annex-B."""
    return vui.stream_vui(codec, data)["sar"]


def _bits(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def strip_sar(nal: bytes, codec: str) -> bytes:
    """An SPS NAL unit (no start code) with aspect_ratio_info taken out
    of its VUI: the flag set to 0, aspect_ratio_idc and an Extended_SAR's
    two terms removed, the RBSP re-padded."""
    hdr = 1 if codec == "h264" else 2
    rbsp = ebsp_to_rbsp(nal[hdr:])
    br = BitReader(rbsp)
    (vui.h264_to_vui if codec == "h264" else vui.hevc_to_vui)(br)
    p = br.pos
    bits = _bits(rbsp)
    bits = bits[:bits.rindex("1")]             # the stop bit and padding
    if bits[p:p + 2] != "11":
        return nal                              # no aspect to take out
    idc = int(bits[p + 2:p + 10], 2)
    cut = p + 10 + (32 if idc == vui.EXTENDED_SAR else 0)
    bits = bits[:p + 1] + "0" + bits[cut:] + "1"
    bits += "0" * (-len(bits) % 8)
    out = int(bits, 2).to_bytes(len(bits) // 8, "big")
    return nal[:hdr] + rbsp_to_ebsp(out)


def strip_config_sar(config: bytes, codec: str) -> bytes:
    """An avcC or hvcC payload with each SPS's aspect taken out."""
    out = bytearray()
    if codec == "h264":
        out += config[:6]
        i = 6
        for _ in range(config[5] & 0x1F):
            ln = int.from_bytes(config[i:i + 2], "big")
            sps = strip_sar(config[i + 2:i + 2 + ln], "h264")
            out += len(sps).to_bytes(2, "big") + sps
            i += 2 + ln
        return bytes(out + config[i:])
    out += config[:23]
    i = 23
    for _ in range(config[22]):
        kind = config[i] & 0x3F
        n = int.from_bytes(config[i + 1:i + 3], "big")
        out += config[i:i + 3]
        i += 3
        for _ in range(n):
            ln = int.from_bytes(config[i:i + 2], "big")
            nal = config[i + 2:i + 2 + ln]
            if kind == 33:
                nal = strip_sar(nal, "hevc")
            out += len(nal).to_bytes(2, "big") + nal
            i += 2 + ln
    return bytes(out + config[i:])


# mp4 boxes that hold boxes, and the bytes of fields ahead of them
_MP4_CONTAINERS = {b"moov": 0, b"trak": 0, b"mdia": 0, b"minf": 0,
                   b"stbl": 0, b"dinf": 0, b"udta": 0, b"edts": 0,
                   b"stsd": 8, b"avc1": 78, b"hvc1": 78, b"av01": 78}


def mp4_boxes(data: bytes, path=()) -> list:
    """[(path of box types, payload)] of every leaf box, and of the field
    bytes ahead of a container's boxes (type b"fields"), in file order."""
    out = []
    i = 0
    while i + 8 <= len(data):
        size = int.from_bytes(data[i:i + 4], "big")
        typ = data[i + 4:i + 8]
        body = data[i + 8:i + size]
        here = path + (typ,)
        if typ in _MP4_CONTAINERS:
            skip = _MP4_CONTAINERS[typ]
            if skip:
                out.append((here + (b"fields",), body[:skip]))
            out += mp4_boxes(body[skip:], here)
        else:
            out.append((here, body))
        i += size
    return out


_MKV_MASTERS = {0x18538067, 0x1549A966, 0x1654AE6B, 0xAE, 0xE0, 0xE1,
                0x1F43B675, 0xA0, 0x1C53BB6B, 0xBB, 0xB7, 0x1043A770,
                0x45B9, 0xB6, 0x80, 0x1254C367, 0x7373, 0x67C8}


def _vint(data, i, keep_marker=False):
    b = data[i]
    n = next(k for k in range(8) if b & (0x80 >> k)) + 1
    v = b if keep_marker else b & (0xFF >> n)
    for j in range(1, n):
        v = (v << 8) | data[i + j]
    return v, n


def mkv_elements(data: bytes, path=()) -> list:
    """[(path of element ids, payload)] of every leaf element of an EBML
    file, in file order; an unknown size runs to the end of its parent."""
    out = []
    i = 0
    while i < len(data):
        eid, n = _vint(data, i, keep_marker=True)
        i += n
        size, n = _vint(data, i)
        unknown = size == (1 << (7 * n)) - 1
        i += n
        end = len(data) if unknown else i + size
        here = path + (eid,)
        if eid in _MKV_MASTERS:
            out += mkv_elements(data[i:end], here)
        else:
            out.append((here, data[i:end]))
        i = end
    return out
