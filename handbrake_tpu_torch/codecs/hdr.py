"""HDR metadata plumbing: SEI parse/emit + mp4 box payloads.

Reference roles: hdr10plus.c:133 (ITU-T T.35 HDR10+ parse), rpu.c:245
(DoVi RPU carriage), work.c:1558 (HDR sanitize), extradata.c and
muxavformat.c track setup (mdcv/clli/colr boxes).

Side-data keys (raw SEI payload bytes, byte-compared through transcode):
  mastering_display — 24-byte mastering_display_colour_volume (SEI 137)
  content_light     — 4-byte content_light_level_info (SEI 144)
  hdr10plus_t35     — user_data_registered_itu_t_t35 payload (SEI 4)
  dovi_rpu          — HEVC NAL-62 RBSP payload (Dolby Vision RPU, unescaped)
"""
from __future__ import annotations

SEI_T35 = 4
SEI_MASTERING = 137
SEI_CLL = 144

HEVC_NAL_PREFIX_SEI = 39
HEVC_NAL_RPU = 62           # unspecified; Dolby Vision RPU carriage
H264_NAL_SEI = 6


def _split_annexb(data: bytes):
    from .h264.bits import split_annexb
    return split_annexb(data)


def _ebsp_to_rbsp(data: bytes) -> bytes:
    from .h264.bits import ebsp_to_rbsp
    return ebsp_to_rbsp(data)


def parse_sei_messages(rbsp: bytes):
    """→ [(payload_type, payload_bytes)] (spec 7.3.2.3.1 both codecs)."""
    out = []
    i = 0
    n = len(rbsp)
    while i < n and rbsp[i] != 0x80:       # rbsp_trailing stop bit byte
        pt = 0
        while i < n and rbsp[i] == 0xFF:
            pt += 255
            i += 1
        if i >= n:
            break
        pt += rbsp[i]
        i += 1
        ps = 0
        while i < n and rbsp[i] == 0xFF:
            ps += 255
            i += 1
        if i >= n:
            break
        ps += rbsp[i]
        i += 1
        out.append((pt, rbsp[i:i + ps]))
        i += ps
    return out


def extract_hdr_side_data(annexb: bytes, codec: str) -> dict:
    """Scan an annex-B access unit for HDR metadata NALs."""
    sd = {}
    for nal in _split_annexb(annexb):
        if not nal:
            continue
        if codec == "hevc":
            ntype = (nal[0] >> 1) & 0x3F
            if ntype == HEVC_NAL_RPU:
                # store the RBSP (unescaped) so nal_unit's re-escape on
                # emission round-trips; keeping the EBSP here would
                # double-escape any 00 00 0x run on every transcode hop
                sd["dovi_rpu"] = _ebsp_to_rbsp(nal[2:])
                continue
            if ntype != HEVC_NAL_PREFIX_SEI:
                continue
            body = _ebsp_to_rbsp(nal[2:])
        else:
            if (nal[0] & 0x1F) != H264_NAL_SEI:
                continue
            body = _ebsp_to_rbsp(nal[1:])
        for pt, payload in parse_sei_messages(body):
            if pt == SEI_MASTERING and len(payload) >= 24:
                sd["mastering_display"] = bytes(payload[:24])
            elif pt == SEI_CLL and len(payload) >= 4:
                sd["content_light"] = bytes(payload[:4])
            elif pt == SEI_T35:
                sd["hdr10plus_t35"] = bytes(payload)
    return sd


def _sei_message(pt: int, payload: bytes) -> bytes:
    out = bytearray()
    while pt >= 255:
        out.append(0xFF)
        pt -= 255
    out.append(pt)
    ps = len(payload)
    while ps >= 255:
        out.append(0xFF)
        ps -= 255
    out.append(ps)
    return bytes(out) + payload


def build_sei_rbsp(side_data: dict, include_t35: bool = True) -> bytes:
    body = b""
    if side_data.get("mastering_display"):
        body += _sei_message(SEI_MASTERING, side_data["mastering_display"])
    if side_data.get("content_light"):
        body += _sei_message(SEI_CLL, side_data["content_light"])
    if include_t35 and side_data.get("hdr10plus_t35"):
        body += _sei_message(SEI_T35, side_data["hdr10plus_t35"])
    return body + b"\x80" if body else b""


def hdr_nals(side_data: dict, codec: str) -> tuple:
    """→ (pre, post) annex-B NAL bytes carrying the side-data's HDR
    metadata.  Prefix SEI goes before the access unit; the DoVi RPU NAL
    is appended after it (Dolby carriage: the RPU describes the access
    unit it follows), so annex-B consumers associate it correctly."""
    pre = b""
    rbsp = build_sei_rbsp(side_data)
    if rbsp:
        if codec == "hevc":
            from .hevc.syntax import nal_unit
            pre += nal_unit(HEVC_NAL_PREFIX_SEI, rbsp)
        else:
            from .h264.bits import nal_unit
            pre += nal_unit(0, H264_NAL_SEI, rbsp)
    post = b""
    if codec == "hevc" and side_data.get("dovi_rpu"):
        from .hevc.syntax import nal_unit
        post = nal_unit(HEVC_NAL_RPU, side_data["dovi_rpu"])
    return pre, post


# -- mp4 box payloads (ISO 14496-12 mdcv / clli / colr) ---------------------
def mdcv_payload(mastering: bytes) -> bytes:
    """SEI 137 payload and the mdcv box share the 24-byte layout (3x
    primaries xy + white point xy as u16, max/min luminance u32); this
    framework keeps the byte order stable end-to-end."""
    return mastering[:24]


def clli_payload(cll: bytes) -> bytes:
    return cll[:4]


def colr_payload(color: dict) -> bytes:
    import struct
    return (b"nclx"
            + struct.pack(">HHH", color.get("Primaries", 1),
                          color.get("Transfer", 1),
                          color.get("Matrix", 1))
            + (0x80 if color.get("Range", 1) else 0).to_bytes(1, "big"))
