"""CEA-608 closed-caption decoder (reference: libhb/deccc608sub.c).

Broadcast/DVD video carries caption byte pairs in MPEG-2 user_data
(ATSC A/53 `GA94` cc_data) or H.264 SEI (registered ITU-T T.35, same
payload).  This implements the line-21 field-1 (CC1) service: pop-on
captions (RCL → off-screen buffer → EOC swap), roll-up modes (RU2/3/4 +
CR), erase controls (EDM/ENM), preamble address codes as row breaks,
and the basic + special character sets.  Output is text SubEvents like
the file importers produce, so captions mux or burn through the same
path.

Out of scope: field 2 / CC3-4, extended charsets beyond the common
specials, italics/color styling (mid-row codes are consumed, not
rendered) — matching the reference's practical subset.
"""
from __future__ import annotations

from .srt import SubEvent

# special characters, codes 0x30-0x3F after (0x11, 0x30+n)
_SPECIALS = "®°½¿™¢£♪à èâêîôû"

_CHAR_REMAP = {0x2A: "á", 0x5C: "é", 0x5E: "í", 0x5F: "ó", 0x60: "ú",
               0x7B: "ç", 0x7C: "÷", 0x7D: "Ñ", 0x7E: "ñ", 0x7F: "█"}


def _char(c: int) -> str:
    if c < 0x20:
        return ""
    return _CHAR_REMAP.get(c, chr(c))


class Cea608Decoder:
    """feed(pairs, pts) → list[SubEvent]; pairs are parity-stripped
    (cc1, cc2) byte tuples from field 1."""

    def __init__(self):
        self.mode = "popon"
        self.disp: list = []          # displayed rows
        self.buf: list = []           # off-screen (pop-on) rows
        self.rollup_rows = 2
        self._last = None             # control-code dedupe
        self._shown_pts = None

    def _emit(self, out, pts):
        if self.disp and self._shown_pts is not None:
            text = "\n".join(r for r in ("".join(r).strip()
                                         for r in self.disp) if r)
            if text:
                out.append(SubEvent(pts=self._shown_pts, stop=pts,
                                    text=text))

    def feed(self, pairs, pts: int):
        out = []
        for (b1, b2) in pairs:
            b1 &= 0x7F
            b2 &= 0x7F
            if b1 == 0 and b2 == 0:
                self._last = None
                continue
            if 0x10 <= b1 <= 0x1F:                 # control code space
                if (b1, b2) == self._last:         # doubled transmission
                    self._last = None
                    continue
                self._last = (b1, b2)
                self._control(b1, b2, pts, out)
                continue
            self._last = None
            row = (self.buf if self.mode == "popon" else self.disp)
            if not row:
                row.append([])
            row[-1].append(_char(b1))
            if b2 >= 0x20:
                row[-1].append(_char(b2))
            if self.mode != "popon" and self._shown_pts is None:
                self._shown_pts = pts      # roll-up text paints live
        return out

    def _control(self, b1, b2, pts, out):
        if b1 in (0x14, 0x15, 0x1C, 0x1D) and 0x20 <= b2 <= 0x2F:
            op = b2
            if op == 0x20:                         # RCL → pop-on
                self.mode = "popon"
            elif op in (0x25, 0x26, 0x27):         # RU2/RU3/RU4
                self.mode = "rollup"
                self.rollup_rows = op - 0x23
                if not self.disp:
                    self.disp.append([])
            elif op == 0x29:                       # RDC → paint-on
                self.mode = "rollup"               # treat as direct
                if not self.disp:
                    self.disp.append([])
            elif op == 0x2C:                       # EDM: erase displayed
                self._emit(out, pts)
                self.disp = []
                self._shown_pts = None
            elif op == 0x2E:                       # ENM: erase buffer
                self.buf = []
            elif op == 0x2D:                       # CR (roll-up scroll)
                self._emit(out, pts)
                self.disp.append([])
                while len(self.disp) > self.rollup_rows:
                    self.disp.pop(0)
                self._shown_pts = pts
            elif op == 0x2F:                       # EOC: swap + display
                self._emit(out, pts)
                self.disp = self.buf or [[]]
                self.buf = []
                self._shown_pts = pts
            elif op == 0x21:                       # backspace
                tgt = self.buf if self.mode == "popon" else self.disp
                if tgt and tgt[-1]:
                    tgt[-1].pop()
        elif 0x10 <= b1 <= 0x17 and 0x40 <= b2 <= 0x7F:
            # preamble address code: new row in the active buffer
            tgt = self.buf if self.mode == "popon" else self.disp
            if tgt and tgt[-1]:
                tgt.append([])
            elif not tgt:
                tgt.append([])
        elif b1 in (0x11, 0x19) and 0x30 <= b2 <= 0x3F:
            tgt = self.buf if self.mode == "popon" else self.disp
            if not tgt:
                tgt.append([])
            tgt[-1].append(_SPECIALS[b2 - 0x30])
        # mid-row style codes (0x11, 0x20-0x2F) are consumed silently

    def flush(self, pts: int):
        out = []
        self._emit(out, pts)
        self.disp = []
        self._shown_pts = None
        return out


# -- cc_data extraction -----------------------------------------------------
def _parse_cc_data(d: bytes):
    """ATSC A/53 cc_data after 'GA94' 0x03: count byte + 3-byte triplets
    (marker/valid/type, cc1, cc2); keep valid field-1 pairs."""
    if len(d) < 2:
        return []
    cc_count = d[0] & 0x1F
    pairs = []
    pos = 2                                        # count + em_data
    for _ in range(cc_count):
        if pos + 3 > len(d):
            break
        flags, c1, c2 = d[pos], d[pos + 1], d[pos + 2]
        pos += 3
        if (flags & 0x04) and (flags & 0x03) == 0:  # valid, NTSC field 1
            pairs.append((c1, c2))
    return pairs


def extract_cc_mpeg2(es: bytes):
    """MPEG-2 user_data (00 00 01 B2) with GA94/0x03 → cc pairs."""
    pairs = []
    i = 0
    while True:
        i = es.find(b"\x00\x00\x01\xb2", i)
        if i < 0:
            break
        j = es.find(b"\x00\x00\x01", i + 4)
        body = es[i + 4:j if j > 0 else len(es)]
        if body[:5] == b"GA94\x03":
            pairs += _parse_cc_data(body[5:])
        i += 4
    return pairs


def extract_cc_h264(es: bytes):
    """H.264 SEI NALs, registered ITU-T T.35 (type 4) with GA94 0x03."""
    from ..codecs.h264.bits import split_annexb, ebsp_to_rbsp
    pairs = []
    for nal in split_annexb(es):
        if (nal[0] & 0x1F) != 6:
            continue
        r = ebsp_to_rbsp(nal[1:])
        pos = 0
        while pos + 2 < len(r):
            pt = 0
            while pos < len(r) and r[pos] == 0xFF:
                pt += 255
                pos += 1
            if pos >= len(r):
                break
            pt += r[pos]
            pos += 1
            sz = 0
            while pos < len(r) and r[pos] == 0xFF:
                sz += 255
                pos += 1
            if pos >= len(r):
                break
            sz += r[pos]
            pos += 1
            payload = r[pos:pos + sz]
            pos += sz
            if pt == 4 and payload[:1] == b"\xb5" \
                    and payload[1:3] == b"\x00\x31" \
                    and payload[3:8] == b"GA94\x03":
                pairs += _parse_cc_data(payload[8:])
    return pairs
