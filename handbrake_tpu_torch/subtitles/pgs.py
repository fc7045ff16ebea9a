"""PGS (HDMV Presentation Graphic Stream) subtitle decoder.

Role of decavsub.c:739's PGS personality: Blu-ray and many MKV releases
carry bitmap subtitles as PGS; burning them in needs segment parsing,
palette application and RLE bitmap decode — the output is the RGBA
events the render_sub filter blends (rendersub.c + hb_blend analog).

MKV delivers one display set per packet as bare segments
(type u8 | size u16 | payload); m2ts wraps each segment in a 'PG' header
(sync-detected and stripped here).  Segments: PCS (composition: epoch
state + object positions), WDS (windows), PDS (palette: YCrCb + alpha),
ODS (object: run-length coded bitmap, possibly fragmented), END.

Every display set REPLACES the whole on-screen composition (a PCS with
zero objects is a pure clear), so the decoder emits a clear marker
(rgba=None) followed by the set's objects — streaming consumers keep an
event on screen until the next set arrives (PGS has no durations).
"""
from __future__ import annotations

import dataclasses

import numpy as np

SEG_PDS = 0x14
SEG_ODS = 0x15
SEG_PCS = 0x16
SEG_WDS = 0x17
SEG_END = 0x80


@dataclasses.dataclass
class PgsEvent:
    pts: int                      # 90 kHz
    stop: int | None              # None: until the next display set
    x: int
    y: int
    rgba: "np.ndarray | None"     # (h, w, 4) uint8; None = clear marker


def _ycbcra_to_rgba(pal):
    """(256, 4) [Y, Cr, Cb, A] → (256, 4) RGBA (BT.709, full-range per
    HDMV convention with video-range luma)."""
    y = pal[:, 0].astype(np.float32)
    cr = (pal[:, 1].astype(np.float32) - 128.0) * (255.0 / 224.0)
    cb = (pal[:, 2].astype(np.float32) - 128.0) * (255.0 / 224.0)
    yf = (y - 16.0) * (255.0 / 219.0)
    r = yf + 1.5748 * cr
    g = yf - 0.4681 * cr - 0.1873 * cb
    b = yf + 1.8556 * cb
    out = np.zeros((256, 4), np.uint8)
    out[:, 0] = np.clip(r, 0, 255)
    out[:, 1] = np.clip(g, 0, 255)
    out[:, 2] = np.clip(b, 0, 255)
    out[:, 3] = pal[:, 3]
    return out


def rle_decode(data: bytes, width: int, height: int) -> np.ndarray:
    """HDMV run-length decode → (height, width) palette indices."""
    out = np.zeros((height, width), np.uint8)
    i = 0
    row = 0
    col = 0
    n = len(data)
    while i < n and row < height:
        b = data[i]
        i += 1
        if b:
            if col < width:
                out[row, col] = b
            col += 1
            continue
        if i >= n:
            break
        f = data[i]
        i += 1
        if f == 0:                       # end of line
            row += 1
            col = 0
            continue
        kind = f >> 6
        if kind == 0:                    # short zero run
            ln = f & 0x3F
            col += ln
        elif kind == 1:                  # long zero run
            ln = ((f & 0x3F) << 8) | data[i]
            i += 1
            col += ln
        elif kind == 2:                  # short colored run
            ln = f & 0x3F
            c = data[i]
            i += 1
            out[row, col:min(col + ln, width)] = c
            col += ln
        else:                            # long colored run
            ln = ((f & 0x3F) << 8) | data[i]
            c = data[i + 1]
            i += 2
            out[row, col:min(col + ln, width)] = c
            col += ln
    return out


class PgsDecoder:
    """feed(packet, pts) → list[PgsEvent] (stop of the previous event is
    patched in place when the next composition arrives)."""

    def __init__(self):
        self.palettes = {}            # id -> (256,4) YCrCbA
        self.objects = {}             # id -> dict(w, h, data bytearray)
        self.comp = None              # pending composition
        self.events: list = []

    def feed(self, packet: bytes, pts: int):
        out = []
        i = 0
        data = bytes(packet)
        while i + 3 <= len(data):
            if data[i:i + 2] == b"PG":           # m2ts segment header
                i += 10
                if i + 3 > len(data):
                    break
            st = data[i]
            size = int.from_bytes(data[i + 1:i + 3], "big")
            seg = data[i + 3:i + 3 + size]
            i += 3 + size
            out += self._segment(st, seg, pts)
        return out

    def flush(self):
        ev = self.events
        self.events = []
        return ev

    def _segment(self, st, seg, pts):
        if st == SEG_PCS:
            n_obj = seg[10] if len(seg) > 10 else 0
            objs = []
            j = 11
            for _ in range(n_obj):
                if j + 8 > len(seg):
                    break
                oid = int.from_bytes(seg[j:j + 2], "big")
                # window_id u8, flags u8 (0x40 = forced, 0x80 = cropped)
                cropped = seg[j + 3] & 0x80
                x = int.from_bytes(seg[j + 4:j + 6], "big")
                y = int.from_bytes(seg[j + 6:j + 8], "big")
                objs.append((oid, x, y))
                j += 8 + (8 if cropped else 0)
            self.comp = {"pts": pts, "pal": seg[9] if len(seg) > 9 else 0,
                         "objs": objs}
        elif st == SEG_PDS:
            pid = seg[0]
            pal = self.palettes.setdefault(
                pid, np.zeros((256, 4), np.uint8))
            for j in range(2, len(seg) - 4, 5):
                idx = seg[j]
                pal[idx] = [seg[j + 1], seg[j + 2], seg[j + 3], seg[j + 4]]
        elif st == SEG_ODS:
            oid = int.from_bytes(seg[0:2], "big")
            flags = seg[3]
            if flags & 0x80:              # first fragment
                w = int.from_bytes(seg[7:9], "big")
                h = int.from_bytes(seg[9:11], "big")
                self.objects[oid] = {"w": w, "h": h,
                                     "data": bytearray(seg[11:])}
            else:                         # continuation
                if oid in self.objects:
                    self.objects[oid]["data"] += seg[4:]
        elif st == SEG_END:
            return self._compose()
        return []

    def _compose(self):
        if not self.comp:
            return []
        # a display set replaces the screen: clear marker first
        out = [PgsEvent(pts=self.comp["pts"], stop=None, x=0, y=0,
                        rgba=None)]
        pal = self.palettes.get(self.comp["pal"])
        rgba_pal = _ycbcra_to_rgba(pal) if pal is not None else None
        for oid, x, y in self.comp["objs"]:
            obj = self.objects.get(oid)
            if obj is None or rgba_pal is None:
                continue
            idx = rle_decode(bytes(obj["data"]), obj["w"], obj["h"])
            ev = PgsEvent(pts=self.comp["pts"], stop=None, x=x, y=y,
                          rgba=rgba_pal[idx])
            out.append(ev)
            self.events.append(ev)
        self.comp = None
        return out


# -- encoder (test fixtures + future PGS passthrough re-mux) ---------------
def rle_encode(idx: np.ndarray) -> bytes:
    """(h, w) palette indices → HDMV RLE."""
    out = bytearray()
    for row in idx:
        col = 0
        w = len(row)
        while col < w:
            c = int(row[col])
            ln = 1
            while col + ln < w and row[col + ln] == c:
                ln += 1
            if c == 0:
                if ln <= 63:
                    out += bytes([0, ln])
                else:
                    out += bytes([0, 0x40 | (ln >> 8), ln & 0xFF])
            elif ln <= 2:
                out += bytes([c] * ln)
            elif ln <= 63:
                out += bytes([0, 0x80 | ln, c])
            else:
                out += bytes([0, 0xC0 | (ln >> 8), ln & 0xFF, c])
            col += ln
        out += b"\x00\x00"                # end of line
    return bytes(out)


def build_display_set(pts, bitmap_idx, palette_ycbcra, x, y,
                      screen=(1920, 1080), clear=False) -> bytes:
    """Assemble one MKV-style PGS packet (segments, no PG headers)."""
    def seg(st, payload):
        return bytes([st]) + len(payload).to_bytes(2, "big") + payload

    w, hgt = screen
    pcs = (w.to_bytes(2, "big") + hgt.to_bytes(2, "big") + b"\x10"
           + b"\x00\x00"          # composition number
           + b"\x80"              # epoch start
           + b"\x00"              # palette update flag
           + b"\x00"              # palette id
           + (b"\x00" if clear else b"\x01"))
    if not clear:
        pcs += (b"\x00\x00"       # object id
                + b"\x00"         # window id
                + b"\x00"         # flags
                + int(x).to_bytes(2, "big") + int(y).to_bytes(2, "big"))
    out = seg(SEG_PCS, pcs)
    if not clear:
        h_, w_ = bitmap_idx.shape
        wds = (b"\x01\x00" + int(x).to_bytes(2, "big")
               + int(y).to_bytes(2, "big")
               + w_.to_bytes(2, "big") + h_.to_bytes(2, "big"))
        out += seg(SEG_WDS, wds)
        pds = b"\x00\x00"
        for i, (yy, cr, cb, a) in enumerate(palette_ycbcra):
            if a or yy or cr or cb:
                pds += bytes([i, yy, cr, cb, a])
        out += seg(SEG_PDS, pds)
        rle = rle_encode(bitmap_idx)
        ods = (b"\x00\x00"        # object id
               + b"\x00"          # version
               + b"\xc0"          # first & last fragment
               + (len(rle) + 4).to_bytes(3, "big")
               + w_.to_bytes(2, "big") + h_.to_bytes(2, "big") + rle)
        out += seg(SEG_ODS, ods)
    out += seg(SEG_END, b"")
    return out
