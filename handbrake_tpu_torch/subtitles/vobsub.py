"""VOBSUB / DVD subpicture (SPU) decoder.

Role of decavsub.c's VOBSUB personality + the dvdsubdec logic HandBrake
relies on: DVD and many MKV releases carry bitmap subtitles as SPU
packets — 2-bit RLE pixels in two interleaved fields plus a command
sequence (palette/alpha selection, screen coords, display start/stop
delays).  The 16-color CLUT comes from the IFO (DVD) or the `palette:`
line of the .idx / MKV CodecPrivate.

Same consumer contract as PgsDecoder (work.py _emit_sub): feed() yields
PgsEvent objects — a clear marker (rgba=None) followed by the bitmap,
and another clear at the commanded stop time; a display replaces the
previous one on screen.
"""
from __future__ import annotations

import numpy as np

from .pgs import PgsEvent

_DEFAULT_CLUT = [
    0x000000, 0xFFFFFF, 0x808080, 0xC0C0C0, 0xFF0000, 0x00FF00,
    0x0000FF, 0xFFFF00, 0xFF00FF, 0x00FFFF, 0x800000, 0x008000,
    0x000080, 0x808000, 0x800080, 0x008080]


def parse_idx_palette(private: bytes) -> list:
    """Extract the 16-entry RGB CLUT from .idx text / MKV CodecPrivate
    (`palette: 000000, ffffff, ...`)."""
    try:
        text = private.decode("utf-8", "replace")
    except AttributeError:
        text = str(private)
    for line in text.splitlines():
        s = line.strip()
        if s.lower().startswith("palette:"):
            vals = []
            for tok in s[8:].split(","):
                tok = tok.strip()
                if tok:
                    try:
                        vals.append(int(tok, 16))
                    except ValueError:
                        vals.append(0)
            if len(vals) >= 16:
                return vals[:16]
    return list(_DEFAULT_CLUT)


class _Nibbler:
    def __init__(self, data, off):
        self.d = data
        self.pos = off * 2            # nibble index

    def get(self, n=1) -> int:
        v = 0
        for _ in range(n):
            byte = self.d[self.pos >> 1]
            v = (v << 4) | ((byte >> 4) if not (self.pos & 1)
                            else (byte & 0x0F))
            self.pos += 1
        return v

    def align(self):
        self.pos = (self.pos + 1) & ~1


def _rle_field(data, off, width, rows) -> np.ndarray:
    """Decode one field (even or odd lines) of DVD 2-bit RLE."""
    out = np.zeros((rows, width), np.uint8)
    nb = _Nibbler(data, off)
    for row in range(rows):
        col = 0
        while col < width:
            v = nb.get()
            if v >= 0x4:                       # 1 nibble: run 1-3
                run, c = v >> 2, v & 3
            else:
                v = (v << 4) | nb.get()
                if v >= 0x10:                  # 2 nibbles: run 4-15
                    run, c = v >> 2, v & 3
                else:
                    v = (v << 4) | nb.get()
                    if v >= 0x40:              # 3 nibbles: run 16-63
                        run, c = v >> 2, v & 3
                    else:                      # 4 nibbles: run 64-255,
                        v = (v << 4) | nb.get()
                        run, c = v >> 2, v & 3
                        if run == 0:           # 0 = to end of line
                            run = width - col
            out[row, col:min(col + run, width)] = c
            col += run
        nb.align()
    return out


class VobSubDecoder:
    """feed(spu_packet, pts) → list[PgsEvent]; palette16 is the RGB CLUT
    (from parse_idx_palette / IFO)."""

    def __init__(self, palette16=None):
        clut = palette16 or _DEFAULT_CLUT
        self.clut = np.array([[(c >> 16) & 255, (c >> 8) & 255, c & 255]
                              for c in clut], np.uint8)
        self._partial = b""

    def feed(self, packet: bytes, pts: int):
        # SPU packets can span PES payloads: byte 0-1 = total size
        data = self._partial + bytes(packet)
        if len(data) < 4:
            self._partial = data
            return []
        total = int.from_bytes(data[0:2], "big")
        if len(data) < total:
            self._partial = data
            return []
        self._partial = data[total:]
        data = data[:total]
        return self._decode_spu(data, pts)

    def flush(self):
        self._partial = b""
        return []

    def _decode_spu(self, d, pts):
        ctrl = int.from_bytes(d[2:4], "big")
        pal_sel = [0, 1, 2, 3]
        alpha = [15, 15, 15, 15]
        x1 = y1 = 0
        w = h = 0
        top_off = bottom_off = 0
        start_delay = None
        stop_delay = None
        pos = ctrl
        seen = set()
        while 0 <= pos < len(d) - 3 and pos not in seen:
            seen.add(pos)
            delay = int.from_bytes(d[pos:pos + 2], "big")
            nxt = int.from_bytes(d[pos + 2:pos + 4], "big")
            i = pos + 4
            while i < len(d):
                cmd = d[i]
                i += 1
                if cmd == 0x00:                # force display
                    start_delay = delay if start_delay is None else \
                        start_delay
                elif cmd == 0x01:              # start display
                    start_delay = delay if start_delay is None else \
                        start_delay
                elif cmd == 0x02:              # stop display
                    stop_delay = delay
                elif cmd == 0x03:              # palette selection
                    pal_sel = [d[i] >> 4, d[i] & 15,
                               d[i + 1] >> 4, d[i + 1] & 15][::-1]
                    i += 2
                elif cmd == 0x04:              # alpha (0-15 per color)
                    alpha = [d[i] >> 4, d[i] & 15,
                             d[i + 1] >> 4, d[i + 1] & 15][::-1]
                    i += 2
                elif cmd == 0x05:              # coords (12-bit x1x2 y1y2)
                    x1 = (d[i] << 4) | (d[i + 1] >> 4)
                    x2 = ((d[i + 1] & 15) << 8) | d[i + 2]
                    y1 = (d[i + 3] << 4) | (d[i + 4] >> 4)
                    y2 = ((d[i + 4] & 15) << 8) | d[i + 5]
                    w, h = x2 - x1 + 1, y2 - y1 + 1
                    i += 6
                elif cmd == 0x06:              # field data offsets
                    top_off = int.from_bytes(d[i:i + 2], "big")
                    bottom_off = int.from_bytes(d[i + 2:i + 4], "big")
                    i += 4
                elif cmd == 0xFF:
                    break
                else:                          # unknown: bail this seq
                    break
            if nxt == pos:                     # last sequence self-links
                break
            pos = nxt
        if w <= 0 or h <= 0 or not top_off:
            return []
        # two interleaved fields (even rows from top, odd from bottom)
        even = _rle_field(d, top_off, w, (h + 1) // 2)
        odd = _rle_field(d, bottom_off, w, h // 2)
        idx = np.zeros((h, w), np.uint8)
        idx[0::2] = even
        idx[1::2] = odd
        rgba_pal = np.zeros((4, 4), np.uint8)
        for k in range(4):
            rgba_pal[k, :3] = self.clut[pal_sel[k] & 15]
            rgba_pal[k, 3] = alpha[k] * 17
        start = pts + (start_delay or 0) * 1024
        out = [PgsEvent(pts=start, stop=None, x=0, y=0, rgba=None),
               PgsEvent(pts=start, stop=None, x=x1, y=y1,
                        rgba=rgba_pal[idx])]
        if stop_delay is not None:
            out.append(PgsEvent(pts=pts + stop_delay * 1024, stop=None,
                                x=0, y=0, rgba=None))
        return out


# -- encoder (test fixtures + future passthrough) --------------------------
def _rle_encode_field(rows, width):
    nibs = []
    for row in rows:
        col = 0
        while col < width:
            c = int(row[col])
            run = 1
            while col + run < width and row[col + run] == c:
                run += 1
            if col + run >= width and run >= 64:
                nibs += [0, 0, 0, c]           # to end of line
            elif run <= 3:
                nibs.append((run << 2) | c)
            elif run <= 15:
                v = (run << 2) | c
                nibs += [v >> 4, v & 15]
            elif run <= 63:
                v = (run << 2) | c
                nibs += [0, (v >> 4) & 15, v & 15]
            else:
                run = min(run, 255)
                v = (run << 2) | c
                nibs += [0, 0, (v >> 4) & 15, v & 15]
            col += run
        if len(nibs) & 1:
            nibs.append(0)                     # byte align per line
    out = bytearray()
    for k in range(0, len(nibs), 2):
        out.append((nibs[k] << 4) | nibs[k + 1])
    return bytes(out)


def build_spu(idx2bit: np.ndarray, x: int, y: int, pal_sel=(0, 1, 2, 3),
              alpha=(0, 15, 15, 15), start_delay=0,
              stop_delay=None) -> bytes:
    """Assemble one SPU packet from a (h, w) 2-bit index bitmap."""
    h, w = idx2bit.shape
    top = _rle_encode_field(idx2bit[0::2], w)
    bottom = _rle_encode_field(idx2bit[1::2], w)
    top_off = 4
    bottom_off = top_off + len(top)
    ctrl_off = bottom_off + len(bottom)
    p = pal_sel
    a = alpha
    cmds = bytearray()
    cmds += bytes([0x03, (p[3] << 4) | p[2], (p[1] << 4) | p[0]])
    cmds += bytes([0x04, (a[3] << 4) | a[2], (a[1] << 4) | a[0]])
    x2, y2 = x + w - 1, y + h - 1
    cmds += bytes([0x05, x >> 4, ((x & 15) << 4) | (x2 >> 8), x2 & 255,
                   y >> 4, ((y & 15) << 4) | (y2 >> 8), y2 & 255])
    cmds += bytes([0x06]) + top_off.to_bytes(2, "big") \
        + bottom_off.to_bytes(2, "big")
    cmds += bytes([0x01, 0xFF])
    seq1 = start_delay.to_bytes(2, "big")      # next offset patched below
    end_cmds = bytes([0x02, 0xFF])
    seq2_off = ctrl_off + 4 + len(cmds)
    if stop_delay is None:
        seq1 += ctrl_off.to_bytes(2, "big")    # self-link: only sequence
        body = bytes(seq1) + bytes(cmds)
    else:
        seq1 += seq2_off.to_bytes(2, "big")
        seq2 = stop_delay.to_bytes(2, "big") + seq2_off.to_bytes(2, "big")
        body = bytes(seq1) + bytes(cmds) + seq2 + end_cmds
    total = ctrl_off + len(body)
    return total.to_bytes(2, "big") + ctrl_off.to_bytes(2, "big") \
        + top + bottom + body
