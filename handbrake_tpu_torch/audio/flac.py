"""FLAC encoder/decoder — host-native, self-contained (reference role:
encavcodecaudio.c FLAC path via libavcodec; HandBrake offers FLAC 16/24).

Implements the FLAC format subset that covers encoding:
  * STREAMINFO metadata block with MD5 of the raw signal
  * frames: fixed predictors (orders 0-4, per-subframe best), constant and
    verbatim subframes, Rice-coded residuals (partitioned, per-partition
    parameter search), stereo left/side, right/side, mid/side decorrelation
  * frame-header CRC-8 and frame CRC-16, UTF-8-style frame numbering
The decoder reads everything the encoder emits (round-trip tests) plus
independent-channel streams.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np

FLAC_MARKER = b"fLaC"
_BLOCK = 4096


# ---------------------------------------------------------------------------
# bit IO (byte-aligned writer with arbitrary-width fields)
# ---------------------------------------------------------------------------
class _BW:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def put_unary(self, q: int):
        while q >= 32:
            self.put(0, 32)
            q -= 32
        self.put(1, q + 1)

    def align(self):
        if self.nbits:
            self.put(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


class _BR:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0          # bit position

    def get(self, n: int) -> int:
        out = 0
        for _ in range(n):
            byte = self.d[self.pos >> 3]
            out = (out << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return out

    def get_unary(self) -> int:
        q = 0
        while self.get(1) == 0:
            q += 1
        return q

    def align(self):
        self.pos = (self.pos + 7) & ~7


# ---------------------------------------------------------------------------
# CRCs (FLAC polynomials)
# ---------------------------------------------------------------------------
def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 \
                else (crc << 1) & 0xFF
    return crc


_CRC16_TAB = None


def _crc16(data: bytes) -> int:
    global _CRC16_TAB
    if _CRC16_TAB is None:
        tab = []
        for i in range(256):
            crc = i << 8
            for _ in range(8):
                crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                    else (crc << 1) & 0xFFFF
            tab.append(crc)
        _CRC16_TAB = tab
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TAB[((crc >> 8) ^ b) & 0xFF]
    return crc


def _utf8_number(n: int) -> bytes:
    """FLAC frame-number coding (UTF-8-style, up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (6 - nbytes + 5 * nbytes)) and nbytes < 7:
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(lead | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _read_utf8_number(br: _BR) -> int:
    b0 = br.get(8)
    if b0 < 0x80:
        return b0
    nbytes = 0
    mask = 0x80
    while b0 & mask:
        nbytes += 1
        mask >>= 1
    n = b0 & (0x7F >> nbytes)
    for _ in range(nbytes - 1):
        n = (n << 6) | (br.get(8) & 0x3F)
    return n


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
_FIXED_COEFS = [
    [],
    [1],
    [2, -1],
    [3, -3, 1],
    [4, -6, 4, -1],
]


def _rice_cost(res: np.ndarray, k: int) -> int:
    z = (np.abs(res.astype(np.int64)) << 1) - (res < 0)
    return int((z >> k).sum()) + len(res) * (k + 1)


def _best_rice_k(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    mean = np.abs(res.astype(np.int64)).mean()
    k = max(0, int(np.log2(mean + 1)))
    best_k, best_c = k, _rice_cost(res, k)
    for kk in (k - 1, k + 1):
        if 0 <= kk <= 30:
            c = _rice_cost(res, kk)
            if c < best_c:
                best_k, best_c = kk, c
    return best_k


def _write_rice(bw: _BW, res: np.ndarray, k: int):
    z = ((np.abs(res.astype(np.int64)) << 1) - (res < 0)).astype(np.int64)
    for v in z:
        bw.put_unary(int(v) >> k)
        if k:
            bw.put(int(v) & ((1 << k) - 1), k)


def _subframe_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


class FlacEncoder:
    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 bits: int = 16, block_size: int = _BLOCK):
        self.sr = sample_rate
        self.ch = channels
        self.bits = bits
        self.bs = block_size
        self.frame_no = 0
        self.total_samples = 0
        self._md5 = hashlib.md5()
        self._min_fs = 1 << 30
        self._max_fs = 0
        self._pending = np.zeros((0, channels), np.int32)

    # -- metadata ----------------------------------------------------------
    def streaminfo(self) -> bytes:
        """34-byte STREAMINFO body."""
        bw = _BW()
        bw.put(self.bs, 16)
        bw.put(self.bs, 16)
        bw.put(0 if self._max_fs == 0 else 0, 24)   # min frame size unknown
        bw.put(0, 24)
        bw.put(self.sr, 20)
        bw.put(self.ch - 1, 3)
        bw.put(self.bits - 1, 5)
        bw.put(self.total_samples, 36)
        bw.align()
        return bw.bytes() + self._md5.digest()

    def header(self) -> bytes:
        si = self.streaminfo()
        return FLAC_MARKER + bytes([0x80, 0, 0, len(si)]) + si

    # -- frames ------------------------------------------------------------
    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: (n, channels) int (or float in [-1,1]); returns frame bytes
        for every complete block (remainder buffered)."""
        if pcm.dtype.kind == "f":
            pcm = np.clip(pcm, -1.0, 1.0)
            pcm = (pcm * ((1 << (self.bits - 1)) - 1)).astype(np.int32)
        pcm = pcm.reshape(-1, self.ch).astype(np.int32)
        self._pending = np.concatenate([self._pending, pcm])
        out = b""
        while len(self._pending) >= self.bs:
            blk, self._pending = self._pending[:self.bs], \
                self._pending[self.bs:]
            out += self._encode_frame(blk)
        return out

    def flush(self) -> bytes:
        out = b""
        if len(self._pending):
            out = self._encode_frame(self._pending)
            self._pending = np.zeros((0, self.ch), np.int32)
        return out

    def _encode_frame(self, blk: np.ndarray) -> bytes:
        n = len(blk)
        if self.bits == 16:
            self._md5.update(blk.astype("<i2").tobytes())
        else:
            raw = blk.astype("<i4").tobytes()
            self._md5.update(b"".join(
                raw[i:i + 3] for i in range(0, len(raw), 4)))
        self.total_samples += n

        # stereo decorrelation choice
        mode = 0   # independent
        chans = [blk[:, c].astype(np.int64) for c in range(self.ch)]
        if self.ch == 2:
            l, r = chans
            side = l - r
            costs = {
                0: _est(l) + _est(r),
                8: _est(l) + _est(side),        # left/side
                9: _est(side) + _est(r),        # right/side
                10: _est((l + r) >> 1) + _est(side),  # mid/side
            }
            mode = min(costs, key=costs.get)
            if mode == 8:
                chans = [l, side]
            elif mode == 9:
                chans = [side, r]
            elif mode == 10:
                chans = [(l + r) >> 1, side]

        # ---- header ----
        hdr = _BW()
        hdr.put(0b11111111111110, 14)
        hdr.put(0, 1)
        hdr.put(0, 1)                       # fixed blocksize stream
        # blocksize code: "get 16 bit from end of header" (0b0111)
        hdr.put(0b0111, 4)
        sr_code = {88200: 0b0001, 176400: 0b0010, 192000: 0b0011,
                   8000: 0b0100, 16000: 0b0101, 22050: 0b0110,
                   24000: 0b0111, 32000: 0b1000, 44100: 0b1001,
                   48000: 0b1010, 96000: 0b1011}.get(self.sr, 0b0000)
        hdr.put(sr_code, 4)
        if self.ch == 2 and mode:
            hdr.put(mode, 4)
        else:
            hdr.put(self.ch - 1, 4)
        bps_code = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101,
                    24: 0b110}.get(self.bits, 0b000)
        hdr.put(bps_code, 3)
        hdr.put(0, 1)
        head = hdr.bytes() + _utf8_number(self.frame_no)
        head += struct.pack(">H", n - 1)
        head += bytes([_crc8(head)])

        # ---- subframes ----
        bw = _BW()
        for ci, x in enumerate(chans):
            bits = self.bits
            if self.ch == 2:
                # side channel carries one extra bit
                if (mode == 8 and ci == 1) or (mode == 9 and ci == 0) \
                        or (mode == 10 and ci == 1):
                    bits += 1
            self._write_subframe(bw, x, bits)
        bw.align()
        body = head + bw.bytes()
        body += struct.pack(">H", _crc16(body))
        self.frame_no += 1
        self._min_fs = min(self._min_fs, len(body))
        self._max_fs = max(self._max_fs, len(body))
        return body

    def _write_subframe(self, bw: _BW, x: np.ndarray, bits: int):
        n = len(x)
        if np.all(x == x[0]):
            bw.put(0, 1)
            bw.put(0b000000, 6)     # constant
            bw.put(0, 1)
            bw.put(int(x[0]), bits)
            return
        # pick best fixed order
        best_o, best_cost, best_res = 0, None, None
        for o in range(min(5, n)):
            res = _subframe_residual(x, o)
            cost = _rice_cost(res, _best_rice_k(res)) + o * bits
            if best_cost is None or cost < best_cost:
                best_o, best_cost, best_res = o, cost, res
        if best_cost > n * bits:    # verbatim wins
            bw.put(0, 1)
            bw.put(0b000001, 6)
            bw.put(0, 1)
            for v in x:
                bw.put(int(v), bits)
            return
        bw.put(0, 1)
        bw.put(0b001000 | best_o, 6)   # FIXED, order o
        bw.put(0, 1)
        for v in x[:best_o]:           # warmup samples
            bw.put(int(v), bits)
        # residual: partition order 0, 4-bit rice
        k = _best_rice_k(best_res)
        bw.put(0b00, 2)                # rice method (4-bit params)
        bw.put(0, 4)                   # partition order 0
        bw.put(min(k, 14), 4)
        _write_rice(bw, best_res, min(k, 14))


def _est(x: np.ndarray) -> int:
    r = np.diff(np.diff(x))
    return _rice_cost(r, _best_rice_k(r)) if len(r) else 0


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
class FlacDecoder:
    def __init__(self, data: bytes = b""):
        self.sr = 0
        self.ch = 0
        self.bits = 0
        self.total = 0
        self._frames_data = b""
        if data:
            self._parse_header(data)

    def _parse_header(self, data: bytes):
        assert data[:4] == FLAC_MARKER
        i = 4
        while True:
            last = data[i] & 0x80
            btype = data[i] & 0x7F
            ln = int.from_bytes(data[i + 1:i + 4], "big")
            if btype == 0:
                br = _BR(data[i + 4:i + 4 + 34])
                br.get(16)
                br.get(16)
                br.get(24)
                br.get(24)
                self.sr = br.get(20)
                self.ch = br.get(3) + 1
                self.bits = br.get(5) + 1
                self.total = br.get(36)
            i += 4 + ln
            if last:
                break
        self._frames_data = data[i:]

    def decode_all(self) -> np.ndarray:
        """Returns (n, channels) int32."""
        br = _BR(self._frames_data)
        chunks = []
        total_bits = len(self._frames_data) * 8
        while br.pos + 40 <= total_bits:
            chunks.append(self._decode_frame(br))
        return np.concatenate(chunks) if chunks else \
            np.zeros((0, self.ch), np.int32)

    def _decode_frame(self, br: _BR) -> np.ndarray:
        sync = br.get(14)
        assert sync == 0b11111111111110, f"bad sync {sync:014b}"
        br.get(1)
        br.get(1)
        bs_code = br.get(4)
        sr_code = br.get(4)
        ch_code = br.get(4)
        bps_code = br.get(3)
        br.get(1)
        _read_utf8_number(br)
        if bs_code == 0b0110:
            n = br.get(8) + 1
        elif bs_code == 0b0111:
            n = br.get(16) + 1
        else:
            n = {0b0001: 192, 0b0010: 576, 0b0011: 1152, 0b0100: 2304,
                 0b0101: 4608, 0b1000: 256, 0b1001: 512, 0b1010: 1024,
                 0b1011: 2048, 0b1100: 4096, 0b1101: 8192, 0b1110: 16384,
                 0b1111: 32768}[bs_code]
        if sr_code == 0b1100:
            br.get(8)
        elif sr_code in (0b1101, 0b1110):
            br.get(16)
        br.get(8)    # crc8
        stereo_mode = 0
        nch = self.ch
        if ch_code >= 8:
            stereo_mode = ch_code
            nch = 2
        # frame-header bps overrides STREAMINFO (needed when STREAMINFO
        # was written with provisional values)
        bits = {0b001: 8, 0b010: 12, 0b100: 16, 0b101: 20,
                0b110: 24}.get(bps_code, self.bits)
        chans = []
        for ci in range(nch):
            b = bits
            if (stereo_mode == 8 and ci == 1) \
                    or (stereo_mode == 9 and ci == 0) \
                    or (stereo_mode == 10 and ci == 1):
                b += 1
            chans.append(self._decode_subframe(br, n, b))
        br.align()
        br.get(16)   # crc16
        if stereo_mode == 8:      # left/side
            l, s = chans
            chans = [l, l - s]
        elif stereo_mode == 9:    # right/side
            s, r = chans
            chans = [s + r, r]
        elif stereo_mode == 10:   # mid/side
            m, s = chans
            l = m + ((s + (s & 1)) >> 1) if False else None
            # mid = (l+r)>>1, side = l-r  →  l = mid + ((side+1)>>1)? use
            # exact inverse: l = mid + ((side + (side & 1)) // 2) is wrong;
            # with floor division mid = (l+r)>>1: l = mid + ((side+1)>>1),
            # r = l - side
            left = m + ((s + 1) >> 1)
            chans = [left, left - s]
        return np.stack(chans, axis=1).astype(np.int32)

    def _decode_subframe(self, br: _BR, n: int, bits: int) -> np.ndarray:
        br.get(1)
        stype = br.get(6)
        wasted = br.get(1)
        shift = 0
        if wasted:
            shift = 1 + br.get_unary()
        if stype == 0:           # constant
            v = _signed(br.get(bits), bits)
            out = np.full(n, v, np.int64)
        elif stype == 1:         # verbatim
            out = np.array([_signed(br.get(bits), bits)
                            for _ in range(n)], np.int64)
        elif 8 <= stype <= 12:   # fixed
            order = stype - 8
            warm = [_signed(br.get(bits), bits) for _ in range(order)]
            res = self._decode_residual(br, n, order)
            out = np.empty(n, np.int64)
            out[:order] = warm
            c = _FIXED_COEFS[order]
            for i in range(order, n):
                pred = sum(c[j] * out[i - 1 - j] for j in range(order))
                out[i] = res[i - order] + pred
        else:
            raise ValueError(f"unsupported subframe type {stype}")
        return out << shift

    def _decode_residual(self, br: _BR, n: int, order: int) -> np.ndarray:
        method = br.get(2)
        kbits = 4 if method == 0 else 5
        porder = br.get(4)
        nparts = 1 << porder
        res = []
        for p in range(nparts):
            cnt = (n >> porder) - (order if p == 0 else 0)
            k = br.get(kbits)
            if k == (1 << kbits) - 1:
                eb = br.get(5)
                res.extend(_signed(br.get(eb), eb) for _ in range(cnt))
            else:
                for _ in range(cnt):
                    q = br.get_unary()
                    z = (q << k) | (br.get(k) if k else 0)
                    res.append((z >> 1) ^ -(z & 1))
        return np.array(res, np.int64)


def _signed(v: int, bits: int) -> int:
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v
