"""Bit-level IO for H.264 syntax: Exp-Golomb, RBSP, emulation prevention.

Role of the reference's bitstream.c + nal_units.c (bitreader/writer,
annex-B framing); ours also backs the decoder used for round-trip tests.
"""
from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def put(self, value: int, nbits: int):
        assert 0 <= nbits <= 32
        if nbits:
            assert 0 <= value < (1 << nbits), (value, nbits)
        self._cur = (self._cur << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._cur >> self._nbits) & 0xFF)
        self._cur &= (1 << self._nbits) - 1

    def put_bit(self, b: int):
        self.put(b & 1, 1)

    def ue(self, v: int):
        """Unsigned Exp-Golomb."""
        assert v >= 0
        vv = v + 1
        nbits = vv.bit_length()
        self.put(0, nbits - 1)
        self.put(vv, nbits)

    def se(self, v: int):
        """Signed Exp-Golomb: 0,1,-1,2,-2... → 0,1,2,3,4."""
        self.ue((2 * v - 1) if v > 0 else (-2 * v))

    def byte_align_zero(self):
        if self._nbits:
            self.put(0, 8 - self._nbits)

    def rbsp_trailing(self):
        self.put_bit(1)
        self.byte_align_zero()

    def bitpos(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def get_rbsp(self) -> bytes:
        assert self._nbits == 0, "call rbsp_trailing/byte_align first"
        return bytes(self._bytes)


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention 0x03 bytes."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation-prevention bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def nal_unit(nal_ref_idc: int, nal_type: int, rbsp: bytes,
             annexb: bool = True, long_start: bool = True) -> bytes:
    hdr = bytes([(nal_ref_idc << 5) | nal_type])
    payload = hdr + rbsp_to_ebsp(rbsp)
    if annexb:
        start = b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01"
        return start + payload
    return payload


def split_annexb(data: bytes):
    """Yield NAL payloads (without start codes) from an annex-B stream."""
    i = 0
    n = len(data)
    starts = []
    while i < n - 2:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # trim trailing zero bytes belonging to next 4-byte start code
        while e > s and data[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        yield data[s:e]


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def u(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def peek(self, nbits: int) -> int:
        save = self.pos
        try:
            return self.u(nbits)
        finally:
            self.pos = save

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad ue(v)")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if (k & 1) else -(k // 2)

    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos

    def more_rbsp_data(self) -> bool:
        """True if there is data before the rbsp_stop_one_bit."""
        left = self.bits_left()
        if left <= 0:
            return False
        # find last set bit in stream (the stop bit)
        save = self.pos
        # scan from end of data for the final 1 bit
        i = len(self.data) - 1
        while i >= 0 and self.data[i] == 0:
            i -= 1
        if i < 0:
            return False
        b = self.data[i]
        lastbit = i * 8 + (7 - ((b & -b).bit_length() - 1))
        self.pos = save
        return self.pos < lastbit
