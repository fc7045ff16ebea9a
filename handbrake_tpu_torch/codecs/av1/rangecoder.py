"""AV1-family multi-symbol range coder with adaptive CDFs.

The reference encodes AV1 via SVT-AV1 (reference encsvtav1.c, SURVEY.md
§2.5) whose entropy stage is the daala `od_ec` multi-symbol range coder.
This is our equivalent: a carry-less byte-oriented range coder (Subbotin
construction) over 15-bit cumulative-frequency tables, with AV1-style
per-symbol CDF adaptation (shift-based update, warm-up accelerated rate,
count saturation at 32).

Streams are self-conformant (decoder.py mirrors this coder exactly);
cross-conformance with libaom's bit-level od_ec output is a later-round
goal — the OBU framing, symbol alphabet, and adaptation dynamics already
follow the AV1 design so the swap is localised here.
"""
from __future__ import annotations

import numpy as np

PROB_TOTAL = 1 << 15          # CDFs sum to 32768 (AV1 15-bit precision)
_TOP = 1 << 24
_BOT = 1 << 16
_MASK32 = 0xFFFFFFFF


def uniform_cdf(n: int) -> np.ndarray:
    """Fresh CDF: n symbols, equal probability, counter appended last."""
    cdf = np.zeros(n + 1, dtype=np.int32)
    for i in range(n):
        cdf[i] = ((i + 1) * PROB_TOTAL) // n
    cdf[n] = 0  # adaptation counter
    return cdf


def update_cdf(cdf: np.ndarray, sym: int) -> None:
    """AV1 adaptation: exponential decay toward the observed symbol.

    rate speeds up during warm-up (count<16, <32) exactly like the spec's
    update_cdf; count saturates at 32.
    """
    n = len(cdf) - 1
    count = int(cdf[n])
    rate = 4 + (count > 15) + (count > 31) + min(max(n - 2, 0), 2).bit_length()
    for i in range(n - 1):
        if i >= sym:
            cdf[i] += (PROB_TOTAL - int(cdf[i])) >> rate
        else:
            cdf[i] -= int(cdf[i]) >> rate
    # EC_MIN_PROB floor: keep every symbol's interval non-empty
    for i in range(n - 1):
        lo = int(cdf[i - 1]) if i > 0 else 0
        if int(cdf[i]) <= lo:
            cdf[i] = lo + 1
        hi_cap = PROB_TOTAL - (n - 1 - i)
        if int(cdf[i]) > hi_cap:
            cdf[i] = hi_cap
    cdf[n] = min(count + 1, 32)


class RangeEncoder:
    """Carry-less range encoder over 15-bit CDFs."""

    def __init__(self):
        self.low = 0
        self.rng = _MASK32
        self.out = bytearray()

    def _renorm(self):
        while True:
            if (self.low ^ (self.low + self.rng)) < _TOP:
                pass
            elif self.rng < _BOT:
                self.rng = (-self.low) & (_BOT - 1)
            else:
                break
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK32
            self.rng = (self.rng << 8) & _MASK32

    def encode_symbol(self, sym: int, cdf: np.ndarray, adapt: bool = True):
        """Code `sym` under `cdf` (increasing, cdf[n-1]==32768)."""
        lo = int(cdf[sym - 1]) if sym > 0 else 0
        hi = int(cdf[sym])
        r = self.rng // PROB_TOTAL
        self.low = (self.low + r * lo) & _MASK32
        self.rng = r * (hi - lo)
        self._renorm()
        if adapt:
            update_cdf(cdf, sym)

    def encode_bit(self, bit: int):
        """Bypass bit (probability 1/2, no model)."""
        self.rng >>= 1
        if bit:
            self.low = (self.low + self.rng) & _MASK32
        self._renorm()

    def encode_literal(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.encode_bit((value >> i) & 1)

    def encode_golomb(self, value: int):
        """Exp-golomb (order 0) in bypass bits — MV/level escape coding."""
        value += 1
        n = value.bit_length()
        self.encode_literal(0, n - 1)
        self.encode_literal(value, n)

    def encode_sgolomb(self, value: int):
        self.encode_golomb((abs(value) << 1) - (value > 0))

    def finish(self) -> bytes:
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK32
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.low = 0
        self.rng = _MASK32
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & _MASK32

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def _renorm(self):
        while True:
            if (self.low ^ (self.low + self.rng)) < _TOP:
                pass
            elif self.rng < _BOT:
                self.rng = (-self.low) & (_BOT - 1)
            else:
                break
            self.code = ((self.code << 8) | self._byte()) & _MASK32
            self.low = (self.low << 8) & _MASK32
            self.rng = (self.rng << 8) & _MASK32

    def decode_symbol(self, cdf: np.ndarray, adapt: bool = True) -> int:
        n = len(cdf) - 1
        r = self.rng // PROB_TOTAL
        off = min(((self.code - self.low) & _MASK32) // r, PROB_TOTAL - 1)
        sym = 0
        while int(cdf[sym]) <= off:
            sym += 1
            if sym >= n - 1:
                break
        lo = int(cdf[sym - 1]) if sym > 0 else 0
        hi = int(cdf[sym])
        self.low = (self.low + r * lo) & _MASK32
        self.rng = r * (hi - lo)
        self._renorm()
        if adapt:
            update_cdf(cdf, sym)
        return sym

    def decode_bit(self) -> int:
        self.rng >>= 1
        bit = 0
        if ((self.code - self.low) & _MASK32) >= self.rng:
            bit = 1
            self.low = (self.low + self.rng) & _MASK32
        self._renorm()
        return bit

    def decode_literal(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bit()
        return v

    def decode_golomb(self) -> int:
        nz = 0
        while self.decode_bit() == 0 and nz < 32:
            nz += 1
        v = 1
        for _ in range(nz):
            v = (v << 1) | self.decode_bit()
        return v - 1

    def decode_sgolomb(self) -> int:
        u = self.decode_golomb()
        return (u + 2) >> 1 if (u & 1) else -(u >> 1)
