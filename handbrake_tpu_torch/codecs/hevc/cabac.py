"""HEVC CABAC arithmetic coding engine (ITU-T H.265 §9.3.4.3).

Context-adaptive binary arithmetic encoder/decoder with the standard
64-state probability model (tables shared with H.264). Entropy coding is
inherently sequential and therefore host-side by design (SURVEY.md §7
"Hard parts #1"); the TPU analysis path produces the syntax elements this
engine serializes.
"""
from __future__ import annotations

from .tables import CTX_INIT, RANGE_TAB_LPS, TRANS_IDX_LPS, ctx_init_state

_RTAB = RANGE_TAB_LPS.tolist()
_TLPS = TRANS_IDX_LPS.tolist()


class ContextSet:
    """All context models for one slice, keyed by (name, idx)."""

    def __init__(self, init_type: int, qp: int):
        self.state = {}
        for name, tables in CTX_INIT.items():
            vals = tables[init_type]
            for i, iv in enumerate(vals):
                self.state[(name, i)] = ctx_init_state(iv, qp)

    def get(self, name: str, idx: int = 0):
        return self.state[(name, idx)]

    def set(self, name: str, idx: int, st):
        self.state[(name, idx)] = st


class CabacEncoder:
    """Arithmetic encoder (9.3.4.3.2-5) writing into a bit list."""

    def __init__(self, ctx: ContextSet):
        self.ctx = ctx
        self.low = 0
        self.range = 510
        self.bits: list = []
        self.first = True
        self.outstanding = 0

    # -- low-level bit output with carry handling --
    def _put(self, b: int):
        if self.first:
            self.first = False
        else:
            self.bits.append(b)
        while self.outstanding > 0:
            self.bits.append(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    # -- bin coding --
    def bin(self, name: str, idx: int, b: int):
        st, mps = self.ctx.get(name, idx)
        lps = _RTAB[st][(self.range >> 6) & 3]
        self.range -= lps
        if b == mps:
            st2, mps2 = (st + 1 if st < 62 else st), mps
        else:
            self.low += self.range
            self.range = lps
            if st == 0:
                mps = 1 - mps
            st2, mps2 = _TLPS[st], mps
        self.ctx.set(name, idx, (st2, mps2))
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def bypass_bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bypass((v >> i) & 1)

    def terminate(self, b: int):
        self.range -= 2
        if b:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self):
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bits.append((self.low >> 8) & 1)
        self.bits.append(1)  # rbsp stop bit folded into flush (9.3.4.3.5)

    def write_to(self, bw):
        """Append the coded bins to a BitWriter and byte-align with zeros."""
        for b in self.bits:
            bw.put_bit(b)
        bw.byte_align_zero()


class CabacDecoder:
    """Arithmetic decoder (9.3.4.3.2-4) reading from a BitReader."""

    def __init__(self, ctx: ContextSet, br):
        self.ctx = ctx
        self.br = br
        self.range = 510
        self.offset = br.u(9)

    def _bit(self) -> int:
        return self.br.u(1) if self.br.bits_left() > 0 else 0

    def bin(self, name: str, idx: int = 0) -> int:
        st, mps = self.ctx.get(name, idx)
        lps = _RTAB[st][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - mps
            self.offset -= self.range
            self.range = lps
            if st == 0:
                mps = 1 - mps
            self.ctx.set(name, idx, (_TLPS[st], mps))
        else:
            b = mps
            self.ctx.set(name, idx, (st + 1 if st < 62 else st, mps))
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return b

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0
