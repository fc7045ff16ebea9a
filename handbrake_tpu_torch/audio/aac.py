"""AAC-LC encoder, from scratch (reference role: encavcodecaudio.c:573 —
HandBrake's default audio encoder is AAC).

Long windows only (2048-sample sine-window MDCT, 1024-sample frames),
SCE/CPE elements, all spectral sections coded with codebook 11 (ESC) or
the zero codebook, one scalefactor per frame (deltas 0 → cheap side
info).  Conformance is pinned by decoding through libavcodec in the test
suite (tests/ffaudio.py oracle); the Huffman tables are the normative
ISO/IEC 14496-3 constants (audio/aac_tables.py).

Output: raw AAC access units (one per 1024 samples) — the caller wraps
them in ADTS (sources/streams) or mp4a/esds (mux/mp4.py).
"""
from __future__ import annotations

import numpy as np

from ..codecs.h264.bits import BitWriter
from .aac_tables import (B11_BITS, B11_CODES, SF_BITS, SF_CODES,
                         SWB_1024_48)

SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350]

# Quantizer-step calibration: the decoder reconstructs
# |q|^(4/3) * 2^((sf-100)/4) * D0 per MDCT bin while our forward sine-
# window MDCT responds with M per unit input amplitude; quantizing with
# step = M*D0*2^((sf-100)/4) makes encode→decode unity-gain.  M and D0
# were measured against libavcodec (M = 488.709, D0 = 2.9802e-8).
SF_ZERO = 100
STEP_CAL = 488.70851 * 2.9802322e-08


def _mdct_matrix(N: int = 2048) -> np.ndarray:
    """The (N, N/2) float64 MDCT cosine matrix."""
    n = np.arange(N)
    k = np.arange(N // 2)
    n0 = (N // 2 + 1) / 2.0
    return np.cos(2 * np.pi / N * np.outer(n + n0, k + 0.5))


# built once: rebuilding it took most of an encode's time
_COSMAT = _mdct_matrix()


def _mdct_long(frames2048: np.ndarray) -> np.ndarray:
    """(B, 2048) windowed blocks → (B, 1024) MDCT coefficients."""
    return frames2048 @ _COSMAT


_WINDOW = np.sin(np.pi / 2048 * (np.arange(2048) + 0.5))


class AACEncoder:
    """AAC-LC encoder. quality: scalefactor step ~ qp analog (lower =
    better; 60 transparent-ish, 90 low rate).

    bitrate > 0 enables closed-loop ABR: the per-frame global quantizer
    adapts toward the bit budget (the encavcodecaudio.c rate-control
    role) from the `quality` starting point."""

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 quality: int = 132, bitrate: int = 0):
        if sample_rate not in (44100, 48000):
            raise ValueError("AAC-LC encoder supports 44.1/48 kHz")
        self.sr = sample_rate
        self.sr_index = SAMPLE_RATES.index(sample_rate)
        self.channels = min(2, channels)
        self.sf = int(quality)
        self.bitrate = int(bitrate)
        self._rc_err = 0.0          # accumulated bits over/under budget
        self.swb = SWB_1024_48
        self.max_sfb = len(self.swb) - 1
        self._hist = np.zeros((self.channels, 1024), np.float32)
        self._pend = np.zeros((0, self.channels), np.float32)

    def _rc_update(self, au_bytes: int):
        """Nudge the quantizer toward the ABR budget (±1 sf per frame,
        each sf step ≈ ±19% rate via the 2^(sf/4) step size)."""
        if self.bitrate <= 0:
            return
        target = self.bitrate * 1024.0 / self.sr
        self._rc_err += au_bytes * 8 - target
        # leaky integrator: react within ~10 frames, forget old error
        self._rc_err *= 0.9
        ratio = self._rc_err / max(1.0, target)
        if ratio > 1.0:
            self.sf = min(200, self.sf + min(4, int(ratio)))
        elif ratio < -1.0:
            self.sf = max(60, self.sf - min(4, int(-ratio)))

    # -- config ------------------------------------------------------------
    def audio_specific_config(self) -> bytes:
        """AudioSpecificConfig for esds/CodecPrivate (AAC-LC)."""
        bw = BitWriter()
        bw.put(2, 5)                    # AOT: AAC-LC
        bw.put(self.sr_index, 4)
        bw.put(self.channels, 4)
        bw.put(0, 3)                    # frame length 1024, no core/ext
        return bw.get_rbsp()

    def adts_header(self, aac_frame_len: int) -> bytes:
        ln = aac_frame_len + 7
        h = bytearray(7)
        h[0] = 0xFF
        h[1] = 0xF1
        h[2] = (1 << 6) | (self.sr_index << 2) | (self.channels >> 2)
        h[3] = ((self.channels & 3) << 6) | ((ln >> 11) & 3)
        h[4] = (ln >> 3) & 0xFF
        h[5] = ((ln & 7) << 5) | 0x1F
        h[6] = 0xFC
        return bytes(h)

    # -- huffman helpers ---------------------------------------------------
    @staticmethod
    def _sf_delta(bw, delta):
        idx = delta + 60
        bw.put(SF_CODES[idx], SF_BITS[idx])

    @staticmethod
    def _esc_value(bw, v):
        """Escape sequence for |q| >= 16 (prefix 1s, 0, mantissa)."""
        nbits = v.bit_length() - 1      # v >= 16 → nbits >= 4
        for _ in range(nbits - 4):
            bw.put_bit(1)
        bw.put_bit(0)
        bw.put(v - (1 << nbits), nbits)

    def _code_band(self, bw, q, start, end):
        for i in range(start, end, 2):
            a, b = int(q[i]), int(q[i + 1])
            ca, cb = min(abs(a), 16), min(abs(b), 16)
            idx = ca * 17 + cb
            bw.put(B11_CODES[idx], B11_BITS[idx])
            if ca:
                bw.put_bit(1 if a < 0 else 0)
            if cb:
                bw.put_bit(1 if b < 0 else 0)
            if ca == 16:
                self._esc_value(bw, min(abs(a), 8191))
            if cb == 16:
                self._esc_value(bw, min(abs(b), 8191))

    # -- one channel stream ------------------------------------------------
    def _ics_info(self, bw):
        bw.put_bit(0)                   # ics_reserved
        bw.put(0, 2)                    # window_sequence: ONLY_LONG
        bw.put_bit(0)                   # window_shape: sine
        bw.put(self.max_sfb, 6)
        bw.put_bit(0)                   # predictor_data_present

    def _channel_stream(self, bw, q, band_used, common_window):
        bw.put(getattr(self, "_frame_sf", self.sf), 8)   # global_gain
        if not common_window:
            self._ics_info(bw)
        # section_data: runs of (cb, length) over max_sfb bands
        runs = []
        for sfb in range(self.max_sfb):
            cb = 11 if band_used[sfb] else 0
            if runs and runs[-1][0] == cb:
                runs[-1][1] += 1
            else:
                runs.append([cb, 1])
        for cb, ln in runs:
            bw.put(cb, 4)
            while ln >= 31:
                bw.put(31, 5)
                ln -= 31
            bw.put(ln, 5)
        # scale_factor_data: dpcm from global_gain, all equal → deltas 0
        for sfb in range(self.max_sfb):
            if band_used[sfb]:
                self._sf_delta(bw, 0)
        bw.put_bit(0)                   # pulse_data_present
        bw.put_bit(0)                   # tns_data_present
        bw.put_bit(0)                   # gain_control_data_present
        for sfb in range(self.max_sfb):
            if band_used[sfb]:
                self._code_band(bw, q, self.swb[sfb], self.swb[sfb + 1])

    # -- frame encode ------------------------------------------------------
    def _encode_frame(self, blocks) -> bytes:
        """blocks: (channels, 2048) pre-windowed input → one raw AU."""
        spec = _mdct_long(blocks * _WINDOW)
        # per-frame sf floor: raise the quantizer until every |q| fits the
        # escape range (8191) — global_gain is per-frame, so this is free
        sf = self.sf
        while True:
            step = STEP_CAL * 2.0 ** (0.25 * (sf - SF_ZERO))
            peak = float(np.max(np.abs(spec))) / step
            if peak ** 0.75 <= 8191 or sf >= 251:
                break
            sf += 4
        self._frame_sf = sf
        bw = BitWriter()
        qs, bands = [], []
        for c in range(self.channels):
            mag = np.abs(spec[c]) / step
            q = (np.floor(mag ** 0.75 + 0.4054)
                 * np.sign(spec[c])).astype(np.int32)
            qs.append(q)
            bands.append([bool(np.any(q[self.swb[s]:self.swb[s + 1]]))
                          for s in range(self.max_sfb)])
        if self.channels == 2:
            bw.put(1, 3)                # CPE
            bw.put(0, 4)                # element_instance_tag
            bw.put_bit(1)               # common_window
            self._ics_info(bw)
            bw.put(0, 2)                # ms_mask_present: none
            self._channel_stream(bw, qs[0], bands[0], True)
            self._channel_stream(bw, qs[1], bands[1], True)
        else:
            bw.put(0, 3)                # SCE
            bw.put(0, 4)
            self._channel_stream(bw, qs[0], bands[0], False)
        bw.put(7, 3)                    # END
        bw.byte_align_zero()
        return bw.get_rbsp()

    def encode(self, pcm: np.ndarray) -> list:
        """pcm: (n, channels) float32 in [-1, 1] → list of raw AUs (each
        1024 samples; 1024-sample encoder latency from the MDCT overlap).
        """
        pcm = np.asarray(pcm, np.float32)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        pcm = pcm[:, :self.channels]          # float domain, ±1.0
        self._pend = np.vstack([self._pend, pcm])
        out = []
        while len(self._pend) >= 1024:
            cur = self._pend[:1024].T               # (ch, 1024)
            self._pend = self._pend[1024:]
            blocks = np.concatenate([self._hist, cur], axis=1)
            self._hist = cur
            au = self._encode_frame(blocks)
            self._rc_update(len(au))
            out.append(au)
        return out

    def flush(self) -> list:
        if len(self._pend) == 0 and not np.any(self._hist):
            return []
        pad = np.zeros((1024 - len(self._pend) + 1024, self.channels),
                       np.float32)
        self._pend = np.vstack([self._pend, pad])
        out = []
        while len(self._pend) >= 1024:
            cur = self._pend[:1024].T
            self._pend = self._pend[1024:]
            blocks = np.concatenate([self._hist, cur], axis=1)
            self._hist = cur
            out.append(self._encode_frame(blocks))
        self._pend = np.zeros((0, self.channels), np.float32)
        return out
