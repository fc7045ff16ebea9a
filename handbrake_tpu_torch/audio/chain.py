"""Audio processing chain: decode output → resample → mixdown → gain/DRC →
encoder (reference: work.c:2042-2109 per-audio-track filter chains +
encavcodecaudio.c).

The counterpart of ``handbrake_tpu/audio/chain.py``: AAC-LC, AC-3, FLAC,
PCM and passthrough.  MP3, Opus and Vorbis ride the libavcodec catalog
(``codecs/avcodec.py``); where the library is missing, asking for one
raises WorkError naming what was not found (the original encodes FLAC
instead).

Encoders emit packet Buffers with sample-accurate 90 kHz timing derived
from a running sample counter (the reference derives pts the same way
after the resampler).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.buffer import Buffer, CLOCK
from . import dsp
from .flac import FlacEncoder


# the codec each encoder name writes (any other name: PCM)
ENCODER_CODECS = {"flac": "flac", "pcm": "pcm_s16le",
                  "pcm_s16le": "pcm_s16le", "aac": "aac", "av_aac": "aac",
                  "ca_aac": "aac", "ac3": "ac3", "eac3": "ac3",
                  "mp3": "mp3", "opus": "opus", "vorbis": "vorbis"}


# the channels of each mixdown ("none" and any other: the source's)
MIXDOWN_CHANNELS = {"mono": 1, "stereo": 2, "dpl2": 2, "5point1": 6,
                    "7point1": 8}


class AudioChain:
    """One per output audio track."""

    def __init__(self, spec, ti):
        """spec: AudioJobTrack; ti: source TrackInfo."""
        self.spec = spec
        self.ti = ti
        self.sr_in = ti.sample_rate
        self.sr_out = spec.samplerate or ti.sample_rate
        self.mixdown = spec.mixdown or "stereo"
        self.out_channels = MIXDOWN_CHANNELS.get(self.mixdown, ti.channels)
        if self.mixdown in ("5point1", "7point1"):
            self.out_channels = min(self.out_channels, ti.channels) \
                if ti.channels > 2 else ti.channels
        self.gain = float(spec.gain or 0.0)
        self.drc = float(spec.drc or 0.0)
        # dynamics (work.c:2042 per-track filter chain analog)
        self.compressor = (dsp.Compressor(self.sr_out,
                                          ratio=float(spec.compressor))
                           if getattr(spec, "compressor", 0) else None)
        self.gate = (dsp.Gate(self.sr_out,
                              threshold_db=float(spec.gate))
                     if getattr(spec, "gate", 0) else None)
        self.codec = spec.encoder
        self.samples_out = 0
        self._enc = self._make_encoder()

    # -- encoder -----------------------------------------------------------
    def _make_encoder(self):
        if self.codec == "flac":
            return FlacEncoder(self.sr_out, self.out_channels, 16)
        if self.codec in ("ac3", "eac3"):
            from .ac3enc import Ac3Encoder
            if self.sr_out not in (48000, 44100, 32000):
                self.sr_out = 48000
            if self.out_channels not in (1, 2, 6):
                from ..utils.logging import log
                log("audio: AC-3 output is 1/2/5.1 — downmixing %d ch"
                    % self.out_channels)
                self.mixdown = "stereo" if self.out_channels < 6 \
                    else "5point1"
                self.out_channels = 2 if self.out_channels < 6 else 6
            br = int(self.spec.bitrate or 192) * 1000
            return Ac3Encoder(self.sr_out, self.out_channels, br)
        if self.codec in ("mp3", "opus", "vorbis"):
            # the libavcodec catalog (encavcodecaudio.c:573 role —
            # upstream also routes these through lavc/LAME/libopus)
            from ..codecs import avcodec as av
            from ..work import WorkError
            av.require(f"audio encoder {self.codec!r}", WorkError)
            if self.codec == "opus" and self.sr_out not in (
                    48000, 24000, 16000, 12000, 8000):
                self.sr_out = 48000
            if self.out_channels > 2:
                self.mixdown = "stereo"
                self.out_channels = 2
            br = int(self.spec.bitrate or 160) * 1000
            name = {"mp3": "libmp3lame", "opus": "libopus",
                    "vorbis": "libvorbis"}[self.codec]
            return av.AVAudioEncoder(name, self.sr_out,
                                     self.out_channels, br)
        if self.codec in ("aac", "av_aac", "ca_aac"):
            from .aac import AACEncoder
            if self.sr_out not in (44100, 48000):
                self.sr_out = 48000
            if self.out_channels > 2:
                # the AAC encoder is stereo-max: downmix here so the
                # container channel count matches the coded stream
                from ..utils.logging import log
                log("audio: AAC output is stereo-max — downmixing %d ch"
                    % self.out_channels)
                self.mixdown = "stereo"
                self.out_channels = 2
            br = float(self.spec.bitrate or 160)
            import math
            quality = int(round(132 - 6 * math.log2(max(br, 32) / 160.0)))
            # closed-loop ABR from the quality-mapped starting point
            return AACEncoder(self.sr_out, self.out_channels,
                              quality=min(200, max(110, quality)),
                              bitrate=int(br * 1000))
        return None                      # pcm / copy

    def is_passthrough(self) -> bool:
        """The encoder is a copy (after ``work.resolve_audio_encoder``,
        ``copy:<codec>`` of a track of that codec)."""
        return self.codec.startswith("copy")

    def out_codec(self) -> str:
        if self.is_passthrough():
            # the resolved copy names the codec it passes through
            return self.codec.partition(":")[2] or self.ti.codec
        return ENCODER_CODECS.get(self.codec, "pcm_s16le")

    def extradata(self, initial: bool = False) -> bytes:
        """Codec config for the muxer. ``initial=True`` (header written
        before encoding, e.g. MKV CodecPrivate) zeroes the MD5/total
        fields — legal per FLAC spec (0 = unknown)."""
        if self.codec == "flac" and self._enc is not None:
            si = self._enc.streaminfo()
            if initial:
                # zero total-samples (36 bits: low nibble of byte 13 +
                # bytes 14-17) and MD5; keep the bits-per-sample bits that
                # share byte 13's high nibble
                si = si[:13] + bytes([si[13] & 0xF0]) \
                    + b"\x00\x00\x00\x00" + b"\x00" * 16
            return bytes([0x80, 0, 0, len(si)]) + si
        if self.out_codec() == "aac" and self._enc is not None:
            return self._enc.audio_specific_config()
        if self.out_codec() == "ac3" and self._enc is not None:
            # dac3 box (ETSI TS 102 366 F.4): fscod/bsid/bsmod/acmod/
            # lfeon/bit_rate_code packed into 3 bytes
            e = self._enc
            v = (e.fscod << 22) | (8 << 17) | (0 << 14) \
                | (e.acmod << 11) | (e.lfeon << 10) \
                | ((e.frmsizecod >> 1) << 5)
            return v.to_bytes(3, "big")
        if self.out_codec() in ("opus", "vorbis") and self._enc is not None:
            return self._enc.extradata     # OpusHead / Xiph lacing
        if self.is_passthrough():
            return self.ti.extradata
        return b""

    # -- processing --------------------------------------------------------
    def process(self, buf: Buffer) -> list:
        if self.is_passthrough():
            return [buf] if buf.data is not None else []
        if buf.planes is None:
            return []
        pcm = np.asarray(buf.planes[0], np.float32)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        pcm = dsp.resample(pcm, self.sr_in, self.sr_out)
        pcm = dsp.apply_mixdown(pcm, self.mixdown
                                if self.out_channels != pcm.shape[1]
                                else "none")
        if self.gain:
            pcm = dsp.apply_gain(pcm, self.gain)
        if self.drc > 1.0:
            pcm = dsp.apply_drc(pcm, self.drc)
        if self.gate is not None:
            pcm = self.gate.process(pcm)
        if self.compressor is not None:
            pcm = self.compressor.process(pcm)
        return self._encode(pcm)

    def _packet(self, data: bytes, nsamples: int) -> Buffer:
        pts = self.samples_out * CLOCK // self.sr_out
        self.samples_out += nsamples
        stop = self.samples_out * CLOCK // self.sr_out
        b = Buffer(data=data, track_kind="audio", pts=pts,
                   duration=stop - pts)
        b.stop = stop
        return b

    def _encode(self, pcm: np.ndarray) -> list:
        if self.out_codec() in ("mp3", "opus", "vorbis"):
            return [self._packet(data, dur) for data, dur
                    in self._enc.encode(np.clip(pcm, -1, 1))]
        if self.out_codec() == "ac3":
            return [self._packet(fr, 1536)
                    for fr in self._enc.encode(np.clip(pcm, -1, 1))]
        if self.out_codec() == "aac":
            out = []
            for au in self._enc.encode(np.clip(pcm, -1, 1)):
                out.append(self._packet(au, 1024))
            return out
        if self.codec == "flac":
            pcm16 = np.clip(pcm * 32767.0, -32768, 32767).astype(np.int32)
            out = []
            # FlacEncoder buffers internally to 4096-sample frames; feed
            # and drain whole frames so packets are frame-aligned
            pending_before = len(self._enc._pending)
            data = self._enc.encode(pcm16)
            if data:
                nframes_samples = (pending_before + len(pcm16)) \
                    - len(self._enc._pending)
                out.append(self._packet(data, nframes_samples))
            return out
        # pcm s16le
        data = (np.clip(pcm, -1, 1) * 32767.0).astype("<i2").tobytes()
        return [self._packet(data, len(pcm))]

    def flush(self) -> list:
        if self.out_codec() in ("mp3", "opus", "vorbis") \
                and self._enc is not None:
            return [self._packet(data, dur) for data, dur
                    in self._enc.flush()]
        if self.out_codec() == "aac" and self._enc is not None:
            return [self._packet(au, 1024) for au in self._enc.flush()]
        if self.out_codec() == "ac3" and self._enc is not None:
            return [self._packet(fr, 1536) for fr in self._enc.flush()]
        if self._enc is not None:
            n = len(self._enc._pending)
            data = self._enc.flush()
            if data:
                return [self._packet(data, n)]
        return []
