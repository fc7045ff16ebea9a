"""Audio DSP: mixdown matrices, sample-rate conversion, gain, DRC,
compressor/gate (reference: audio_resample in decavcodec.c via
libswresample; acompressor.c/agate.c avfilter aliases).

Mixdown coefficients follow the ITU/AC-3 downmix convention the reference
inherits from libav: center and surround at -3 dB into stereo.
Resampling reuses the crop/scale's lanczos weights (a (out, in) weight
matrix from ``filters/kernels.py`` ``resample_matrix``, applied with numpy
on the host).
"""
from __future__ import annotations

import numpy as np

CLEV = 0.7071067811865476   # -3 dB
SLEV = 0.7071067811865476

# channel orders assumed: mono=[C]; stereo=[L,R]; 5.1=[L,R,C,LFE,Ls,Rs];
# 7.1=[L,R,C,LFE,Ls,Rs,Lb,Rb]
MIXDOWNS = ("mono", "stereo", "dpl2", "5point1", "7point1", "none")


def mixdown_matrix(in_ch: int, mixdown: str) -> np.ndarray:
    """(out_ch, in_ch) float32 downmix matrix."""
    if mixdown in ("none", "") or in_ch == 1 and mixdown == "mono":
        return np.eye(in_ch, dtype=np.float32)
    if mixdown == "mono":
        out = np.zeros((1, in_ch), np.float32)
        if in_ch == 2:
            out[0] = [0.5, 0.5]
        elif in_ch >= 6:
            out[0, :3] = [0.5, 0.5, CLEV]
            out[0, 4:in_ch] = SLEV * 0.5
        else:
            out[0] = 1.0 / in_ch
        return out
    out_ch = 2 if mixdown in ("stereo", "dpl2") else \
        6 if mixdown == "5point1" else 8
    if in_ch <= out_ch and mixdown in ("5point1", "7point1"):
        m = np.zeros((out_ch, in_ch), np.float32)
        m[:in_ch, :in_ch] = np.eye(in_ch)
        return m
    m = np.zeros((2, in_ch), np.float32)
    if in_ch == 1:
        m[:, 0] = CLEV
    elif in_ch == 2:
        m = np.eye(2, dtype=np.float32)
    elif in_ch >= 6:
        # L R C LFE Ls Rs (Lb Rb)
        m[0, 0] = 1.0
        m[1, 1] = 1.0
        m[0, 2] = m[1, 2] = CLEV
        if mixdown == "dpl2":
            # Dolby PLII: surrounds at -1.2 dB with ±90° phase — real
            # encoder uses a Hilbert pair; matrix approximation here
            m[0, 4], m[1, 4] = -0.8660, 0.5
            m[0, 5], m[1, 5] = -0.5, 0.8660
        else:
            m[0, 4] = m[1, 5] = SLEV
        if in_ch >= 8:
            m[0, 6] = m[1, 7] = SLEV
    else:
        m[0, : in_ch] = m[1, :in_ch] = 1.0 / in_ch
    return m


def apply_mixdown(pcm: np.ndarray, mixdown: str) -> np.ndarray:
    """pcm (n, in_ch) float32 → (n, out_ch)."""
    m = mixdown_matrix(pcm.shape[1], mixdown)
    if m.shape[0] == m.shape[1] and np.allclose(m, np.eye(m.shape[0])):
        return pcm
    return pcm @ m.T


def resample(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Windowed-sinc rational resample, (n, ch) float32."""
    if sr_in == sr_out or pcm.size == 0:
        return pcm
    from ..filters.kernels import resample_matrix
    n_in = pcm.shape[0]
    n_out = int(round(n_in * sr_out / sr_in))
    A = resample_matrix(n_in, n_out, "lanczos")
    return (A @ pcm).astype(pcm.dtype)


def apply_gain(pcm: np.ndarray, gain_db: float) -> np.ndarray:
    if not gain_db:
        return pcm
    return pcm * (10.0 ** (gain_db / 20.0))


def apply_drc(pcm: np.ndarray, drc: float) -> np.ndarray:
    """Simple dynamic range compression: drc in [1, 4] like the
    reference's slider (1 = off); soft-knee above -20 dBFS."""
    if drc <= 1.0:
        return pcm
    thresh = 10.0 ** (-20.0 / 20.0)
    ratio = drc
    mag = np.abs(pcm)
    over = mag > thresh
    out = pcm.copy()
    comp = thresh * (mag[over] / thresh) ** (1.0 / ratio)
    out[over] = np.sign(pcm[over]) * comp
    return out


class Compressor:
    """acompressor analog: envelope-follower compressor with attack/release
    (per-buffer streaming; state carried between calls)."""

    def __init__(self, sr: int, threshold_db: float = -18.0,
                 ratio: float = 2.0, attack_ms: float = 20.0,
                 release_ms: float = 250.0, makeup_db: float = 0.0):
        self.thresh = 10.0 ** (threshold_db / 20.0)
        self.ratio = ratio
        self.a_att = float(np.exp(-1.0 / (sr * attack_ms / 1000.0)))
        self.a_rel = float(np.exp(-1.0 / (sr * release_ms / 1000.0)))
        self.makeup = 10.0 ** (makeup_db / 20.0)
        self.env = 0.0

    def process(self, pcm: np.ndarray) -> np.ndarray:
        mono = np.abs(pcm).max(axis=1) if pcm.ndim == 2 else np.abs(pcm)
        env = np.empty_like(mono)
        e = self.env
        for i, x in enumerate(mono):
            a = self.a_att if x > e else self.a_rel
            e = a * e + (1 - a) * x
            env[i] = e
        self.env = float(e)
        gain = np.ones_like(env)
        over = env > self.thresh
        gain[over] = (self.thresh * (env[over] / self.thresh)
                      ** (1.0 / self.ratio)) / env[over]
        g = gain[:, None] if pcm.ndim == 2 else gain
        return pcm * g * self.makeup


class Gate:
    """agate analog: downward expander below threshold."""

    def __init__(self, sr: int, threshold_db: float = -40.0,
                 ratio: float = 2.0, attack_ms: float = 10.0,
                 release_ms: float = 150.0):
        self.thresh = 10.0 ** (threshold_db / 20.0)
        self.ratio = ratio
        self.a_att = float(np.exp(-1.0 / (sr * attack_ms / 1000.0)))
        self.a_rel = float(np.exp(-1.0 / (sr * release_ms / 1000.0)))
        self.env = 0.0

    def process(self, pcm: np.ndarray) -> np.ndarray:
        mono = np.abs(pcm).max(axis=1) if pcm.ndim == 2 else np.abs(pcm)
        env = np.empty_like(mono)
        e = self.env
        for i, x in enumerate(mono):
            a = self.a_att if x > e else self.a_rel
            e = a * e + (1 - a) * x
            env[i] = e
        self.env = float(e)
        gain = np.ones_like(env)
        under = (env < self.thresh) & (env > 0)
        gain[under] = (env[under] / self.thresh) ** (self.ratio - 1.0)
        gain[env == 0] = 0.0
        g = gain[:, None] if pcm.ndim == 2 else gain
        return pcm * g
