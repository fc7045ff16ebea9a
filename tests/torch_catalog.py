"""Helpers of the libavcodec catalog's tests (``tests/test_torch_avcodec*.py``
and the refusals elsewhere): sources built with the port's muxers, the
reference's side of each comparison in a child process, and a binding
with the system library hidden.

The catalog's encoders and decoders are ctypes on the system
libavcodec.  ``hide(monkeypatch, tmp_path)`` points a binding's library
directory at an empty one and gives it a fresh probe state, so that
``available()`` is False and ``missing()`` names the two sonames, as on
a machine without the library; the monkeypatch restores both.

The ``reference`` fixture runs a function of ``torch_catalog_ref`` (the
JAX package's binding, decoders, scan and ``do_job``) in one spawned
child process a test module and hands back what it returns or raises.
The reference's binding finds an AVFrame field by scanning memory and
writes through what it found, once a process; in the child, that write
never lands in the worker that runs the other test files."""
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

import torch_catalog_ref
from handbrake_tpu_torch.codecs import avcodec
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.utils.synth import make_clip

W, H, N = 96, 64, 8
FRAME = 3000                    # 90 kHz ticks a frame at 30 fps
MISSING = r"libavutil\.so\.57 and libavcodec\.so\.59 not found"

needs_libavcodec = pytest.mark.skipif(
    not avcodec.available(),
    reason=f"the system libavcodec is missing ({avcodec.missing()})")


def hide(monkeypatch, tmp_path):
    """Hide the system libavcodec from the port's binding for one test
    (``torch_catalog_ref.job(..., hidden=True)`` hides it from the
    reference's, in the child)."""
    empty = tmp_path / "no_libavcodec"
    empty.mkdir(exist_ok=True)
    monkeypatch.setattr(avcodec, "_LIBDIR", str(empty))
    monkeypatch.setattr(avcodec, "_state", {})
    assert not avcodec.available()


REFERENCE_LIMIT_S = 600         # one call in the child, at most


@pytest.fixture(scope="module")
def reference():
    """``reference(fn, *args, **kw)`` runs ``fn`` (a function of
    ``torch_catalog_ref``) in this module's child process, started with
    spawn, and returns its result or raises its exception.  One child a
    module, so JAX is imported once a file."""
    with ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=torch_catalog_ref.start) as pool:
        yield lambda fn, *a, **kw: pool.submit(fn, *a, **kw).result(
            REFERENCE_LIMIT_S)


def tone(sr, n, seed=0, ch=2):
    """A tone a channel (440 Hz, 550 Hz, ...) with a little noise."""
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    return np.stack([0.35 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                     + 0.01 * rng.standard_normal(n) for c in range(ch)],
                    1).astype(np.float32)


def frames(seed=1, w=W, h=H, n=N):
    return make_clip(w, h, n, seed=seed)


def h264_aus(seed=1, w=W, h=H, n=N):
    enc = H264Encoder(EncoderConfig(width=w, height=h, qp=30, gop=n),
                      device="cpu")
    return [enc.encode_frame(*f) for f in frames(seed, w, h, n)]


def mkv_source(path, vpackets=None, vcodec="h264", vpriv=b"",
               acodec=None, apackets=(), sr=48000, apriv=b"", channels=2,
               pts=None, w=W, h=H):
    """An mkv of one video track (H.264 from the port's encoder unless
    `vpackets` is given, each with its display pts from `pts`) and at
    most one audio track of (packet, 90 kHz duration) pairs."""
    if vpackets is None:
        vpackets = h264_aus(w=w, h=h)
    pts = pts or [i * FRAME for i in range(len(vpackets))]
    wr = MKVWriter(path, webm=path.endswith(".webm"))
    vi = wr.add_video_track(codec=vcodec, width=w, height=h, fps=30.0,
                            private=vpriv)
    if acodec:
        ai = wr.add_audio_track(codec=acodec, sample_rate=sr,
                                channels=channels, private=apriv)
    for i, p in enumerate(vpackets):
        wr.write_sample(vi, p, pts_90k=pts[i], duration_90k=FRAME,
                        sync=i == 0, annexb=vcodec in ("h264", "hevc"))
    t = 0
    for p, dur in apackets:
        wr.write_sample(ai, p, pts_90k=t, duration_90k=dur)
        t += dur
    wr.finalize()
    return path


def pcm_packets(sr=48000, n=None, seed=0):
    """0.3 s of tone as s16le packets of 0.1 s."""
    pcm = np.clip(tone(sr, n or (3 * sr) // 10, seed) * 32767, -32768,
                  32767).astype("<i2")
    step = sr // 10
    return [(pcm[i:i + step].tobytes(), 9000)
            for i in range(0, len(pcm), step)]


def lavc_audio(codec, sr=48000, channels=2, bit_rate=192000, seconds=0.3):
    """(packets with 90 kHz durations, extradata) of libavcodec's
    `codec` encoder on a tone, through the port's binding."""
    enc = avcodec.AVAudioEncoder(codec, sr, channels, bit_rate)
    pkts = enc.encode(tone(sr, int(sr * seconds), ch=channels)) + enc.flush()
    return ([(p, int(round(d * 90000 / sr))) for p, d in pkts],
            enc.extradata)


def lavc_video(codec, opts=None, seed=1, w=W, h=H, n=N, bit_rate=400000):
    """(packets, extradata) of libavcodec's `codec` video encoder on a
    clip, through the port's binding."""
    enc = avcodec.AVVideoEncoder(codec, w, h, (30, 1), bit_rate=bit_rate,
                                 opts=opts)
    pkts = []
    for f in frames(seed, w, h, n):
        pkts += enc.encode(*f)
    pkts += enc.flush()
    return [p for p, _k in pkts], enc.extradata


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def no_output(path):
    return not os.path.exists(path)
