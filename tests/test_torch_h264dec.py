"""The port's H.264 decoder (``codecs/h264/native_decoder.py`` on its own
build of ``native/hbdec264.cpp``, behind ``codecs/registry``'s
``H264VideoDecoder``) held against the JAX package's
``NativeH264Decoder``: the planes must be equal, exactly, frame for frame,
on the JAX encoder's CAVLC and CABAC/High+8x8 streams at 64x48 and at
172x140 (SPS frame cropping), on the port's CPU encoder's streams, and on
a stream of several IDR periods.  The port's decoder must also give back
the port's encoder's reconstructions.  No fallback: a decoder whose
native library does not build raises."""
import numpy as np
import pytest

from handbrake_tpu.codecs.h264 import encoder as jenc
from handbrake_tpu.codecs.h264.native_decoder import \
    NativeH264Decoder as JNativeDecoder
from handbrake_tpu_torch.codecs import registry
from handbrake_tpu_torch.codecs.h264 import encoder as tenc
from handbrake_tpu_torch.codecs.h264.native_decoder import NativeH264Decoder
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.native import build
from handbrake_tpu_torch.utils.synth import make_clip


def _jax_stream(w, h, n, **tools):
    cfg = dict(width=w, height=h, qp=30, gop=60)
    cfg.update(tools)
    enc = jenc.H264Encoder(jenc.EncoderConfig(**cfg))
    return [enc.encode_frame(*f) for f in make_clip(w, h, n, seed=w + h)]


def _port_stream(w, h, n, gop=60, recons=None, **tools):
    cfg = dict(width=w, height=h, qp=28, gop=gop, deblock=True, cabac=True,
               transform8x8=True)
    cfg.update(tools)
    enc = tenc.H264Encoder(tenc.EncoderConfig(**cfg), device="cpu")
    out = []
    for f in make_clip(w, h, n, seed=3):
        out.append(enc.encode_frame(*f))
        if recons is not None:
            recons.append(tuple(p.cpu().numpy() for p in
                                (enc.recon_y, enc.recon_u, enc.recon_v)))
    return out


# (stream maker, its arguments, frames, width, height)
STREAMS = {
    "jax-cavlc-64x48": (_jax_stream, dict(), 5, 64, 48),
    "jax-cavlc-172x140-crop": (_jax_stream, dict(), 4, 172, 140),
    "jax-cabac-high-64x48": (_jax_stream, dict(
        backend="device", deblock=True, cabac=True, transform8x8=True),
        5, 64, 48),
    "jax-cabac-high-172x140-crop": (_jax_stream, dict(
        backend="device", deblock=True, cabac=True, transform8x8=True),
        4, 172, 140),
    "port-cabac-high-64x48": (_port_stream, dict(), 5, 64, 48),
    "port-cavlc-64x48": (_port_stream, dict(cabac=False), 5, 64, 48),
    "port-multi-idr-64x48": (_port_stream, dict(gop=3), 8, 64, 48),
}


def _decode(dec, stream):
    return [f for au in stream for f in dec.decode(au)]


@pytest.mark.parametrize("name", list(STREAMS))
def test_decoder_planes_equal_reference(name):
    make, kw, n, w, h = STREAMS[name]
    stream = make(w, h, n, **kw)
    got = _decode(NativeH264Decoder(), stream)
    want = _decode(JNativeDecoder(), stream)
    assert len(got) == len(want) == n
    for g, r in zip(got, want):
        assert [p.shape for p in g] == [(h, w), (h // 2, w // 2),
                                        (h // 2, w // 2)]
        for a, b in zip(g, r):
            assert a.dtype == np.uint8 and np.array_equal(a, b)
    # the whole stream in one call, as a demuxer's packet of annex-B
    whole = NativeH264Decoder().decode(b"".join(stream))
    assert all(np.array_equal(a, b) for f, r in zip(whole, got)
               for a, b in zip(f, r))


def test_decoder_gives_back_the_encoders_recons():
    recons = []
    stream = _port_stream(64, 48, 7, gop=4, recons=recons)
    got = _decode(NativeH264Decoder(), stream)
    assert len(got) == len(recons) == 7
    for g, r in zip(got, recons):
        for a, b in zip(g, r):
            assert np.array_equal(a, b[:a.shape[0], :a.shape[1]])


def test_registry_decoder_from_avcc():
    """create_video_decoder("h264") with an avcC (an mp4's or mkv's
    CodecPrivate), then length-stripped samples as annex-B packets; its
    info() gives the cropped size."""
    from handbrake_tpu_torch.mux.nal import (build_avcc, extract_sps_pps,
                                             strip_parameter_sets)
    stream = _port_stream(64, 48, 3)
    sps, pps = extract_sps_pps(stream[0])
    dec = registry.create_video_decoder("h264", build_avcc(sps, pps))
    assert isinstance(dec, registry.H264VideoDecoder)
    frames = []
    for i, au in enumerate(stream):
        frames += dec.feed(Buffer(data=strip_parameter_sets(au), pts=i * 3003,
                                  duration=3003))
    assert [f.pts for f in frames] == [0, 3003, 6006]
    assert dec.info()["width"] == 64 and dec.info()["height"] == 48
    want = _decode(JNativeDecoder(), stream)
    for f, r in zip(frames, want):
        assert all(np.array_equal(a, b) for a, b in zip(f.planes, r))


def test_no_python_fallback(monkeypatch, tmp_path):
    """A native build that fails raises; nothing decodes in Python."""
    def fail(*a, **k):
        raise RuntimeError("hbdec264: build failed")
    monkeypatch.setattr(build, "_dec_lib", [None])
    monkeypatch.setattr(build, "compile_shared", fail)
    with pytest.raises(RuntimeError, match="build failed"):
        registry.create_video_decoder("h264")
    # nor does a catalog codec where libavcodec is missing
    from torch_catalog import hide
    hide(monkeypatch, tmp_path)
    with pytest.raises(ValueError, match="vp9.*libavcodec.so.59 not found"):
        registry.create_video_decoder("vp9")
