"""The port's H.264 encoder (handbrake_tpu_torch.codecs.h264.encoder, on
the CPU) held against the JAX package's H264Encoder(backend="device",
cabac=True, deblock=True, transform8x8=True): the annex-B bytes must be
identical, frame by frame.

Cases: dispatch_batch 1 and 8, an IDR in mid-clip, a qp change per
batch, begin/finish pipelining across scene cuts (the intra-fallback
redo path), and a stream begun by the JAX encoder and continued by the
port (from_reference_state)."""
import functools

import jax
import numpy as np
import pytest

from handbrake_tpu.codecs.h264 import encoder as jenc
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu_torch.codecs.h264 import encoder as tenc

W, H = 96, 64


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """Every reference encoder of one shape shares one jitted analyzer
    (the build functions are pure), so each compiles once per module."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        yield


def _cut_clip():
    """test_h264_codec.test_device_deblock_conformance's clip: smooth
    motion with scene cuts at frames 3 and 6 (intra fallbacks)."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(8):
        if t in (3, 6):
            y = np.clip(rng.normal(128, 60, (H, W)), 0, 255).astype(np.uint8)
        else:
            y = (96 + 70 * np.sin((xx + 2 * t) / 9.0)
                 * np.cos((yy + t) / 7.0)).clip(0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 11.0 + t), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 13.0 + t), 0,
                    255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _pipe_clip():
    """test_h264_codec.test_device_deblock_pipelined_scene_cut's clip."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(7):
        if t == 3:
            y = np.clip(rng.normal(120, 55, (H, W)), 0, 255).astype(np.uint8)
        else:
            y = (90 + 70 * np.sin((xx + 3 * t) / 8.0)
                 * np.cos((yy + 2 * t) / 6.0)).clip(0, 255).astype(np.uint8)
        frames.append((y, np.full((H // 2, W // 2), 105, np.uint8),
                       np.full((H // 2, W // 2), 150, np.uint8)))
    return frames


def _pan_clip():
    """test_h264_codec.test_device_transform8x8's clip: smooth ramps
    where the 8x8 transform wins."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H + 64, 0:W + 64]
    base = np.clip(96 + 90 * np.sin(xx / 40.0) * np.cos(yy / 35.0)
                   + rng.normal(0, 2, (H + 64, W + 64)), 0,
                   255).astype(np.uint8)
    return [(np.ascontiguousarray(base[4 + t:4 + t + H,
                                       4 + 3 * t:4 + 3 * t + W]),
             np.full((H // 2, W // 2), 110, np.uint8),
             np.full((H // 2, W // 2), 140, np.uint8)) for t in range(6)]


CLIPS = {"cut": _cut_clip, "pipe": _pipe_clip, "pan": _pan_clip}


def _cfg(mod, qp, gop, batch, **tools):
    kw = dict(width=W, height=H, qp=qp, gop=gop, deblock=True, cabac=True,
              transform8x8=True, dispatch_batch=batch)
    kw.update(tools)
    if mod is jenc:
        kw["backend"] = "device"
    return mod.EncoderConfig(**kw)


def _run(enc, frames, depth, qps=None):
    """Per-frame bytes, with up to `depth` begun frames in flight."""
    out, pend = [], []
    for i, f in enumerate(frames):
        pend.append(enc.begin_frame(*f, qp=None if qps is None else qps[i]))
        if len(pend) > depth:
            out.append(enc.finish_frame(pend.pop(0)))
    while pend:
        out.append(enc.finish_frame(pend.pop(0)))
    return out


# (clip, qp, gop, dispatch_batch, frames in flight, per-frame qps[,
#  toolset changes from the High-profile default])
CASES = {
    "batch1-idr-midclip": ("cut", 30, 5, 1, 0, None),
    "batch8-idr-midclip-pipelined": ("cut", 30, 5, 8, 9, None),
    "batch8-qp-per-batch": ("cut", 30, 8, 8, 2,
                            [30, 27, 33, 36, 24, 29, 31, 26]),
    "batch1-qp-per-frame-pipelined": ("cut", 30, 8, 1, 1,
                                      [30, 27, 33, 36, 24, 29, 31, 26]),
    "pipelined-scene-cut": ("pipe", 31, 7, 1, 2, None),
    "batch8-pipelined-scene-cut": ("pipe", 31, 7, 8, 3, None),
    "transform8x8-pan": ("pan", 30, 6, 1, 0, None),
    "cavlc": ("cut", 30, 5, 8, 3, None, dict(cabac=False)),
    "deblock-off": ("pan", 30, 6, 1, 1, None, dict(deblock=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stream_matches_jax(case):
    clip, qp, gop, batch, depth, qps, *tools = CASES[case]
    tools = tools[0] if tools else {}
    frames = CLIPS[clip]()
    jax_enc = jenc.H264Encoder(_cfg(jenc, qp, gop, batch, **tools))
    want = _run(jax_enc, frames, depth, qps)
    enc = tenc.H264Encoder(_cfg(tenc, qp, gop, batch, **tools),
                           device="cpu")
    got = _run(enc, frames, depth, qps)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (case, i, len(g), len(w))
    if clip == "pipe" and depth:
        # the scene cut's intra fallback re-ran the in-flight analysis
        assert enc.n_redo > 0
    # the reference chain ends on the same (deblocked) picture
    for a, b in ((enc.recon_y, jax_enc.recon_y),
                 (enc.recon_u, jax_enc.recon_u),
                 (enc.recon_v, jax_enc.recon_v)):
        assert np.array_equal(a.numpy(), np.asarray(jax.device_get(b)))


def test_from_reference_state_continues_jax_stream():
    """A stream begun by the JAX encoder and continued by the port is the
    JAX encoder's stream, byte for byte (the state crosses as numpy)."""
    frames = _cut_clip()
    k = 4                                 # continue after the cut at 3
    jax_enc = jenc.H264Encoder(_cfg(jenc, 30, 8, 1))
    want = [jax_enc.encode_frame(*f) for f in frames[:k]]
    state = {"recon_y": np.asarray(jax.device_get(jax_enc.recon_y)),
             "recon_u": np.asarray(jax.device_get(jax_enc.recon_u)),
             "recon_v": np.asarray(jax.device_get(jax_enc.recon_v)),
             "frame_num": jax_enc.frame_num,
             "frame_idx": jax_enc.frame_idx,
             "idr_pic_id": jax_enc.idr_pic_id}
    want += [jax_enc.encode_frame(*f) for f in frames[k:]]
    enc = tenc.H264Encoder.from_reference_state(_cfg(tenc, 30, 8, 1), state,
                                                device="cpu")
    got = [enc.encode_frame(*f) for f in frames[k:]]
    assert got == want[k:]


def test_headers_match_jax():
    for batch in (1, 8):
        a = jenc.H264Encoder(_cfg(jenc, 26, 60, batch)).headers()
        b = tenc.H264Encoder(_cfg(tenc, 26, 60, batch),
                             device="cpu").headers()
        assert a == b


def test_unported_paths_raise():
    """The host walker (backend="host", intra4x4, analysis=) is ported
    and codes CAVLC only: under this CABAC config each raises instead of
    the reference's silent switch to the device path or to CAVLC, and
    the device path takes no hints.  The GOP-parallel entry is ported
    (tests/test_torch_parallel_gop.py holds it)."""
    frames = _cut_clip()
    cfg = _cfg(tenc, 30, 8, 1)
    cfg.intra4x4 = True
    with pytest.raises(ValueError, match="CAVLC"):
        tenc.H264Encoder(cfg, device="cpu")
    cfg = _cfg(tenc, 30, 8, 1)
    cfg.backend = "host"
    with pytest.raises(ValueError, match="CAVLC"):
        tenc.H264Encoder(cfg, device="cpu")
    enc = tenc.H264Encoder(_cfg(tenc, 30, 8, 1), device="cpu")
    with pytest.raises(ValueError, match="host"):
        enc.begin_frame(*frames[0], analysis={})
    assert callable(enc.encode_p_from_analysis)


def test_finish_order_is_fifo():
    frames = _cut_clip()
    enc = tenc.H264Encoder(_cfg(tenc, 30, 8, 1), device="cpu")
    p0 = enc.begin_frame(*frames[0])
    p1 = enc.begin_frame(*frames[1])
    with pytest.raises(RuntimeError):
        enc.finish_frame(p1)
    assert enc.finish_frame(p0).startswith(b"\x00\x00\x00\x01")
