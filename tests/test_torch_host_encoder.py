"""The port's host H.264 engine on the CPU, held against the JAX package:
``H264Encoder(backend="host")`` (the CAVLC MB walker: I16 and Intra4x4,
P_L0_16x16/P_Skip from the host motion search, the 8x8 inter transform,
the native in-loop deblock, ``analysis=`` hints) gives the reference's
streams byte for byte, and the port's decoder gives back its recon frame
for frame; ``intra4x4`` sends the device backend's I slices through the
walker, as in the reference.  The walker and the module-level engine
that ``encoder_b.py`` imports are copies, held to their originals'
source text.
"""
import functools
import inspect

import numpy as np
import pytest

from handbrake_tpu.codecs.h264 import encoder as jenc_mod
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu_torch.codecs.h264 import encoder as enc_mod
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.codecs.h264.native_decoder import NativeH264Decoder
from handbrake_tpu_torch.utils.synth import make_clip

W, H, N = 96, 64, 6


def _run(enc, frames, analysis=None):
    """(access units, the recon after each frame on the host)."""
    aus, recons = [], []
    for f in frames:
        aus.append(enc.encode_frame(*f, analysis=analysis))
        recons.append(tuple(np.asarray(p.cpu() if hasattr(p, "cpu") else p)
                            for p in (enc.recon_y, enc.recon_u,
                                      enc.recon_v)))
    return aus, recons


def _assert_decodes_to(aus, recons):
    got = NativeH264Decoder().decode(b"".join(aus))
    assert len(got) == len(recons)
    for planes, want in zip(got, recons):
        for g, w in zip(planes, want):
            assert np.array_equal(g, w[:g.shape[0], :g.shape[1]])


CASES = {
    "cavlc-p": dict(),
    "deblock": dict(deblock=True),
    "qp14": dict(qp=14),
    "qp40": dict(qp=40, deblock=True),
    "intra4x4": dict(intra4x4=True),
    "transform8x8": dict(transform8x8=True, deblock=True),
    "intra4x4-8x8": dict(intra4x4=True, transform8x8=True, qp=20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_stream_equals_reference(case):
    kw = CASES[case]
    frames = make_clip(W, H, N, seed=3)
    want, _ = _run(jenc_mod.H264Encoder(jenc_mod.EncoderConfig(
        width=W, height=H, gop=4, backend="host", **kw)), frames)
    got, recons = _run(H264Encoder(EncoderConfig(
        width=W, height=H, gop=4, backend="host", **kw), device="cpu"),
        frames)
    assert got == want
    _assert_decodes_to(got, recons)


def _hints(seed):
    """Per-MB hints: an I16 mode that is always available (DC) on every
    third MB, small motion vectors elsewhere."""
    rng = np.random.default_rng(seed)
    out = {}
    for mby in range(H // 16):
        for mbx in range(W // 16):
            if (mbx + mby) % 3 == 0:
                out[(mbx, mby)] = {"i16_mode": 2}
            else:
                out[(mbx, mby)] = {"mv": tuple(int(v) for v in
                                               rng.integers(-20, 21, 2))}
    return out


def test_analysis_hints_equal_reference():
    frames = make_clip(W, H, 4, seed=4)
    hints = _hints(0)
    want, _ = _run(jenc_mod.H264Encoder(jenc_mod.EncoderConfig(
        width=W, height=H, backend="host")), frames, hints)
    got, recons = _run(H264Encoder(EncoderConfig(
        width=W, height=H, backend="host"), device="cpu"), frames, hints)
    assert got == want
    plain, _ = _run(H264Encoder(EncoderConfig(
        width=W, height=H, backend="host"), device="cpu"), frames)
    assert got != plain           # the hints steered the walker
    _assert_decodes_to(got, recons)


@pytest.fixture
def _shared_jax_analyzer(monkeypatch):
    monkeypatch.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
    monkeypatch.setattr(encoder_tpu, "build_p_analyzer", functools.lru_cache(
        None)(encoder_tpu.build_p_analyzer))


@pytest.mark.usefixtures("_shared_jax_analyzer")
def test_intra4x4_on_the_device_backend_equals_reference():
    """I slices through the walker, P frames through the analyzer."""
    w, h = 64, 48
    frames = make_clip(w, h, 5, seed=7)
    kw = dict(width=w, height=h, gop=3, intra4x4=True, deblock=True)
    want, _ = _run(jenc_mod.H264Encoder(jenc_mod.EncoderConfig(
        backend="device", **kw)), frames)
    enc = H264Encoder(EncoderConfig(**kw), device="cpu")
    got, recons = _run(enc, frames)
    assert got == want
    _assert_decodes_to(got, recons)
    plain = H264Encoder(EncoderConfig(**dict(kw, intra4x4=False)),
                        device="cpu")
    assert got[0] != plain.encode_frame(*frames[0])


def test_walker_refusals():
    """CABAC under the walker would corrupt the stream, and the device
    analyzer has no use for hints: both raise instead of the reference's
    silent switch and silent drop."""
    for kw in (dict(backend="host", cabac=True), dict(intra4x4=True,
                                                      cabac=True)):
        with pytest.raises(ValueError, match="CAVLC"):
            H264Encoder(EncoderConfig(width=W, height=H, **kw), device="cpu")
    enc = H264Encoder(EncoderConfig(width=W, height=H), device="cpu")
    y, u, v = make_clip(W, H, 1)[0]
    with pytest.raises(ValueError, match="host"):
        enc.encode_frame(y, u, v, analysis=_hints(0))


# the host engine, copied verbatim: encoder_b.py imports the module-level
# names, H264Encoder's walker the methods
ENGINE = ("_ue_len", "_se_len", "_sad", "MBCtx", "zigzag", "_i16_neighbors",
          "i16_candidate_modes", "encode_i16_luma", "encode_chroma",
          "_chroma_neighbors", "chroma_candidate_modes", "motion_search",
          "encode_inter_luma", "encode_inter_luma8")
WALKER = ("_encode_mb", "_i4_mode_at", "_i4_mpm", "_blk_coded_before",
          "_analyze_i4", "_write_intra4_mb", "_write_intra_mb",
          "_write_inter_mb", "_write_luma_residual_i16",
          "_write_luma_residual_inter", "_write_luma_residual_inter8",
          "_write_chroma_residual")


@pytest.mark.parametrize("name", ENGINE + WALKER)
def test_engine_copy_equals_original(name):
    if name in ENGINE:
        got, want = getattr(enc_mod, name), getattr(jenc_mod, name)
    else:
        got = getattr(enc_mod.H264Encoder, name)
        want = getattr(jenc_mod.H264Encoder, name)
    assert inspect.getsource(got) == inspect.getsource(want)


def test_engine_constants_equal_original():
    assert enc_mod.PAD == jenc_mod.PAD
    assert np.array_equal(enc_mod._CODED_ORDER, jenc_mod._CODED_ORDER)
    assert np.array_equal(enc_mod._CODED_ORDER_C, jenc_mod._CODED_ORDER_C)
    j = jenc_mod.EncoderConfig(width=W, height=H)
    t = EncoderConfig(width=W, height=H)
    assert t.search_range == j.search_range
