"""The port's AV1 codec (``handbrake_tpu_torch/codecs/av1``) against the
JAX package's, on the CPU.  Tolerance: none; every comparison is
equality.

- Every copied module equals its original; the encoder differs only in
  the listed replacements (its device search is the port's torch
  search, on the encoder's device, and a failed search raises).
- ``analyzer.motion_search`` equals the reference's ``build_me`` at
  search ranges 8 and 2: shifted noise, stripes whose best shifts tie
  (the first minimum wins) and flat frames.
- ``AV1Encoder(device="cpu")`` streams equal the JAX encoder's
  ``backend="device"`` streams over 6 frames at 96x64 and 88x56 with a
  per-frame qp, and the host search's streams its host search's; each
  stream decodes with the port's decoder (and the registry's, from the
  av1C) to the encoder's reconstructions.
- A device search that fails raises in the port; the reference catches
  the error and codes the frame with its host search, without a word.
"""
import filecmp
import functools
import os

import numpy as np
import pytest
import torch

import handbrake_tpu
import handbrake_tpu_torch
from handbrake_tpu.codecs.av1 import encoder as jenc
from handbrake_tpu.codecs.av1 import encoder_tpu
from handbrake_tpu_torch.codecs import registry
from handbrake_tpu_torch.codecs.av1 import analyzer
from handbrake_tpu_torch.codecs.av1 import encoder as tenc
from handbrake_tpu_torch.codecs.av1.decoder import AV1Decoder
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.utils.synth import make_clip

# the encoder's device search is the port's torch search, on the
# encoder's device; the device backend is the default; a failed search
# raises instead of falling back to the host search
_ENCODER = (
    ("""The batched TPU analysis path lives in encoder_tpu.py; this walker owns
the sequential entropy coding (SURVEY.md §7 "Hard parts #1").
""", """The batched P-frame motion search runs as torch ops on the encoder's
device (analyzer.py); this walker owns the sequential entropy coding
(SURVEY.md §7 "Hard parts #1").  A device search that fails raises: the
frame is not coded with the host search in its place.
"""),
    ("""from .rangecoder import RangeEncoder
""", """from .rangecoder import RangeEncoder
from ...utils.device import resolve_device
"""),
    ("""    backend: str = "host"       # "device" = batched jax analysis (P frames)
""", """    backend: str = "device"     # batched torch search of P frames on the
                                # encoder's device; "host" = _search
"""),
    ('''class AV1Encoder:
    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
''', '''class AV1Encoder:
    """device=None searches P frames on the CUDA card; "cpu" on the
    CPU."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
'''),
    ('''    def _device_analysis(self, ypad):
        """Batched full-pel ME on the accelerator (encoder_tpu.py)."""
        try:
            if self._analyzer is None:
                from .encoder_tpu import build_me
                self._analyzer = build_me(
                    self.h64 // 16, self.w64 // 16, self.cfg.search_range)
            mvx, mvy, sad = self._analyzer(
                ypad.astype(np.uint8),
                self.recon_y)
            return {"mvx": np.asarray(mvx), "mvy": np.asarray(mvy),
                    "sad": np.asarray(sad)}
        except Exception:
            return None
''', '''    def _device_analysis(self, ypad):
        """Batched full-pel ME on the encoder's device (analyzer.py).
        An error propagates (the reference catches every exception and
        codes the frame with the host search)."""
        if self._analyzer is None:
            from .analyzer import build_me
            self._analyzer = build_me(
                self.h64 // 16, self.w64 // 16, self.cfg.search_range,
                device=self.device)
        mvx, mvy, sad = self._analyzer(
            ypad.astype(np.uint8),
            self.recon_y)
        return {"mvx": np.asarray(mvx), "mvy": np.asarray(mvy),
                "sad": np.asarray(sad)}
'''))

COPIES = {f"codecs/av1/{m}.py": () for m in (
    "__init__", "cdfs", "obu", "rangecoder", "transform", "predict",
    "decoder")}
COPIES["codecs/av1/encoder.py"] = _ENCODER


@pytest.mark.parametrize("rel", list(COPIES))
def test_copy_equals_original(rel):
    port = os.path.join(os.path.dirname(handbrake_tpu_torch.__file__), rel)
    ref = os.path.join(os.path.dirname(handbrake_tpu.__file__), rel)
    if not COPIES[rel]:
        assert filecmp.cmp(port, ref, shallow=False)
        return
    with open(port) as f:
        got = f.read()
    with open(ref) as f:
        want = f.read()
    for old, new in COPIES[rel]:
        assert want.count(old) == 1 and got.count(new) == 1
        want = want.replace(old, new)
    assert got == want


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_search():
    """The reference's encoders of one shape share one jitted search."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(encoder_tpu, "build_me",
                   functools.lru_cache(None)(encoder_tpu.build_me))
        yield


ROWS, COLS = 4, 5


def _search_frames(kind, seed):
    rng = np.random.default_rng(seed)
    h, w = ROWS * 16, COLS * 16
    if kind == "noise":
        ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
        return np.roll(ref, (3, -2), (0, 1)), ref
    if kind == "ties":
        # stripes of period 4 both ways: shifts a period apart match
        # alike, with equal penalties, so the first minimum decides
        yy, xx = np.mgrid[0:h, 0:w]
        ref = (40 * (xx % 4) + 30 * (yy % 4)).astype(np.uint8)
        return np.roll(ref, (2, 2), (0, 1)), ref
    ref = np.full((h, w), 77, np.uint8)
    return ref.copy(), ref


@pytest.mark.parametrize("kind", ["noise", "ties", "flat"])
@pytest.mark.parametrize("sr", [8, 2])
def test_search_equals_reference(sr, kind):
    cur, ref = _search_frames(kind, seed=sr)
    want = encoder_tpu.build_me(ROWS, COLS, sr)(cur, ref)
    got = analyzer.motion_search(torch.from_numpy(cur), torch.from_numpy(ref),
                                 sr)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kind == "ties":
        # the picked shift is the first of its tied pair: dy = -2
        assert (got[1].numpy()[1:-1, 1:-1] == -2).all()


def test_search_builder_takes_numpy():
    cur, ref = _search_frames("noise", seed=1)
    got = analyzer.build_me(ROWS, COLS, 8, device="cpu")(cur, ref)
    want = analyzer.motion_search(torch.from_numpy(cur), torch.from_numpy(ref),
                                  8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


QPS = (30, 26, 34, 22, 38, 28)


def _encode(enc, frames):
    aus, recons = [], []
    for f, qp in zip(frames, QPS):
        aus.append(enc.encode_frame(*f, qp=qp))
        recons.append(tuple(np.array(p) for p in (enc.recon_y, enc.recon_u,
                                                  enc.recon_v)))
    return aus, recons


def _check_decode(frames, recons, w, h):
    assert len(frames) == len(recons)
    for f, r in zip(frames, recons):
        for p, q, (ph, pw) in zip(f, r, ((h, w), (h // 2, w // 2),
                                         (h // 2, w // 2))):
            assert p.shape == (ph, pw)
            np.testing.assert_array_equal(p, q[:ph, :pw])


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("w,h", [(96, 64), (88, 56)])
def test_encoder_stream_equals_reference(w, h, backend):
    frames = make_clip(w, h, len(QPS), seed=w)
    kw = dict(width=w, height=h, qp=30, gop=4, backend=backend)
    want, _ = _encode(jenc.AV1Encoder(jenc.EncoderConfig(**kw)), frames)
    port = tenc.AV1Encoder(tenc.EncoderConfig(**kw), device="cpu")
    got, recons = _encode(port, frames)
    assert got == want
    dec = AV1Decoder()
    _check_decode([f for au in got for f in dec.decode(au)], recons, w, h)
    # the registry's decoder, configured from the encoder's av1C
    rdec = registry.create_video_decoder("av1", port.extradata)
    out = [f.planes for i, au in enumerate(got)
           for f in rdec.feed(Buffer(data=au, pts=i))]
    _check_decode(out, recons, w, h)
    assert rdec.info() == {"width": w, "height": h, "pix_fmt": "yuv420p"}


def test_failed_search_raises_where_the_reference_falls_back(monkeypatch):
    """A device search that raises: the port's encoder raises on the
    first P frame; the reference's codes it with the host search and
    writes the host backend's stream."""
    w, h = 96, 64
    frames = make_clip(w, h, 3, seed=4)

    def broken(*a, **k):
        raise RuntimeError("device search failed")
    monkeypatch.setattr(analyzer, "build_me", broken)
    monkeypatch.setattr(encoder_tpu, "build_me", broken)
    kw = dict(width=w, height=h, qp=30, gop=60)
    port = tenc.AV1Encoder(tenc.EncoderConfig(**kw), device="cpu")
    port.encode_frame(*frames[0])              # the key frame searches none
    with pytest.raises(RuntimeError, match="device search failed"):
        port.encode_frame(*frames[1])
    ref = jenc.AV1Encoder(jenc.EncoderConfig(backend="device", **kw))
    host = jenc.AV1Encoder(jenc.EncoderConfig(backend="host", **kw))
    assert [ref.encode_frame(*f) for f in frames] == \
        [host.encode_frame(*f) for f in frames]


def test_encoder_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.AV1Encoder(tenc.EncoderConfig(width=64, height=64))
