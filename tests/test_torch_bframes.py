"""The port's B-frame walker (``codecs/h264/encoder_b.py``) and its motion
compensation (``codecs/h264/predict.py``) on the CPU, held against the
JAX package:

- IB..BP streams of ``utils/synth.make_clip`` frames (96x64, 13 frames,
  gop 8: a mid-stream IDR and a flush tail) equal the reference's byte
  for byte, and the port's decoder gives back the walker's
  reconstructions exactly;
- the reference's MC slices its padded reference without bounds, so a
  spatial-direct MV that points far outside the picture (uncorrelated
  content) raises ``ValueError`` there; the port reads the samples at
  coordinates clamped to the picture (spec 8.4.2.2.1), as the decoder
  does, and encodes the same frames;
- ``mc_luma_block``/``mc_chroma_block`` equal the reference's on every
  in-range MV phase, and a clamped-coordinate oracle on MVs out to
  +-(PAD + 24) pixels;
- a job's adapter drops each reconstruction once its access unit is out.
"""
import numpy as np
import pytest

from handbrake_tpu.codecs.h264 import predict as jP
from handbrake_tpu.codecs.h264.encoder import EncoderConfig as JConfig
from handbrake_tpu.codecs.h264.encoder_b import H264BEncoder as JBEncoder
from handbrake_tpu_torch.codecs.h264 import predict as P
from handbrake_tpu_torch.codecs.h264.encoder import PAD, EncoderConfig
from handbrake_tpu_torch.codecs.h264.encoder_b import H264BEncoder
from handbrake_tpu_torch.codecs.h264.native_decoder import NativeH264Decoder
from handbrake_tpu_torch.utils.synth import make_clip
from handbrake_tpu_torch.work import _BFrameEncoderAdapter

W, H = 96, 64


def _encode(B, C, frames, w, h, bframes, refs=2, gop=60):
    enc = B(C(width=w, height=h, gop=gop), bframes=bframes, refs=refs)
    aus = []
    for f in frames:
        aus += enc.push_frame(*f)
    return enc, aus + enc.flush()


def _assert_decodes_to_recons(enc, aus):
    """The stream decodes, in display order, to the walker's recons."""
    got = NativeH264Decoder().decode(b"".join(au for _d, au in aus))
    disp = sorted(d for d, _au in aus)
    assert len(got) == len(disp)
    for d, planes in zip(disp, got):
        for g, want in zip(planes, enc.recons[d]):
            assert np.array_equal(g, want[:g.shape[0], :g.shape[1]]), d


@pytest.mark.parametrize("bframes,refs", [(2, 2), (3, 3)])
def test_b_stream_equals_reference(bframes, refs):
    frames = make_clip(W, H, 13, seed=3)
    _jenc, want = _encode(JBEncoder, JConfig, frames, W, H, bframes,
                          refs, gop=8)
    enc, got = _encode(H264BEncoder, EncoderConfig, frames, W, H, bframes,
                       refs, gop=8)
    assert got == want
    order = [d for d, _au in got]
    assert order != sorted(order) and sorted(order) == list(range(13))
    _assert_decodes_to_recons(enc, got)


def _noise(w, h, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


# (width, height, seed): five noise frames with bframes 3 on which the
# reference's MC raises
NOISE = [(64, 48, 0), (96, 64, 0), (128, 96, 0), (160, 96, 2), (320, 192, 0)]


@pytest.mark.parametrize("w,h,seed", NOISE)
def test_noise_crashes_reference_and_port_encodes(w, h, seed):
    frames = _noise(w, h, 5, seed)
    with pytest.raises(ValueError, match="broadcast"):
        _encode(JBEncoder, JConfig, frames, w, h, 3)
    enc, aus = _encode(H264BEncoder, EncoderConfig, frames, w, h, 3)
    assert sorted(d for d, _au in aus) == list(range(5))
    _assert_decodes_to_recons(enc, aus)


def _planes(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    luma = rng.integers(0, 256, (h, w), dtype=np.uint8)
    chroma = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    return luma, chroma


@pytest.mark.parametrize("seed", [0, 1])
def test_mc_equals_reference_in_range(seed):
    """Every quarter-pel luma phase and eighth-pel chroma phase, at
    seeded positions whose windows lie inside the padded plane."""
    luma, chroma = _planes(seed)
    lp, cp = P.pad_plane(luma, PAD), P.pad_plane(chroma, PAD)
    rng = np.random.default_rng(100 + seed)
    for fy in range(4):
        for fx in range(4):
            for _ in range(3):
                x0, y0 = (int(v) for v in rng.integers(0, 3, 2) * 16)
                dx, dy = (int(v) for v in rng.integers(-PAD + 3, PAD - 19,
                                                       2))
                mvx, mvy = 4 * dx + fx, 4 * dy + fy
                want = jP.mc_luma_block(lp, PAD, x0, y0, 16, 16, mvx, mvy)
                got = P.mc_luma_block(lp, PAD, x0, y0, 16, 16, mvx, mvy)
                assert np.array_equal(got, want), (x0, y0, mvx, mvy)
    for fy in range(8):
        for fx in range(8):
            x0, y0 = (int(v) for v in rng.integers(0, 3, 2) * 8)
            dx, dy = (int(v) for v in rng.integers(-PAD + 1, PAD - 9, 2))
            mvx, mvy = 8 * dx + fx, 8 * dy + fy
            want = jP.mc_chroma_block(cp, PAD, x0, y0, 8, 8, mvx, mvy)
            got = P.mc_chroma_block(cp, PAD, x0, y0, 8, 8, mvx, mvy)
            assert np.array_equal(got, want), (x0, y0, mvx, mvy)


@pytest.mark.parametrize("seed", [0, 1])
def test_mc_equals_clamped_oracle(seed):
    """MVs out to +-(PAD + 24) pixels past the picture.  The oracle is the
    reference's arithmetic on a plane padded so far that no window
    leaves it: an edge-padded plane read in range is the picture read at
    clamped coordinates."""
    luma, chroma = _planes(seed)
    far = 200
    lp, cp = P.pad_plane(luma, PAD), P.pad_plane(chroma, PAD)
    lf, cf = np.pad(luma, far, mode="edge"), np.pad(chroma, far, mode="edge")
    rng = np.random.default_rng(200 + seed)
    reach = PAD + 24
    n_out = 0
    for _ in range(120):
        x0, y0 = (int(v) for v in rng.integers(0, 3, 2) * 16)
        # the block lands up to `reach` pixels past each edge
        tx = int(rng.integers(-reach - 16, 64 + reach + 1))
        ty = int(rng.integers(-reach - 16, 48 + reach + 1))
        mvx = 4 * (tx - x0) + int(rng.integers(0, 4))
        mvy = 4 * (ty - y0) + int(rng.integers(0, 4))
        want = jP.mc_luma_block(lf, far, x0, y0, 16, 16, mvx, mvy)
        got = P.mc_luma_block(lp, PAD, x0, y0, 16, 16, mvx, mvy)
        assert np.array_equal(got, want), (x0, y0, mvx, mvy)
        cx, cy = x0 // 2, y0 // 2
        want = jP.mc_chroma_block(cf, far, cx, cy, 8, 8, mvx, mvy)
        got = P.mc_chroma_block(cp, PAD, cx, cy, 8, 8, mvx, mvy)
        assert np.array_equal(got, want), (cx, cy, mvx, mvy)
        n_out += not (-PAD + 2 <= tx and tx + 19 <= 64 + PAD
                      and -PAD + 2 <= ty and ty + 19 <= 48 + PAD)
    assert n_out > 30       # many windows leave the padded plane


class _Counted(dict):
    """A recons dict that records the most entries it ever held."""
    most = 0

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self.most = max(self.most, len(self))


def test_job_adapter_holds_no_more_than_a_group():
    bframes = 3
    enc = H264BEncoder(EncoderConfig(width=48, height=32, gop=12,
                                     backend="host"), bframes=bframes,
                       refs=bframes)
    enc.recons = _Counted()
    ad = _BFrameEncoderAdapter(enc)
    out = []
    for f in make_clip(48, 32, 40, seed=5):
        out += ad.push_display_frame(*f)
        assert len(enc.recons) == 0
    out += ad.flush()
    assert sorted(d for d, _au in out) == list(range(40))
    assert 0 < enc.recons.most <= bframes + 1
    assert len(enc.recons) == 0 and len(enc.dpb) <= bframes + 1
