"""The port's MPEG-2 decoder (``codecs/mpeg2.py``, host numpy) and MJPEG
decoder (the native ``hbdecmjpeg.cpp``) held against the JAX package's:
planes, pts and durations equal on the committed progressive streams
(``tests/data/torch_sources``), and the MJPEG planes equal for the
committed AVI and for 4:2:2 and 4:4:4 JPEGs.  Two repairs, each beside
the reference's behaviour:

- field DCT (``dct_type`` 1 in frame pictures of an interlaced sequence,
  as interlaced DVDs code them): the port places the luma blocks on
  alternate lines, and decodes libavcodec's ``+ildct`` streams as
  libavcodec does (the stored decode beside each stream), where the
  reference ignores ``dct_type`` and decodes 176x160 wrongly and raises
  at 176x144 (it also counts an interlaced sequence's macroblock rows as
  a progressive one's);
- an MJPEG frame that does not decode raises, where the reference drops
  it without a word."""
import os

import numpy as np
import pytest

from handbrake_tpu.codecs.mpeg2 import Mpeg2Decoder as JMpeg2Decoder
from handbrake_tpu.codecs.registry import create_video_decoder as jcreate
from handbrake_tpu.sources.avi import AVIDemuxer as JAVIDemuxer
from handbrake_tpu_torch.codecs.mpeg2 import Mpeg2Decoder
from handbrake_tpu_torch.codecs.registry import (MJPEGVideoDecoder,
                                                 Mpeg2VideoDecoder,
                                                 create_video_decoder)
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.sources.avi import AVIDemuxer
from handbrake_tpu_torch.sources.ps import PSDemuxer
from handbrake_tpu_torch.tools import source_builders as B

FRAME = 3003


def equal_frames(a, b):
    return len(a) == len(b) and all(
        all(np.array_equal(p, q) for p, q in zip(x, y)) for x, y in zip(a, b))


@pytest.mark.parametrize("name,pictures", [("mpeg2_176x144.m2v", None),
                                           ("mpeg2_720x480.m2v", 8)])
def test_mpeg2_planes_equal_reference(name, pictures):
    """The whole 176x144 stream (IBBP), and the 720x480 one's first 8
    pictures (I P B B P B B P: the host decoder takes ~0.5 s a picture
    at this size on a CPU core)."""
    es = B.fixture(name)
    if pictures:
        es = b"".join(B.split_pictures(es)[:pictures])
    got = Mpeg2Decoder().decode(es)
    assert equal_frames(got, JMpeg2Decoder().decode(es))
    assert len(got) == (pictures or 12)
    h, w = (144, 176) if pictures is None else (480, 720)
    assert got[0][0].shape == (h, w) and got[0][1].shape == (h // 2, w // 2)


def _ps_packets(tmp_path):
    path = str(tmp_path / "a.vob")
    with open(path, "wb") as f:
        f.write(B.build_ps(B.video_units(B.fixture("mpeg2_176x144.m2v"),
                                         4 * FRAME, FRAME)))
    d = PSDemuxer(path)
    pkts = [b for _, b in d.packets()]
    d.close()
    return pkts


def _run(dec, pkts):
    out = []
    for b in pkts:
        out += dec.feed(b)
    out += dec.flush()
    return [(f.pts, f.duration, f.stop, [np.asarray(p) for p in f.planes])
            for f in out], dec.info()


def test_mpeg2_video_decoder_equals_reference(tmp_path):
    """Fed the PS packets in decode order: each picture keeps its own
    packet's pts, durations come from the sequence header's rate."""
    pkts = _ps_packets(tmp_path)
    got, info = _run(create_video_decoder("mpeg2"), pkts)
    want, jinfo = _run(jcreate("mpeg2"), pkts)
    assert info == jinfo
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert all(all(np.array_equal(p, q) for p, q in zip(g[3], w[3]))
               for g, w in zip(got, want))
    assert [g[0] for g in got] == [(4 + i) * FRAME for i in range(12)]
    assert {g[1] for g in got} == {FRAME}
    assert isinstance(create_video_decoder("mpeg2video"), Mpeg2VideoDecoder)


def _max_err(frames, ref):
    return [max(int(np.abs(f[k].astype(int) - ref["yuv"[k]][i]).max())
                for k in range(3)) for i, f in enumerate(frames)]


def test_field_dct_decodes_as_libavcodec_where_the_reference_fails():
    """176x160, 6 frames (I + 5 P), field DCT: the port within 2 of
    libavcodec's decode on frames 0-4 and 3 on frame 5.  The 3 is not the
    field DCT: the same frames coded with frame DCT decode with the same
    per-frame differences [1, 2, 2, 1, 2, 3] (``make_source_fixtures
    --check``; on frame DCT the port's decoder is the reference's), a
    float IDCT drifting from libavcodec's integer one over P frames.  The
    reference misreads every frame by 200 or more."""
    es = B.fixture("mpeg2_ildct_176x160.m2v")
    ref = np.load(os.path.join(B.FIXTURES, "mpeg2_ildct_176x160.npz"))
    got = Mpeg2Decoder().decode(es)
    assert len(got) == 6 == ref["y"].shape[0]
    errs = _max_err(got, ref)
    assert max(errs[:5]) <= 2 and errs[5] <= 3, errs
    assert all(float(np.abs(f[0].astype(int) - ref["y"][i]).mean()) < 0.05
               for i, f in enumerate(got))
    jerrs = _max_err(JMpeg2Decoder().decode(es), ref)
    assert min(jerrs) >= 200, jerrs


def test_field_dct_interlaced_rows_where_the_reference_crashes():
    """176x144 interlaced: 10 macroblock rows are coded (2 * ceil(144 /
    32)), the port decodes the 144 it shows; the reference allocates 9
    rows and raises."""
    es = B.fixture("mpeg2_ildct_176x144.m2v")
    ref = np.load(os.path.join(B.FIXTURES, "mpeg2_ildct_176x144.npz"))
    got = Mpeg2Decoder().decode(es)
    assert got[0][0].shape == (144, 176)
    assert max(_max_err(got, ref)) <= 2
    with pytest.raises(ValueError, match="could not broadcast"):
        JMpeg2Decoder().decode(es)


# ---------------------------------------------------------------------------
# MJPEG
# ---------------------------------------------------------------------------
AVI = os.path.join(B.FIXTURES, "mjpeg_640x480.avi")


def _decode_all(make, pkts):
    dec = make("mjpeg")
    out = []
    for b in pkts:
        out += dec.feed(b)
    return [[np.asarray(p) for p in f.planes] for f in out], dec.info()


def test_mjpeg_avi_planes_equal_reference():
    d, jd = AVIDemuxer(AVI), JAVIDemuxer(AVI)
    pkts = [b for _, b in d.packets()]
    assert [bytes(b.data) for b in pkts] == \
        [bytes(b.data) for _, b in jd.packets()]
    got, info = _decode_all(create_video_decoder, pkts)
    want, jinfo = _decode_all(jcreate, pkts)
    assert info == jinfo == {"width": 640, "height": 480,
                             "pix_fmt": "yuv420p"}
    assert len(got) == 6 and equal_frames(got, want)
    assert got[0][1].shape == (240, 320)


@pytest.mark.parametrize("sampling,label", [(0x111111, "4:4:4"),
                                            (0x211111, "4:2:2"),
                                            (0x221111, "4:2:0")])
def test_mjpeg_subsamplings_equal_reference(sampling, label):
    """cv2-made JPEGs of each chroma sampling, brought to 4:2:0 by the
    same averaging in both packages."""
    got, want = _decode_all(create_video_decoder, _jpegs(sampling)), \
        _decode_all(jcreate, _jpegs(sampling))
    assert got[1] == want[1]
    assert len(got[0]) == 2 and equal_frames(got[0], want[0])
    assert got[0][0][1].shape == (48, 64)


def _jpegs(sampling):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    bgr = cv2.GaussianBlur(rng.integers(0, 255, (96, 128, 3), np.uint8),
                           (0, 0), 2)
    out = []
    for k in range(2):
        ok, jpg = cv2.imencode(".jpg", np.roll(bgr, 3 * k, 1), [
            cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
        assert ok
        out.append(Buffer(data=jpg.tobytes(), pts=k * 3600))
    return out


def _bad_frames():
    """The three frames the reference drops: headers cut short, an
    entropy-coded scan of random bytes (a code no table holds)."""
    d = AVIDemuxer(AVI)
    pkt = bytes(next(b for _, b in d.packets()).data)
    d.close()
    sos = pkt.find(b"\xff\xda")
    start = sos + 2 + int.from_bytes(pkt[sos + 2:sos + 4], "big")
    junk = np.random.default_rng(0).integers(
        0, 255, len(pkt) - start - 2, dtype=np.uint8).tobytes()
    return {"headers cut short": pkt[:sos // 2],
            "undecodable scan": pkt[:start] + junk.replace(b"\xff", b"\xfe")
            + b"\xff\xd9"}


@pytest.mark.parametrize("case", ["headers cut short", "undecodable scan",
                                  "4:1:1"])
def test_bad_mjpeg_frame_raises_where_the_reference_drops_it(case):
    if case == "4:1:1":
        buf = _jpegs(0x411111)[1]
        buf.pts = 7200
    else:
        buf = Buffer(data=_bad_frames()[case], pts=7200)
    assert jcreate("mjpeg").feed(buf) == []
    with pytest.raises(ValueError, match="pts 7200"):
        MJPEGVideoDecoder().feed(buf)
