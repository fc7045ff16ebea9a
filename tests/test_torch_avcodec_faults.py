"""The reference faults on the libavcodec catalog's paths that the port
repairs, each with the reference's behaviour held beside it: MPEG-2's
one-frame encoder delay, VP8's encoder name, ProRes's pixel format, the
fallback decoder's pts behind B-frames (in mkv, and in AVI, which the
reference does not read), and an HEVC stream that leaves the native
subset after its first frames.  (VP9's rate at a quality is held in
``tests/test_torch_avcodec.py``.)  The reference's jobs and decoders run
in a child process (``torch_catalog.reference``)."""
import os

import numpy as np
import pytest

import torch_catalog_ref as ref_side
from handbrake_tpu import work as jwork
from handbrake_tpu_torch import work
from handbrake_tpu_torch.codecs import avcodec as av
from handbrake_tpu_torch.codecs import registry
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.sources.probe import open_source
from handbrake_tpu_torch.tools.source_builders import fixture
from test_torch_avcodec import _bframe_mpeg4
from torch_catalog import FRAME, N, mkv_source, needs_libavcodec, \
    reference

pytestmark = needs_libavcodec


@pytest.fixture(scope="module")
def h264_src(tmp_path_factory):
    return mkv_source(str(tmp_path_factory.mktemp("h264") / "src.mkv"))


def _job(Sm, src, out, vcodec, mux="mkv", **kw):
    j = Sm.Job(path=src, file=out, mux=mux, vcodec=vcodec, **kw)
    j.audio = []
    return j


def _ref_job(reference, src, out, vcodec, mux="mkv", **kw):
    """The reference's do_job of the same job, in the child."""
    return reference(ref_side.job, dict(path=src, file=out, mux=mux,
                                        vcodec=vcodec, **kw))


def _decode_track(path, name):
    d = MKVDemuxer(path)
    try:
        ti = d.tracks[0]
        dec = av.AVVideoDecoder(name, extradata=bytes(ti.extradata or b""))
        got = [f for _t, b in d.packets() for f in dec.decode(b.data, b.pts)]
    finally:
        d.close()
    return ti.codec, got + dec.flush()


def _pts(path):
    d = MKVDemuxer(path)
    try:
        return [b.pts for _t, b in d.packets()]
    finally:
        d.close()


def test_mpeg2_job_writes_every_frame(reference, h264_src, tmp_path):
    """mpeg2video holds the first frame back: the port pairs each packet
    with its frame and drains the encoder at the end; the reference
    fails the job at frame 0."""
    out = str(tmp_path / "port.mkv")
    stats = work.do_job(_job(S, h264_src, out, "mpeg2", vbitrate=1200),
                        device="cpu")
    assert stats["frames_out"] == N
    codec, got = _decode_track(out, "mpeg2video")
    assert codec == "mpeg2" and len(got) == N
    # each packet on its own frame's time, as a codec without delay
    ref = str(tmp_path / "mpeg4.mkv")
    work.do_job(_job(S, h264_src, ref, "mpeg4", vbitrate=1200),
                device="cpu")
    assert _pts(out) == _pts(ref)
    with pytest.raises(jwork.WorkError, match="encoder delayed a frame"):
        _ref_job(reference, h264_src, str(tmp_path / "ref.mkv"), "mpeg2",
                 vbitrate=1200)


def test_vp8_job_writes_a_vp8_track(reference, h264_src, tmp_path):
    out = str(tmp_path / "port.webm")
    stats = work.do_job(_job(S, h264_src, out, "vp8", mux="webm",
                             quality=20.0), device="cpu")
    assert stats["frames_out"] == N
    codec, got = _decode_track(out, "vp8")
    assert codec == "vp8" and len(got) == N
    with pytest.raises(RuntimeError, match="no encoder vp8"):
        _ref_job(reference, h264_src, str(tmp_path / "ref.webm"), "vp8",
                 mux="webm", quality=20.0)


def test_prores_refused_at_job_start(reference, h264_src, tmp_path):
    out = str(tmp_path / "port.mkv")
    with pytest.raises(work.WorkError, match="prores: the catalog feeds "
                       "yuv420p 8-bit; libavcodec's prores takes 4:2:2 "
                       "10-bit"):
        work.do_job(_job(S, h264_src, out, "prores", quality=20.0),
                    device="cpu")
    assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match="open prores failed"):
        _ref_job(reference, h264_src, str(tmp_path / "ref.mkv"), "prores",
                 quality=20.0)


def test_bframe_mpeg4_source_keeps_display_pts(reference, tmp_path):
    """An mkv of an MPEG-4 ASP stream with B-frames, each packet with its
    display pts, to H.264: the port's frames keep their display times
    (no composition offset in the mp4); the reference's come out one
    frame late, each on the next packet's pts, the last on none."""
    pkts, order, xd = _bframe_mpeg4()
    src = mkv_source(str(tmp_path / "bf.mkv"), vpackets=pkts,
                     vcodec="mpeg4", vpriv=xd,
                     pts=[d * FRAME for d in order])
    offsets = {}
    for pkg, run in (("port", lambda out: work.do_job(_job(
            S, src, out, "h264", mux="mp4", quality=28.0), device="cpu")),
                     ("ref", lambda out: _ref_job(
                         reference, src, out, "h264", mux="mp4",
                         quality=28.0)[0])):
        out = str(tmp_path / f"{pkg}.mp4")
        assert run(out)["frames_out"] == N
        d = MP4Demuxer(out)
        offsets[pkg] = list(d._samples[0].cts_offsets)
        d.close()
    assert offsets["port"] == [0] * N
    assert offsets["ref"] == [2970] * N     # one frame, in the mp4's ticks


def test_bframe_avi_fixture_in_display_order():
    """The committed MPEG-4 AVI (B-frames, decode order, one timestamp a
    chunk): the demuxer restamps each VOP with its display time and the
    decoder's frames come out in order, the last one included.  The
    reference reads no MPEG-4 in AVI."""
    path = os.path.join(os.path.dirname(__file__), "data", "torch_sources",
                        "mpeg4_bframes_176x144.avi")
    src = open_source(path)
    try:
        ti = src.tracks[0]
        assert (ti.codec, ti.width, ti.height) == ("mpeg4", 176, 144)
        dec = registry.create_video_decoder("mpeg4", ti.extradata)
        pts, got = [], []
        for _t, b in src.packets():
            pts.append(b.pts)
            got += dec.feed(b)
        got += dec.flush()
    finally:
        src.close()
    assert pts != sorted(pts)
    assert [f.pts for f in got] == sorted(pts) == \
        [i * 3000 for i in range(12)]
    from handbrake_tpu.sources.probe import open_source as j_open_source
    jsrc = j_open_source(path)
    try:
        assert jsrc.tracks[0].codec == "unknown"
    finally:
        jsrc.close()
    assert len(fixture("mpeg4_bframes_176x144.avi")) < 8000


def _midstream():
    """Two frames in the native subset, then a packet whose SPS turns on
    SAO."""
    from handbrake_tpu_torch.codecs.hevc import encoder as tenc
    from handbrake_tpu_torch.utils.synth import make_clip
    from test_torch_hevc import sao_stream
    enc = tenc.HEVCEncoder(tenc.EncoderConfig(width=64, height=64, qp=30),
                           device="cpu")
    return [enc.encode_frame(*f) for f in make_clip(64, 64, 2, seed=5)] \
        + [sao_stream()]


def test_hevc_beyond_subset_after_frames_raises_named(reference):
    """After frames have come out, the port raises, naming the frame; the
    reference switches to libavcodec with an empty buffer and loses the
    rest of the stream without a word."""
    pkts = _midstream()
    dec = registry.create_video_decoder("hevc")
    assert isinstance(dec, registry.ResilientHEVCDecoder)
    got = [len(dec.feed(Buffer(data=p, pts=i * FRAME)))
           for i, p in enumerate(pkts[:2])]
    assert got == [1, 1]
    with pytest.raises(ValueError, match=r"frame 3 \(in the packet at pts "
                       r"6000\).*after 2 frames decoded natively.*SAO "
                       r"unsupported"):
        dec.feed(Buffer(data=pkts[2], pts=2 * FRAME))
    fed, tail, _name, fallback = reference(
        ref_side.decode, "hevc", b"",
        [dict(data=p, pts=i * FRAME) for i, p in enumerate(pkts)])
    jgot = [len(f) for f in fed] + [len(tail)]
    assert jgot == [1, 1, 0, 0] and fallback


def test_hevc_switch_before_first_frame_replays_all(reference):
    """The SAO stream alone: the switch comes before any frame, and the
    packets are replayed from the first, as the reference does."""
    from test_torch_hevc import sao_stream
    data = sao_stream()
    dec = registry.create_video_decoder("hevc")
    got = dec.feed(Buffer(data=data, pts=0)) + dec.flush()
    fed, tail, _name, _fb = reference(ref_side.decode, "hevc", b"",
                                      [dict(data=data, pts=0)])
    want = fed[0] + tail
    assert isinstance(dec.inner, registry.AVFallbackVideoDecoder)
    assert len(got) == len(want)
    for a, (_pts, _dur, _stop, planes) in zip(got, want):
        assert all(np.array_equal(p, q) for p, q in zip(a.planes, planes))
