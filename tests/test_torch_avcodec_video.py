"""The libavcodec catalog's video on the port's job path (``work.do_job`` on
the CPU), held byte for byte against the JAX package's output file on the
same source: the MPEG-4, Theora and FFV1 encoders and VP9 at a bit rate
(mkv); VP9, MPEG-4 (no B-frames), Theora and FFV1 sources and a libx265
stream (beyond the native HEVC subset, through the switch) decoded to
H.264; and the scan of each source.  96x64, 8 frames, from a seeded
clip.  The reference's jobs and scans run in a child process
(``torch_catalog.reference``)."""
import os
import sys

import numpy as np
import pytest

import torch_catalog_ref as ref_side
from handbrake_tpu_torch import work
from handbrake_tpu_torch.codecs import registry
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.scan import scan_title
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from torch_catalog import H, N, W, file_bytes, lavc_video, mkv_source, \
    needs_libavcodec, reference

pytestmark = needs_libavcodec


@pytest.fixture(scope="module")
def h264_src(tmp_path_factory):
    return mkv_source(str(tmp_path_factory.mktemp("h264") / "src.mkv"))


def _both(reference, src, tmp_path, mux, vcodec, quality=None,
          vbitrate=None):
    """The job through both packages: (port bytes, reference bytes)."""
    fields = dict(path=src, mux=mux, vcodec=vcodec, quality=quality,
                  vbitrate=vbitrate)
    out = str(tmp_path / f"port.{mux}")
    j = S.Job(file=out, **fields)
    j.audio = []
    assert work.do_job(j, device="cpu")["frames_out"] == N
    stats, want = reference(ref_side.job, dict(
        fields, file=str(tmp_path / f"ref.{mux}")))
    assert stats["frames_out"] == N
    return file_bytes(out), want


@pytest.mark.parametrize("vcodec,vbitrate", [
    ("mpeg4", 1200), ("theora", 1200), ("ffv1", 1200), ("vp9", 400)])
def test_encoder_job_equals_reference(reference, h264_src, tmp_path, vcodec,
                                     vbitrate):
    got, want = _both(reference, h264_src, tmp_path, "mkv", vcodec,
                      vbitrate=vbitrate)
    assert got == want
    d = MKVDemuxer(str(tmp_path / "port.mkv"))
    try:
        assert [t.codec for t in d.tracks] == [vcodec]
    finally:
        d.close()


def _x265(path):
    """A libx265 stream (CU quadtrees, SAO), as tests/test_avcodec.py's
    test_universal_hevc_input makes it."""
    sys.path.insert(0, os.path.dirname(__file__))
    import ffvideo
    rng = np.random.default_rng(4)
    base = rng.integers(0, 255, (H + 32, W + 32), np.uint8)
    clip = [(np.ascontiguousarray(base[t:t + H, 2 * t:2 * t + W]),
             np.full((H // 2, W // 2), 110, np.uint8),
             np.full((H // 2, W // 2), 60, np.uint8)) for t in range(N)]
    enc = ffvideo.FFVideoEncoder(
        "libx265", W, H, 30, bit_rate=500000,
        opts={"x265-params": "bframes=0:keyint=4:pools=none:"
                             "frame-threads=1:log-level=error"})
    return mkv_source(path, vpackets=enc.encode(clip), vcodec="hevc")


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("lavcv")
    out = {}
    for codec in ("vp9", "mpeg4", "theora", "ffv1"):
        opts = {"lag-in-frames": 0, "cpu-used": 4} if codec == "vp9" else {}
        pkts, xd = lavc_video(codec, opts=opts)
        ext = "webm" if codec == "vp9" else "mkv"
        out[codec] = mkv_source(str(d / f"{codec}.{ext}"), vpackets=pkts,
                                vcodec=codec, vpriv=xd)
    out["x265"] = _x265(str(d / "x265.mkv"))
    return out


@pytest.mark.parametrize("codec", ["vp9", "mpeg4", "theora", "ffv1", "x265"])
def test_source_to_h264_equals_reference(reference, sources, tmp_path,
                                         codec):
    got, want = _both(reference, sources[codec], tmp_path, "mp4", "h264",
                      quality=28.0)
    assert got == want


def test_x265_source_switches_before_its_first_frame(sources):
    """The native decoder states the stream is beyond its subset on the
    first packet; the switch replays it, and every frame comes out with
    its packet's pts."""
    from handbrake_tpu_torch.sources.probe import open_source
    src = open_source(sources["x265"])
    try:
        ti = src.tracks[0]
        dec = registry.create_video_decoder("hevc", ti.extradata)
        pts, got = [], []
        for _t, b in src.packets():
            pts.append(b.pts)
            got += dec.feed(b)
        got += dec.flush()
    finally:
        src.close()
    assert isinstance(dec.inner, registry.AVFallbackVideoDecoder)
    assert [f.pts for f in got] == pts and len(got) == N


@pytest.mark.parametrize("codec", ["vp9", "mpeg4", "theora", "ffv1", "x265"])
def test_scan_of_source_equals_reference(reference, sources, codec):
    t = scan_title(sources[codec], preview_count=3, keep_previews=True)
    j = reference(ref_side.scan, sources[codec], preview_count=3,
                  keep_previews=True)
    assert (t.width, t.height, t.crop, t.interlaced, t.video_codec,
            t.vrate_num, t.vrate_den, t.nframes, t.duration) == \
        (j.width, j.height, j.crop, j.interlaced, j.video_codec,
         j.vrate_num, j.vrate_den, j.nframes, j.duration)
    got = t.metadata["__previews__"]
    want = j.metadata["__previews__"]
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(g, w))
