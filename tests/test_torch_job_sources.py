"""The port's H.264-source and Matroska job paths (``work.do_job``,
``scan.scan_title`` and the CLI, on the CPU) held against the JAX
package's on small files: the port's mkv and webm of a y4m job equal the
JAX package's byte for byte; an H.264 mp4 source and an H.264 mkv source,
each written by the JAX package, transcode to mp4 and mkv files equal to
the JAX package's, and so does an annex-B H.264 stream of the JAX
encoder; a scan of them gives the reference's geometry, crop and preview
planes, and ``Handle.get_preview`` the reference's preview.  The annex-B
stream states 30000/1001 in its VUI: the port reads that rate and the
reference is given it (``torch_rates``), and the reference left alone
still labels the stream 25 fps; a stream that states no rate gives files
equal to the reference's with neither package given a rate."""
import functools
from fractions import Fraction

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.codecs.h264 import encoder as jenc
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.hb import Handle as JHandle
from handbrake_tpu.job import schema as JS
from handbrake_tpu.scan import scan_title as j_scan_title
from handbrake_tpu.sources.raw import AnnexBReader as JAnnexBReader
from handbrake_tpu_torch import work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.hb import Handle
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.scan import scan_title
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.raw import AnnexBReader
from handbrake_tpu_torch.utils.synth import write_y4m
from torch_rates import reference_reads_rate  # noqa: F401  (a fixture)

W, H, N = 64, 48, 10
BAR = 8                 # black rows above and below the picture
FPS = (30000, 1001)


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """Every reference encoder of one shape shares one jitted analyzer
    (the build functions are pure), so each compiles once per module.
    The reference encodes on its device path, as the port does: some of
    the JAX package's tests set HB_TPU_DISABLE_DEVICE=1 for the rest of
    their process, which would switch it to its host path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        yield


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A letterboxed y4m, the JAX package's H.264 mp4 and mkv of it (High
    profile, unscaled, so the bars stay in the picture), and the JAX
    encoder's annex-B stream of the same frames, with the VUI timing
    (30000/1001) it writes and, as "untimed", without."""
    d = tmp_path_factory.mktemp("tsrc")
    base = (np.add.outer(np.arange(H - 2 * BAR), np.arange(W)) * 3
            % 256).astype(np.uint8)
    chroma = (H - 2 * BAR) // 2, W // 2
    frames = [(np.roll(base, 2 * i, axis=1),
               np.full(chroma, 100 + i, np.uint8),
               np.full(chroma, 70, np.uint8)) for i in range(N)]
    y4m = write_y4m(str(d / "in.y4m"), frames, W, H, BAR, FPS)
    out = {"y4m": y4m}
    for mux in ("mp4", "mkv"):
        out[mux] = str(d / f"src.{mux}")
        jwork.do_job(_job(JS, y4m, out[mux], mux, quality=24.0))
    enc = jenc.H264Encoder(jenc.EncoderConfig(
        width=W, height=H, qp=26, gop=4, backend="device", deblock=True,
        cabac=True, transform8x8=True))
    black = [np.full((BAR, W), 16, np.uint8),
             np.full((BAR // 2, W // 2), 128, np.uint8)]
    out["annexb"] = str(d / "src.264")
    with open(out["annexb"], "wb") as f:
        for y, u, v in frames:
            f.write(enc.encode_frame(
                np.concatenate([black[0], y, black[0]]),
                *(np.concatenate([black[1], c, black[1]]) for c in (u, v))))
    enc = jenc.H264Encoder(jenc.EncoderConfig(
        width=W, height=H, qp=26, gop=4, backend="device", deblock=True,
        cabac=True, transform8x8=True))
    enc.sps.vui_timing = ()            # an SPS with no VUI
    out["untimed"] = str(d / "untimed.264")
    with open(out["untimed"], "wb") as f:
        for y, u, v in frames[:4]:
            f.write(enc.encode_frame(
                np.concatenate([black[0], y, black[0]]),
                *(np.concatenate([black[1], c, black[1]]) for c in (u, v))))
    return out


def _job(Sm, path, out, mux, quality=28.0):
    return Sm.Job(path=path, file=out, mux=mux, vcodec="h264",
                  quality=quality, encoder_profile="high")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _mkv_video(path):
    d = MKVDemuxer(path)
    try:
        return ([(t.kind, t.codec, t.width, t.height, t.extradata)
                 for t in d.tracks],
                [(b.pts, int(b.frametype), bytes(b.data))
                 for _, b in d.packets()])
    finally:
        d.close()


@pytest.mark.parametrize("mux", ["mkv", "webm"])
def test_y4m_job_to_matroska_equals_reference(sources, tmp_path, mux):
    jout, tout = str(tmp_path / f"ref.{mux}"), str(tmp_path / f"port.{mux}")
    jstats = jwork.do_job(_job(JS, sources["y4m"], jout, mux))
    tstats = work.do_job(_job(S, sources["y4m"], tout, mux), device="cpu")
    assert tstats == jstats and tstats["frames_out"] == N
    assert _bytes(tout) == _bytes(jout)
    tracks, pkts = _mkv_video(tout)
    assert tracks[0][:4] == ("video", "h264", W, H)
    assert tracks[0][4].startswith(b"\x01") and len(pkts) == N
    assert pkts[0][1] != 0             # the IDR is a keyframe


@pytest.mark.parametrize("out_mux", ["mp4", "mkv"])
@pytest.mark.parametrize("src_mux", ["mp4", "mkv", "annexb"])
def test_h264_source_transcodes_equal_reference(sources, tmp_path, src_mux,
                                                out_mux,
                                                reference_reads_rate):
    src = sources[src_mux]
    jout = str(tmp_path / f"ref.{out_mux}")
    tout = str(tmp_path / f"port.{out_mux}")
    jstats = jwork.do_job(_job(JS, src, jout, out_mux))
    tstats = work.do_job(_job(S, src, tout, out_mux), device="cpu")
    assert tstats == jstats and tstats["frames_out"] == N
    assert _bytes(tout) == _bytes(jout)


def test_cli_mkv_source_to_mkv_equals_reference(sources, tmp_path):
    """The CLI's default preset on the mkv source: the scan decodes the
    previews and autocrops the bars, then the job writes mkv from the
    .mkv extension."""
    argv = ["-i", sources["mkv"], "-e", "h264", "-q", "28",
            "--encoder-profile", "high"]
    jout, tout = str(tmp_path / "ref.mkv"), str(tmp_path / "port.mkv")
    assert jcli(argv + ["-o", jout]) == 0
    assert cli(argv + ["-o", tout, "--device", "cpu"]) == 0
    assert _bytes(tout) == _bytes(jout)
    tracks, pkts = _mkv_video(tout)
    assert tracks[0][2:4] == (W, H - 2 * BAR) and len(pkts) == N


@pytest.mark.parametrize("kind", ["mp4", "mkv", "annexb"])
def test_scan_h264_source_equals_reference(sources, kind,
                                           reference_reads_rate):
    t = scan_title(sources[kind], preview_count=3, keep_previews=True)
    j = j_scan_title(sources[kind], preview_count=3, keep_previews=True)
    assert (t.width, t.height, t.crop, t.interlaced, t.video_codec,
            t.vrate_num, t.vrate_den, t.nframes, t.duration) == \
        (j.width, j.height, j.crop, j.interlaced, j.video_codec,
         j.vrate_num, j.vrate_den, j.nframes, j.duration)
    assert t.crop == (BAR, BAR, 0, 0)
    got = t.metadata["__previews__"]
    want = j.metadata["__previews__"]
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(g, w))


def test_reference_left_alone_labels_annexb_25_fps(sources):
    """Without the rate the test gives it, the reference labels the
    annex-B stream 25 fps, in its reader and its scan; the port labels it
    with the 30000/1001 its VUI states."""
    path = sources["annexb"]
    assert JAnnexBReader(path).fps == Fraction(25, 1)
    assert AnnexBReader(path).fps == Fraction(30000, 1001)
    t = scan_title(path, preview_count=1)
    j = j_scan_title(path, preview_count=1)
    assert (j.vrate_num, j.vrate_den) == (25, 1)
    assert (t.vrate_num, t.vrate_den) == (30000, 1001)
    assert t.nframes == j.nframes == N


@pytest.mark.parametrize("out_mux", ["mp4", "mkv"])
def test_untimed_annexb_keeps_25_fps_equal_reference(sources, tmp_path,
                                                     out_mux):
    """A stream whose SPS has no VUI states no rate: both packages label
    it 25 fps, with no rate given to either, and their files are equal
    byte for byte."""
    src = sources["untimed"]
    assert AnnexBReader(src).fps == JAnnexBReader(src).fps == 25
    jout = str(tmp_path / f"ref.{out_mux}")
    tout = str(tmp_path / f"port.{out_mux}")
    jstats = jwork.do_job(_job(JS, src, jout, out_mux))
    tstats = work.do_job(_job(S, src, tout, out_mux), device="cpu")
    assert tstats == jstats and tstats["frames_out"] == 4
    assert _bytes(tout) == _bytes(jout)


def test_handle_preview_of_h264_source_equals_reference(sources, tmp_path):
    """Handle.scan keeps the mkv source's previews; get_preview runs the
    job's crop/scale on them, as the reference's Handle does."""
    h, jh = Handle(device="cpu"), JHandle()
    try:
        for handle in (h, jh):
            handle.scan(sources["mkv"], preview_count=2, keep_previews=True)
            handle.scan_wait()
        assert h.scan_error is None and len(h.titles) == 1
        crop = {"crop-top": BAR, "crop-bottom": BAR, "width": 32,
                "height": 16}
        out = str(tmp_path / "x.mp4")
        job, jjob = _job(S, sources["mkv"], out, "mp4"), \
            _job(JS, sources["mkv"], out, "mp4")
        job.filters = [S.FilterSpec(S.FILTER_CROP_SCALE, dict(crop))]
        jjob.filters = [JS.FilterSpec(JS.FILTER_CROP_SCALE, dict(crop))]
        for k in range(2):
            got, want = h.get_preview(job, k), jh.get_preview(jjob, k)
            assert [p.shape for p in got] == [(16, 32), (8, 16), (8, 16)]
            assert all(np.array_equal(a, np.asarray(b))
                       for a, b in zip(got, want))
    finally:
        h.close()
        jh.close()
