"""The port's job path (handbrake_tpu_torch: work.do_job, hb.Handle and
the CLI, on the CPU) held against the JAX package's (device backend, JAX
on the CPU) on a small y4m: the mp4 files must carry the same video
samples, avcC, sample timestamps and track size.  Where a job resamples,
the test first asserts that the port's scaled planes equal the
reference's on every frame of the input, so the equal streams are not
left to luck.  Unported filters, codecs, containers and options raise
NotImplementedError, and nothing falls back to the CPU on its own."""
import os
import time

import numpy as np
import pytest
import torch

from handbrake_tpu import work as jwork
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.core.buffer import YUV420P as J_YUV420P
from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu.core.buffer import Geometry as JGeometry
from handbrake_tpu.filters.base import FilterInit as JFilterInit
from handbrake_tpu.filters.cropscale import CropScaleFilter as JCropScale
from handbrake_tpu.hb import Handle as JHandle
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.core.buffer import YUV420P, Buffer, Geometry
from handbrake_tpu_torch.filters.base import FilterInit
from handbrake_tpu_torch.filters.cropscale import CropScaleFilter
from handbrake_tpu_torch.hb import Handle
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.sources.raw import Y4MReader
from handbrake_tpu_torch.utils.synth import write_y4m


@pytest.fixture(autouse=True)
def _reference_device_path(monkeypatch):
    """The JAX package's jobs run on its device path, as the port's do:
    some of its own tests leave HB_TPU_DISABLE_DEVICE=1 set for the rest
    of their process, which switches it to its host encoder."""
    monkeypatch.delenv("HB_TPU_DISABLE_DEVICE", raising=False)


W, H, N = 64, 48, 12
FPS = (30000, 1001)
BAR = 8                 # black rows above and below in the letterboxed y4m


def _write_y4m(path, bar=0):
    """tests/test_work.py's clip (a diagonal ramp, rolled per frame),
    optionally between `bar` black rows above and below."""
    base = (np.add.outer(np.arange(H - 2 * bar), np.arange(W)) * 3
            % 256).astype(np.uint8)
    chroma = (H - 2 * bar) // 2, W // 2
    frames = [(np.roll(base, i, axis=1), np.full(chroma, 110 + i, np.uint8),
               np.full(chroma, 60, np.uint8)) for i in range(N)]
    return write_y4m(path, frames, W, H, bar, FPS)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    return _write_y4m(str(tmp_path_factory.mktemp("tjob") / "in.y4m"))


@pytest.fixture(scope="module")
def letterbox(tmp_path_factory):
    return _write_y4m(str(tmp_path_factory.mktemp("tjob") / "lb.y4m"), BAR)


def _mp4(path):
    """(video samples, avcC, (pts, dts, duration) per sample, size)."""
    d = MP4Demuxer(path)
    try:
        ti = d.tracks[0]
        bufs = [b for _, b in d.packets()]
        return ([bytes(b.data) for b in bufs], ti.extradata,
                [(b.pts, b.dts, b.duration) for b in bufs],
                (ti.width, ti.height))
    finally:
        d.close()


# the three jobs: crop/scale settings (None: no filter) and anamorphic mode
JOBS = {
    "unscaled": (None, None),
    "crop-only": ({"crop-top": 4, "crop-bottom": 2, "crop-left": 6,
                   "crop-right": 8}, None),
    "crop-scale-anamorphic": ({"crop-top": 2, "crop-bottom": 2,
                               "crop-left": 4, "width": 32,
                               "height": 24}, 2),
}


def _job(Sm, path, out, name):
    st, ana = JOBS[name]
    j = Sm.Job(path=path, file=out, mux="mp4", vcodec="h264", quality=28.0,
               encoder_profile="high")
    if st is not None:
        j.filters = [Sm.FilterSpec(Sm.FILTER_CROP_SCALE, dict(st))]
    j.anamorphic_mode = ana
    return j


def _assert_scaled_planes_equal(path, settings):
    """The port's CropScaleFilter gives the reference's planes on every
    frame of the source (the job's resolved settings)."""
    jf, tf = JCropScale(dict(settings)), CropScaleFilter(dict(settings))
    jf.init(JFilterInit(geometry=JGeometry(W, H)))
    tf.init(FilterInit(geometry=Geometry(W, H), device="cpu"))
    rd = Y4MReader(path)
    try:
        for _, b in rd.packets():
            want = jf.work(JBuffer(planes=list(b.planes), pix_fmt=J_YUV420P,
                                   pts=b.pts))[0].planes
            got = tf.work(Buffer(planes=list(b.planes), pix_fmt=YUV420P,
                                 pts=b.pts))[0].planes
            for g, w in zip(got, want):
                g = work.to_host(g)
                assert g.dtype == np.uint8
                assert np.array_equal(g, np.asarray(w))
    finally:
        rd.close()


@pytest.mark.parametrize("name", list(JOBS))
def test_do_job_equals_reference(src, tmp_path, name):
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    jstats = jwork.do_job(_job(JS, src, jout, name))
    t0 = time.perf_counter()
    tstats = work.do_job(_job(S, src, tout, name), device="cpu")
    print(f"{name}: port do_job {time.perf_counter() - t0:.2f} s on the CPU")
    if name == "crop-scale-anamorphic":
        # the port's SPS is longer by its aspect (the IDR carries it)
        grown = {k: v for k, v in tstats.items() if k != "bytes_out"}
        assert grown == {k: v for k, v in jstats.items()
                         if k != "bytes_out"}
        assert tstats["bytes_out"] > jstats["bytes_out"]
    else:
        assert tstats == jstats
    assert tstats["frames_out"] == N
    if name == "crop-scale-anamorphic":
        st = dict(JOBS[name][0], width=tstats["width"],
                  height=tstats["height"])
        _assert_scaled_planes_equal(src, st)
    got, want = _mp4(tout), _mp4(jout)
    assert got[3] == want[3] == (tstats["width"], tstats["height"])
    assert got[1].startswith(b"\x01")
    if name == "crop-scale-anamorphic":
        # the loose job's pixel aspect, which the reference resolves and
        # drops: the port's SPS and pasp carry it, and its avcC is the
        # reference's with the aspect put in
        from fractions import Fraction
        from handbrake_tpu.job.geometry import (GeometrySettings,
                                                set_anamorphic_size2)
        from torch_par import sar_of, strip_config_sar
        st, mode = JOBS[name]
        par = set_anamorphic_size2(W, H, Fraction(1), GeometrySettings(
            mode=mode, width=st["width"], height=st["height"],
            crop=(st["crop-top"], st["crop-bottom"], st["crop-left"],
                  st.get("crop-right", 0))))[2]
        assert par != 1
        assert sar_of("h264", got[1]) == par.as_integer_ratio()
        d = MP4Demuxer(tout)
        assert (d.tracks[0].par_num, d.tracks[0].par_den) == \
            par.as_integer_ratio()
        d.close()
        assert strip_config_sar(got[1], "h264") == want[1]
        assert tstats["bytes_out"] - jstats["bytes_out"] == \
            len(got[1]) - len(want[1])
    else:
        assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(got[0]) == N and got[0] == want[0]


CLI_CASES = {"default-preset": [],
             "default-preset-scaled": ["-w", "32", "-l", "16"],
             "two-pass-bitrate": ["-b", "400", "--two-pass"],
             "frame-range-cfr": ["--start-at", "frame:3", "--stop-at",
                                 "frame:6", "--cfr", "-r", "25"]}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_equals_reference(letterbox, tmp_path, case):
    """Default preset (Fast 1080p30): the scan autocrops the bars, then
    crop/scale and the framerate shaper run before the encoder; also a
    scaled job, a two-pass bitrate job (analysis pass, then the final
    pass on its stats) and a frame range re-timed to 25 fps CFR."""
    extra = CLI_CASES[case]
    argv = ["-i", letterbox, "-e", "h264", "-q", "28", "--encoder-profile",
            "high", *extra]
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    assert jcli(argv + ["-o", jout]) == 0
    assert cli(argv + ["-o", tout, "--device", "cpu"]) == 0
    got, want = _mp4(tout), _mp4(jout)
    scaled = case == "default-preset-scaled"
    assert got[3] == want[3] == ((32, 16) if scaled else (W, H - 2 * BAR))
    if scaled:
        _assert_scaled_planes_equal(letterbox, {
            "crop-top": BAR, "crop-bottom": BAR, "width": 32, "height": 16})
    if "--stop-at" not in extra:
        assert len(got[0]) == N
    assert got[0] and got == want


def test_cfr_drop_choice_equals_reference():
    """The framerate shaper re-timing 60 fps to 29.97 fps CFR drops the
    same frames as the reference at 1920x804, where the reference's f32
    mean of the motion metric rounds (the sum passes 2**24) and the
    port's exact int64 sum does not: both metrics agree within f32
    rounding (relative 1e-6) and so do the choices."""
    from fractions import Fraction

    from handbrake_tpu.filters.vfr import VFRFilter as JVFR
    from handbrake_tpu.filters.vfr import motion_metric as jmetric
    from handbrake_tpu_torch.filters.vfr import VFRFilter, motion_metric
    h, w, n = 804, 1920, 10
    rng = np.random.default_rng(5)
    base = rng.integers(0, 200, (h, w))
    frames = [[np.clip(base + 7 * ((i * 5) % 9) + rng.integers(0, 40, (h, w)),
                       0, 255).astype(np.uint8),
               np.full((h // 2, w // 2), 128, np.uint8),
               np.full((h // 2, w // 2), 128, np.uint8)] for i in range(n)]
    diff = np.abs(frames[0][0].astype(np.int64) - frames[1][0]).sum()
    assert diff > 2 ** 24
    got, want = motion_metric(frames[0][0], frames[1][0], "cpu"), float(
        jmetric(frames[0][0], frames[1][0]))
    assert abs(got - want) <= 1e-6 * got
    settings = {"mode": 1, "rate": "30000/1001"}
    jf, tf = JVFR(dict(settings)), VFRFilter(dict(settings))
    jf.init(JFilterInit(geometry=JGeometry(w, h), vrate=Fraction(60)))
    tf.init(FilterInit(geometry=Geometry(w, h), vrate=Fraction(60),
                       device="cpu"))
    index = {id(f): i for i, f in enumerate(frames)}
    outs = []
    for f, Buf, fmt in ((jf, JBuffer, J_YUV420P), (tf, Buffer, YUV420P)):
        out = []
        for i, planes in enumerate(frames + [None]):
            buf = (Buf.eof() if planes is None else
                   Buf(planes=planes, pix_fmt=fmt, pts=1500 * i,
                       duration=1500))
            out += [(index[id(b.planes)], b.pts) for b in f.work(buf)
                    if not b.is_eof()]
        outs.append((out, f.drops))
    assert outs[0] == outs[1] and outs[1][1] > 0


def _wait(h, state, timeout=120):
    t0 = time.monotonic()
    while h.get_state()["State"] != state:
        assert time.monotonic() - t0 < timeout, h.get_state()
        time.sleep(0.02)


def test_handle_equals_do_job(src, tmp_path):
    direct = str(tmp_path / "direct.mp4")
    work.do_job(_job(S, src, direct, "crop-only"), device="cpu")
    h = Handle(device="cpu")
    h.scan(src, preview_count=3, keep_previews=True)
    _wait(h, "SCANDONE")
    assert [(t.width, t.height, t.crop) for t in h.titles] == \
        [(W, H, (0, 0, 0, 0))]
    out = str(tmp_path / "handle.mp4")
    h.add(_job(S, src, out, "crop-only"))
    h.start()
    _wait(h, "WORKDONE")
    assert h.work_wait() == 0 and h.work_exception is None
    with open(out, "rb") as a, open(direct, "rb") as b:
        assert a.read() == b.read()
    # the preview runs the job's filter graph on a stored scan preview
    jh = JHandle()
    jh.scan(src, preview_count=3, keep_previews=True)
    jh.scan_wait()
    job = _job(S, src, out, "crop-scale-anamorphic")
    jjob = _job(JS, src, out, "crop-scale-anamorphic")
    for k in range(3):
        got, want = h.get_preview(job, k), jh.get_preview(jjob, k)
        assert [p.shape for p in got] == [(24, 32), (12, 16), (12, 16)]
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray)
            assert np.array_equal(g, np.asarray(w))
    h.close()
    jh.close()


def test_no_fallback_to_the_cpu(src, tmp_path, monkeypatch):
    """device=None means the CUDA card; no environment variable moves a
    job to the CPU or to a host encoder."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    monkeypatch.setenv("HB_TPU_DISABLE_DEVICE", "1")
    out = str(tmp_path / "x.mp4")
    with pytest.raises(RuntimeError, match="CUDA"):
        work.do_job(_job(S, src, out, "unscaled"))
    with pytest.raises(RuntimeError, match="CUDA"):
        work.do_job(_job(S, src, out, "unscaled"), device="cuda")
    assert not os.path.exists(out)
    h = Handle()
    h.add(_job(S, src, out, "unscaled"))
    h.start()
    assert h.work_wait(60) != 0
    assert isinstance(h.work_exception, RuntimeError)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["-i", src, "-o", out])


# job changes whose paths are later slices of the port, or that the port
# refuses, and what each raises
UNPORTED_JOBS = {
    # mkv is ported, and so is the catalog; its ProRes encoder is
    # refused (the catalog feeds yuv420p 8-bit)
    "mux-mkv": (lambda j: (setattr(j, "mux", "mkv"),
                           setattr(j, "vcodec", "prores")),
                work.WorkError),
    # HEVC jobs run (tests/test_torch_job_hevc_av1.py); GOP-parallel
    # encoding is H.264's alone
    "vcodec-hevc": (lambda j: (setattr(j, "vcodec", "hevc_tpu"),
                               setattr(j, "gop_parallel", 2)),
                    work.WorkError),
}


@pytest.mark.parametrize("change", list(UNPORTED_JOBS))
def test_unported_job_raises(src, tmp_path, change):
    j = _job(S, src, str(tmp_path / "x.mp4"), "crop-only")
    change_job, exc = UNPORTED_JOBS[change]
    change_job(j)
    with pytest.raises(exc):
        work.do_job(j, device="cpu")


def _srt(path):
    with open(path, "w") as f:
        f.write("1\n00:00:00,050 --> 00:00:00,200\ncue\n\n")
    return path


# job changes that raised NotImplementedError until their paths were
# ported (tile-parallel nlmeans, GOP-parallel encoding, checkpoint and
# resume); each now runs
FORMERLY_UNPORTED_JOBS = {
    "filter-decomb": lambda j, d: (j.filters.extend([
        S.FilterSpec(S.FILTER_DECOMB, {}),
        S.FilterSpec(S.FILTER_RENDER_SUB, {})]),
        setattr(j, "tile_parallel", 2)),
    "filter-nlmeans": lambda j, d: j.filters.append(
        S.FilterSpec(S.FILTER_NLMEANS, {"tile_parallel": 2})),
    "gop-parallel": lambda j, d: setattr(j, "gop_parallel", 2),
    "checkpoint": lambda j, d: setattr(j, "checkpoint", True),
    # a kept SRT track, resumed from a journal
    "subtitles": lambda j, d: (j.subtitles.append(
        S.SubtitleJobTrack(track=-1, import_file=_srt(str(d / "a.srt")))),
        setattr(j, "resume", True)),
}


def _video_samples(path) -> int:
    d = MP4Demuxer(path)
    n = d.n_samples(0)
    d.close()
    return n


def _killed_journal(monkeypatch, run):
    """Run a checkpointed job as `run` does, keep its journal as a kill
    would, and delete its output."""
    from handbrake_tpu_torch import checkpoint

    def keep(self, complete=False):
        self.f.close()
    with monkeypatch.context() as m:
        m.setattr(checkpoint.CkptJournal, "close", keep)
        run()


@pytest.mark.parametrize("change", list(FORMERLY_UNPORTED_JOBS))
def test_formerly_unported_job_runs(src, tmp_path, monkeypatch, change):
    out = str(tmp_path / "x.mp4")
    j = _job(S, src, out, "crop-only")
    FORMERLY_UNPORTED_JOBS[change](j, tmp_path)
    if j.resume:
        first = j.clone()
        first.resume, first.checkpoint = False, True
        _killed_journal(monkeypatch,
                        lambda: work.do_job(first, device="cpu"))
        os.unlink(out)
    stats = work.do_job(j, device="cpu")
    assert stats["frames_out"] > 0
    assert _video_samples(out) == N
    assert not os.path.exists(out + ".ckpt")


# -e x265 and -e svt_av1 run now (tests/test_torch_job_hevc_av1.py);
# their places hold other catalog options
@pytest.mark.parametrize("opts", [["-E", "opus"], ["-a", "1", "-E", "mp3"],
                                  ["-f", "mkv", "-e", "ffv1"],
                                  ["-E", "vorbis"],
                                  ["-f", "webm", "-e", "vp9"],
                                  ["-f", "mkv", "-e", "mpeg2"]])
def test_unported_cli_option_raises(src, tmp_path, opts, monkeypatch,
                                    capsys):
    """The catalog's options run where libavcodec is (the
    test_torch_avcodec files); where it is missing the CLI exits
    non-zero naming it, and writes no file."""
    from torch_catalog import hide, mkv_source, pcm_packets
    if "-E" in opts:
        # an audio encoder is needed only where -a selects a track
        src = mkv_source(str(tmp_path / "av.mkv"), acodec="pcm_s16le",
                         apackets=pcm_packets())
        opts = opts if "-a" in opts else ["-a", "1", *opts]
    hide(monkeypatch, tmp_path)
    out = str(tmp_path / "x.mp4")
    assert cli(["-i", src, "-o", out, "--device", "cpu", *opts]) != 0
    assert "libavcodec.so.59 not found" in capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.mark.parametrize("opts", [["--gop-parallel", "2"],
                                  ["--tile-parallel", "2"],
                                  ["--checkpoint"], ["--resume"]])
def test_formerly_unported_cli_option_runs(src, tmp_path, monkeypatch, opts):
    out = str(tmp_path / "x.mp4")
    argv = ["-i", src, "-o", out, "--device", "cpu"]
    if opts == ["--resume"]:
        _killed_journal(monkeypatch,
                        lambda: cli(argv + ["--checkpoint"]))
        os.unlink(out)
    assert cli(argv + opts) == 0
    assert _video_samples(out) == N
    assert not os.path.exists(out + ".ckpt")


def test_unported_sources_raise(tmp_path, monkeypatch):
    """AVI, MPEG-TS/PS and disc folders are ported (test_torch_sources and
    test_torch_job_discs hold them): a malformed AVI, a TS without sync
    and an empty VIDEO_TS raise what the JAX package's do_job raises on
    them, and the CLI exits as its CLI does.  An HEVC elementary stream
    beyond the native decoder's subset (SAO on) raises ValueError naming
    ROADMAP item 1.10 (its libavcodec decode)."""
    from test_torch_hevc import sao_stream
    from handbrake_tpu.sources.common import DemuxError as JDemuxError
    from handbrake_tpu_torch.sources.common import DemuxError
    avi = tmp_path / "a.avi"
    avi.write_bytes(b"RIFF" + bytes(4) + b"AVI " + bytes(64))
    ts = tmp_path / "a.ts"
    ts.write_bytes(b"\x47" + bytes(187))
    hevc = tmp_path / "a.265"
    hevc.write_bytes(sao_stream())
    disc = tmp_path / "VIDEO_TS"
    disc.mkdir()
    for path in (str(avi), str(ts), str(disc)):
        with pytest.raises(JDemuxError) as want:
            jwork.do_job(_job(JS, path, str(tmp_path / "r.mp4"), "unscaled"))
        with pytest.raises(DemuxError) as got:
            work.do_job(_job(S, path, str(tmp_path / "x.mp4"), "unscaled"),
                        device="cpu")
        assert str(got.value) == str(want.value)
    from torch_catalog import hide
    with monkeypatch.context() as m:
        hide(m, tmp_path)        # with libavcodec the stream switches to it
        with pytest.raises(ValueError, match="item 1.10"):
            work.do_job(_job(S, str(hevc), str(tmp_path / "x.mp4"),
                             "unscaled"), device="cpu")
    args = ["-i", str(avi), "-o", str(tmp_path / "y.mp4")]
    assert cli([*args, "--device", "cpu"]) == jcli(args) != 0
