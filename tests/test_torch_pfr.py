"""The peak-rate (PFR) shaper on the CPU (ROADMAP 3.20): the port's
``VFRFilter`` mode 2 held to HandBrake's rule, ``vfr_c_rule``, from
libhb's ``vfr.c`` ``adjust_frame_rate``, and the jobs
that carry its timeline and rate to the encoder, the rate controller and
the file.  Beside each case, the JAX package's shaper gives what it gave
before (``reference_rule``): a frame that starts less than two thirds of
a peak frame time after the last kept one is dropped, and a kept frame
keeps its own times, so a 60 fps source comes out half as long.  Both
rules are written out in ``tests/torch_rates.py``.

The job source is a 64x48 H.264 mp4 at 60 fps, 12 frames, with a stereo
48 kHz AAC track as long, written by the port's own encoders and muxer;
it goes through the CLI's default preset (Fast 1080p30, peak 30)."""
import functools
import math
import os
from fractions import Fraction

import numpy as np
import pytest

from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu.core.buffer import Geometry as JGeometry
from handbrake_tpu.core.buffer import YUV420P as J_YUV420P
from handbrake_tpu.filters.base import FilterInit as JFilterInit
from handbrake_tpu.filters.vfr import VFRFilter as JVFR
from handbrake_tpu_torch import checkpoint
from handbrake_tpu_torch.audio.aac import AACEncoder
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs import ratecontrol, vui
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.core.buffer import YUV420P, Buffer, Geometry
from handbrake_tpu_torch.filters.base import FilterInit
from handbrake_tpu_torch.filters.vfr import VFRFilter
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.parallel.launch import torchrun
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.utils.synth import make_clip
from torch_rates import reference_rule, vfr_c_rule, vfr_c_shaper

W, H, N = 64, 48, 12
SRC_TICKS = 1500                # a frame at 60 fps
PEAK_TICKS = 3000               # a frame at the preset's peak, 30 fps
AAC_TICKS = 1920                # 1024 samples at 48 kHz
# the sound's own length: a track of AAC carries its encoder's latency of
# one frame ahead of the sound, unmarked (no edit list), and the job's
# sound went through two AAC encoders (the source's and the job's)
AAC_LATENCY = 2 * AAC_TICKS
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the rule -----------------------------------------------------------------
def _grid(rate, n, t0=0):
    """n contiguous frames at `rate` from t0: each starts where the last
    stopped, the starts truncated to ticks."""
    starts = [t0 + math.trunc(Fraction(90000 * k) / rate)
              for k in range(n + 1)]
    return [(starts[k], starts[k + 1] - starts[k]) for k in range(n)]


def _mkv_ms(n):
    """30000/1001 in mkv: starts in whole milliseconds, each frame lasting
    until the next one starts."""
    starts = [90 * round(k * 1001 / 30) for k in range(n + 1)]
    return [(starts[k], starts[k + 1] - starts[k]) for k in range(n)]


def _burst(seed, n):
    """A variable-rate stream: 24 fps, a 120 fps burst, 60 fps, 30000/1001,
    then frames of random length from those rates' frame times."""
    frames = _grid(Fraction(24000, 1001), 6, 4500)
    for rate, k in ((Fraction(120), 9), (Fraction(60), 7),
                    (Fraction(30000, 1001), 5)):
        t = sum(frames[-1])
        frames += _grid(rate, k, t)
    rng = np.random.default_rng(seed)
    for d in rng.choice([750, 1500, 3003, 3754, 1800], n):
        frames.append((sum(frames[-1]), int(d)))
    return frames


CASES = {
    "60-into-30": (Fraction(60), Fraction(30), _grid(Fraction(60), 12)),
    "50-into-30": (Fraction(50), Fraction(30), _grid(Fraction(50), 10)),
    "50-into-25": (Fraction(50), Fraction(25), _grid(Fraction(50), 10)),
    "60-into-24000/1001": (Fraction(60), Fraction(24000, 1001),
                           _grid(Fraction(60), 15)),
    "24000/1001-into-30": (Fraction(24000, 1001), Fraction(30),
                           _grid(Fraction(24000, 1001), 9, 90000)),
    "25-into-30": (Fraction(25), Fraction(30), _grid(Fraction(25), 8)),
    "30-into-30": (Fraction(30), Fraction(30), _grid(Fraction(30), 8)),
    "30000/1001-mkv-ms-into-30": (Fraction(30000, 1001), Fraction(30),
                                  _mkv_ms(12)),
    "burst-into-30": (Fraction(30000, 1001), Fraction(30), _burst(3, 20)),
}
UNCHANGED = ("24000/1001-into-30", "25-into-30", "30-into-30")


def _shape(pkg, rate, peak, frames):
    """(kept [(index, pts, duration)], the rate that leaves the filter)
    of one package's shaper in PFR mode."""
    Filt, Init, Geo, Buf, fmt = (
        (VFRFilter, FilterInit, Geometry, Buffer, YUV420P) if pkg == "torch"
        else (JVFR, JFilterInit, JGeometry, JBuffer, J_YUV420P))
    f = Filt({"mode": 2, "rate-num": peak.numerator,
              "rate-den": peak.denominator})
    kw = {"device": "cpu"} if pkg == "torch" else {}
    fo = f.init(Init(geometry=Geo(4, 4), vrate=rate, **kw))
    planes = [np.zeros((4, 4), np.uint8)] * 3
    bufs = [Buf(planes=list(planes), pix_fmt=fmt, pts=start, duration=dur,
                stop=start + dur) for start, dur in frames]
    index = {id(b): i for i, b in enumerate(bufs)}
    out = []
    for buf in bufs + [Buf.eof()]:
        for b in f.work(buf):
            if not b.is_eof():
                assert b.stop == b.pts + b.duration
                out.append((index[id(b)], b.pts, b.duration))
    return out, fo.vrate


@pytest.mark.parametrize("case", list(CASES))
def test_pfr_equals_vfr_c_rule(case):
    rate, peak, frames = CASES[case]
    got, out_rate = _shape("torch", rate, peak, frames)
    assert got == vfr_c_rule(frames, peak)
    assert out_rate == min(rate, peak)
    if case in UNCHANGED:
        assert got == [(i, s, d) for i, (s, d) in enumerate(frames)]
    ref, ref_rate = _shape("jax", rate, peak, frames)
    assert ref == reference_rule(frames, peak) and ref_rate == rate
    with vfr_c_shaper():        # the reference as the port's tests hold it
        assert _shape("jax", rate, peak, frames) == (got, out_rate)


def test_pfr_rule_cases_as_written():
    """The rule's own numbers: 60 into 30 keeps 0, 2 and 4 at 0, 3000 and
    6000; 50 into 30 keeps 0, 1, 3 and 5 of 6, 3000 ticks each."""
    assert vfr_c_rule(_grid(Fraction(60), 6), Fraction(30)) == [
        (0, 0, 3000), (2, 3000, 3000), (4, 6000, 3000)]
    assert vfr_c_rule(_grid(Fraction(50), 6), Fraction(30)) == [
        (0, 0, 3000), (1, 3000, 3000), (3, 6000, 3000), (5, 9000, 3000)]
    assert reference_rule(_grid(Fraction(50), 6), Fraction(30)) == [
        (0, 0, 1800), (2, 3600, 1800), (4, 7200, 1800)]


# -- jobs ---------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """The reference's encoders of one shape share one jitted analyzer,
    on its device path (some of its tests leave HB_TPU_DISABLE_DEVICE=1
    set)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        yield


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """The 60 fps H.264 mp4 with its AAC track, 12 frames (0.2 s)."""
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=28, gop=N,
                                    fps=(60, 1)), device="cpu")
    video = [enc.encode_frame(*f) for f in make_clip(W, H, N, seed=23)]
    t = np.arange(N * SRC_TICKS * 48000 // 90000) / 48000
    pcm = np.stack([0.4 * np.sin(2 * np.pi * f * t) for f in (440, 550)],
                   1).astype(np.float32)
    aac = AACEncoder(48000, 2)
    sound = aac.encode(pcm) + aac.flush()
    path = str(tmp_path_factory.mktemp("pfr") / "src60.mp4")
    w = MP4Writer(path)
    vi = w.add_video_track(codec="h264", width=W, height=H)
    ai = w.add_audio_track(codec="aac", sample_rate=48000, channels=2,
                           extradata=aac.audio_specific_config())
    k = 0
    for i, au in enumerate(video):
        w.write_sample(vi, au, duration=SRC_TICKS, sync=i == 0, annexb=True)
        while k < len(sound) and (k * AAC_TICKS < (i + 1) * SRC_TICKS
                                  or i == N - 1):
            w.write_sample(ai, sound[k], duration=1024)
            k += 1
    w.finalize()
    return path


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _lengths(path):
    """(video [(pts, duration)] in display order, video length, sound
    length), 90 kHz: in an mp4 each track's duration (its samples'
    durations summed: the timeline a player builds), in an mkv each
    track's last block's time plus its duration."""
    mkv = path.endswith(".mkv")
    d = MKVDemuxer(path) if mkv else MP4Demuxer(path)
    try:
        pk = {}
        for trk, b in d.packets():
            pk.setdefault(d.tracks[trk].kind, []).append(
                (b.pts, b.duration))
        if not mkv:
            return (sorted(pk["video"]), d.track_duration(0),
                    d.track_duration(1))
    finally:
        d.close()
    video = sorted(pk["video"])
    return (video, video[-1][0] + video[-1][1],
            max(p for p, _d in pk["audio"]) + AAC_TICKS)


@pytest.mark.parametrize("mux", ["mp4", "mkv"])
def test_60fps_default_preset_keeps_its_length(src, tmp_path, mux, capfd):
    """The default preset to mp4 and mkv: 6 frames of 3000 ticks, the
    video as long as the source's and within a peak frame time of the
    sound, the VUI at 30 and the log line.  The reference keeps the same
    frames at the same starts, each with its own 1500 ticks: its mp4's
    video is half as long as the source's."""
    out, ref = str(tmp_path / f"o.{mux}"), str(tmp_path / f"ref.{mux}")
    capfd.readouterr()
    assert cli(["-i", src, "-o", out, "--device", "cpu"]) == 0
    assert ("pfr: 6 frames dropped to hold the peak of 30/1 fps; the "
            "source runs at 60/1 fps, the encoder and its rate control at "
            "30/1 fps") in capfd.readouterr().err
    video, v_len, a_len = _lengths(out)
    if mux == "mp4":
        assert video == [(PEAK_TICKS * i, PEAK_TICKS) for i in range(6)]
    else:                       # block times in whole milliseconds
        assert [p for p, _d in video] == [
            PEAK_TICKS * i // 90 * 90 for i in range(6)]
    assert abs(v_len - N * SRC_TICKS) <= 90
    assert abs(v_len - (a_len - AAC_LATENCY)) <= PEAK_TICKS
    d = MKVDemuxer(out) if mux == "mkv" else MP4Demuxer(out)
    try:
        assert vui.stream_rate("h264", bytes(d.tracks[0].extradata))[0] \
            == 30
    finally:
        d.close()
    assert jcli(["-i", src, "-o", ref]) == 0
    ref_video, ref_len, _ = _lengths(ref)
    assert [p for p, _d in ref_video] == [p for p, _d in video]
    if mux == "mp4":            # frames of their own 1500 ticks
        assert ref_len == 6 * SRC_TICKS


@pytest.mark.parametrize("two_pass", [False, True], ids=["abr", "2pass"])
def test_bitrate_job_controls_at_the_peak(src, tmp_path, monkeypatch, capfd,
                                          two_pass):
    """``-b 900`` (and ``--two-pass``) on the 60 fps source: every rate
    controller is built at 30 fps, its budget 900 kb/s over 30 frames a
    second, and the log line names 30 for the encoder and its rate
    control."""
    built = []
    make = ratecontrol.make_rate_controller

    def spy(job, w, h, fps):
        rc = make(job, w, h, fps)
        built.append((job.pass_id, fps, rc.fps, rc.target_bpf))
        return rc
    monkeypatch.setattr(ratecontrol, "make_rate_controller", spy)
    out = str(tmp_path / "o.mp4")
    capfd.readouterr()
    assert cli(["-i", src, "-o", out, "-b", "900", "--device", "cpu"]
               + (["--two-pass"] if two_pass else [])) == 0
    err = capfd.readouterr().err
    assert built and all(b[1:] == (30.0, 30.0, 900000 / 30) for b in built)
    assert len(built) == (2 if two_pass else 1)
    assert err.count("the encoder and its rate control at 30/1 fps") == 1
    assert _lengths(out)[0] == [(PEAK_TICKS * i, PEAK_TICKS)
                                for i in range(6)]


def test_bframes_cts_follow_shaped_pts(src, tmp_path):
    """``--bframes 3`` with the default preset's PFR: the samples in
    decode order last 3000 ticks each, and each one's decode time plus
    its cts offset is its shaped display pts."""
    out = str(tmp_path / "o.mp4")
    assert cli(["-i", src, "-o", out, "-e", "h264", "-q", "28",
                "--bframes", "3", "--device", "cpu"]) == 0
    d = MP4Demuxer(out)
    try:
        st = d._samples[0]
        durs, dts, cts = st.durations, st.dts, st.cts_offsets
    finally:
        d.close()
    assert durs == [PEAK_TICKS] * 6 and any(cts)
    assert dts == [PEAK_TICKS * i for i in range(6)]
    assert sorted(t + c for t, c in zip(dts, cts)) == [
        PEAK_TICKS * i for i in range(6)]
    assert [t + c for t, c in zip(dts, cts)] != sorted(
        t + c for t, c in zip(dts, cts))


def test_resumed_pfr_job_equals_uninterrupted(src, tmp_path, monkeypatch,
                                              capfd):
    """The default preset with keyint 2, checkpointed, its journal cut
    after the second GOP: the journal's durations are the shaped 3000
    ticks, the resume decodes from the start (PFR keeps state) and its
    file equals the uninterrupted one."""
    argv = ["-i", src, "-x", "keyint=2", "--device", "cpu"]
    ref = str(tmp_path / "ref.mp4")
    assert cli(argv + ["-o", ref]) == 0
    out = str(tmp_path / "o.mp4")
    with monkeypatch.context() as m:
        m.setattr(checkpoint.CkptJournal, "close",
                  lambda self, complete=False: self.f.close())
        assert cli(argv + ["-o", out, "--checkpoint"]) == 0
    assert _bytes(out) == _bytes(ref)
    ck = out + ".ckpt"
    data = _bytes(ck)
    spans = checkpoint.spans(data)
    video = [checkpoint._get(data[s + checkpoint._HDR.size:e], 0)[0]
             for tag, s, e in spans if tag == "v"]
    assert [(v[1], v[2]) for v in video] == [
        (PEAK_TICKS * i, PEAK_TICKS) for i in range(6)]
    marks = [e for tag, _s, e in spans if tag == "g"]
    with open(ck, "wb") as f:
        f.write(data[:marks[1]])
    os.unlink(out)
    capfd.readouterr()
    assert cli(argv + ["-o", out, "--resume"]) == 0
    err = capfd.readouterr().err
    assert "resume: 4 frames from checkpoint; vfr drops and re-times " \
        "frames by the frames kept before (PFR mode); decoding from the " \
        "job's start" in err
    assert not os.path.exists(ck)
    assert _bytes(out) == _bytes(ref)


def test_gop_parallel_over_ranks_equals_serial(src, tmp_path):
    """``--gop-parallel 2`` under torchrun on two CPU ranks: rank 0 shapes
    the frames, and the file equals the one-rank job's; its samples carry
    the serial job's shaped times."""
    argv = ["-i", src, "-e", "h264", "-q", "28", "--device", "cpu"]
    out = str(tmp_path / "ranks.mp4")
    rc, log = torchrun(2, ["-m", "handbrake_tpu_torch.cli", *argv, "-o", out,
                           "--gop-parallel", "2"], limit_s=120,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       cwd=str(tmp_path))
    assert rc == 0, log[-3000:]
    assert "6 frames as 2 GOPs over 2 rank(s)" in log
    one = str(tmp_path / "one.mp4")
    assert cli(argv + ["-o", one, "--gop-parallel", "2"]) == 0
    assert _bytes(out) == _bytes(one)
    serial = str(tmp_path / "serial.mp4")
    assert cli(argv + ["-o", serial]) == 0
    assert _lengths(out) == _lengths(serial)
    assert _lengths(out)[0] == [(PEAK_TICKS * i, PEAK_TICKS)
                                for i in range(6)]
