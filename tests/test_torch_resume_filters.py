"""A resumed job under every kind of filter chain, on the CPU: the port
against its own uninterrupted run and against the JAX package.

A resumed job feeds the filter graph every frame the uninterrupted job
fed it and drops the frames done after the graph, so a temporal filter
holds the same state at the boundary and a rate shaper cuts the same
frames.  Where every filter is frame-local (one frame out for each
frame in, each from its own frame alone), the decode ahead of the last
keyframe before the boundary is skipped: those frames stand in as
timing only, from the journal.

The reference drops n_done source frames ahead of its filters (it seeks
to frame n_done + 1), so its resumed file differs from its uninterrupted
one wherever the chain keeps state or changes the frame count; that is
held here as it is.  The crash is simulated as in
``test_torch_checkpoint.py``: the journal is kept at the end of a
checkpointed run and cut after a marker."""
import contextlib
import os

import numpy as np
import pytest

from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import checkpoint, work
from handbrake_tpu_torch.codecs import registry
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.utils import logging as plog
from handbrake_tpu_torch.utils.synth import (make_clip, make_interlaced_clip,
                                              write_y4m)
from test_torch_checkpoint import (FPS, H, N, W, _bytes, _crash, _cut,
                                   _job, _run, _samples,
                                   _shared_jax_analyzers)  # noqa: F401
from torch_rates import vfr_c_shaper

CROP = {"crop-top": 8, "crop-bottom": 8, "crop-left": 8, "crop-right": 8,
        "width": 32, "height": 24}
# nlmeans with a ring of one frame before; small patch and range keep
# the reference's compile short
NLMEANS = {"y_strength": 6.0, "frame_count": 2, "y_patch_size": 3,
           "y_range": 1, "cb_patch_size": 3, "cb_range": 1}
# chain: (filters, clip, the reference's resumed file equal to its
# uninterrupted one after 1 and after 2 GOPs).  PFR at half rate keeps
# every other frame, so it takes 24 frames to give 3 GOPs.  The
# reference's burn-in differs on resume too, a chain without a filter
# of its own.
CHAINS = {
    "none": ([], "ramp", (True, True)),
    "hqdn3d": ([(S.FILTER_DENOISE, {})], "ramp", (False, False)),
    "cfr-half": ([(S.FILTER_VFR, {"mode": 1, "rate-num": 15000,
                                  "rate-den": 1001})], "ramp",
                 (False, False)),
    "pfr-half": ([(S.FILTER_VFR, {"mode": 2, "rate-num": 15000,
                                  "rate-den": 1001})], "ramp24",
                 (False, False)),
    "decomb": ([(S.FILTER_DECOMB, {"mode": 7})], "interlaced",
               (False, False)),
    "detelecine": ([(S.FILTER_DETELECINE, {})], "telecined",
                   (False, False)),
    "nlmeans-temporal": ([(S.FILTER_NLMEANS, NLMEANS)], "ramp",
                         (False, False)),
    "crop-scale": ([(S.FILTER_CROP_SCALE, CROP)], "ramp", (True, True)),
    "srt-burn": ([], "srt", (False, False)),
}


def _ramp(n):
    """test_torch_checkpoint.py's clip: a diagonal ramp rolled a frame."""
    base = (np.add.outer(np.arange(H), np.arange(W)) * 3 % 256).astype(
        np.uint8)
    return [(np.roll(base, i, axis=1),
             np.full((H // 2, W // 2), 110 + i, np.uint8),
             np.full((H // 2, W // 2), 60, np.uint8)) for i in range(n)]


def _telecined(n_film):
    """3:2 pulldown of n_film frames: (top, bottom) source frames (0, 0)
    (1, 0) (1, 1) (2, 2) (3, 3) for each 4 film frames."""
    film = make_clip(W, H, n_film, seed=7)
    frames = []
    for g in range(0, n_film, 4):
        for t, b in [(0, 0), (1, 0), (1, 1), (2, 2), (3, 3)]:
            fr = []
            for pt, pb in zip(film[g + t], film[g + b]):
                p = pt.copy()
                p[1::2] = pb[1::2]
                fr.append(p)
            frames.append(fr)
    return frames


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume_src")
    srt = str(d / "cue.srt")
    with open(srt, "w") as f:
        f.write("1\n00:00:00,100 --> 00:00:00,300\nfirst\n\n"
                "2\n00:00:00,250 --> 00:00:00,450\nsecond\n\n")
    return {
        "ramp": write_y4m(str(d / "ramp.y4m"), _ramp(N), W, H, 0, FPS),
        "ramp24": write_y4m(str(d / "ramp24.y4m"), _ramp(24), W, H, 0,
                            FPS),
        "interlaced": write_y4m(str(d / "il.y4m"),
                                make_interlaced_clip(W, H, N, seed=5),
                                W, H, 0, FPS, interlace="t"),
        "telecined": write_y4m(str(d / "tc.y4m"), _telecined(16), W, H, 0,
                               FPS),
        "srt": srt,
    }


def _chain_job(Sm, chain, sources, out, **kw):
    filters, clip, _ = CHAINS[chain]
    src = sources["ramp" if clip == "srt" else clip]
    j = _job(Sm, src, out, **kw)
    j.filters = [Sm.FilterSpec(i, dict(st)) for i, st in filters]
    if clip == "srt":
        j.subtitles = [Sm.SubtitleJobTrack(track=-1, burn=True,
                                           import_file=sources["srt"])]
    return j


@pytest.fixture(scope="module")
def checkpointed(sources, tmp_path_factory):
    """(file, journal) of each package's checkpointed run of a chain,
    kept as a kill after the last GOP would keep them: the file is the
    uninterrupted one.  "jax-vfr-c" is the reference with its peak-rate
    shaper on vfr.c's rule, as the port's is."""
    d = tmp_path_factory.mktemp("resume_runs")
    cache = {}

    def get(pkg, chain):
        if (pkg, chain) not in cache:
            Sm = S if pkg == "torch" else JS
            out = str(d / f"{pkg}_{chain}.mp4")
            shaper = vfr_c_shaper() if pkg == "jax-vfr-c" \
                else contextlib.nullcontext()
            with pytest.MonkeyPatch.context() as m, shaper:
                _crash(m, pkg)
                _run(pkg, _chain_job(Sm, chain, sources, out,
                                     checkpoint=True))
            cache[pkg, chain] = (_bytes(out), _bytes(out + ".ckpt"))
        return cache[pkg, chain]
    return get


def _durations(data, tmp_path):
    """The video sample durations of an mp4 file's bytes."""
    path = str(tmp_path / "durations.mp4")
    with open(path, "wb") as f:
        f.write(data)
    d = MP4Demuxer(path)
    try:
        return d._samples[0].durations
    finally:
        d.close()


def _resumed(pkg, chain, sources, checkpointed, gops, path):
    """The file of a resume from the checkpointed run's journal cut after
    `gops` GOPs."""
    Sm = S if pkg == "torch" else JS
    with open(path + ".ckpt", "wb") as f:
        f.write(checkpointed(pkg, chain)[1])
    _cut(pkg, path + ".ckpt", gops)
    stats = _run(pkg, _chain_job(Sm, chain, sources, path, resume=True))
    return _bytes(path), stats


@pytest.mark.parametrize("gops", [1, 2], ids=["cut1", "cut2"])
@pytest.mark.parametrize("chain", list(CHAINS))
def test_resumed_file_equals_uninterrupted(chain, gops, sources,
                                           checkpointed, tmp_path):
    """The port's resumed file equals its uninterrupted file byte for
    byte, which equals the reference's uninterrupted file; the
    reference's resumed file equals its uninterrupted one only where the
    chain is frame-local."""
    want, _journal = checkpointed("torch", chain)
    got, stats = _resumed("torch", chain, sources, checkpointed, gops,
                          str(tmp_path / "torch.mp4"))
    assert got == want
    frame_local = CHAINS[chain][0] == [] or chain == "crop-scale"
    assert stats["resume"] == ("keyframe" if frame_local else "start")
    jwant, _ = checkpointed("jax", chain)
    if chain == "pfr-half":
        # vfr.c's rule (ROADMAP 3.20) keeps the frames the reference
        # keeps, each lasting two source frames; the reference's own
        # keeps each one's 3003 ticks
        assert want == checkpointed("jax-vfr-c", chain)[0]
        assert [_durations(f, tmp_path) for f in (want, jwant)] == [
            [6006] * 12, [3003] * 12]
    else:
        assert want == jwant
    jgot, _ = _resumed("jax", chain, sources, checkpointed, gops,
                       str(tmp_path / "jax.mp4"))
    assert (jgot == jwant) == CHAINS[chain][2][gops - 1]


def test_cfr_half_rate_sample_counts(sources, checkpointed, tmp_path):
    """CFR at half rate: 9 samples uninterrupted; the reference resumes
    with 13 (4 frames re-coded from source frames 8-15), the port with
    the 9 of its uninterrupted run."""
    want, _ = checkpointed("torch", "cfr-half")
    path = str(tmp_path / "cfr.mp4")
    with open(path, "wb") as f:
        f.write(want)
    assert len(_samples(path)) == 9
    for pkg, n in (("torch", 9), ("jax", 13)):
        got, _ = _resumed(pkg, "cfr-half", sources, checkpointed, 2,
                          str(tmp_path / f"{pkg}.mp4"))
        assert len(_samples(str(tmp_path / f"{pkg}.mp4"))) == n


def _h264_mp4(path, w, h, n, gop):
    """An mp4 of the port's H.264 stream (an IDR each `gop` frames)
    beside a PCM stereo track."""
    enc = H264Encoder(EncoderConfig(width=w, height=h, qp=26, gop=gop),
                      device="cpu")
    t = np.arange(1600 * n) / 48000.0
    pcm = (np.stack([np.sin(2 * np.pi * 440 * t)] * 2, 1) * 12000).astype(
        "<i2")
    wr = MP4Writer(path)
    vi = wr.add_video_track(codec="h264", width=w, height=h)
    ai = wr.add_audio_track(codec="pcm_s16le", sample_rate=48000,
                            channels=2)
    for i, f in enumerate(make_clip(w, h, n, seed=8)):
        wr.write_sample(vi, enc.encode_frame(*f), duration=3003,
                        sync=i % gop == 0, annexb=True)
        wr.write_sample(ai, pcm[i * 1600:(i + 1) * 1600].tobytes(),
                        duration=1600)
    wr.finalize()
    return path


@pytest.mark.parametrize("filters,path", [
    ([], "keyframe"),
    ([(S.FILTER_GRAYSCALE, {})], "keyframe"),
    ([(S.FILTER_DENOISE, {})], "start"),
], ids=["none", "grayscale", "hqdn3d"])
def test_decoder_fed_from_the_keyframe(filters, path, tmp_path,
                                       monkeypatch):
    """96x64 H.264 mp4 with an IDR each 4 frames and AAC coded from its
    PCM; the job's keyint 6, the journal cut after one GOP (6 frames
    done).  A frame-local chain feeds the decoder the packets from the
    IDR at packet 4 on, and drops 2 frames after the filters; hqdn3d
    feeds it every packet.  The log line says which and why, and both
    files equal the uninterrupted one."""
    w, h, n = 96, 64, 16
    src = _h264_mp4(str(tmp_path / "src.mp4"), w, h, n, 4)
    kw = dict(encoder_options="keyint=6",
              audio=[S.AudioJobTrack(track=0, encoder="aac", bitrate=128)])

    def job(out, **more):
        j = _job(S, src, out, **kw, **more)
        j.filters = [S.FilterSpec(i, dict(st)) for i, st in filters]
        return j
    ref = str(tmp_path / "ref.mp4")
    _run("torch", job(ref))
    out = str(tmp_path / "out.mp4")
    with monkeypatch.context() as m:
        _crash(m, "torch")
        _run("torch", job(out, checkpoint=True))
    _cut("torch", out + ".ckpt", 1)
    os.unlink(out)
    fed, lines = [], []
    real = registry.H264VideoDecoder.feed

    def feed(self, buf):
        fed.append(buf.pts)
        return real(self, buf)
    monkeypatch.setattr(registry.H264VideoDecoder, "feed", feed)
    monkeypatch.setattr(plog, "_logger_cb", lines.append)
    stats = _run("torch", job(out, resume=True))
    assert _bytes(out) == _bytes(ref)
    all_pts = [3003 * k for k in range(n)]
    said = [ln for ln in lines if "resume:" in ln]
    assert len(said) == 1
    if path == "keyframe":
        assert fed == all_pts[4:]
        assert stats["video_packets_skipped"] == 4
        assert stats["frames_decoded"] == n - 4
        assert "starts at the keyframe in packet 4" in said[0]
        assert "4 frames ahead of it stand in" in said[0]
        assert "2 are decoded and filtered again" in said[0]
    else:
        assert fed == all_pts
        assert stats["frames_decoded"] == n
        assert "hqdn3d keeps state across frames" in said[0]
        assert "decoding from the job's start" in said[0]
    assert "the sound is decoded and coded again" in said[0]


def test_annexb_parameter_sets_primed(tmp_path, monkeypatch):
    """A raw H.264 stream whose SPS and PPS come once, ahead of the first
    IDR (an IDR each 4 frames), keyint 4, cut after 2 GOPs: the decoder
    restarted at the third IDR gets them from the skipped packets
    (``prime``), decodes 8 of 16 frames, and the file equals the
    uninterrupted one."""
    w, h, n = 96, 64, 16
    enc = H264Encoder(EncoderConfig(width=w, height=h, qp=26, gop=4),
                      device="cpu")
    aus = [enc.encode_frame(*f) for f in make_clip(w, h, n, seed=10)]
    headers = aus[0][:aus[0].index(b"\x00\x00\x00\x01\x65")]
    assert b"\x00\x00\x00\x01\x67" in headers
    src = str(tmp_path / "src.264")
    with open(src, "wb") as f:
        f.write(aus[0] + b"".join(au[len(headers):] if au.startswith(headers)
                                  else au for au in aus[1:]))
    assert _bytes(src).count(b"\x00\x00\x00\x01\x67") == 1
    ref = str(tmp_path / "ref.mp4")
    _run("torch", _job(S, src, ref))
    out = str(tmp_path / "out.mp4")
    with monkeypatch.context() as m:
        _crash(m, "torch")
        _run("torch", _job(S, src, out, checkpoint=True))
    _cut("torch", out + ".ckpt", 2)
    os.unlink(out)
    stats = _run("torch", _job(S, src, out, resume=True))
    assert stats["resume"] == "keyframe"
    assert stats["video_packets_skipped"] == 8
    assert stats["frames_decoded"] == n - 8
    assert _bytes(out) == _bytes(ref)


def test_dvd_open_gop_leading_b_dropped(tmp_path, monkeypatch):
    """A DVD folder of the 720x480 DVD stream's first 16 pictures
    (MPEG-2: a closed GOP of 10, then an open GOP whose I picture is
    followed by two B pictures that refer to the GOP before), cropped
    and scaled to 176x120, keyint 7, cut after 2 GOPs (14 frames done):
    the decode starts at the second GOP's I picture, 12 frames ahead of
    it stand in, the two leading B pictures the decoder gives from it
    are dropped, never passed on, and the file equals the uninterrupted
    one.  (The 176x144 fixture is one GOP: it has no keyframe after its
    first picture.)"""
    from handbrake_tpu_torch.tools import source_builders as B
    from test_torch_sources import T0
    es = b"".join(B.split_pictures(B.fixture("mpeg2_720x480.m2v"))[:16])
    src = B.write_dvd(str(tmp_path / "disc"),
                      B.build_ps(B.video_units(es, T0, 3003)), 2,
                      [0.3, 0.3])
    kw = dict(quality=28.0, encoder_options="keyint=7",
              filters=[S.FilterSpec(S.FILTER_CROP_SCALE,
                                    {"width": 176, "height": 120})])
    ref = str(tmp_path / "ref.mp4")
    _run("torch", _job(S, src, ref, **kw))
    out = str(tmp_path / "out.mp4")
    with monkeypatch.context() as m:
        _crash(m, "torch")
        _run("torch", _job(S, src, out, checkpoint=True, **kw))
    _cut("torch", out + ".ckpt", 2)
    os.unlink(out)
    given, lines = [], []
    real = registry.Mpeg2VideoDecoder.feed

    def feed(self, buf):
        got = real(self, buf)
        given.extend(f.pts for f in got)
        return got
    monkeypatch.setattr(registry.Mpeg2VideoDecoder, "feed", feed)
    monkeypatch.setattr(plog, "_logger_cb", lines.append)
    stats = _run("torch", _job(S, src, out, resume=True, **kw))
    said = next(ln for ln in lines if "resume:" in ln)
    assert stats["resume"] == "keyframe"
    assert f"keyframe in packet {stats['video_packets_skipped']}:" in said
    assert "12 frames ahead of it stand in" in said
    assert "2 are decoded and filtered again" in said
    # the leading B pictures (display 10, 11) come out of the decoder
    # first and go no further; then the I picture (12) and the rest
    assert sorted(given)[:3] == [T0 + k * 3003 for k in (10, 11, 12)]
    assert stats["frames_decoded"] == 6
    assert stats["frames_out"] == 16 - 14
    assert _bytes(out) == _bytes(ref)


def _as_version_2(path):
    """Rewrite a journal as version 2 wrote it: the older magic and
    markers of (frames, rc state)."""
    data = _bytes(path)
    out = bytearray(b"HBTCKP2\n")
    for tag, s, end in checkpoint.spans(data):
        fields = checkpoint._get(data[s + checkpoint._HDR.size:end], 0)[0]
        out += checkpoint.encode_record(tag, fields[:2] if tag == "g"
                                        else fields)
    with open(path, "wb") as f:
        f.write(bytes(out))


def test_version_2_journal_resumes_with_full_decode(sources, tmp_path,
                                                    monkeypatch):
    """A version 2 journal (no resume point in its markers) resumes with
    a full decode, its file equal to the uninterrupted one, and a second
    crash of that resume leaves a version 2 journal that resumes too."""
    ref = str(tmp_path / "ref.mp4")
    _run("torch", _chain_job(S, "none", sources, ref))
    out = str(tmp_path / "v2.mp4")
    with monkeypatch.context() as m:
        _crash(m, "torch")
        _run("torch", _chain_job(S, "none", sources, out, checkpoint=True))
    _cut("torch", out + ".ckpt", 1)
    _as_version_2(out + ".ckpt")
    os.unlink(out)
    lines = []
    monkeypatch.setattr(plog, "_logger_cb", lines.append)
    with monkeypatch.context() as m:
        _crash(m, "torch")
        stats = _run("torch", _chain_job(S, "none", sources, out,
                                         resume=True))
    assert stats["resume"] == "start" and stats["frames_decoded"] == N
    assert any("format 2" in ln and "decoding from the job's start" in ln
               for ln in lines)
    assert _bytes(out) == _bytes(ref)
    assert _bytes(out + ".ckpt").startswith(b"HBTCKP2\n")
    _cut("torch", out + ".ckpt", 2)
    os.unlink(out)
    _run("torch", _chain_job(S, "none", sources, out, resume=True))
    assert _bytes(out) == _bytes(ref)


def test_journal_resume_point_and_timeline(sources, checkpointed):
    """Each version 3 marker holds the boundary's resume point: for the
    16-frame y4m with keyint 4, frame-local, the frames the graph had
    taken (the boundary frame's count), the untouched sync, the y4m
    frame of the boundary itself as the random access point, and the
    timing of the frames ahead of it (3003 ticks a frame from 0)."""
    _file, data = checkpointed("torch", "none")
    marks = [checkpoint._get(data[s + checkpoint._HDR.size:end], 0)[0]
             for tag, s, end in checkpoint.spans(data) if tag == "g"]
    assert [m[0] for m in marks] == [4, 8, 12]
    for frames, _rc, point in marks:
        assert point["graph_in"] == frames + 1
        assert point["sync_touched"] is False
        assert (point["packet"], point["display"]) == (frames, frames)
        assert point["rap_pts"] == 3003 * frames
    tl = checkpoint.Timeline()
    for _f, _rc, point in marks:
        tl.extend_packed(point["timing"])
    assert len(tl) == 12
    assert [tl[i] for i in (0, 11)] == [(0, 3003, 3003),
                                        (33033, 36036, 3003)]
