"""Checkpoint/resume in the port's job path (``work.do_job`` with
``checkpoint``/``resume``, ``checkpoint.py``'s journal, the CLI's
``--checkpoint``/``--resume`` and a ``Handle`` job), on the CPU, byte for
byte against the JAX package (its device path) and against the same job
run without a crash.

A crash is simulated as the JAX package's own test does it: the journal's
close is patched to keep the file, which is then cut after a GOP marker
and the output deleted.  Six faults of the reference are held beside
the port: its resume appends to the journal without cutting the stale
tail, so a second crash replays it; it unpickles whatever ``<dest>.ckpt``
holds; a resumed B-frame job restarts ``idr_pic_id``; a resumed
GOP-parallel job cuts its windows anew from a marker inside one; a
resumed frame-ranged job starts from the source's frame n_done + 1 and
runs past its end; and a resumed DVD job, whose timestamps do not start
at 0, codes its source again from the first picture."""
import functools
import os
import pickle

import jax
import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.parallel import gop as jgop
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import checkpoint, work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.hb import Handle
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.utils.synth import make_clip, write_y4m

W, H, N = 64, 48, 16
FPS = (30000, 1001)
KEYINT = "keyint=4"


class _CachedVmapJax:
    """jax, with vmap cached by (function, in_axes), so the reference's
    GOP-parallel windows of one shape and G share one executable."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    @functools.lru_cache(None)
    def _vmap(f, in_axes):
        return jax.vmap(f, in_axes=in_axes)

    def vmap(self, f, in_axes=0):
        return self._vmap(f, in_axes)


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """The reference encodes on its device path, as the port does (some
    of its tests leave HB_TPU_DISABLE_DEVICE=1 set); its encoders of one
    shape share one jitted analyzer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch",
                     "build_p_analyzer_fn"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        mp.setattr(jgop, "jax", _CachedVmapJax())
        yield


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    """tests/test_work.py's clip (a diagonal ramp rolled per frame)."""
    d = tmp_path_factory.mktemp("ckpt")
    base = (np.add.outer(np.arange(H), np.arange(W)) * 3 % 256).astype(
        np.uint8)
    frames = [(np.roll(base, i, axis=1),
               np.full((H // 2, W // 2), 110 + i, np.uint8),
               np.full((H // 2, W // 2), 60, np.uint8)) for i in range(N)]
    return write_y4m(str(d / "in.y4m"), frames, W, H, 0, FPS)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _job(Sm, src, out, **kw):
    j = Sm.Job(path=src, file=out, mux="mp4", vcodec="h264", quality=30.0,
               encoder_options=KEYINT)
    for k, v in kw.items():
        setattr(j, k, v)
    return j


def _run(pkg, job):
    if pkg == "torch":
        return work.do_job(job, device="cpu")
    return jwork.do_job(job)


def _crash(monkeypatch, pkg):
    """Keep the journal at the end of the next job, as a kill would."""
    def keep(self, complete=False):
        self.f.close()
    monkeypatch.setattr(checkpoint.CkptJournal if pkg == "torch"
                        else jwork._CkptJournal, "close", keep)


def _port_marks(data):
    return [end for tag, _s, end in checkpoint.spans(data) if tag == "g"]


def _port_marked_frames(data):
    """The frames done that each of the port's markers records."""
    return [checkpoint._get(data[s + checkpoint._HDR.size:end], 0)[0][0]
            for tag, s, end in checkpoint.spans(data) if tag == "g"]


def _samples(path):
    d = MP4Demuxer(path)
    out = [bytes(d.read_sample(0, k).data) for k in range(d.n_samples(0))]
    d.close()
    return out


def _ref_spans(data):
    """[(tag, end)] of the reference's pickled journal records."""
    out, i = [], 0
    while i + 4 <= len(data):
        ln = int.from_bytes(data[i:i + 4], "big")
        rec = pickle.loads(data[i + 4:i + 4 + ln])
        i += 4 + ln
        out.append((rec[0], i))
    return out


def _cut(pkg, path, gops, stale=0, torn=False):
    """Cut the journal after its `gops`-th marker, keeping `stale` more
    complete records and, with `torn`, half of the next one."""
    data = _bytes(path)
    if pkg == "torch":
        sp = [(tag, end) for tag, _s, end in checkpoint.spans(data)]
    else:
        sp = _ref_spans(data)
    marks = [k for k, (tag, _e) in enumerate(sp) if tag in ("g", "gop")]
    k = marks[gops - 1] + stale
    cut = sp[k][1]
    if torn:
        cut += (sp[k + 1][1] - cut) // 2
    with open(path, "wb") as f:
        f.write(data[:cut])


def _crashed_run(monkeypatch, pkg, Sm, src, out, gops, stale=0, **kw):
    """A checkpointed job killed after `gops` complete GOPs and `stale`
    records more (its output deleted, its journal cut)."""
    with monkeypatch.context() as m:
        _crash(m, pkg)
        _run(pkg, _job(Sm, src, out, checkpoint=True, **kw))
    _cut(pkg, out + ".ckpt", gops, stale=stale)
    os.unlink(out)


def test_checkpoint_resume_gop_boundary(y4m, tmp_path, monkeypatch):
    """tests/test_work.py::test_checkpoint_resume_gop_boundary's scenario:
    the resumed file equals the uninterrupted one and the reference's
    resumed file, byte for byte."""
    files = {}
    for pkg, Sm in (("torch", S), ("jax", JS)):
        ref = str(tmp_path / f"{pkg}_ref.mp4")
        _run(pkg, _job(Sm, y4m, ref))
        out = str(tmp_path / f"{pkg}_ck.mp4")
        _run(pkg, _job(Sm, y4m, out, checkpoint=True))
        assert not os.path.exists(out + ".ckpt")   # complete → removed
        assert _bytes(out) == _bytes(ref)
        _crashed_run(monkeypatch, pkg, Sm, y4m, out, 1)
        stats = _run(pkg, _job(Sm, y4m, out, resume=True))
        assert stats["frames_out"] == N - 4
        assert not os.path.exists(out + ".ckpt")
        files[pkg] = (_bytes(ref), _bytes(out))
    assert files["torch"][1] == files["torch"][0]
    assert files["torch"][1] == files["jax"][1]


def test_journal_typed_records(y4m, tmp_path, monkeypatch):
    """The port's journal: the magic, then one typed record a sample and
    a marker at each IDR after the first, with the frames done and the
    rate controller's state at that boundary."""
    out = str(tmp_path / "j.mp4")
    with monkeypatch.context() as m:
        _crash(m, "torch")
        _run("torch", _job(S, y4m, out, checkpoint=True))
    recs, n_done, rc_state, cut = checkpoint.load(out + ".ckpt")
    assert _bytes(out + ".ckpt")[:len(checkpoint.MAGIC)] == checkpoint.MAGIC
    assert n_done == N - 4 and rc_state["_gops_done"] == 3
    assert rc_state["frame_idx"] == N - 4 and rc_state["base_qp"] == 30
    assert [r[0] for r in recs] == ["v"] * (N - 4)
    assert [r[4] for r in recs] == [i % 4 == 0 for i in range(N - 4)]
    assert cut == _port_marks(_bytes(out + ".ckpt"))[-1]
    # a value of every type the journal stores comes back as it went in
    vals = (None, True, 7, -(1 << 62), 2.5, b"\x00\xff", "s", [1, (2, 3)],
            {"k": [0.1]})
    body = checkpoint.encode_record("v", vals)
    assert checkpoint._get(body, 9)[0] == vals


def test_pickle_journal_refused(y4m, tmp_path):
    """A .ckpt holding a pickle is refused, never unpickled; the
    reference unpickles it (and so runs what it names) before failing."""
    class Payload:
        def __reduce__(self):
            return (open, (marker, "w"))

    for pkg, Sm in (("torch", S), ("jax", JS)):
        out = str(tmp_path / f"{pkg}.mp4")
        marker = str(tmp_path / f"{pkg}.ran")
        blob = pickle.dumps(Payload(), protocol=4)
        with open(out + ".ckpt", "wb") as f:
            f.write(len(blob).to_bytes(4, "big") + blob)
        with pytest.raises(Exception) as e:
            _run(pkg, _job(Sm, y4m, out, resume=True))
        if pkg == "torch":
            assert isinstance(e.value, checkpoint.JournalError)
            assert not os.path.exists(marker)
        else:
            assert os.path.exists(marker)      # the payload ran


def test_resume_without_journal_raises(y4m, tmp_path):
    out = str(tmp_path / "none.mp4")
    with pytest.raises(work.WorkError, match="no checkpoint journal"):
        _run("torch", _job(S, y4m, out, resume=True))
    assert not os.path.exists(out)


@pytest.mark.parametrize("torn", [False, True], ids=["stale", "torn"])
def test_second_crash_after_resume(y4m, tmp_path, monkeypatch, torn):
    """A crash leaves two complete records past the second marker (and,
    with `torn`, half of a third); the resume crashes again; a second
    resume must give the uninterrupted file.  The port cuts the journal
    before it appends.  The reference appends after the stale records:
    with them complete it replays them after the second crash and writes
    two samples too many."""
    counts = {}
    for pkg, Sm in (("torch", S), ("jax", JS)):
        ref = str(tmp_path / f"{pkg}_ref.mp4")
        _run(pkg, _job(Sm, y4m, ref))
        out = str(tmp_path / f"{pkg}.mp4")
        with monkeypatch.context() as m:
            _crash(m, pkg)
            _run(pkg, _job(Sm, y4m, out, checkpoint=True))
        _cut(pkg, out + ".ckpt", 2, stale=2, torn=torn)
        os.unlink(out)
        with monkeypatch.context() as m:
            _crash(m, pkg)
            _run(pkg, _job(Sm, y4m, out, resume=True))
        os.unlink(out)
        _run(pkg, _job(Sm, y4m, out, resume=True))
        d = MP4Demuxer(out)
        counts[pkg] = d.n_samples(0)
        d.close()
        if pkg == "torch":
            assert _bytes(out) == _bytes(ref)
    assert counts["torch"] == N
    if not torn:
        assert counts["jax"] == N + 2


def _av_source(path, srt):
    """An mp4 with the port's H.264 stream and a PCM stereo track, and an
    SRT file of two cues."""
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=26, gop=60,
                                    cabac=True, deblock=True,
                                    transform8x8=True), device="cpu")
    t = np.arange(1600 * N) / 48000.0
    pcm = (np.stack([np.sin(2 * np.pi * 440 * t)] * 2, 1) * 12000).astype(
        "<i2")
    w = MP4Writer(path)
    vi = w.add_video_track(codec="h264", width=W, height=H)
    ai = w.add_audio_track(codec="pcm_s16le", sample_rate=48000, channels=2)
    for i, f in enumerate(make_clip(W, H, N, seed=4)):
        w.write_sample(vi, enc.encode_frame(*f), duration=3003,
                       sync=i == 0, annexb=True)
        w.write_sample(ai, pcm[i * 1600:(i + 1) * 1600].tobytes(),
                       duration=1600)
    w.finalize()
    with open(srt, "w") as f:
        f.write("1\n00:00:00,100 --> 00:00:00,150\nfirst\n\n"
                "2\n00:00:00,350 --> 00:00:00,450\nsecond\n\n")
    return path


def test_resume_with_audio_and_subtitle(tmp_path, monkeypatch):
    """An AAC track and a kept SRT track: the journal holds 'a' and 's'
    records, and the resumed file equals the uninterrupted run's (which
    equals the reference's): a resumed job reads its source from the
    start again, so its AAC encoder gives the packets it gave, and the
    journaled ones are not written twice.  The reference restarts its AAC encoder at the resume
    point, so its resumed file differs from its uninterrupted one (and
    from the port's) in the audio alone."""
    srt = str(tmp_path / "a.srt")
    src = _av_source(str(tmp_path / "av.mp4"), srt)
    files = {}
    for pkg, Sm in (("torch", S), ("jax", JS)):
        kw = dict(audio=[Sm.AudioJobTrack(track=0, encoder="aac",
                                          bitrate=128)],
                  subtitles=[Sm.SubtitleJobTrack(track=-1,
                                                 import_file=srt)])
        ref = str(tmp_path / f"{pkg}_ref.mp4")
        _run(pkg, _job(Sm, src, ref, **kw))
        out = str(tmp_path / f"{pkg}.mp4")
        with monkeypatch.context() as m:
            _crash(m, pkg)
            _run(pkg, _job(Sm, src, out, checkpoint=True, **kw))
        if pkg == "torch":
            tags = [t for t, _s, _e in checkpoint.spans(_bytes(out + ".ckpt"))]
            assert {"v", "a", "s", "g"} <= set(tags)
        _cut(pkg, out + ".ckpt", 2)
        os.unlink(out)
        _run(pkg, _job(Sm, src, out, resume=True, **kw))
        files[pkg] = (ref, out)
    assert _bytes(files["torch"][0]) == _bytes(files["jax"][0])
    assert _bytes(files["torch"][1]) == _bytes(files["torch"][0])
    assert _bytes(files["jax"][1]) != _bytes(files["jax"][0])
    j0, j1 = (MP4Demuxer(p) for p in files["jax"])
    assert [bytes(j0.read_sample(0, k).data) for k in range(N)] == \
        [bytes(j1.read_sample(0, k).data) for k in range(N)]
    assert [bytes(j0.read_sample(1, k).data)
            for k in range(j0.n_samples(1))] != \
        [bytes(j1.read_sample(1, k).data) for k in range(j1.n_samples(1))]
    j0.close()
    j1.close()
    a, b = (MP4Demuxer(p) for p in files["torch"])
    assert a.n_samples(0) == b.n_samples(0) == N
    assert all(bytes(a.read_sample(0, k).data) == bytes(b.read_sample(0, k)
                                                        .data)
               for k in range(N))
    assert [t.kind for t in b.tracks] == ["video", "audio", "subtitle"]
    a.close()
    b.close()


def test_dvd_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A DVD folder of the 176x144 MPEG-2 fixture (12 pictures, the first
    pts 0.1 s in), keyint 4, the journal cut after the first GOP: the
    port reads the title from its first picture again and drops 4, so
    its resumed file equals the uninterrupted one.  The reference seeks
    to 4 frame times from 0, which is before the title's first picture,
    and codes all 12 again after the 4 it replayed: 16 samples."""
    from handbrake_tpu_torch.tools import source_builders as B
    from test_torch_sources import T0
    es = B.fixture("mpeg2_176x144.m2v")
    src = B.write_dvd(str(tmp_path / "disc"),
                      B.build_ps(B.video_units(es, T0, 3003)), 2,
                      [0.2, 0.2])
    got = {}
    for pkg, Sm in (("torch", S), ("jax", JS)):
        ref = str(tmp_path / f"{pkg}_ref.mp4")
        _run(pkg, _job(Sm, src, ref, quality=28.0))
        out = str(tmp_path / f"{pkg}.mp4")
        _crashed_run(monkeypatch, pkg, Sm, src, out, 1, quality=28.0)
        stats = _run(pkg, _job(Sm, src, out, resume=True, quality=28.0))
        got[pkg] = (_samples(ref), _samples(out))
        if pkg == "torch":
            assert stats["frames_out"] == 8
            assert _bytes(out) == _bytes(ref)
    want, resumed = got["torch"]
    assert len(want) == 12 and resumed == want
    jref, jout = got["jax"]
    assert jref == want
    assert len(jout) == 16 and jout[:4] == want[:4]


def test_bframe_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """96x64, 24 frames, keyint 4, two B-frames, the journal cut after two
    GOPs: the port's resumed file equals its uninterrupted run (and that
    the reference's).  The reference's resumed file differs in samples
    8, 12, 16 and 20, the IDRs after the resume point, whose idr_pic_id
    restarts."""
    w, h, n = 96, 64, 24
    src = write_y4m(str(tmp_path / "b.y4m"), make_clip(w, h, n, seed=6),
                    w, h, 0, FPS)
    got = {}
    for pkg, Sm in (("torch", S), ("jax", JS)):
        ref = str(tmp_path / f"{pkg}_ref.mp4")
        _run(pkg, _job(Sm, src, ref, bframes=2, quality=28.0))
        out = str(tmp_path / f"{pkg}.mp4")
        _crashed_run(monkeypatch, pkg, Sm, src, out, 2, bframes=2,
                     quality=28.0)
        _run(pkg, _job(Sm, src, out, resume=True, bframes=2, quality=28.0))
        got[pkg] = []
        for p in (ref, out):
            d = MP4Demuxer(p)
            got[pkg].append([bytes(d.read_sample(0, k).data)
                             for k in range(d.n_samples(0))])
            d.close()
        if pkg == "torch":
            assert _bytes(out) == _bytes(ref)
    assert got["torch"][0] == got["jax"][0]
    jref, jout = got["jax"]
    assert [k for k in range(n) if jref[k] != jout[k]] == [8, 12, 16, 20]


@pytest.mark.parametrize("rate", [False, True], ids=["quality", "2pass"])
def test_gop_parallel_resume_mid_window(y4m, tmp_path, monkeypatch, rate):
    """gop_parallel=2, keyint 4: windows of 8 frames.  The port's journal
    marks only each window's first frame, so a crash in the middle of the
    second window resumes at its start and the file equals the
    uninterrupted one (with a multipass bitrate too, which budgets each
    window).  The reference marks every GOP's IDR: resumed at frame 12 it
    codes the last 4 frames as one window of two GOPs of 2, where its
    uninterrupted run coded one GOP of 4, and its file differs there."""
    kw = dict(gop_parallel=2)
    if rate:
        kw.update(quality=None, vbitrate=300, multipass=True)
    ref = str(tmp_path / "ref.mp4")
    _run("torch", _job(S, y4m, ref, **kw))
    out = str(tmp_path / "gp.mp4")
    with monkeypatch.context() as m:
        _crash(m, "torch")
        _run("torch", _job(S, y4m, out, checkpoint=True, **kw))
    assert _port_marked_frames(_bytes(out + ".ckpt")) == [8]
    _cut("torch", out + ".ckpt", 1, stale=3)        # frames 8-10 kept
    os.unlink(out)
    stats = _run("torch", _job(S, y4m, out, resume=True, **kw))
    assert stats["frames_out"] == N - 8
    assert _bytes(out) == _bytes(ref)
    if rate:
        return
    jref = str(tmp_path / "jref.mp4")
    _run("jax", _job(JS, y4m, jref, **kw))
    assert _bytes(jref) == _bytes(ref)
    jout = str(tmp_path / "jgp.mp4")
    _crashed_run(monkeypatch, "jax", JS, y4m, jout, 3, **kw)
    _run("jax", _job(JS, y4m, jout, resume=True, **kw))
    want, got = _samples(jref), _samples(jout)
    assert len(got) == N and got[:12] == want[:12] and got[12:] != want[12:]


def test_ranged_resume_keeps_the_range(y4m, tmp_path, monkeypatch):
    """A job over source frames 3-14 (12 frames, keyint 4) cut after its
    first GOP resumes at source frame 7 and stops at 14: the file equals
    the uninterrupted one.  The reference resumes at source frame 5 (its
    frame n_done + 1) and runs to the end of the source: 16 samples, the
    resumed ones not the job's frames."""
    files = {}
    for pkg, Sm in (("torch", S), ("jax", JS)):
        kw = dict(range=Sm.RangeSpec("frame", 3, 14))
        ref = str(tmp_path / f"{pkg}_ref.mp4")
        _run(pkg, _job(Sm, y4m, ref, **kw))
        out = str(tmp_path / f"{pkg}.mp4")
        _crashed_run(monkeypatch, pkg, Sm, y4m, out, 1,
                     range=Sm.RangeSpec("frame", 3, 14))
        _run(pkg, _job(Sm, y4m, out, resume=True, **kw))
        files[pkg] = (_samples(ref), _samples(out))
    want, got = files["torch"]
    assert len(want) == 12 and got == want
    assert files["jax"][0] == want
    jgot = files["jax"][1]
    assert len(jgot) == 16 and jgot[:4] == want[:4] and jgot[4:12] != want[4:]


def test_abr_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A single-pass bitrate job resumes equal to its uninterrupted run:
    the journal keeps the rate controller's state from the GOP boundary,
    before the IDR's qp is chosen.  (The reference takes it on the mux
    thread when it commits, frames later; the port with that state
    resumes to a different file.)"""
    src = write_y4m(str(tmp_path / "abr.y4m"), make_clip(W, H, 24, seed=3),
                    W, H, 0, FPS)
    kw = dict(quality=None, vbitrate=200)
    ref = str(tmp_path / "ref.mp4")
    _run("torch", _job(S, src, ref, **kw))
    out = str(tmp_path / "abr.mp4")
    _crashed_run(monkeypatch, "torch", S, src, out, 3, **kw)
    _run("torch", _job(S, src, out, resume=True, **kw))
    assert _bytes(out) == _bytes(ref)


def test_cli_and_handle_resume(y4m, tmp_path, monkeypatch):
    """--checkpoint, then --resume through both CLIs: equal files; a
    Handle job with resume gives the same file."""
    argv = ["-e", "h264", "-q", "30", "-x", KEYINT]
    files = {}
    for pkg, main in (("torch", cli), ("jax", jcli)):
        extra = ["--device", "cpu"] if pkg == "torch" else []
        out = str(tmp_path / f"{pkg}.mp4")
        with monkeypatch.context() as m:
            _crash(m, pkg)
            assert main(["-i", y4m, "-o", out, "--checkpoint"] + argv
                        + extra) == 0
        _cut(pkg, out + ".ckpt", 2)
        os.unlink(out)
        assert main(["-i", y4m, "-o", out, "--resume"] + argv + extra) == 0
        files[pkg] = _bytes(out)
    assert files["torch"] == files["jax"]
    out = str(tmp_path / "handle.mp4")
    with monkeypatch.context() as m:
        _crash(m, "torch")
        _run("torch", _job(S, y4m, out, checkpoint=True))
    _cut("torch", out + ".ckpt", 1)
    os.unlink(out)
    h = Handle(device="cpu")
    h.add(_job(S, y4m, out, resume=True))
    h.start()
    assert h.work_wait(120) == 0, h.work_exception
    plain = str(tmp_path / "plain.mp4")
    _run("torch", _job(S, y4m, plain))
    assert _bytes(out) == _bytes(plain)
