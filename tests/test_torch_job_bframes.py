"""B-frame jobs and an H.264 source's HDR/T.35 SEIs on the port's job path
(on the CPU), held against the JAX package byte for byte:

- a y4m clip (96x64) through ``do_job`` with ``bframes`` to mp4 (decode
  order differs from display order, ctts offsets non-zero) and to mkv,
  through the CLI's ``--bframes`` and through ``Handle``; the mp4's
  stream decodes to the walker's reconstructions;
- a B-frame job with a bitrate or multipass target raises ``WorkError``
  in the port, where the reference encodes it at the constant qp and
  ignores the target; so does one with ``cabac=1``, ``deblock=1`` or
  ``8x8dct=1`` (through ``do_job``, ``Handle`` and the CLI, no file
  left), where the reference's file equals its plain job's; a High
  profile alone runs, equal to the reference, with a log line;
- an H.264 mp4 source that carries mastering-display (137),
  content-light (144) and T.35 (4) SEIs: the port writes them again as
  the reference does (137/144 on IDRs and in the mp4's mdcv/clli boxes,
  T.35 on the next decoded frame), to mp4 and to mkv; a B-frame job of it
  writes no SEI in either package.
"""
import functools
import os

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs import hdr as jhdr
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs.h264.bits import ebsp_to_rbsp, split_annexb
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.codecs.h264.native_decoder import NativeH264Decoder
from handbrake_tpu_torch.codecs.hdr import parse_sei_messages
from handbrake_tpu_torch.hb import Handle
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
from torch_rates import reference_reads_mp4_rate  # noqa: F401  (a fixture)

W, H, N = 96, 64, 11
FRAME = 3000


@pytest.fixture(scope="module", autouse=True)
def _reference_device_path():
    """The reference encodes its non-B jobs on its device path, as the
    port does, with one analyzer compile a shape in this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        yield


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tbjob") / "in.y4m")
    return write_y4m(path, make_clip(W, H, N, seed=2), W, H)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _bjob(Sm, path, out, mux, **kw):
    return Sm.Job(path=path, file=out, mux=mux, vcodec="h264",
                  quality=28.0, bframes=kw.pop("bframes", 2), **kw)


def _video_samples(path):
    """(annex-B samples in decode order, their cts offsets, the SPS and
    PPS of the avcC as annex-B)."""
    d = MP4Demuxer(path)
    try:
        n = d.n_samples(0)
        return ([bytes(d.read_sample(0, i).data) for i in range(n)],
                list(d._samples[0].cts_offsets),
                _avcc_to_annexb(d.tracks[0].extradata))
    finally:
        d.close()


def _avcc_to_annexb(avcc: bytes) -> bytes:
    out, i = b"", 5
    for _ in range(2):                  # the SPS, then the PPS array
        n = avcc[i] & 0x1F
        i += 1
        for _ in range(n):
            ln = int.from_bytes(avcc[i:i + 2], "big")
            out += b"\x00\x00\x00\x01" + avcc[i + 2:i + 2 + ln]
            i += 2 + ln
    return out


B_JOBS = {"mp4": dict(), "mkv": dict(),
          "mp4-keyint-b3": dict(bframes=3, encoder_options="keyint=5")}


@pytest.mark.parametrize("case", list(B_JOBS))
def test_b_job_equals_reference(src, tmp_path, monkeypatch, case):
    mux = case[:3]
    jout, tout = str(tmp_path / f"ref.{mux}"), str(tmp_path / f"port.{mux}")
    jstats = jwork.do_job(_bjob(JS, src, jout, mux, **B_JOBS[case]))
    recons = {}
    release = work._BFrameEncoderAdapter._release

    def spy(self, aus):
        for d, _au in aus:
            recons[d] = self.benc.recons[d]
        return release(self, aus)
    monkeypatch.setattr(work._BFrameEncoderAdapter, "_release", spy)
    tstats = work.do_job(_bjob(S, src, tout, mux, **B_JOBS[case]),
                         device="cpu")
    assert tstats == jstats and tstats["frames_out"] == N
    assert _bytes(tout) == _bytes(jout)
    if mux != "mp4":
        return
    samples, cts, params = _video_samples(tout)
    assert len(samples) == N and any(cts) and sorted(recons) == \
        list(range(N))
    got = NativeH264Decoder().decode(params + b"".join(samples))
    assert len(got) == N
    for d, planes in enumerate(got):
        for g, want in zip(planes, recons[d]):
            assert np.array_equal(g, want[:g.shape[0], :g.shape[1]]), d


def test_b_cli_equals_reference(src, tmp_path):
    argv = ["-i", src, "-e", "h264", "-q", "28", "--bframes", "2"]
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    assert jcli(argv + ["-o", jout]) == 0
    assert cli(argv + ["-o", tout, "--device", "cpu"]) == 0
    assert _bytes(tout) == _bytes(jout)
    assert any(_video_samples(tout)[1])


def test_b_handle_equals_do_job(src, tmp_path):
    direct, out = str(tmp_path / "direct.mkv"), str(tmp_path / "handle.mkv")
    work.do_job(_bjob(S, src, direct, "mkv"), device="cpu")
    h = Handle(device="cpu")
    h.add(_bjob(S, src, out, "mkv"))
    h.start()
    assert h.work_wait(120) == 0 and h.work_exception is None
    h.close()
    assert _bytes(out) == _bytes(direct)


@pytest.mark.parametrize("target", [dict(vbitrate=60),
                                    dict(vbitrate=60, multipass=True)],
                         ids=["bitrate", "multipass"])
def test_b_job_with_a_rate_target_raises(src, tmp_path, target):
    """The reference's file ignores the target: it equals the file of
    the same job at the constant qp its walker uses (quality 26 when no
    quality is given).  The port refuses the job."""
    ref_t, ref_q = str(tmp_path / "t.mp4"), str(tmp_path / "q.mp4")
    jt = _bjob(JS, src, ref_t, "mp4", **target)
    jt.quality = None
    jwork.do_job(jt)
    jq = _bjob(JS, src, ref_q, "mp4")
    jq.quality = 26.0
    jwork.do_job(jq)
    assert _bytes(ref_t) == _bytes(ref_q)
    t = _bjob(S, src, str(tmp_path / "port.mp4"), "mp4", **target)
    t.quality = None
    with pytest.raises(work.WorkError, match="bitrate"):
        work.do_job(t, device="cpu")


B_OFF = {"cabac": "cabac=1", "deblock": "deblock=1", "8x8dct": "8x8dct=1"}


@pytest.fixture(scope="module")
def plain(src, tmp_path_factory):
    """The plain B-frame job's mp4 from each package: {pkg: bytes}."""
    d = tmp_path_factory.mktemp("plain")
    jwork.do_job(_bjob(JS, src, str(d / "ref.mp4"), "mp4"))
    work.do_job(_bjob(S, src, str(d / "port.mp4"), "mp4"), device="cpu")
    return {pkg: _bytes(str(d / f"{pkg}.mp4")) for pkg in ("ref", "port")}


@pytest.mark.parametrize("setting", list(B_OFF))
def test_b_job_ignores_cabac_deblock_and_8x8(src, plain, tmp_path, setting):
    """The reference's B walker codes CAVLC with the in-loop filter off
    and no 8x8 transform whatever the options ask: its file of a job
    with the setting equals its plain job's file.  The port refuses the
    setting, naming it, and writes no file."""
    ref = str(tmp_path / "ref.mp4")
    jwork.do_job(_bjob(JS, src, ref, "mp4",
                       encoder_options=B_OFF[setting]))
    assert _bytes(ref) == plain["ref"]
    out = str(tmp_path / "port.mp4")
    with pytest.raises(work.WorkError, match=rf"cannot take "
                       rf"{B_OFF[setting]}: the B-frame walker codes CAVLC "
                       rf"with no in-loop filter and no 8x8 transform"):
        work.do_job(_bjob(S, src, out, "mp4", encoder_profile="high",
                          encoder_options=f"keyint=5:{B_OFF[setting]}"),
                    device="cpu")
    assert not os.path.exists(out)


@pytest.mark.parametrize("setting", list(B_OFF))
def test_b_cli_refuses_setting(src, tmp_path, capsys, setting):
    """The CLI's --bframes with -x asking for the setting exits non-zero
    with the message and leaves no file."""
    out = str(tmp_path / "port.mp4")
    assert cli(["-i", src, "-o", out, "-e", "h264", "-q", "28",
                "--bframes", "2", "-x", B_OFF[setting],
                "--device", "cpu"]) != 0
    assert f"cannot take {B_OFF[setting]}: the B-frame walker codes " \
        f"CAVLC" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_b_handle_refuses_all_three(src, tmp_path):
    out = str(tmp_path / "handle.mp4")
    h = Handle(device="cpu")
    h.add(_bjob(S, src, out, "mp4",
                encoder_options="cabac=1:deblock=-1,-1:8x8dct=1"))
    h.start()
    assert h.work_wait(120) != 0
    h.close()
    assert isinstance(h.work_exception, work.WorkError)
    assert "cannot take cabac=1, deblock=-1,-1, 8x8dct=1" in \
        str(h.work_exception)
    assert not os.path.exists(out)


@pytest.mark.parametrize("opts", ["cabac=0:deblock=0:8x8dct=0",
                                  "keyint=22"], ids=["off", "other"])
def test_b_job_takes_settings_it_codes(src, plain, tmp_path, opts):
    """Options that ask for what the walker codes run, and give the plain
    job's file, which equals the reference's."""
    out = str(tmp_path / "port.mp4")
    work.do_job(_bjob(S, src, out, "mp4", encoder_options=opts),
                device="cpu")
    assert _bytes(out) == plain["port"] == plain["ref"]


def test_b_cli_high_profile_equals_reference(src, tmp_path, capsys):
    """A High-profile --bframes job runs: the port's file equals the
    reference's byte for byte, its SPS says Main (profile_idc 77) as the
    reference's does, and the port logs that the profile's CABAC and
    8x8 transform are not applied."""
    argv = ["-i", src, "-e", "h264", "-q", "28", "--bframes", "2",
            "--encoder-profile", "high"]
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    assert jcli(argv + ["-o", jout]) == 0
    capsys.readouterr()
    assert cli(argv + ["-o", tout, "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert _bytes(tout) == _bytes(jout)
    assert "the B-frame walker codes CAVLC with no in-loop filter and no " \
        "8x8 transform, so profile high's CABAC and 8x8 transform are " \
        "not applied" in err
    params = _video_samples(tout)[2]
    assert params[4] & 0x1F == 7 and params[5] == 77
    assert _video_samples(jout)[2][5] == 77


# ---------------------------------------------------------------------------
# SEI metadata of an H.264 source
# ---------------------------------------------------------------------------
MASTERING = bytes(range(1, 25))
CLL = b"\x03\xe8\x01\x90"


def _t35(k):
    """A T.35 payload a frame, with a 00 00 03 run for the emulation
    prevention to escape."""
    return b"\xb5\x00\x3c\x00\x01\x04\x00\x00\x03" + bytes([k, 0x40 + k])


@pytest.fixture(scope="module")
def sei_src(tmp_path_factory):
    """An mp4 of the clip (port's encoder, CAVLC P frames) whose first
    access unit carries 137, 144 and T.35 SEIs and every other a T.35
    SEI of its own; the SEI NALs come from the JAX package's hdr_nals."""
    path = str(tmp_path_factory.mktemp("tsei") / "hdr.mp4")
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=24, gop=N),
                      device="cpu")
    w = MP4Writer(path)
    vi = w.add_video_track(codec="h264", width=W, height=H)
    for k, f in enumerate(make_clip(W, H, N, seed=8)):
        sd = {"hdr10plus_t35": _t35(k)}
        if k == 0:
            sd.update(mastering_display=MASTERING, content_light=CLL)
        pre, _post = jhdr.hdr_nals(sd, "h264")
        w.write_sample(vi, pre + enc.encode_frame(*f), duration=FRAME,
                       sync=k == 0, annexb=True)
    w.finalize()
    return path


def _sei_payloads(samples):
    """Per sample, the SEI messages' (type, payload) in order."""
    out = []
    for s in samples:
        msgs = []
        for nal in split_annexb(s):
            if nal and (nal[0] & 0x1F) == 6:
                msgs += [(pt, bytes(p)) for pt, p in
                         parse_sei_messages(ebsp_to_rbsp(nal[1:]))]
        out.append(msgs)
    return out


@pytest.mark.parametrize("mux", ["mp4", "mkv"])
def test_sei_job_equals_reference(sei_src, tmp_path, mux,
                                  reference_reads_mp4_rate):
    """The mp4 source's samples last 3000 ticks, so the port labels it 30
    fps from its stts, and the reference is given that rate
    (``torch_rates``)."""
    def job(Sm, out):
        return Sm.Job(path=sei_src, file=out, mux=mux, vcodec="h264",
                      quality=28.0, encoder_profile="high",
                      encoder_options="keyint=4")
    jout, tout = str(tmp_path / f"ref.{mux}"), str(tmp_path / f"port.{mux}")
    jwork.do_job(job(JS, jout))
    work.do_job(job(S, tout), device="cpu")
    assert _bytes(tout) == _bytes(jout)
    if mux != "mp4":
        return
    data = _bytes(tout)
    assert b"mdcv" + MASTERING in data and b"clli" + CLL in data
    seis = _sei_payloads(_video_samples(tout)[0])
    for k, msgs in enumerate(seis):
        static = [(137, MASTERING), (144, CLL)] if k % 4 == 0 else []
        # a source T.35 rides the next frame the decoder gives out: here,
        # with no reorder delay, its own
        assert msgs == static + [(4, _t35(k))], k


def test_b_job_writes_no_sei(sei_src, tmp_path, reference_reads_mp4_rate):
    """The reference writes SEIs only for an encoder whose class name
    holds "H264"; its B-frame adapter's does not, so neither package
    writes them on a B-frame job (a fault the two share).  The source's
    30 fps is the reference's too, as above."""
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    jwork.do_job(_bjob(JS, sei_src, jout, "mp4"))
    work.do_job(_bjob(S, sei_src, tout, "mp4"), device="cpu")
    assert _bytes(tout) == _bytes(jout)
    samples, cts, _params = _video_samples(tout)
    assert len(samples) == N and any(cts)
    assert not any(_sei_payloads(samples))


class _Sync:
    """What the decode stage asks of its synchronizer: frames it queues
    are kept, and EOF yields nothing more."""
    streams = ()

    class cadence:
        @staticmethod
        def stats():
            return {"cadence": "progressive", "breaks": 0}
        info = stats

    def __init__(self):
        self.frames = []

    def queue(self, _sid, f):
        self.frames.append(f)

    def set_eof(self, _idx):
        pass

    def poll(self):
        return []


class _HoldingDecoder:
    """A decoder that gives out nothing until EOF, as one with a
    reorder delay does with its last frames."""

    def __init__(self, buffer_cls):
        self.buffer_cls, self.fed = buffer_cls, 0

    def feed(self, _buf):
        self.fed += 1
        return []

    def flush(self):
        return [self.buffer_cls(track_kind="video", pts=k * FRAME,
                                duration=FRAME) for k in range(self.fed)]


@pytest.mark.parametrize("pkg", [jwork, work], ids=["jax", "torch"])
def test_flush_attaches_held_sei_to_every_frame(pkg):
    """Frames drained at EOF each carry the SEIs read so far, the last
    T.35 included, in both packages."""
    sync = _Sync()
    dec = _HoldingDecoder(pkg.Buffer)
    stage = pkg._DecodeSyncStage(0, dec, {}, sync, 0, {}, {"frames_in": 0},
                                 vcodec="h264")
    for k in range(3):
        sd = {"hdr10plus_t35": _t35(k)}
        if k == 0:
            sd.update(mastering_display=MASTERING, content_light=CLL)
        pre, _post = jhdr.hdr_nals(sd, "h264")
        au = pkg.Buffer(track_kind="video", pts=k * FRAME)
        au.data, au.stream_id = pre, 0
        stage.work(au)
    stage.work(pkg.Buffer.eof())
    assert [f.side_data for f in sync.frames] == [
        {"mastering_display": MASTERING, "content_light": CLL,
         "hdr10plus_t35": _t35(2)}] * 3
