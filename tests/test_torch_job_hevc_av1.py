"""HEVC and AV1 jobs on the port's job path, on the CPU, held against the
JAX package (its device path) byte for byte.  Tolerance: none; every
output file is compared for equality.

- A y4m clip (96x64) through ``do_job`` to HEVC (Main, Main 10) and AV1,
  into mp4 and mkv, and through the CLI (``--device cpu``): ``-e x265``,
  ``-e svt_av1``, ``--encoder-profile main10``, ``-Z "H.265 MKV
  1080p30"`` and ``-Z "AV1 MKV 1080p30"``.
- HEVC and AV1 sources, through ``do_job`` and the CLI: a ``.265``
  elementary stream, HEVC in a TS
  (stream type 0x24; the reference reads no geometry from its SPS and
  fails, so the port's file is held to the same job from the
  elementary stream), an HEVC mp4 whose access units carry
  mastering-display, content-light and T.35 SEIs and a Dolby Vision RPU
  (written again as the reference writes them: the SEIs ahead of the
  access unit, the RPU after it), and AV1 mkv and mp4 (av01) files.
- Checkpoint/resume of an HEVC and an AV1 job (``keyint=4``, the journal
  cut after two GOPs): the resumed file equals the uninterrupted run and
  the reference's resumed file.
- The refusals: ``gop_parallel`` with HEVC or AV1 raises WorkError,
  where the reference logs that it ignores the request and codes the job
  serially; ``bframes`` with HEVC or AV1 raises WorkError, where the
  reference codes I and P frames without a word;
  an HEVC source beyond the native decoder's subset raises ValueError
  naming ROADMAP item 1.10.
"""
import functools
import os

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs.av1 import encoder_tpu as jav1_tpu
from handbrake_tpu.codecs.h264 import encoder_tpu as jh264_tpu
from handbrake_tpu.codecs.hevc import encoder_tpu as jhevc_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs.h264.bits import split_annexb
from handbrake_tpu_torch.codecs.hdr import hdr_nals
from handbrake_tpu_torch.codecs.hevc.encoder import EncoderConfig, HEVCEncoder
from handbrake_tpu_torch.hb import Handle
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.tools import source_builders as B
from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
from handbrake_tpu_torch.work import WorkError
from test_torch_checkpoint import _crash, _cut
from test_torch_hevc import sao_stream
from torch_rates import reference_reads_rate  # noqa: F401  (a fixture)

W, H, N = 96, 64, 6
FRAME = 3003
T0 = 90000


@pytest.fixture(scope="module", autouse=True)
def _reference_device_path():
    """The reference encodes on its device path, as the port does (some
    pre-port test files leave HB_TPU_DISABLE_DEVICE=1 set in their
    worker); its encoders of one shape share one jitted analyzer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        mp.setattr(jhevc_tpu, "build_ctu_analyzer",
                   functools.lru_cache(None)(jhevc_tpu.build_ctu_analyzer))
        mp.setattr(jav1_tpu, "build_me",
                   functools.lru_cache(None)(jav1_tpu.build_me))
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(jh264_tpu, name,
                       functools.lru_cache(None)(getattr(jh264_tpu, name)))
        yield


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hvjob") / "in.y4m")
    return write_y4m(path, make_clip(W, H, N, seed=2), W, H)


@pytest.fixture(scope="module")
def src10(tmp_path_factory):
    """The clip as a 10-bit y4m (samples x 4 plus two low bits)."""
    path = str(tmp_path_factory.mktemp("hvjob10") / "in10.y4m")
    rng = np.random.default_rng(7)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30000:1001 Ip A1:1 C420p10\n"
                .encode())
        for planes in make_clip(W, H, N, seed=2):
            f.write(b"FRAME\n")
            for p in planes:
                f.write(((p.astype("<u2") << 2)
                         | rng.integers(0, 4, p.shape).astype("<u2"))
                        .tobytes())
    return path


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _job(Sm, path, out, mux, vcodec, **kw):
    return Sm.Job(path=path, file=out, mux=mux, vcodec=vcodec, quality=28.0,
                  **kw)


def _both(path, tmp_path, mux, vcodec, **kw):
    """The same job through both packages: (port stats, ref stats, port
    file bytes, ref file bytes)."""
    jout, tout = str(tmp_path / f"ref.{mux}"), str(tmp_path / f"port.{mux}")
    jstats = jwork.do_job(_job(JS, path, jout, mux, vcodec, **kw))
    tstats = work.do_job(_job(S, path, tout, mux, vcodec, **kw),
                         device="cpu")
    return tstats, jstats, _bytes(tout), _bytes(jout)


Y4M_JOBS = {
    "hevc-mp4": ("mp4", "hevc_tpu", {}),
    "hevc-mkv": ("mkv", "x265", {}),
    "hevc-main10-mkv": ("mkv", "hevc", {"encoder_profile": "main10"}),
    "hevc-keyint3-mp4": ("mp4", "h265", {"encoder_options": "keyint=3"}),
    "av1-mp4": ("mp4", "av1_tpu", {}),
    "av1-mkv": ("mkv", "svt_av1", {}),
    "av1-keyint3-mkv": ("mkv", "av1", {"encoder_options": "keyint=3"}),
}


@pytest.mark.parametrize("case", list(Y4M_JOBS))
def test_y4m_job_equals_reference(src, tmp_path, case):
    mux, vcodec, kw = Y4M_JOBS[case]
    tstats, jstats, got, want = _both(src, tmp_path, mux, vcodec, **kw)
    assert tstats == jstats and tstats["frames_out"] == N
    assert got == want


def test_main10_y4m_job_equals_reference(src10, tmp_path):
    """A 10-bit source into Main 10: the encoder takes the 10-bit planes
    (and into Main, 8-bit planes shifted down) as the reference does."""
    for prof in ("main10", "main"):
        tstats, jstats, got, want = _both(src10, tmp_path, "mp4", "x265",
                                          encoder_profile=prof)
        assert tstats == jstats and got == want


CLI_JOBS = {
    "x265": ["-e", "x265", "-q", "30"],
    "svt_av1": ["-e", "svt_av1", "-q", "30", "-f", "mkv"],
    "x265-main10": ["-e", "x265", "--encoder-profile", "main10"],
    "preset-hevc": ["-Z", "H.265 MKV 1080p30"],
    "preset-av1": ["-Z", "AV1 MKV 1080p30"],
}


@pytest.mark.parametrize("case", list(CLI_JOBS))
def test_cli_equals_reference(src, tmp_path, case):
    ext = "mkv" if case.startswith("preset") or case == "svt_av1" else "mp4"
    jout, tout = str(tmp_path / f"ref.{ext}"), str(tmp_path / f"port.{ext}")
    assert jcli(["-i", src, "-o", jout, *CLI_JOBS[case]]) == 0
    assert cli(["-i", src, "-o", tout, *CLI_JOBS[case],
                "--device", "cpu"]) == 0
    assert _bytes(tout) == _bytes(jout)


def test_handle_hevc_job_equals_reference(src, tmp_path):
    """An HEVC job through ``Handle`` (scan, then work on its threads)."""
    out = str(tmp_path / "h.mkv")
    h = Handle(device="cpu")
    h.add(_job(S, src, out, "mkv", "x265"))
    h.start()
    assert h.work_wait(120) == 0 and h.work_exception is None
    h.close()
    jout = str(tmp_path / "ref.mkv")
    jwork.do_job(_job(JS, src, jout, "mkv", "x265"))
    assert _bytes(out) == _bytes(jout)


# ---------------------------------------------------------------------------
# HEVC and AV1 sources
# ---------------------------------------------------------------------------
MASTERING = bytes(range(1, 25))
CLL = b"\x03\xe8\x01\x90"
T35 = b"\xb5\x00\x3c\x00\x01\x04\x01\x40"


def _hevc_aus(n=N, seed=3):
    enc = HEVCEncoder(EncoderConfig(width=W, height=H, qp=30, gop=4),
                      device="cpu")
    return [enc.encode_frame(*f) for f in make_clip(W, H, n, seed=seed)]


def _hdr_aus():
    """The access units with prefix SEIs (mastering display and content
    light on IDRs, T.35 on every frame) ahead and an RPU after."""
    out = []
    for i, au in enumerate(_hevc_aus()):
        sd = {"hdr10plus_t35": T35 + bytes([i]),
              "dovi_rpu": b"\x19\x08\x09" + bytes([i, 0x80])}
        if i % 4 == 0:
            sd.update(mastering_display=MASTERING, content_light=CLL)
        pre, post = hdr_nals(sd, "hevc")
        out.append(pre + au + post)
    return out


def _write_mp4(path, codec, aus):
    w = MP4Writer(path)
    v = w.add_video_track(codec=codec, width=W, height=H)
    for i, au in enumerate(aus):
        w.write_sample(v, au, duration=FRAME, sync=i % 4 == 0, annexb=True)
    w.finalize()
    return path


@pytest.fixture(scope="module")
def sources(tmp_path_factory, src):
    d = tmp_path_factory.mktemp("hvsrc")
    es = str(d / "clip.265")
    with open(es, "wb") as f:
        f.write(b"".join(_hevc_aus()))
    ts, ts_es = str(d / "clip.ts"), str(d / "clip4.265")
    aus = _hevc_aus(seed=4)
    units = [(T0 + i * FRAME, 0x100, 0xE0, au, T0 + i * FRAME)
             for i, au in enumerate(aus)]
    with open(ts, "wb") as f:
        f.write(B.build_ts([(0x24, 0x100, b"")], units))
    with open(ts_es, "wb") as f:
        f.write(b"".join(aus))
    hdr = _write_mp4(str(d / "hdr.mp4"), "hevc", _hdr_aus())
    av1, av1_mp4 = str(d / "av1.mkv"), str(d / "av1.mp4")
    work.do_job(_job(S, src, av1, "mkv", "av1"), device="cpu")
    work.do_job(_job(S, src, av1_mp4, "mp4", "av1"), device="cpu")
    return {"es": es, "ts": ts, "ts_es": ts_es, "hdr": hdr, "av1": av1,
            "av1_mp4": av1_mp4}


SOURCE_JOBS = {
    "es-to-h264-mp4": ("es", "mp4", "h264", {"encoder_profile": "high"}),
    "es-to-hevc-mkv": ("es", "mkv", "hevc", {}),
    "hdr-to-hevc-mkv": ("hdr", "mkv", "hevc", {}),
    "hdr-to-hevc-mp4": ("hdr", "mp4", "hevc", {}),
    "hdr-to-h264-mp4": ("hdr", "mp4", "h264", {}),
    "av1-to-h264-mp4": ("av1", "mp4", "h264", {}),
    "av01-mp4-to-hevc-mkv": ("av1_mp4", "mkv", "hevc", {}),
}


@pytest.mark.parametrize("case", list(SOURCE_JOBS))
def test_source_job_equals_reference(sources, tmp_path, case,
                                     reference_reads_rate):
    """The .265 states its rate, which the port reads and the reference
    is given (``torch_rates``)."""
    name, mux, vcodec, kw = SOURCE_JOBS[case]
    tstats, jstats, got, want = _both(sources[name], tmp_path, mux, vcodec,
                                      **kw)
    assert tstats == jstats and tstats["frames_out"] == N
    assert got == want


def _mkv_samples(path):
    d = MKVDemuxer(path)
    try:
        return [bytes(b.data) for t, b in d.packets() if t == 0]
    finally:
        d.close()


def test_hevc_ts_source_repairs_reference_geometry(sources, tmp_path):
    """HEVC in a TS: the port reads the picture size from the SPS and
    codes the frames the reference codes from the same stream as an
    elementary stream; the reference reads no HEVC SPS in a TS, leaves
    the track 0x0 and fails in its encoder's SPS."""
    from handbrake_tpu_torch.sources.probe import open_source
    src = open_source(sources["ts"])
    try:
        assert (src.tracks[0].codec, src.tracks[0].width,
                src.tracks[0].height) == ("hevc", W, H)
    finally:
        src.close()
    out, jout = str(tmp_path / "ts.mkv"), str(tmp_path / "es.mkv")
    stats = work.do_job(_job(S, sources["ts"], out, "mkv", "h264"),
                        device="cpu")
    jwork.do_job(_job(JS, sources["ts_es"], jout, "mkv", "h264"))
    assert stats["frames_out"] == N
    assert _mkv_samples(out) == _mkv_samples(jout)
    with pytest.raises(AssertionError):
        jwork.do_job(_job(JS, sources["ts"], str(tmp_path / "r.mkv"), "mkv",
                          "h264"))


def test_cropped_hevc_es_keeps_the_picture_size(tmp_path):
    """A .265 whose picture (96x72) is smaller than its coded size
    (96x96): the port's job codes 96x72; the reference takes the coded
    size and codes 96x96."""
    enc = HEVCEncoder(EncoderConfig(width=96, height=72, qp=30),
                      device="cpu")
    es = str(tmp_path / "c.265")
    with open(es, "wb") as f:
        f.write(b"".join(enc.encode_frame(*fr)
                         for fr in make_clip(96, 72, 3, seed=1)))
    stats = work.do_job(_job(S, es, str(tmp_path / "p.mp4"), "mp4", "h264"),
                        device="cpu")
    jstats = jwork.do_job(_job(JS, es, str(tmp_path / "r.mp4"), "mp4",
                               "h264"))
    assert (stats["width"], stats["height"]) == (96, 72)
    assert (jstats["width"], jstats["height"]) == (96, 96)


@pytest.mark.parametrize("name,argv", [
    ("es", ["-e", "x265", "-q", "30"]),
    ("hdr", ["-e", "hevc", "-f", "mkv"]),
    ("av1", ["-e", "h264", "--encoder-profile", "high"])],
    ids=["es-to-hevc", "hdr-to-hevc-mkv", "av1-to-h264"])
def test_cli_source_equals_reference(sources, tmp_path, name, argv,
                                     reference_reads_rate):
    """The CLI (scan with its previews, then the job) on HEVC and AV1
    sources; the reference is given the .265's stated rate."""
    jout, tout = str(tmp_path / "ref.out"), str(tmp_path / "port.out")
    assert jcli(["-i", sources[name], "-o", jout, *argv]) == 0
    assert cli(["-i", sources[name], "-o", tout, *argv, "--device",
                "cpu"]) == 0
    assert _bytes(tout) == _bytes(jout)


def _nal_types(au):
    return [(n[0] >> 1) & 0x3F for n in split_annexb(au)]


def test_hdr_source_writes_seis_and_rpu(sources, tmp_path):
    """The HEVC job of the HDR source: a prefix SEI (39) ahead of every
    access unit and the RPU (62) after it, and the mp4's mdcv/clli from
    the source's metadata."""
    out = str(tmp_path / "hdr.mp4")
    work.do_job(_job(S, sources["hdr"], out, "mp4", "hevc"), device="cpu")
    d = MP4Demuxer(out)
    try:
        aus = [bytes(d.read_sample(0, k).data) for k in range(d.n_samples(0))]
        assert len(aus) == N
        for au in aus:
            t = _nal_types(au)
            assert t[0] == 39 and t[-1] == 62 and t.count(62) == 1
    finally:
        d.close()
    data = _bytes(out)
    assert b"mdcv" in data and b"clli" in data and MASTERING in data


def test_av1_mkv_carries_av1c(tmp_path, src):
    out = str(tmp_path / "a.mkv")
    work.do_job(_job(S, src, out, "mkv", "av1"), device="cpu")
    d = MKVDemuxer(out)
    try:
        ti = d.tracks[0]
        assert ti.codec == "av1" and bytes(ti.extradata)[:1] == b"\x81"
    finally:
        d.close()


def test_beyond_subset_source_raises(tmp_path, monkeypatch):
    """An HEVC elementary stream with SAO on, where libavcodec is
    missing: the port's job raises ValueError naming ROADMAP item 1.10
    and the library before it encodes a frame (with the library it
    switches to it)."""
    from torch_catalog import hide
    hide(monkeypatch, tmp_path)
    es = str(tmp_path / "sao.265")
    with open(es, "wb") as f:
        f.write(sao_stream())
    with pytest.raises(ValueError, match=r"SAO unsupported.*item 1\.10.*"
                       r"libavcodec is missing"):
        work.do_job(_job(S, es, str(tmp_path / "x.mp4"), "mp4", "h264"),
                    device="cpu")


# ---------------------------------------------------------------------------
# checkpoint/resume
# ---------------------------------------------------------------------------
RN = 12


@pytest.fixture(scope="module")
def src12(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hvres") / "in.y4m")
    return write_y4m(path, make_clip(W, H, RN, seed=8), W, H)


def _run(pkg, job):
    if pkg == "torch":
        return work.do_job(job, device="cpu")
    return jwork.do_job(job)


@pytest.mark.parametrize("mux", ["mp4", "mkv"])
@pytest.mark.parametrize("vcodec", ["hevc", "av1"])
def test_resume_equals_uninterrupted(src12, tmp_path, monkeypatch, vcodec,
                                     mux):
    """keyint 4, the journal cut after two GOPs: each package's resumed
    file equals its uninterrupted run, and the two packages' files are
    equal (the walkers carry no state across an IDR that a resume would
    have to restore)."""
    files = {}
    for pkg, Sm in (("torch", S), ("jax", JS)):
        full = str(tmp_path / f"{pkg}_full.{mux}")
        _run(pkg, _job(Sm, src12, full, mux, vcodec,
                       encoder_options="keyint=4"))
        out = str(tmp_path / f"{pkg}_ck.{mux}")
        with monkeypatch.context() as m:
            _crash(m, pkg)
            _run(pkg, _job(Sm, src12, out, mux, vcodec, checkpoint=True,
                           encoder_options="keyint=4"))
        _cut(pkg, out + ".ckpt", 2)
        os.unlink(out)
        stats = _run(pkg, _job(Sm, src12, out, mux, vcodec, resume=True,
                               encoder_options="keyint=4"))
        assert stats["frames_out"] == RN - 8
        assert not os.path.exists(out + ".ckpt")
        files[pkg] = (_bytes(full), _bytes(out))
    assert files["torch"][1] == files["torch"][0]
    assert files["torch"] == files["jax"]


# ---------------------------------------------------------------------------
# refusals of the reference's faults
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vcodec", ["x265", "av1"])
def test_gop_parallel_raises_where_the_reference_ignores_it(src, tmp_path,
                                                            vcodec):
    """GOP-parallel encoding is an H.264 path: the port raises WorkError
    for an HEVC or AV1 job; the reference logs that it ignores the
    request and writes the file it writes without it."""
    with pytest.raises(WorkError, match="GOP-parallel"):
        work.do_job(_job(S, src, str(tmp_path / "x.mkv"), "mkv", vcodec,
                         gop_parallel=2), device="cpu")
    a, b = str(tmp_path / "g.mkv"), str(tmp_path / "s.mkv")
    jwork.do_job(_job(JS, src, a, "mkv", vcodec, gop_parallel=2))
    jwork.do_job(_job(JS, src, b, "mkv", vcodec))
    assert _bytes(a) == _bytes(b)


@pytest.mark.parametrize("vcodec", ["hevc", "svt_av1"])
def test_bframes_raise_where_the_reference_codes_p_frames(src, tmp_path,
                                                          vcodec):
    """A B-frame request: the port raises WorkError; the reference writes
    the file it writes without B-frames."""
    with pytest.raises(WorkError, match="no B-frames"):
        work.do_job(_job(S, src, str(tmp_path / "x.mp4"), "mp4", vcodec,
                         bframes=2), device="cpu")
    a, b = str(tmp_path / "b.mp4"), str(tmp_path / "p.mp4")
    jwork.do_job(_job(JS, src, a, "mp4", vcodec, bframes=2))
    jwork.do_job(_job(JS, src, b, "mp4", vcodec))
    assert _bytes(a) == _bytes(b)
