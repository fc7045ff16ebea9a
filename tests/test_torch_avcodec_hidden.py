"""The libavcodec catalog where the library is missing, as on the machine
with the card: the binding's directory is pointed at an empty one
(``torch_catalog.hide``), and every catalog route of the port refuses
where ``do_job`` builds its encoders and decoders, naming the codec and
the sonames that were not found, before a frame is read and before the
output file is made.  The CLI exits non-zero with the message, and
refuses a catalog encoder (of ``-Z``, ``-e`` or ``-E``) before it scans
the source.  Where the reference falls back, its file is held beside: it
encodes FLAC in place of MP3/Opus/Vorbis, and it passes an E-AC-3 track
through undecoded.  The reference's jobs run in a child process with its
binding hidden the same way (``torch_catalog.reference``)."""
import os

import pytest

import torch_catalog_ref as ref_side
from handbrake_tpu_torch import hb, work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs import avcodec
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.scan import scan_title
from handbrake_tpu_torch.sources.common import TrackInfo
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from torch_catalog import MISSING, hide, lavc_audio, lavc_video, \
    mkv_source, needs_libavcodec, pcm_packets, reference

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_sources")


@pytest.fixture(scope="module")
def pcm_src(tmp_path_factory):
    return mkv_source(str(tmp_path_factory.mktemp("pcm") / "src.mkv"),
                      acodec="pcm_s16le", apackets=pcm_packets())


@pytest.fixture
def no_lib(monkeypatch, tmp_path):
    hide(monkeypatch, tmp_path)


def _tracks(audio):
    return [dict(track=0, encoder=a, mixdown="stereo", bitrate=128)
            for a in (audio or [])]


def _job(Sm, src, out, vcodec="h264", audio=None, mux=None, **kw):
    mux = mux or os.path.splitext(out)[1][1:]
    j = Sm.Job(path=src, file=out, mux=mux, vcodec=vcodec, **kw)
    j.audio = [Sm.AudioJobTrack(**a) for a in _tracks(audio)]
    return j


def _ref_job(reference, src, out, audio, **kw):
    """The reference's do_job of the same H.264 job, in the child, with
    its binding hidden."""
    return reference(ref_side.job, dict(
        path=src, file=out, mux=os.path.splitext(out)[1][1:],
        vcodec="h264", **kw), _tracks(audio), hidden=True)


@pytest.mark.parametrize("vcodec", ["mpeg2", "mpeg4", "vp8", "vp9", "ffv1",
                                    "theora"])
def test_video_encoder_refused(pcm_src, tmp_path, no_lib, vcodec):
    out = str(tmp_path / "x.mkv")
    with pytest.raises(work.WorkError, match=rf"the {vcodec} video encoder "
                       rf"needs libavcodec, which is missing \({MISSING}"):
        work.do_job(_job(S, pcm_src, out, vcodec, quality=20.0),
                    device="cpu")
    assert not os.path.exists(out)


@pytest.mark.parametrize("codec", ["mp3", "opus", "vorbis"])
def test_audio_encoder_refused_not_flac(reference, pcm_src, tmp_path,
                                        no_lib, codec):
    """No FLAC in place of the codec asked for; the reference, with the
    library hidden the same way, writes a FLAC track."""
    out = str(tmp_path / "x.mkv")
    with pytest.raises(work.WorkError, match=rf"audio encoder '{codec}' "
                       rf"needs libavcodec, which is missing \({MISSING}"):
        work.do_job(_job(S, pcm_src, out, audio=[codec], quality=30.0),
                    device="cpu")
    assert not os.path.exists(out)
    ref = str(tmp_path / "ref.mkv")
    _ref_job(reference, pcm_src, ref, [codec], quality=30.0)
    d = MKVDemuxer(ref)
    try:
        assert [t.codec for t in d.tracks if t.kind == "audio"] == ["flac"]
    finally:
        d.close()


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Catalog sources, made while the library is there: the committed
    VP9 webm, MPEG-4 AVI and E-AC-3 mkv, and Theora, FFV1, DTS, MP3,
    Vorbis and Opus mkv files."""
    if not avcodec.available():
        pytest.skip("the system libavcodec is missing: no sources to make")
    d = tmp_path_factory.mktemp("hidden")
    out = {"vp9": os.path.join(DATA, "vp9_176x144.webm"),
           "mpeg4": os.path.join(DATA, "mpeg4_bframes_176x144.avi"),
           "eac3": os.path.join(DATA, "eac3_176x144.mkv")}
    for codec in ("theora", "ffv1"):
        pkts, xd = lavc_video(codec)
        out[codec] = mkv_source(str(d / f"{codec}.mkv"), vpackets=pkts,
                                vcodec=codec, vpriv=xd)
    for codec, enc in (("dts", "dca"), ("mp3", "libmp3lame"),
                       ("vorbis", "libvorbis"), ("opus", "libopus")):
        pkts, xd = lavc_audio(enc, bit_rate=768000 if enc == "dca"
                              else 128000)
        out[codec] = mkv_source(str(d / f"{codec}.mkv"), acodec=codec,
                                apackets=pkts, apriv=xd)
    return out


@needs_libavcodec
@pytest.mark.parametrize("codec", ["vp9", "mpeg4", "theora", "ffv1"])
def test_video_source_refused(sources, tmp_path, no_lib, codec):
    out = str(tmp_path / "x.mp4")
    msg = rf"{codec}: decoding it needs libavcodec, which is missing " \
        rf"\({MISSING}"
    with pytest.raises(ValueError, match=msg):
        work.do_job(_job(S, sources[codec], out, quality=28.0),
                    device="cpu")
    assert not os.path.exists(out)
    with pytest.raises(ValueError, match=msg):
        scan_title(sources[codec], preview_count=2)


@needs_libavcodec
@pytest.mark.parametrize("codec", ["eac3", "dts", "mp3", "vorbis", "opus"])
def test_audio_source_refused(sources, tmp_path, no_lib, codec):
    out = str(tmp_path / "x.mp4")
    with pytest.raises(work.WorkError, match=rf"{codec}: decoding the track "
                       rf"needs libavcodec, which is missing \({MISSING}"):
        work.do_job(_job(S, sources[codec], out, audio=["aac"],
                         quality=28.0), device="cpu")
    assert not os.path.exists(out)


@needs_libavcodec
def test_eac3_not_passed_through(reference, sources, tmp_path, no_lib):
    """The reference, with the library hidden, passes the E-AC-3 packets
    to an AAC chain, which drops them: its file has an AAC track with
    no sound in it."""
    out = str(tmp_path / "ref.mkv")
    _ref_job(reference, sources["eac3"], out, ["aac"], quality=28.0)
    d = MKVDemuxer(out)
    try:
        at = [i for i, t in enumerate(d.tracks) if t.kind == "audio"]
        assert [d.tracks[i].codec for i in at] == ["aac"]
        assert not [b for t, b in d.packets() if t == at[0]]
    finally:
        d.close()


@pytest.mark.parametrize("codec", ["truehd", "mlp", "dca"])
def test_other_audio_decoders_refused(no_lib, codec):
    ti = TrackInfo(kind="audio", codec=codec, sample_rate=48000, channels=2)
    with pytest.raises(work.WorkError, match=rf"{codec}: decoding the "
                       rf"track needs libavcodec, which is missing"):
        work._make_audio_decoder(ti, S.AudioJobTrack(track=0,
                                                     encoder="aac"))


def test_copy_of_a_catalog_track_needs_no_library(no_lib):
    ti = TrackInfo(kind="audio", codec="eac3", sample_rate=48000,
                   channels=2)
    dec = work._make_audio_decoder(ti, S.AudioJobTrack(track=0,
                                                       encoder="copy:eac3"))
    assert type(dec).__name__ == "_CopyAudioDecoder"


@needs_libavcodec
@pytest.mark.parametrize("args", [["-e", "vp9", "-f", "webm"],
                                  ["-a", "1", "-E", "opus"],
                                  ["--source", "vp9"]])
def test_cli_exits_non_zero_with_the_message(sources, pcm_src, tmp_path,
                                             no_lib, capsys, args):
    src = pcm_src
    if args[0] == "--source":
        src, args = sources[args[1]], []
    out = str(tmp_path / ("x.webm" if "webm" in args else "x.mkv"))
    rc = cli(["-i", src, "-o", out, "--device", "cpu", *args])
    assert rc != 0
    assert "libavutil.so.57 and libavcodec.so.59 not found" in \
        capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.fixture
def no_scan(monkeypatch):
    def scan(*a, **k):
        pytest.fail("the CLI scanned the source of a job it refuses")
    monkeypatch.setattr(hb.Handle, "scan", scan)


# the CLI's arguments → the do_job that refuses the same encoder
BEFORE_SCAN = {
    "webm_preset": (["-Z", "WebM 1080p30"],
                    dict(vcodec="vp9", audio=["opus"], mux="webm")),
    "opus": (["-e", "h264", "-q", "28", "-a", "1", "-E", "opus"],
             dict(audio=["opus"], quality=28.0)),
    "vp9": (["-e", "vp9", "-f", "webm"], dict(vcodec="vp9", mux="webm")),
}


@pytest.mark.parametrize("case", list(BEFORE_SCAN))
def test_cli_refuses_catalog_encoder_before_scan(pcm_src, tmp_path, no_lib,
                                                 no_scan, capsys, case):
    """The encoders come from -Z, -e and -E, not from the source: the CLI
    refuses before it scans, with do_job's message for the same job, and
    leaves no file."""
    args, job = BEFORE_SCAN[case]
    out = str(tmp_path / "x.webm")
    assert cli(["-i", pcm_src, "-o", out, "--device", "cpu", *args]) == 3
    err = capsys.readouterr().err
    with pytest.raises(work.WorkError) as e:
        work.do_job(_job(S, pcm_src, str(tmp_path / "y.mkv"), **job),
                    device="cpu")
    assert f"encode failed with error 4: {e.value}" in err
    assert "libavutil.so.57 and libavcodec.so.59 not found" in err
    assert not os.path.exists(out)


def test_cli_preset_audio_needs_a_track(tmp_path, no_lib):
    """A preset's catalog audio encoder is needed only where the source
    has an audio track, which the scan tells: on a source without one,
    "Fast 1080p30 Opus" runs with the library hidden."""
    from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
    src = write_y4m(str(tmp_path / "v.y4m"), make_clip(64, 48, 3, seed=1),
                    64, 48)
    out = str(tmp_path / "v.mp4")
    assert cli(["-i", src, "-o", out, "-Z", "Fast 1080p30 Opus",
                "--device", "cpu"]) == 0
    assert os.path.exists(out)
