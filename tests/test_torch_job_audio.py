"""Audio on the port's job path (``work.do_job``, ``hb.Handle`` and the CLI,
on the CPU) held against the JAX package's: each output file, mp4 or
mkv, must equal the reference's byte for byte.  The sources are small
H.264 mp4 and mkv files that the port's own encoders and muxers write
(64x48, 6 frames, 0.2 s of sound a track):

- PCM in mp4 to mkv with FLAC (the case of ``tests/test_work.py``
  ``test_do_job_with_audio_flac``) and to mp4 with AAC;
- 5.1 AC-3 to stereo AAC; 44.1 kHz PCM to 48 kHz AAC; ``copy:aac`` and
  ``copy:ac3`` (the 5.1 copy labelled with its 6 channels, where the
  reference writes the default mixdown's 2); two and three tracks of one
  source; PCM output;
- the CLI's default preset, and ``-a 1 -E aac -B 128``, against the JAX
  CLI's; the same job through ``hb.Handle``;
- adding audio changes no video byte;
- the refusals: an opus encoder, an E-AC-3 or Opus source track, bad AAC
  extradata, an AAC Main track and a FLAC track without STREAMINFO
  raise, where the reference falls back (FLAC instead of opus, a
  passthrough the chain drops, frames dropped for silence); no output
  file is left that would hide it.

No test here loads libavcodec."""
import functools
import os

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import work
from handbrake_tpu_torch.audio.aac import AACEncoder
from handbrake_tpu_torch.audio.aacdec import AACDecoder
from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.hb import Handle
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.utils.synth import make_clip

W, H, N = 64, 48, 6
FRAME = 3003                    # 90 kHz ticks a frame at 30000/1001


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


def _tone(sr, ch, n, seed):
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    return np.stack([0.4 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                     + 0.02 * rng.standard_normal(n) for c in range(ch)],
                    1).astype(np.float32)


def _s16(pcm):
    return np.clip(pcm * 32767, -32768, 32767).astype("<i2")


def _dac3(enc):
    """The dac3 payload of an AC-3 encoder's stream."""
    v = (enc.fscod << 22) | (8 << 17) | (enc.acmod << 11) \
        | (enc.lfeon << 10) | ((enc.frmsizecod >> 1) << 5)
    return v.to_bytes(3, "big")


@functools.lru_cache(None)
def _video():
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=28, gop=N,
                                    deblock=True, cabac=True,
                                    transform8x8=True), device="cpu")
    return [enc.encode_frame(*f) for f in make_clip(W, H, N, seed=3)]


def _audio_tracks():
    """(codec, rate, channels, extradata, [(payload, samples)]) for the
    three sound tracks: AAC stereo 48 kHz, AC-3 5.1 48 kHz and PCM
    stereo 44.1 kHz, each as long as the video."""
    secs = N * FRAME / 90000
    out = []
    pcm = _tone(48000, 2, int(48000 * secs), 1)
    aac = AACEncoder(48000, 2, quality=120)
    out.append(("aac", 48000, 2, aac.audio_specific_config(),
                [(au, 1024) for au in aac.encode(pcm) + aac.flush()]))
    ac3 = Ac3Encoder(48000, 6, 384000)
    frames = ac3.encode(_tone(48000, 6, int(48000 * secs), 2)) + ac3.flush()
    out.append(("ac3", 48000, 6, _dac3(ac3), [(f, 1536) for f in frames]))
    pcm44 = _s16(_tone(44100, 2, int(44100 * secs), 3))
    out.append(("pcm_s16le", 44100, 2, b"",
                [(pcm44[i:i + 1470].tobytes(), len(pcm44[i:i + 1470]))
                 for i in range(0, len(pcm44), 1470)]))
    return out


def _write_mp4(path, tracks):
    w = MP4Writer(path)
    vi = w.add_video_track(codec="h264", width=W, height=H)
    ais = [w.add_audio_track(codec=c, sample_rate=sr, channels=ch,
                             extradata=xd) for c, sr, ch, xd, _ in tracks]
    for i, au in enumerate(_video()):
        w.write_sample(vi, au, duration=FRAME, sync=i == 0, annexb=True)
        # the sound of this frame's interval, interleaved with it
        for ai, (_c, sr, _ch, _xd, pkts) in zip(ais, tracks):
            t0, t1 = i * FRAME * sr // 90000, (i + 1) * FRAME * sr // 90000
            pos = 0
            for data, n in pkts:
                if t0 <= pos < t1 or (i == N - 1 and pos >= t1):
                    w.write_sample(ai, data, duration=n)
                pos += n
    w.finalize()
    return path


def _write_mkv(path, codec, private=b""):
    """An H.264 mkv with one audio track of `codec` whose packets are
    opaque bytes (the job must refuse the track before reading one)."""
    w = MKVWriter(path)
    vi = w.add_video_track(codec="h264", width=W, height=H, fps=30000 / 1001)
    ai = w.add_audio_track(codec=codec, sample_rate=48000, channels=2,
                           private=private)
    for i, au in enumerate(_video()):
        w.write_sample(vi, au, pts_90k=i * FRAME, duration_90k=FRAME,
                       sync=i == 0, annexb=True)
        w.write_sample(ai, bytes([0x0B, 0x77]) + bytes(range(i, i + 60)),
                       pts_90k=i * FRAME, duration_90k=FRAME)
    w.finalize()
    return path


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("tav")
    tracks = _audio_tracks()
    pcm48 = _s16(_tone(48000, 2, 1600, 4))
    return {
        # one track: tests/test_work.py's source (1600 samples a frame)
        "pcm": _write_mp4(str(d / "pcm.mp4"), [
            ("pcm_s16le", 48000, 2, b"", [(pcm48.tobytes(), 1600)] * N)]),
        "av": _write_mp4(str(d / "av.mp4"), tracks),
        "bad-asc": _write_mp4(str(d / "bad.mp4"), [
            ("aac", 48000, 2, b"\x12", tracks[0][4])]),
        # the LC track's packets, its ASC naming AAC Main (object type 1)
        "aac-main": _write_mp4(str(d / "main.mp4"), [
            ("aac", 48000, 2, b"\x09\x90", tracks[0][4])]),
        "eac3": _write_mkv(str(d / "eac3.mkv"), "eac3"),
        "opus": _write_mkv(str(d / "opus.mkv"), "opus",
                           b"OpusHead\x01\x02" + bytes(9)),
        "flac-no-streaminfo": _write_mkv(str(d / "flac.mkv"), "flac"),
    }


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _job(Sm, src, out, mux, tracks):
    j = Sm.Job(path=src, file=out, mux=mux, vcodec="h264", quality=28.0,
               encoder_profile="high")
    j.audio = [Sm.AudioJobTrack(**t) for t in tracks]
    return j


def _packets(path):
    """[(kind, codec, rate, channels, extradata)], {track: [payloads]}"""
    d = MKVDemuxer(path) if path.endswith(".mkv") else MP4Demuxer(path)
    try:
        tracks = [(t.kind, t.codec, t.sample_rate if t.kind == "audio"
                   else t.width, t.channels if t.kind == "audio"
                   else t.height, bytes(t.extradata or b""))
                  for t in d.tracks]
        pk = {}
        for trk, b in d.packets():
            pk.setdefault(trk, []).append((b.pts, bytes(b.data)))
        return tracks, pk
    finally:
        d.close()


# job name: (source, mux, the job's audio tracks)
JOBS = {
    "pcm-flac-mkv": ("pcm", "mkv", [dict(track=0, encoder="flac",
                                         mixdown="stereo")]),
    "pcm-aac-mp4": ("pcm", "mp4", [dict(track=0, encoder="aac",
                                        bitrate=160)]),
    "ac3-5.1-aac-stereo": ("av", "mp4", [dict(track=1, encoder="aac",
                                              bitrate=160,
                                              mixdown="stereo")]),
    "pcm-44.1k-to-48k": ("av", "mp4", [dict(track=2, encoder="aac",
                                            bitrate=128,
                                            samplerate=48000)]),
    "copy-aac": ("av", "mp4", [dict(track=0, encoder="copy:aac")]),
    "copy-ac3-mkv": ("av", "mkv", [dict(track=1, encoder="copy:ac3")]),
    "two-tracks": ("av", "mkv", [dict(track=0, encoder="ac3", bitrate=192),
                                 dict(track=1, encoder="flac",
                                      mixdown="stereo")]),
    "three-tracks": ("av", "mkv", [dict(track=0, encoder="copy:aac"),
                                   dict(track=1, encoder="flac",
                                        mixdown="stereo"),
                                   dict(track=2, encoder="ac3",
                                        samplerate=48000)]),
    "ac3-5.1-mp4-gain": ("av", "mp4", [dict(track=1, encoder="ac3",
                                            mixdown="5point1", bitrate=384,
                                            gain=-3.0, drc=2.0)]),
    "pcm-out": ("av", "mkv", [dict(track=2, encoder="pcm",
                                   mixdown="mono")]),
}


@pytest.mark.parametrize("name", list(JOBS))
def test_audio_job_equals_reference(sources, tmp_path, name):
    src, mux, tracks = JOBS[name]
    jout, tout = str(tmp_path / f"ref.{mux}"), str(tmp_path / f"port.{mux}")
    jstats = jwork.do_job(_job(JS, sources[src], jout, mux, tracks))
    tstats = work.do_job(_job(S, sources[src], tout, mux, tracks),
                         device="cpu")
    assert tstats == jstats and tstats["frames_out"] == N
    ttracks, tpk = _packets(tout)
    # every asked track is there and carries packets
    assert [t[0] for t in ttracks] == ["video"] + ["audio"] * len(tracks)
    assert all(tpk.get(i) for i in range(1 + len(tracks)))
    got = _bytes(tout)
    if name == "copy-ac3-mkv":
        # the copy of the 5.1 track keeps its 6 channels; the reference
        # labels it with the default mixdown's 2 (mkv Channels, 0x9F)
        assert [t[3] for t in ttracks[1:]] == [6]
        assert got.count(b"\x9f\x81\x06") == 1
        got = got.replace(b"\x9f\x81\x06", b"\x9f\x81\x02")
    assert got == _bytes(jout)


def test_audio_changes_no_video_byte(sources, tmp_path):
    outs = {}
    for name, tracks in (("with", [dict(track=0, encoder="aac")]),
                         ("without", [])):
        path = str(tmp_path / f"{name}.mp4")
        work.do_job(_job(S, sources["av"], path, "mp4", tracks),
                    device="cpu")
        outs[name] = _packets(path)
    (tw, pw), (tn, pn) = outs["with"], outs["without"]
    assert tw[0] == tn[0] and pw[0] == pn[0]
    assert len(tw) == 2 and len(tn) == 1


def test_aac_output_decodes_to_the_source_length(sources, tmp_path):
    """The AAC track of an mp4 decodes through the port's decoder, within
    one AAC frame of the source's sample count, from the video's start."""
    path = str(tmp_path / "aac.mp4")
    work.do_job(_job(S, sources["av"], path, "mp4",
                     [dict(track=0, encoder="aac")]), device="cpu")
    tracks, pk = _packets(path)
    dec = AACDecoder(tracks[1][4])
    n = sum(dec.decode_frame(p).shape[0] for _pts, p in pk[1])
    src_n = sum(s for _d, s in _audio_tracks()[0][4])
    # the encoder's 1024-sample priming frame is in the count
    assert abs(n - 1024 - src_n) <= 1024
    assert pk[1][0][0] == pk[0][0][0] == 0


def _cli_args(src, out, *extra):
    return ["-i", src, "-o", out, "-e", "h264", "-q", "28",
            "--encoder-profile", "high", *extra]


@pytest.mark.parametrize("extra", [[], ["-a", "1", "-E", "aac", "-B", "128"],
                                   ["-a", "2", "-E", "ac3", "--mixdown",
                                    "stereo", "-R", "44.1"]])
def test_cli_audio_job_equals_reference(sources, tmp_path, extra):
    """The default preset (AAC stereo 160 from the first track), and the
    audio flags, as the JAX CLI reads them."""
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    assert jcli(_cli_args(sources["av"], jout, *extra)) == 0
    assert cli(_cli_args(sources["av"], tout, *extra, "--device",
                         "cpu")) == 0
    tracks, _pk = _packets(tout)
    assert [t[:2] for t in tracks][1][0] == "audio"
    assert _bytes(tout) == _bytes(jout)


def test_cli_per_track_audio_lists(sources, tmp_path):
    """-E, -B, -6 and -R take a list, one value a track (the last one
    repeating): the three-track job of the CLI equals do_job's."""
    out = str(tmp_path / "cli.mkv")
    assert cli(_cli_args(sources["av"], out, "-a", "1,2,3", "-E",
                         "copy:aac,flac,ac3", "-B", "160,160,192", "-6",
                         "stereo", "-R", "auto,auto,48", "--device",
                         "cpu")) == 0
    tracks, pk = _packets(out)
    assert [t[1] for t in tracks] == ["h264", "aac", "flac", "ac3"]
    assert [t[2] for t in tracks[1:]] == [48000, 48000, 48000]
    src_aac = [p for p, _n in _audio_tracks()[0][4]]
    assert [p for _pts, p in pk[1]] == src_aac      # copied untouched
    ac3_frames = -(-int(44100 * N * FRAME / 90000 * 48000 / 44100) // 1536)
    assert len(pk[3]) in (ac3_frames, ac3_frames + 1)


def test_handle_audio_job_equals_reference(sources, tmp_path):
    jout, tout = str(tmp_path / "ref.mkv"), str(tmp_path / "port.mkv")
    tracks = [dict(track=1, encoder="aac", mixdown="stereo")]
    jwork.do_job(_job(JS, sources["av"], jout, "mkv", tracks))
    h = Handle(device="cpu")
    h.add(_job(S, sources["av"], tout, "mkv", tracks))
    h.start()
    assert h.work_wait(120) == 0 and h.work_exception is None
    assert _bytes(tout) == _bytes(jout)


# -- refusals ----------------------------------------------------------------
@pytest.mark.parametrize("codec", ["opus", "mp3", "vorbis"])
def test_libavcodec_encoder_job_raises(sources, tmp_path, codec,
                                       monkeypatch, capsys):
    """With libavcodec missing, the job and the CLI refuse, naming it."""
    from torch_catalog import MISSING, hide
    hide(monkeypatch, tmp_path)
    out = str(tmp_path / "x.mkv")
    with pytest.raises(work.WorkError, match=rf"{codec}.*{MISSING}"):
        work.do_job(_job(S, sources["av"], out, "mkv",
                         [dict(track=0, encoder=codec)]), device="cpu")
    assert cli(_cli_args(sources["av"], out, "-a", "1", "-E", codec,
                         "--device", "cpu")) != 0
    assert "libavcodec.so.59 not found" in capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.mark.parametrize("src", ["eac3", "opus"])
def test_libavcodec_source_track_raises(sources, tmp_path, src,
                                        monkeypatch):
    """With libavcodec missing, a selected E-AC-3 or Opus track refuses,
    naming it."""
    from torch_catalog import MISSING, hide
    hide(monkeypatch, tmp_path)
    out = str(tmp_path / "x.mkv")
    with pytest.raises(work.WorkError, match=rf"{src}.*{MISSING}"):
        work.do_job(_job(S, sources[src], out, "mkv",
                         [dict(track=0, encoder="aac")]), device="cpu")
    assert not os.path.exists(out)
    # a copy of the track needs no decoder: it passes through, as in the
    # reference
    work.do_job(_job(S, sources[src], out, "mkv",
                     [dict(track=0, encoder=f"copy:{src}")]), device="cpu")
    tracks, pk = _packets(out)
    assert tracks[1][1] == src and len(pk[1]) == N


def test_bad_aac_extradata_raises(sources, tmp_path):
    """The reference turns the failed decoder into a passthrough that its
    chain drops, so its file has an empty AAC track; the port raises."""
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    tracks = [dict(track=0, encoder="aac")]
    jwork.do_job(_job(JS, sources["bad-asc"], jout, "mp4", tracks))
    _jt, jpk = _packets(jout)
    assert not jpk.get(1)
    with pytest.raises(work.WorkError, match="aac"):
        work.do_job(_job(S, sources["bad-asc"], tout, "mp4", tracks),
                    device="cpu")
    assert not os.path.exists(tout)


def test_aac_main_track_raises(sources, tmp_path):
    """An AAC Main track: the decoder reads LC syntax, and each frame that
    uses Main's prediction would be dropped and filled with silence, so
    the port refuses the track before the job writes a file."""
    out = str(tmp_path / "x.mp4")
    with pytest.raises(work.WorkError, match="object type 1"):
        work.do_job(_job(S, sources["aac-main"], out, "mp4",
                         [dict(track=0, encoder="aac")]), device="cpu")
    assert not os.path.exists(out)


def test_flac_track_without_streaminfo_raises(sources, tmp_path):
    out = str(tmp_path / "x.mkv")
    with pytest.raises(work.WorkError, match="flac"):
        work.do_job(_job(S, sources["flac-no-streaminfo"], out, "mkv",
                         [dict(track=0, encoder="aac")]), device="cpu")
    assert not os.path.exists(out)


@pytest.mark.parametrize("json_out", [False, True])
def test_cli_scan_lists_audio_tracks(sources, capsys, json_out):
    """--scan lists the source's three sound tracks as the JAX CLI does."""
    extra = ["--json"] if json_out else []
    assert jcli(["-i", sources["av"], "--scan", *extra]) == 0
    want = capsys.readouterr().out
    assert cli(["-i", sources["av"], "--scan", *extra, "--device",
                "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "aac" in got and "ac3" in got and "pcm_s16le" in got
