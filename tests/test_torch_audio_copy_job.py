"""Audio outputs and passthrough on the port's job path (``work.do_job``,
``hb.Handle``, the CLI, ``--queue-import-file`` and a resumed job, on the
CPU), held beside the JAX package:

- fan-out: two outputs of one source track (``[aac, copy:aac]``,
  ``[copy:ac3, aac]``) to mp4 and mkv write two full tracks; the copy's
  packets are the source's, the AAC track is the one the reference
  writes when that output is alone, and the reference's own file of the
  pair has one audio track in mp4 and an empty one in mkv;
- a queued Job JSON's CopyMask and FallbackEncoder are applied;
- a checkpointed fan-out job resumed after its second GOP equals the
  unresumed one, and a journal of the previous format is refused;
- the mp4 config boxes of a copy come from the stream: ``dac3`` for the
  AC-3 layouts 1/0, 2/0, 2/1 and 3/2+LFE, ``dec3`` for E-AC-3 with and
  without a dependent substream, MP2 as ``mp4a`` with
  objectTypeIndication 0x6B and Layer II frames, each read back by the
  port's mp4 reader as written; a codec without a sample entry or a
  CodecID raises MuxError in either muxer;
- a DVD folder with AC-3 5.1, DTS 5.1 and LPCM stereo tracks: the DTS
  track with its header's rate and channels, the IFO's languages on the
  title and in the preset's selection, each IFO/stream disagreement
  logged, and a preset job to mp4 with AAC and the AC-3 copy."""
import functools
import os

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import checkpoint, work
from handbrake_tpu_torch.audio.ac3dec import frame_size, read_bsi
from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.hb import Handle
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.common import MuxError
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.mux.mp4 import MP4Writer, dac3, dec3
from handbrake_tpu_torch.scan import scan
from handbrake_tpu_torch.sources.dvd import open_dvd_title
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.tools import source_builders as B
from test_torch_job_audio import (FRAME, _audio_tracks, _bytes, _job,
                                  _packets, _tone, _video, _write_mp4)
from test_torch_sources import T0, h264_ts, mp2_frames


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """The reference's encoders of one shape share one jitted analyzer,
    on its device path (as in tests/test_torch_job_audio.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        yield


@pytest.fixture(scope="module")
def av(tmp_path_factory):
    """tests/test_torch_job_audio.py's ``av`` source: AAC stereo, AC-3
    5.1 and 44.1 kHz PCM beside 6 frames of 64x48 H.264."""
    d = tmp_path_factory.mktemp("fan")
    return _write_mp4(str(d / "av.mp4"), _audio_tracks())


def _source_payloads(track):
    return [p for p, _n in _audio_tracks()[track][4]]


# name: (source track, the outputs' encoders)
FANS = {"aac+copy:aac": (0, ["aac", "copy:aac"]),
        "copy:ac3+aac": (1, ["copy:ac3", "aac"])}


def _audio(track, encoders):
    return [dict(track=track, encoder=e) for e in encoders]


@pytest.mark.parametrize("mux", ["mp4", "mkv"])
@pytest.mark.parametrize("fan", list(FANS))
def test_fan_out_writes_both_outputs(av, tmp_path, fan, mux):
    track, encoders = FANS[fan]
    out = str(tmp_path / f"port.{mux}")
    work.do_job(_job(S, av, out, mux, _audio(track, encoders)),
                device="cpu")
    tracks, pk = _packets(out)
    codec = _audio_tracks()[track][0]
    assert [t[:2] for t in tracks[1:]] == [
        ("audio", codec if e.startswith("copy") else "aac")
        for e in encoders]
    c = 1 + next(i for i, e in enumerate(encoders) if e.startswith("copy"))
    a = 3 - c
    assert [p for _pts, p in pk[c]] == _source_payloads(track)
    # the AAC output equals the reference's when it is the job's only one
    alone = str(tmp_path / f"ref_alone.{mux}")
    jwork.do_job(_job(JS, av, alone, mux, _audio(track, ["aac"])))
    jt, jpk = _packets(alone)
    assert tracks[a] == jt[1] and pk[a] == jpk[1] and len(pk[a]) > 6
    # the reference's file of the pair: one audio track in mp4 (the
    # second output's), an empty first one in mkv
    both = str(tmp_path / f"ref_both.{mux}")
    jwork.do_job(_job(JS, av, both, mux, _audio(track, encoders)))
    jt, jpk = _packets(both)
    if mux == "mp4":
        assert len(jt) == 2 and jt[1][:2] == tracks[1 + (c == 1)][:2]
    else:
        assert len(jt) == 3 and not jpk.get(1) and jpk.get(2)


def test_fan_out_through_handle_and_cli(av, tmp_path):
    """``-a 1,1 -E aac,copy:aac`` through the CLI, and the same job
    through ``hb.Handle``, equal do_job's file."""
    outs = {}
    for how in ("do_job", "handle", "cli"):
        out = outs[how] = str(tmp_path / f"{how}.mkv")
        job = _job(S, av, out, "mkv", _audio(0, ["aac", "copy:aac"]))
        if how == "do_job":
            work.do_job(job, device="cpu")
        elif how == "handle":
            h = Handle(device="cpu")
            h.add(job)
            h.start()
            assert h.work_wait(120) == 0 and h.work_exception is None
        else:
            assert cli(["-i", av, "-o", out, "-e", "h264", "-q", "28",
                        "--encoder-profile", "high", "-a", "1,1", "-E",
                        "aac,copy:aac", "-B", "160", "-6", "stereo",
                        "--device", "cpu"]) == 0
    tracks, pk = _packets(outs["cli"])
    assert [t[1] for t in tracks] == ["h264", "aac", "aac"]
    assert [p for _pts, p in pk[2]] == _source_payloads(0)
    assert _bytes(outs["handle"]) == _bytes(outs["do_job"])
    # the CLI's default preset sets more than do_job's Job: the audio is
    # the same
    _, dpk = _packets(outs["do_job"])
    assert pk[1] == dpk[1] and pk[2] == dpk[2]


def test_queue_import_applies_mask_and_fallback(av, tmp_path):
    """A Job JSON through ``--queue-import-file``: its CopyMask (AAC only)
    sends ``copy`` of the AC-3 track to its FallbackEncoder (FLAC), beside
    an AC-3 copy of the same track; the reference copies the AC-3 track
    through for both and keeps one track of the pair."""
    import json
    out = str(tmp_path / "q.mkv")
    job = _job(S, av, out, "mkv", _audio(1, ["copy", "copy:ac3"]))
    job.audio_copy_mask, job.audio_fallback = ["copy:aac"], "flac"
    q = str(tmp_path / "queue.json")
    with open(q, "w") as f:
        json.dump([{"Job": job.to_json()}], f)
    assert cli(["--queue-import-file", q, "--device", "cpu"]) == 0
    tracks, pk = _packets(out)
    assert [t[1] for t in tracks[1:]] == ["flac", "ac3"]
    assert [p for _pts, p in pk[2]] == _source_payloads(1) and pk[1]
    ref = str(tmp_path / "ref.mkv")
    jjob = JS.Job.from_json(dict(job.to_json(), Destination=dict(
        job.to_json()["Destination"], File=ref)))
    jwork.do_job(jjob)
    jt, jpk = _packets(ref)
    assert [t[1] for t in jt[1:]] == ["ac3", "ac3"] and not jpk.get(1)


def _keep_journal(monkeypatch):
    monkeypatch.setattr(checkpoint.CkptJournal, "close",
                        lambda self, complete=False: self.f.close())


@pytest.fixture(scope="module")
def long_ac3(tmp_path_factory):
    """45 frames (1.5 s) of 64x48 H.264 and an AC-3 5.1 track: long
    enough that the muxer's 0.5 s chunks put audio before a GOP marker."""
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.utils.synth import make_clip
    n = 45
    enc = H264Encoder(EncoderConfig(width=64, height=48, qp=28, gop=n),
                      device="cpu")
    video = [enc.encode_frame(*f) for f in make_clip(64, 48, n, seed=4)]
    ac3 = Ac3Encoder(48000, 6, 384000)
    frames = ac3.encode(_tone(48000, 6, int(48000 * n * FRAME / 90000),
                              6)) + ac3.flush()
    path = str(tmp_path_factory.mktemp("long") / "long.mp4")
    w = MP4Writer(path)
    vi = w.add_video_track(codec="h264", width=64, height=48)
    ai = w.add_audio_track(codec="ac3", sample_rate=48000, channels=6,
                           extradata=dac3(read_bsi(frames[0])))
    for i, au in enumerate(video):
        w.write_sample(vi, au, duration=FRAME, sync=i == 0, annexb=True)
        while frames and len(frames) * 2880 > (n - i - 1) * FRAME:
            w.write_sample(ai, frames.pop(0), duration=1536)
    w.finalize()
    return path


def test_resumed_fan_out_equals_unresumed(long_ac3, tmp_path, monkeypatch):
    def job(out, **kw):
        j = _job(S, long_ac3, out, "mp4", _audio(0, ["copy:ac3", "aac"]))
        j.encoder_options = "keyint=15"
        for k, v in kw.items():
            setattr(j, k, v)
        return j

    ref = str(tmp_path / "ref.mp4")
    work.do_job(job(ref), device="cpu")
    out = str(tmp_path / "ck.mp4")
    with monkeypatch.context() as m:
        _keep_journal(m)
        work.do_job(job(out, checkpoint=True), device="cpu")
    data = _bytes(out + ".ckpt")
    spans = checkpoint.spans(data)
    marks = [end for tag, _s, end in spans if tag == "g"]
    # cut after the second GOP's marker, as a kill there would leave it:
    # both outputs' records are in the replayed part
    assert len(marks) == 2
    keys = {checkpoint._get(data[s + checkpoint._HDR.size:e], 0)[0][0]
            for tag, s, e in spans if tag == "a" and e <= marks[1]}
    assert keys == {0, 1}
    with open(out + ".ckpt", "wb") as f:
        f.write(data[:marks[1]])
    os.unlink(out)
    work.do_job(job(out, resume=True), device="cpu")
    assert _bytes(out) == _bytes(ref)
    tracks, pk = _packets(out)
    assert [t[1] for t in tracks[1:]] == ["ac3", "aac"]
    d = MP4Demuxer(long_ac3)
    assert [p for _pts, p in pk[1]] == [bytes(b.data) for t, b
                                        in d.packets() if t == 1]
    d.close()


def test_journal_of_the_previous_format_is_refused(av, tmp_path):
    """A version 1 journal keyed its audio records by source track; a
    resume refuses it, naming the format, and writes no output."""
    out = str(tmp_path / "old.mp4")
    with open(out + ".ckpt", "wb") as f:
        f.write(b"HBTCKP1\n" + checkpoint.encode_record(
            "a", (1, b"\x0b\x77", 0, 2880, 2880)))
    j = _job(S, av, out, "mp4", _audio(1, ["copy:ac3"]))
    j.resume = True
    with pytest.raises(checkpoint.JournalError, match="version 1"):
        work.do_job(j, device="cpu")
    assert not os.path.exists(out)


# ---------------------------------------------------------------------------
# config boxes from the stream
# ---------------------------------------------------------------------------
def ac3_frame(acmod, lfeon, frmsizecod=20, bsmod=0) -> bytes:
    """An AC-3 syncframe of this layout at 48 kHz: syncinfo and the BSI
    head, the rest zero (it describes a stream; it decodes to nothing)."""
    f = [(0x0B77, 16), (0, 16), (0, 2), (frmsizecod, 6), (8, 5),
         (bsmod, 3), (acmod, 3)]
    if (acmod & 1) and acmod != 1:
        f.append((0, 2))
    if acmod & 4:
        f.append((0, 2))
    if acmod == 2:
        f.append((0, 2))
    head = B.pack_bits(f + [(lfeon, 1)])
    return head + bytes(frame_size(0, frmsizecod) - len(head))


def eac3_frame(strmtyp, acmod, lfeon, size=512, bsmod=0, chanmap=None,
               substreamid=0) -> bytes:
    """An E-AC-3 syncframe (A/52 E.1.2.2) of 6 blocks at 48 kHz, bsid 16,
    with informational metadata carrying ``bsmod`` and, for a dependent
    substream, ``chanmap``; the rest zero."""
    f = [(0x0B77, 16), (strmtyp, 2), (substreamid, 3), (size // 2 - 1, 11),
         (0, 2), (3, 2), (acmod, 3), (lfeon, 1), (16, 5), (0, 5), (0, 1)]
    if acmod == 0:
        f += [(0, 5), (0, 1)]
    if strmtyp == 1:
        f += [(0, 1)] if chanmap is None else [(1, 1), (chanmap, 16)]
    f += [(0, 1), (1, 1), (bsmod, 3)]
    head = B.pack_bits(f)
    return head + bytes(size - len(head))


AC3_LAYOUTS = {"1/0": (1, 0), "2/0": (2, 0), "2/1": (4, 0),
               "3/2+LFE": (7, 1)}
# Lrs/Rrs (chanmap index 6) in the dependent substream of a 5.1 stream
EAC3_STREAMS = {
    "5.1": [eac3_frame(0, 7, 1, bsmod=2)],
    "5.1+Lrs/Rrs": [eac3_frame(0, 7, 1), eac3_frame(1, 2, 0,
                                                    chanmap=1 << 9)],
}


def _mkv_source(path, codec, packets, ticks):
    w = MKVWriter(path)
    vi = w.add_video_track(codec="h264", width=64, height=48,
                           fps=30000 / 1001)
    ai = w.add_audio_track(codec=codec, sample_rate=48000, channels=2)
    for i, au in enumerate(_video()):
        w.write_sample(vi, au, pts_90k=i * FRAME, duration_90k=FRAME,
                       sync=i == 0, annexb=True)
    for k, p in enumerate(packets):
        w.write_sample(ai, p, pts_90k=k * ticks, duration_90k=ticks)
    w.finalize()
    return path


def _copy_to_mp4(tmp_path, src, codec):
    out = str(tmp_path / "copy.mp4")
    work.do_job(_job(S, src, out, "mp4", _audio(0, [f"copy:{codec}"])),
                device="cpu")
    d = MP4Demuxer(out)
    try:
        ti = d.tracks[1]
        return ti, [bytes(b.data) for t, b in d.packets() if t == 1]
    finally:
        d.close()


@pytest.mark.parametrize("layout", list(AC3_LAYOUTS))
def test_dac3_from_the_stream(tmp_path, layout):
    acmod, lfeon = AC3_LAYOUTS[layout]
    frame = ac3_frame(acmod, lfeon, frmsizecod=28, bsmod=1)
    bsi = read_bsi(frame)
    assert (bsi["acmod"], bsi["lfeon"], bsi["bsmod"], bsi["bsid"]) == (
        acmod, lfeon, 1, 8) and bsi["bit_rate"] == 384000
    want = ((8 << 17) | (1 << 14) | (acmod << 11) | (lfeon << 10)
            | (14 << 5)).to_bytes(3, "big")
    assert dac3(bsi) == want
    src = _mkv_source(str(tmp_path / "ac3.mkv"), "ac3", [frame] * 7, 2880)
    ti, pkts = _copy_to_mp4(tmp_path, src, "ac3")
    assert (ti.codec, bytes(ti.extradata)) == ("ac3", want)
    assert pkts == [frame] * 7


def test_dac3_of_an_encoded_5_1_copy(tmp_path):
    """The port's own 5.1 encoder at 448 kb/s: dac3 3/2+LFE, code 15."""
    enc = Ac3Encoder(48000, 6, 448000)
    frames = enc.encode(_tone(48000, 6, 48000 // 5, 9)) + enc.flush()
    src = _mkv_source(str(tmp_path / "ac3.mkv"), "ac3", frames, 2880)
    ti, pkts = _copy_to_mp4(tmp_path, src, "ac3")
    assert bytes(ti.extradata) == ((8 << 17) | (7 << 11) | (1 << 10)
                                   | (15 << 5)).to_bytes(3, "big")
    assert pkts == frames


@pytest.mark.parametrize("name", list(EAC3_STREAMS))
def test_dec3_from_the_stream(tmp_path, name):
    unit = b"".join(EAC3_STREAMS[name])
    info = read_bsi(unit * 2)
    (sub,) = info["substreams"]
    dep = len(EAC3_STREAMS[name]) - 1
    assert (sub["acmod"], sub["lfeon"], sub["num_dep_sub"]) == (7, 1, dep)
    # 512 bytes a 1536-sample frame at 48 kHz: 128 kb/s a substream
    assert info["data_rate"] == 128 * (1 + dep)
    want = B.pack_bits(
        [(128 * (1 + dep), 13), (0, 3), (0, 2), (16, 5), (0, 2),
         (sub["bsmod"], 3), (7, 3), (1, 1), (0, 3), (dep, 4)]
        + ([(1 << 7, 9)] if dep else [(0, 1)]))
    assert dec3(info) == want
    assert sub["bsmod"] == (2 if name == "5.1" else 0)
    src = _mkv_source(str(tmp_path / "eac3.mkv"), "eac3", [unit] * 7, 2880)
    ti, pkts = _copy_to_mp4(tmp_path, src, "eac3")
    assert (ti.codec, bytes(ti.extradata)) == ("eac3", want)
    assert pkts == [unit] * 7


def test_eac3_fixture_round_trips_through_mp4(tmp_path):
    """The committed E-AC-3 stereo 96 kb/s track (libavcodec's) copied to
    mp4: ec-3 with its dec3, the packets untouched; the reference writes
    it as mp4a with AAC's esds, which its reader takes for AAC."""
    src = os.path.join(os.path.dirname(__file__), "data", "torch_sources",
                       "eac3_176x144.mkv")
    ti, pkts = _copy_to_mp4(tmp_path, src, "eac3")
    assert (ti.codec, bytes(ti.extradata).hex()) == ("eac3", "0300200400")
    from handbrake_tpu_torch.sources.mkv import MKVDemuxer
    d = MKVDemuxer(src)
    assert pkts == [bytes(b.data) for t, b in d.packets() if t == 1]
    d.close()
    ref = str(tmp_path / "ref.mp4")
    jwork.do_job(_job(JS, src, ref, "mp4", _audio(0, ["copy:eac3"])))
    d = MP4Demuxer(ref)
    assert d.tracks[1].codec == "aac"
    d.close()


def test_mp2_copy_round_trips_through_mp4(tmp_path):
    """MP2 from a TS copied to mp4: mp4a with objectTypeIndication 0x6B,
    read back as mp2 from the Layer II frames (an MP3 track stays mp3)."""
    src = str(tmp_path / "mp2.ts")
    with open(src, "wb") as f:
        f.write(h264_ts(n=8, audio=[(0x03, 0x101, 0xC0, b"",
                                     mp2_frames()[:10], 2160)]))
    ti, pkts = _copy_to_mp4(tmp_path, src, "mp2")
    assert ti.codec == "mp2" and ti.extradata == b""
    assert b"".join(pkts) == b"".join(mp2_frames()[:10])
    path = str(tmp_path / "mp3.mp4")
    w = MP4Writer(path)
    a = w.add_audio_track(codec="mp3", sample_rate=48000, channels=2)
    w.write_sample(a, bytes([0xFF, 0xFB, 0x90, 0x64]) + bytes(413), 1152)
    w.finalize()
    d = MP4Demuxer(path)
    assert d.tracks[0].codec == "mp3"
    d.close()


@pytest.mark.parametrize("writer,codec", [("mp4", "dts"), ("mp4", "truehd"),
                                          ("mp4", "vorbis"), ("mkv", "lpcm"),
                                          ("mkv", "aac_latm")])
def test_muxer_refuses_a_codec_it_does_not_know(tmp_path, writer, codec):
    W = MP4Writer if writer == "mp4" else MKVWriter
    w = W(str(tmp_path / f"x.{writer}"))
    with pytest.raises(MuxError, match=f"{writer}: no .* for "
                       f"{codec!r} audio"):
        w.add_audio_track(codec=codec, sample_rate=48000, channels=2)


# ---------------------------------------------------------------------------
# a DVD with AC-3, DTS and LPCM tracks
# ---------------------------------------------------------------------------
def dvd_audio_units(ac3, seconds=0.4):
    """Audio stream 0: ``ac3`` frames on 0x80; 1: 5.1 DTS core frames on
    0x89; 2: LPCM stereo on 0xA2."""
    units = [(T0 + k * 2880, 0xBD, f, B.ac3_sub, T0 + k * 2880)
             for k, f in enumerate(ac3)]
    units += [(T0 + k * 960, 0xBD, B.dts_core_frame(),
               lambda p: B.dts_sub(p, 1), T0 + k * 960)
              for k in range(int(seconds * 50))]
    lp = _tone(48000, 2, int(48000 * seconds), 5)
    units += [(T0 + k * 900, 0xBD, B.s16be_lpcm(lp[k * 480:(k + 1) * 480]),
               lambda p: B.lpcm_sub(p, 2), T0 + k * 900)
              for k in range(len(lp) // 480)]
    return units


# stream attributes as the IFO lists them
DVD_ATTRS = [("ac3", 6, "en"), ("dts", 6, "en"), ("lpcm", 2, "fr")]


@pytest.fixture(scope="module")
def dvd(tmp_path_factory):
    enc = Ac3Encoder(48000, 6, 448000)
    ac3 = enc.encode(_tone(48000, 6, int(48000 * 0.4), 8)) + enc.flush()
    es = B.fixture("mpeg2_176x144.m2v")
    ps = B.build_ps(B.video_units(es, T0, 3003) + dvd_audio_units(ac3))
    root = B.write_dvd(str(tmp_path_factory.mktemp("dvd3") / "disc"), ps,
                       2, [0.2, 0.2], audio_attrs=[
                           B.vts_audio_attr(*a) for a in DVD_ATTRS])
    return root, ac3, ps


def test_dvd_tracks_take_the_ifo_languages(dvd, capfd):
    root, _ac3, _ps = dvd
    d, _t = open_dvd_title(root)
    got = [(t.codec, t.sample_rate, t.channels, t.language)
           for t in d.tracks if t.kind == "audio"]
    d.close()
    assert got == [("ac3", 48000, 6, "eng"), ("dts", 48000, 6, "eng"),
                   ("lpcm", 48000, 2, "fre")]
    assert "dvd: audio stream" not in capfd.readouterr().err
    (title,) = scan(root, preview_count=2)
    assert [a.language for a in title.audio] == ["eng", "eng", "fre"]


@pytest.mark.parametrize("langs,want", [(["fre"], [2]), (["eng"], [0]),
                                        (["und"], [0])])
def test_dvd_languages_reach_the_preset_selection(dvd, langs, want):
    from handbrake_tpu_torch.job.presets import preset_search, preset_to_job
    root, _ac3, _ps = dvd
    (title,) = scan(root, preview_count=2)
    preset = dict(preset_search("Fast 480p30"), AudioLanguageList=langs)
    assert [a.track for a in preset_to_job(title, preset).audio] == want


# IFO attribute lists that say otherwise than the VOBs, and the log line
# each gives
DISAGREEMENTS = {
    "codec": ([("ac3", 6, "en"), ("mp2", 6, "en"), ("lpcm", 2, "fr")],
              "audio stream 2 is dts in the VOBs, mp2 in the IFO; the "
              "stream's codec is kept"),
    "channels": ([("ac3", 2, "en"), ("dts", 6, "en"), ("lpcm", 2, "fr")],
                 "audio stream 1 (ac3) has 6 channels in the VOBs, 2 in "
                 "the IFO; the stream's count is kept"),
    "never-carried": (DVD_ATTRS + [("ac3", 2, "de")],
                      "the IFO lists audio stream 4 (ac3, 2 ch, ger) that "
                      "the VOBs never carry; it gets no track"),
}


@pytest.mark.parametrize("case", list(DISAGREEMENTS))
def test_dvd_ifo_disagreement_is_logged(dvd, tmp_path, capfd, case):
    attrs, line = DISAGREEMENTS[case]
    _root, _ac3, ps = dvd
    root = B.write_dvd(str(tmp_path / "disc"), ps, 2, [0.2, 0.2],
                       audio_attrs=[B.vts_audio_attr(*a) for a in attrs])
    d, _t = open_dvd_title(root)
    got = [(t.codec, t.channels, t.language)
           for t in d.tracks if t.kind == "audio"]
    d.close()
    assert got == [("ac3", 6, "eng" if case != "channels" else "eng"),
                   ("dts", 6, "eng"), ("lpcm", 2, "fre")]
    assert f"dvd: {line}" in capfd.readouterr().err


def test_dvd_preset_job_to_mp4(dvd, tmp_path):
    """A preset that copies AC-3 beside an AAC stereo encode of the
    first English track: two outputs of track 1, the copy's frames,
    dac3 and 6 channels the stream's (not the preset mixdown's 2), the
    DTS and LPCM tracks left out."""
    import json
    from handbrake_tpu_torch.job.presets import preset_search
    root, ac3, _ps = dvd
    preset = dict(preset_search("Fast 480p30"),
                  AudioLanguageList=["eng"],
                  AudioTrackSelectionBehavior="first",
                  AudioCopyMask=["copy:ac3"], AudioEncoderFallback="aac",
                  AudioList=[{"AudioEncoder": "aac", "AudioBitrate": 160,
                              "AudioMixdown": "stereo"},
                             {"AudioEncoder": "copy"}])
    pf = str(tmp_path / "p.json")
    with open(pf, "w") as f:
        json.dump(preset, f)
    out = str(tmp_path / "dvd.mp4")
    assert cli(["-i", root, "-o", out, "--preset-import-file", pf, "-e",
                "h264", "-q", "28", "--encoder-profile", "high",
                "--previews", "2", "--device", "cpu"]) == 0
    tracks, pk = _packets(out)
    assert [t[:4] for t in tracks[1:]] == [("audio", "aac", 48000, 2),
                                           ("audio", "ac3", 48000, 6)]
    assert [p for _pts, p in pk[2]] == list(ac3)
    assert tracks[2][4] == dac3(read_bsi(ac3[0]))
    from handbrake_tpu_torch.audio.aacdec import AACDecoder
    dec = AACDecoder(tracks[1][4])
    pcm = np.concatenate([dec.decode_frame(p) for _pts, p in pk[1]])
    # the encoder's priming frame and the last frame's padding aside,
    # the AC-3 track's length
    assert abs(pcm.shape[0] - 1536 * len(ac3)) <= 2 * 1024
    assert np.isfinite(pcm).all() and np.abs(pcm).max() > 0.05
