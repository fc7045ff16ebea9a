"""Disc and stream sources on the port's job path (on the CPU), held
against the JAX package byte for byte: a DVD-Video folder (the 176x144
MPEG-2 fixture over two VOBs, an AC-3 track copied, a DVD LPCM track to
AAC, a VobSub card burned with the IFO's palette, chapter markers), a
Blu-ray folder (H.264 and AC-3 over two m2ts clips, an MPLS with two
chapter marks), a TS with MP2 audio, an MPEG-2 PS whose user data
carries CEA-608 captions (kept as a text track), an MJPEG AVI, the CLI on
the DVD folder (``-t``, ``-c``, ``-m``) and ``scan`` of each.  Then the
codecs that the port leaves to later items raise, naming the item.

The DVD job's mp4 equals the reference's apart from the AC-3 copy's
``dac3`` payload: the port's is the copied stream's BSI, the reference's
a guess from the track's channel count (``dac3_apart``)."""
import functools
import os
from fractions import Fraction

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu.scan import scan as jscan
from handbrake_tpu_torch import work
from handbrake_tpu_torch.audio.ac3dec import read_bsi
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mp4 import dac3
from handbrake_tpu_torch.scan import scan
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.tools import source_builders as B
from handbrake_tpu_torch.work import WorkError
from test_torch_sources import (FRAME, T0, ac3_frames, dvd_units, h264_aus,
                                h264_ts, mp2_frames)
from torch_rates import (reference_rule, shaper_input, times_of,
                         vfr_c_rule, vfr_c_shaper, video_times)


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """Each shape compiles the reference's analyzer once in this module;
    the reference encodes on its device path, as the port does."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        yield


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("discjobs")
    es = B.fixture("mpeg2_176x144.m2v")
    out = {"dvd": B.write_dvd(str(d / "dvd"), B.build_ps(dvd_units(es)), 2,
                              [0.2, 0.2])}
    ts = h264_ts(n=8, audio=[(0x81, 0x1100, 0xBD, b"", ac3_frames(), 2880)])
    out["bd"] = B.write_bd(str(d / "bd"), ts, 2, 8 / 30,
                           [(0, 0.0), (1, 0.05)])
    out["ts"] = str(d / "mp2.ts")
    with open(out["ts"], "wb") as f:
        f.write(h264_ts(n=8, audio=[(0x03, 0x101, 0xC0, b"",
                                     mp2_frames()[:10], 2160)]))
    # captions: loaded on picture 1, shown (EOC) on 2, erased (EDM) on 8
    user = {1: B.cc_user_data(B.cea608_popon("CAPTION ONE")),
            2: B.cc_user_data([(0x14, 0x2F)]),
            8: B.cc_user_data([(0x14, 0x2C)])}
    out["cc"] = str(d / "cc.mpg")
    with open(out["cc"], "wb") as f:
        f.write(B.build_ps(B.video_units(es, T0, FRAME, user=user)))
    cv2 = pytest.importorskip("cv2")
    out["avi"] = str(d / "cam.avi")
    vw = cv2.VideoWriter(out["avi"], cv2.VideoWriter_fourcc(*"MJPG"), 25,
                         (176, 144))
    rng = np.random.default_rng(7)
    base = cv2.GaussianBlur(rng.integers(0, 255, (160, 200, 3), np.uint8),
                            (0, 0), 2)
    for i in range(8):
        vw.write(base[i:i + 144, 2 * i:2 * i + 176])
    vw.release()
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# the DVD fixture's AC-3 track (2/0, 48 kHz, 192 kb/s): its own dac3
# (bsid 8, bit_rate_code 10), and the reference's guess from the channel
# count, whose bit_rate_code is 11 whatever the stream's rate
DVD_DAC3, DVD_DAC3_REF = bytes.fromhex("101140"), bytes.fromhex("101160")


def dac3_apart(got: bytes, want: bytes) -> tuple:
    """(the port's dac3 payload, the reference's, the port's file with
    the reference's payload in place of its own): two mp4s that have one
    dac3 box each, at the same offset."""
    i = got.find(b"dac3")
    assert i > 0 and got.count(b"dac3") == want.count(b"dac3") == 1
    assert want.find(b"dac3") == i
    return got[i + 4:i + 7], want[i + 4:i + 7], \
        got[:i + 4] + want[i + 4:i + 7] + got[i + 7:]


def _job(Sm, src, out, mux, audio=(), subs=(), markers=False):
    j = Sm.Job(path=src, file=out, mux=mux, vcodec="h264", quality=28.0,
               encoder_profile="high", chapter_markers=markers)
    j.audio = [Sm.AudioJobTrack(**a) for a in audio]
    j.subtitles = [Sm.SubtitleJobTrack(**s) for s in subs]
    return j


JOBS = {
    "dvd": ("mp4", [dict(track=0, encoder="copy:ac3"),
                    dict(track=1, encoder="aac")],
            [dict(track=0, burn=True)], True),
    "bd": ("mkv", [dict(track=0, encoder="copy:ac3")], [], True),
    "ts": ("mp4", [dict(track=0, encoder="aac")], [], False),
    "cc": ("mkv", [], [dict(cc=True, language="eng")], False),
    "avi": ("mp4", [], [], False),
}


def _luma(path, k):
    """Frame k of an output's H.264 track, decoded by the port."""
    from handbrake_tpu_torch.codecs.registry import create_video_decoder
    d = MP4Demuxer(path)
    dec = create_video_decoder("h264", d.tracks[0].extradata)
    frames = []
    for i in range(d.n_samples(0)):
        frames += dec.feed(d.read_sample(0, i))
    d.close()
    return np.asarray(frames[k].planes[0]).astype(int)


@pytest.mark.parametrize("name", list(JOBS))
def test_disc_and_stream_jobs_equal_reference(sources, tmp_path, name):
    mux, audio, subs, markers = JOBS[name]
    jout = str(tmp_path / f"ref.{mux}")
    tout = str(tmp_path / f"port.{mux}")
    jwork.do_job(_job(JS, sources[name], jout, mux, audio, subs, markers))
    stats = work.do_job(_job(S, sources[name], tout, mux, audio, subs,
                             markers), device="cpu")
    got, want = _bytes(tout), _bytes(jout)
    if name == "dvd":
        port, ref, got = dac3_apart(got, want)
        assert (port, ref) == (DVD_DAC3, DVD_DAC3_REF)
        assert port == dac3(read_bsi(ac3_frames()[0]))
    assert got == want
    assert stats["frames_out"] == {"bd": 8, "ts": 8, "avi": 8}.get(name, 12)
    D = MKVDemuxer if mux == "mkv" else MP4Demuxer
    d = D(tout)
    kinds = [(t.kind, t.codec) for t in d.tracks]
    chapters = list(getattr(d, "chapters", []))
    pkts = [(t, bytes(b.data)) for t, b in d.packets()]
    d.close()
    if name == "dvd":
        assert kinds[1:] == [("audio", "ac3"), ("audio", "aac")]
        assert [p for t, p in pkts if t == 1] == list(ac3_frames())
        assert len(chapters) == 2
        # the white card (30, 20, 32x16) shows from its picture on
        card = (slice(22, 34), slice(32, 60))
        assert _luma(tout, 3)[card].mean() > _luma(tout, 0)[card].mean() + 60
    elif name == "bd":
        assert kinds[1] == ("audio", "ac3") and len(chapters) == 2
    elif name == "cc":
        assert any(b"CAPTION ONE" in p for t, p in pkts if t == 1)


def test_cli_on_a_dvd_folder_equals_reference(sources, tmp_path):
    """-t 1 -c 2 -m: title 1's second chapter, with its marker.  Where
    the two VOBs meet the sync leaves a frame of 18 ticks, which the
    default preset's peak-rate shaper (30) counts as a whole frame, so
    the frames after it stop on the peak's grid (vfr.c's rule, ROADMAP
    3.20): the file equals the reference's with its shaper on that
    rule, and the reference's own shaper keeps each frame's own times
    and drops the frame after the short one."""
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    args = ["-i", sources["dvd"], "-t", "1", "-c", "2", "-m", "-e", "h264",
            "-q", "28", "--encoder-profile", "high"]
    with vfr_c_shaper():
        assert jcli([*args, "-o", jout]) == 0
    with shaper_input() as frames:
        assert cli([*args, "-o", tout, "--device", "cpu"]) == 0
    assert _bytes(tout) == _bytes(jout)
    own = str(tmp_path / "ref_own.mp4")
    assert jcli([*args, "-o", own]) == 0
    peak = Fraction(30)
    assert video_times(tout) == times_of(vfr_c_rule(frames, peak))
    assert video_times(own) == times_of(reference_rule(frames, peak))
    assert any(d < 100 for _p, d in frames)
    d = MP4Demuxer(tout)
    assert 0 < d.n_samples(0) < 12
    d.close()


def test_handle_on_a_dvd_folder_equals_reference(sources, tmp_path):
    """hb.Handle scans the folder and works the job on its threads: the
    DVD job's file, as the reference's Handle writes it."""
    from handbrake_tpu.hb import Handle as JHandle
    from handbrake_tpu_torch.hb import Handle
    outs = []
    for H_, Sm, kw in ((JHandle, JS, {}), (Handle, S, {"device": "cpu"})):
        h = H_(**kw)
        h.scan(sources["dvd"], preview_count=2)
        assert [t.video_codec for t in h.scan_wait(timeout=120)] == \
            ["mpeg2"]
        outs.append(str(tmp_path / f"{H_.__module__}.mp4"))
        mux, audio, subs, markers = JOBS["dvd"]
        h.add(_job(Sm, sources["dvd"], outs[-1], mux, audio, subs, markers))
        h.start()
        assert h.work_wait(timeout=300) == 0
        assert getattr(h, "work_exception", None) is None
        h.close()
    port, ref, got = dac3_apart(_bytes(outs[1]), _bytes(outs[0]))
    assert (port, ref) == (DVD_DAC3, DVD_DAC3_REF)
    assert got == _bytes(outs[0])


def _title(t):
    return (t.index, t.container, t.video_codec, t.width, t.height,
            t.vrate_num, t.vrate_den, t.duration, t.crop, t.interlaced,
            t.nframes, [(c.name, c.duration) for c in t.chapters],
            [(a.codec, a.sample_rate, a.channels, a.language)
             for a in t.audio],
            [(s.source, s.language) for s in t.subtitles])


@pytest.mark.parametrize("name", list(JOBS))
def test_scan_equals_reference(sources, name):
    got = [_title(t) for t in scan(sources[name], preview_count=2)]
    assert got == [_title(t) for t in jscan(sources[name], preview_count=2)]
    assert len(got) == 1
    want = {"dvd": ("mpeg2", 2, ["vobsub"]), "bd": ("h264", 2, []),
            "ts": ("h264", 0, []), "cc": ("mpeg2", 0, ["cc"]),
            "avi": ("mjpeg", 0, [])}[name]
    assert (got[0][2], len(got[0][11]), [s[0] for s in got[0][13]]) == want


# ---------------------------------------------------------------------------
# what the port leaves to later items raises, naming the item
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stype,kind,exc,match", [
    (0x24, "video", ValueError, "item 1.10"),     # HEVC beyond the subset
    (0x10, "video", ValueError, "libavcodec.so.59 not found"),  # MPEG-4
    (0x87, "audio", WorkError, "libavcodec.so.59 not found"),   # E-AC-3
    (0x82, "audio", WorkError, "libavcodec.so.59 not found"),   # DTS
    (0x11, "audio", WorkError, "aac_latm"),               # LATM AAC
    (0x80, "audio", WorkError, "lpcm"),                   # Blu-ray LPCM
], ids=["hevc", "mpeg4", "eac3", "dts", "aac_latm", "bd-lpcm"])
def test_unported_ts_codecs_raise(tmp_path, stype, kind, exc, match,
                                  monkeypatch):
    """A TS whose video, or whose selected audio track, the port cannot
    decode: the job raises before it encodes, naming the ROADMAP item,
    the codec or the missing library, and drops nothing without a word.
    HEVC beyond the native decoder's subset (SAO on), MPEG-4 part 2,
    E-AC-3 and DTS decode through libavcodec (item 1.10), so each is
    held here with the library hidden, as on a machine without it."""
    from torch_catalog import hide
    hide(monkeypatch, tmp_path)
    from test_torch_hevc import sao_stream
    aus = [sao_stream()] if stype == 0x24 else h264_aus()
    if kind == "video":
        streams = [(stype, 0x100, b"")]
        units = [(T0 + i * FRAME, 0x100, 0xE0, au, T0 + i * FRAME)
                 for i, au in enumerate(aus)]
    else:
        streams = [(0x1B, 0x100, b""), (stype, 0x101, b"")]
        units = [(T0 + i * FRAME, 0x100, 0xE0, au, T0 + i * FRAME)
                 for i, au in enumerate(aus)]
        units += [(T0 + k * 2880, 0x101, 0xBD, bytes(64), T0 + k * 2880)
                  for k in range(4)]
    path = str(tmp_path / "x.ts")
    with open(path, "wb") as f:
        f.write(B.build_ts(streams, units))
    audio = [dict(track=0, encoder="aac")] if kind == "audio" else []
    with pytest.raises(exc, match=match):
        work.do_job(_job(S, path, str(tmp_path / "x.mp4"), "mp4", audio),
                    device="cpu")
    assert not os.path.exists(str(tmp_path / "x.mp4")) or \
        os.path.getsize(str(tmp_path / "x.mp4")) == 0
