"""A Blu-ray's usual streams as tracks of the port (``sources/ts.py``,
``sources/bd.py``, ``audio/frames.py`` and ``work.py``'s copy path, on
the CPU), each beside the JAX package's behaviour on the same input:

- a TS and a BDMV folder over two m2ts clips that carry, beside H.264
  and an AC-3 track (stream type 0x81), Dolby TrueHD (0x83: the
  committed libavcodec fixture's access units at PES
  stream_id_extension 0x72, the AC-3 syncframes of its core at 0x76,
  interleaved on one PID), E-AC-3 (0x84, 0xA1), DTS-HD (0x85, its
  extension substream with static fields), DTS Express (0xA2), PGS
  (0x90, a display set cut across PES packets mid-segment) and IGS
  (0x91).  The port lists video, the audio in PMT order with the
  TrueHD core as an ``ac3`` track of its own, then the ``pgs`` track,
  and logs the skipped 0x91 entry; the reference lists video and AC-3;
- copies to mkv: the TrueHD blocks are the fixture's units one by one,
  the first with a major sync, no AC-3 byte among them, labelled with
  libavcodec's rate and channels; the core's blocks its syncframes;
  E-AC-3 and DTS-HD framed as the other disc copies are, the DTS-HD track
  labelled with its extension substream's nuTotalNumChs; DTS Express
  labelled from its asset descriptor, and refused where its header
  carries no static fields; the PGS track kept as S_HDMV/PGS blocks
  equal to the display sets;
- the PGS burned: the video samples equal those of the same job on an
  mkv source with the same H.264 stream and display sets;
- ``copy:truehd`` to mp4 with libavcodec hidden, as on the card
  machine, raises WorkError naming it;
- the TrueHD readers on the fixture: its major syncs where libavcodec
  marked key units, the rate and channel fields, the framer against
  arbitrary cuts and a head that is no unit.

The fixture (``tests/data/torch_sources/truehd_48k_2.0.{thd,json}``) is
read from disk: no test here loads libavcodec."""
import functools
import json
import os
import random

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from handbrake_tpu.sources import bd as jbd
from handbrake_tpu.sources.ts import TSDemuxer as JTSDemuxer
from handbrake_tpu_torch import work
from handbrake_tpu_torch.audio import frames as F
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.sources import bd
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.ts import TSDemuxer
from handbrake_tpu_torch.subtitles.pgs import build_display_set
from handbrake_tpu_torch.tools import source_builders as B
from test_torch_audio_copy_job import EAC3_STREAMS
from test_torch_sources import FRAME, T0, ac3_frames, h264_aus
from torch_catalog import MISSING, hide

N = 16                         # pictures: 0.53 s, the fixture's 0.5 s


@functools.lru_cache(None)
def truehd():
    """(the fixture's units, libavcodec's account of them)."""
    data = B.fixture("truehd_48k_2.0.thd")
    info = json.loads(B.fixture("truehd_48k_2.0.json"))
    ends = np.cumsum(info["unit_sizes"]).tolist()
    return [data[a:b] for a, b in zip([0] + ends[:-1], ends)], info


def _pts(n, samples, rate=48000):
    return [T0 + k * samples * 90000 // rate for k in range(n)]


@functools.lru_cache(None)
def streams():
    """kind: (stream type, PID, stream id, language, frames,
    samples a frame, rate, channels the copy says), in PMT order."""
    eac3 = [b"".join(EAC3_STREAMS["5.1"])] * 10
    d = MKVDemuxer(os.path.join(B.FIXTURES, "eac3_176x144.mkv"))
    eac3_2 = [bytes(b.data) for t, b in d.packets() if t == 1]
    d.close()
    units, info = truehd()
    return {
        "ac3": (0x81, 0x1100, 0xBD, "eng", list(ac3_frames(seconds=0.4)),
                1536, 48000, 2),
        "truehd": (0x83, 0x1101, 0xFD, "fra", units,
                   info["samples_per_unit"], info["decoded_sample_rate"],
                   info["decoded_channels"]),
        "core": (0x83, 0x1101, 0xFD, "fra",
                 list(ac3_frames(ch=6, seconds=0.5, seed=3)), 1536, 48000,
                 6),
        "eac3": (0x84, 0x1102, 0xFD, "", eac3, 1536, 48000, 6),
        "dts-hd": (0x85, 0x1103, 0xFD, "", [
            B.dts_core_frame(size=1024, fill=k + 1)
            + B.dts_exss(600 + 8 * k, fill=k + 40, asset=(48000, 8, 512))
            for k in range(20)], 512, 48000, 8),
        "eac3-secondary": (0xA1, 0x1104, 0xFD, "", eac3_2, 1536, 48000, 2),
        "dts-express": (0xA2, 0x1105, 0xFD, "", [
            B.dts_exss(400 + 4 * k, fill=k + 60, asset=(48000, 2, 1024))
            for k in range(20)], 1024, 48000, 2),
    }


AUDIO = ["ac3", "truehd", "core", "eac3", "dts-hd", "eac3-secondary",
         "dts-express"]
CODECS = {"ac3": "ac3", "truehd": "truehd", "core": "ac3", "eac3": "eac3",
          "dts-hd": "dts", "eac3-secondary": "eac3", "dts-express": "dts"}


@functools.lru_cache(None)
def display_sets():
    """(pts, display set): a card shown on picture 2, cleared on 7."""
    pal = np.zeros((256, 4), np.uint8)
    pal[1] = (235, 128, 128, 255)
    pal[2] = (81, 90, 240, 180)
    card = np.ones((12, 30), np.uint8)
    card[3:9, 4:26] = 2
    return [(2 * FRAME, build_display_set(2 * FRAME, card, pal, 20, 16,
                                          screen=(64, 48))),
            (7 * FRAME, build_display_set(7 * FRAME, card, pal, 0, 0,
                                          screen=(64, 48), clear=True))]


def _units(kind):
    """build_ts units of one sound track: several frames a PES and one
    frame split across two; the TrueHD units 12 a PES at extension 0x72,
    its core's syncframes one a PES at 0x76."""
    _st, pid, sid, _lang, frames, samples, rate, _ch = streams()[kind]
    pts = _pts(len(frames), samples, rate)
    ends = np.cumsum([len(f) for f in frames]).tolist()
    ext = {"truehd": 0x72, "core": 0x76}.get(kind)
    per = 12 if kind == "truehd" else 1 if kind == "core" else 3
    cuts = set(ends[per - 1:-1:per]) | {ends[4] + len(frames[5]) // 2}
    return B.pes_units(pid, sid, frames, pts, sorted(cuts), ext)


def bd_ts(kinds=AUDIO, pgs=True):
    """The TS: H.264 on 0x1011, ``kinds`` in AUDIO's order, the PGS
    display sets (the first cut inside its first segment, the PES after
    the cut without a PTS), an IGS PID that no track reads."""
    s = streams()
    pmt = [(0x1B, 0x1011, b"")]
    units = [(T0 + i * FRAME, 0x1011, 0xE0, au, T0 + i * FRAME)
             for i, au in enumerate(h264_aus(n=N))]
    for k in kinds:
        stype, pid, _sid, lang, *_ = s[k]
        if k != "core":
            pmt.append((stype, pid, B.lang_descriptor(lang) if lang
                        else b""))
        units += _units(k)
    if pgs:
        pmt += [(0x90, 0x1200, B.lang_descriptor("deu")),
                (0x91, 0x1300, b"")]
        (p0, ds0), (p1, ds1) = display_sets()
        units += [(T0 + p0, 0x1200, 0xBD, ds0[:20], T0 + p0),
                  (T0 + p0 + 1, 0x1200, 0xBD, ds0[20:], None),
                  (T0 + p1, 0x1200, 0xBD, ds1, T0 + p1),
                  (T0, 0x1300, 0xBD, b"\x16\x00\x04igs!", T0)]
    return B.build_ts(pmt, units)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("bdstreams")
    ts = bd_ts()
    path = str(d / "bd.ts")
    with open(path, "wb") as f:
        f.write(ts)
    root = B.write_bd(str(d / "disc"), ts, 2, N / 30, [(0, 0.0)])
    return {"ts": path, "bd": root}


def _open(Mod, src):
    """The port's or the reference's demuxer of the TS or the folder."""
    if os.path.isdir(src):
        return (bd if Mod is TSDemuxer else jbd).open_bd_title(src)[0]
    return Mod(src)


def _listing(d):
    try:
        return [(t.kind, t.codec, t.language) for t in d.tracks]
    finally:
        d.close()


PORT_TRACKS = [("video", "h264", "und"), ("audio", "ac3", "eng"),
               ("audio", "truehd", "fra"), ("audio", "ac3", "fra"),
               ("audio", "eac3", "und"), ("audio", "dts", "und"),
               ("audio", "eac3", "und"), ("audio", "dts", "und"),
               ("subtitle", "pgs", "deu")]


@pytest.mark.parametrize("src", ["ts", "bd"])
def test_track_list_beside_the_reference(sources, src, capfd):
    """Both demuxers of the TS and of the folder: the port's nine tracks,
    the skipped IGS entry logged with its type and PID; the reference's
    two."""
    capfd.readouterr()
    assert _listing(_open(TSDemuxer, sources[src])) == PORT_TRACKS
    err = capfd.readouterr().err
    assert err.count("ts: PMT entry of stream type 0x91 on PID 0x1300 "
                     "skipped") == 1
    assert [t[:2] for t in _listing(_open(JTSDemuxer, sources[src]))] == [
        ("video", "h264"), ("audio", "ac3")]


def _by_track(d):
    out = {}
    try:
        for trk, b in d.packets():
            out.setdefault(trk, []).append((b.pts, bytes(b.data)))
    finally:
        d.close()
    return out


def test_bd_clips_keep_the_extension_routing(sources):
    """The folder's two clips give the TS's packets, track by track: the
    cut between the clips falls inside the TrueHD PID's PES run, and its
    TrueHD and AC-3 bytes stay apart; the PGS track gives whole display
    sets at their PTS."""
    got = _by_track(_open(TSDemuxer, sources["bd"]))
    assert got == _by_track(TSDemuxer(sources["ts"]))
    units = truehd()[0]
    assert b"".join(p for _t, p in got[2]) == b"".join(units)
    assert b"".join(p for _t, p in got[3]) == b"".join(streams()["core"][4])
    assert got[8] == [(T0 + p, ds) for p, ds in display_sets()]
    # the cut is inside the TrueHD PID's run of TS packets
    with open(sources["ts"], "rb") as f:
        ts = f.read()
    n = len(ts) // 188
    pids = [((ts[i * 188 + 1] & 0x1F) << 8) | ts[i * 188 + 2]
            for i in range(n)]
    first = pids.index(0x1101)
    last = n - 1 - pids[::-1].index(0x1101)
    assert first < n // 2 < last


def test_truehd_pes_without_the_extension_is_truehd(tmp_path):
    """On a TrueHD PID only extension 0x76 is the AC-3 core, as mpegts.c
    routes them: PES packets with no extension carry TrueHD."""
    units = truehd()[0][:48]
    core = list(ac3_frames(seconds=0.1))
    pts = _pts(48, 40)
    ts = B.build_ts([(0x1B, 0x1011, b""), (0x83, 0x1101, b"")], [
        (T0 + i * FRAME, 0x1011, 0xE0, au, T0 + i * FRAME)
        for i, au in enumerate(h264_aus(n=2))]
        + [(pts[k], 0x1101, 0xFD, b"".join(units[k:k + 12]), pts[k])
           for k in range(0, 48, 12)]
        + [(T0 + k * 2880, 0x1101, 0xFD, f, T0 + k * 2880, 0x76)
           for k, f in enumerate(core)])
    src = str(tmp_path / "thd.ts")
    with open(src, "wb") as f:
        f.write(ts)
    got = _by_track(TSDemuxer(src))
    assert b"".join(p for _t, p in got[1]) == b"".join(units)
    assert [p for _t, p in got[2]] == core


def _job(src, out, mux="mkv", audio=(), subs=()):
    """A job of the port.  These tests hold the sound and the subtitles,
    so the video's in-loop filter is off: each job codes cheaply."""
    j = S.Job(path=src, file=out, mux=mux, vcodec="h264", quality=28.0,
              encoder_options="deblock=0")
    j.audio = [S.AudioJobTrack(track=t, encoder=e) for t, e in audio]
    j.subtitles = [S.SubtitleJobTrack(**s) for s in subs]
    return j


def _read(path):
    """[(kind, codec, rate, channels)], {track: [(pts, bytes)]}."""
    d = MKVDemuxer(path)
    tracks = [(t.kind, t.codec, t.sample_rate, t.channels) for t in d.tracks]
    return tracks, _by_track(d)


@pytest.fixture(scope="module")
def copies(sources, tmp_path_factory):
    """Each source's every sound track copied to mkv, the PGS kept."""
    d = tmp_path_factory.mktemp("bdcopies")
    out = {}
    for name, src in sources.items():
        out[name] = str(d / f"{name}.mkv")
        work.do_job(_job(src, out[name], audio=[
            (i, f"copy:{CODECS[k]}") for i, k in enumerate(AUDIO)],
            subs=[dict(track=0)]), device="cpu")
    return out


@pytest.mark.parametrize("src", ["ts", "bd"])
def test_truehd_copy_is_the_fixture_units(copies, src):
    units, info = truehd()
    tracks, pk = _read(copies[src])
    blocks = [p for _t, p in pk[2]]
    assert blocks == units
    assert F.truehd_major_sync(blocks[0]) is not None
    core = streams()["core"][4]
    assert not any(f in b for b in blocks for f in core[:2])
    assert tracks[2] == ("audio", "truehd", info["decoded_sample_rate"],
                         info["decoded_channels"])
    # each block at its unit's time (mkv keeps milliseconds)
    assert all(abs(t - (T0 + k * 75)) <= 90
               for k, (t, _p) in enumerate(pk[2]))


@pytest.mark.parametrize("src", ["ts", "bd"])
@pytest.mark.parametrize("kind", [k for k in AUDIO if k != "truehd"])
def test_other_copies_are_their_frames(copies, src, kind):
    """The core's blocks are its syncframes; E-AC-3, DTS-HD and DTS
    Express are framed and labelled from their headers: DTS-HD with
    its extension substream's 8 channels, not its core's 6."""
    _st, _pid, _sid, _l, frames, _n, rate, ch = streams()[kind]
    tracks, pk = _read(copies[src])
    trk = 1 + AUDIO.index(kind)
    assert [p for _t, p in pk[trk]] == list(frames)
    assert tracks[trk] == ("audio", CODECS[kind], rate, ch)


@pytest.mark.parametrize("src", ["ts", "bd"])
def test_pgs_kept_as_display_sets(copies, src):
    tracks, pk = _read(copies[src])
    assert tracks[8][:2] == ("subtitle", "pgs")
    assert [p for _t, p in pk[8]] == [ds for _p, ds in display_sets()]


def test_dts_express_without_static_fields_refused(tmp_path):
    """A DTS Express stream whose extension substreams carry no static
    fields does not say its rate or channels: the copy raises, naming
    the track, and writes no file."""
    frames = [B.dts_exss(400, fill=k + 1) for k in range(8)]
    units = [(T0 + i * FRAME, 0x1011, 0xE0, au, T0 + i * FRAME)
             for i, au in enumerate(h264_aus(n=4))]
    units += B.pes_units(0x1105, 0xFD, frames, _pts(8, 1024), [800, 1600])
    src = str(tmp_path / "express.ts")
    with open(src, "wb") as f:
        f.write(B.build_ts([(0x1B, 0x1011, b""), (0xA2, 0x1105, b"")],
                           units))
    out = str(tmp_path / "out.mkv")
    with pytest.raises(work.WorkError, match="audio track 1: a DTS Express "
                       "stream .* no static fields"):
        work.do_job(_job(src, out, audio=[(0, "copy:dts")]), device="cpu")
    assert not os.path.exists(out)


def _mkv_twin(path):
    """An mkv of the same H.264 stream and display sets, from time 0."""
    w = MKVWriter(path)
    vi = w.add_video_track(codec="h264", width=64, height=48,
                           fps=30000 / 1001)
    si = w.add_subtitle_track(codec="pgs")
    for i, au in enumerate(h264_aus(n=N)):
        w.write_sample(vi, au, pts_90k=i * FRAME, duration_90k=FRAME,
                       sync=i == 0, annexb=True)
        if i == 0:
            for pts, ds in display_sets():
                w.write_sample(si, ds, pts_90k=pts)
    w.finalize()
    return path


@pytest.fixture(scope="module")
def burned_mkv_twin(tmp_path_factory):
    d = tmp_path_factory.mktemp("bdburn")
    out = str(d / "twin.mkv")
    work.do_job(_job(_mkv_twin(str(d / "twin_src.mkv")), out,
                     subs=[dict(track=0, burn=True)]), device="cpu")
    plain = str(d / "plain.mkv")
    work.do_job(_job(_mkv_twin(str(d / "plain_src.mkv")), plain),
                device="cpu")
    return _read(out)[1][0], _read(plain)[1][0]


@pytest.mark.parametrize("src", ["ts", "bd"])
def test_pgs_burned_equals_the_mkv_source(sources, burned_mkv_twin, src,
                                          tmp_path):
    out = str(tmp_path / "burn.mkv")
    work.do_job(_job(sources[src], out, subs=[dict(track=0, burn=True)]),
                device="cpu")
    tracks, pk = _read(out)
    assert [t[0] for t in tracks] == ["video"]
    twin, plain = burned_mkv_twin
    assert [p for _t, p in pk[0]] == [p for _t, p in twin]
    assert [p for _t, p in twin] != [p for _t, p in plain]   # it shows


def test_truehd_to_mp4_needs_libavcodec(sources, tmp_path, monkeypatch):
    """mp4 holds no TrueHD, so the copy takes the fallback encoder, whose
    decoder is libavcodec's: with the library hidden the job refuses,
    naming it, before any file exists."""
    hide(monkeypatch, tmp_path)
    out = str(tmp_path / "out.mp4")
    with pytest.raises(work.WorkError, match=rf"truehd: decoding the track "
                       rf"needs libavcodec, which is missing \({MISSING}"):
        work.do_job(_job(sources["ts"], out, mux="mp4",
                         audio=[(1, "copy:truehd")]), device="cpu")
    assert not os.path.exists(out)


# ---------------------------------------------------------------------------
# the TrueHD readers
# ---------------------------------------------------------------------------
def test_major_syncs_where_libavcodec_marked_key_units():
    units, info = truehd()
    assert [i for i, u in enumerate(units)
            if F.truehd_major_sync(u) is not None] == info["key_units"]
    m = F.truehd_major_sync(units[0])
    assert (m.sample_rate, m.channels, m.samples) == (
        info["decoded_sample_rate"], info["decoded_channels"],
        info["samples_per_unit"])
    assert all(F.truehd_parity(u, m.substreams) for i, u in enumerate(units)
               if i not in info["key_units"])
    assert sum(info["unit_sizes"]) == len(B.fixture("truehd_48k_2.0.thd"))
    assert len(units) * m.samples == info["decoded_samples"]
    # a unit whose major sync is damaged carries none
    bad = bytearray(units[0])
    bad[12] ^= 1
    assert F.truehd_major_sync(bytes(bad)) is None


def _with_format(unit, code, six, eight):
    """``unit`` with its major sync's rate code and the 6- and 8-channel
    presentations' assignments replaced, the checksum made anew."""
    u = bytearray(unit)
    v = int.from_bytes(u[8:12], "big")
    v = (v & 0x0FF06000) | code << 28 | six << 15 | eight
    u[8:12] = v.to_bytes(4, "big")
    size = 28 + (2 + 2 * (u[30] >> 4) if u[29] & 1 else 0)
    check = F._crc16(bytes(u[4:4 + size - 4])) \
        ^ int.from_bytes(u[size:size + 2], "big")
    u[size + 2:size + 4] = check.to_bytes(2, "big")
    return bytes(u)


@pytest.mark.parametrize("code,rate,samples", [
    (0, 48000, 40), (1, 96000, 80), (2, 192000, 160), (8, 44100, 40),
    (9, 88200, 80), (10, 176400, 160)])
@pytest.mark.parametrize("six,eight,ch", [
    (0b00001, 0, 2), (0b01111, 0, 6), (0b01111, 0b1001111, 8),
    (0b01011, 0b1000001011, 7), (0b00011, 0b1100000000000, 2)])
def test_major_sync_rate_and_channels(code, rate, samples, six, eight, ch):
    """libavcodec's reading: the rate code, 40 samples a unit per 48 or
    44.1 kHz, the 8-channel assignment where it is not 0, else the
    6-channel one, each bit counting its speakers."""
    u = _with_format(truehd()[0][0], code, six, eight)
    assert F.truehd_major_sync(u)[:3] == (rate, ch, samples)
    h = F.truehd_unit(u)
    assert (h.size, h.sample_rate, h.channels) == (len(u), rate, ch)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10 ** 6), ncuts=st.integers(0, 60))
def test_truehd_framer_against_arbitrary_cuts(seed, ncuts):
    """The fixture cut anywhere, each packet with the pts of the first
    unit that begins in it: the units come back whole, each pts its
    packet's or the one before plus 40 samples."""
    units, _info = truehd()
    pts = _pts(len(units), 40)
    data = b"".join(units)
    rng = random.Random(seed)
    cuts = sorted(rng.sample(range(1, len(data)), ncuts))
    fr = F.Framer("truehd", quiet=True)
    got = []
    for p, payload, _n, _first in B.es_pieces(units, pts, cuts):
        got += fr.feed(payload, p)
    got += fr.flush()
    assert [f.data for f in got] == units
    assert [f.pts for f in got] == pts
    assert fr.dropped == 0


def test_truehd_framer_starts_at_a_major_sync(capfd):
    """A copy that begins mid-stream starts at the next unit with a major
    sync; what comes before it is dropped with one log line, and so is
    a damaged unit's run up to the next major sync."""
    units, info = truehd()
    keys = info["key_units"]
    head = b"".join(units[5:keys[1]])
    body = b"".join(units[keys[1]:keys[3]])
    bad = bytearray(units[keys[3] + 2])
    bad[0] ^= 0x10                       # its check nibble no longer holds
    rest = units[keys[3]:keys[3] + 2] + [bytes(bad)] + units[keys[3] + 3:]
    fr = F.Framer("truehd", "audio track 2 (truehd)")
    got = fr.feed(head + body + b"".join(rest)) + fr.flush()
    assert [f.data for f in got] == units[keys[1]:keys[3] + 2] \
        + units[keys[4]:]
    err = capfd.readouterr().err
    assert f"audio: audio track 2 (truehd) copy: {len(head)} bytes dropped " \
        f"(before the first major sync)" in err
    lost = sum(map(len, units[keys[3] + 2:keys[4]]))
    assert f"{lost} bytes dropped (no frame: resynced at the next major " \
        f"sync)" in err


# ---------------------------------------------------------------------------
# DTS: the extension substream's static fields (ROADMAP 3.18)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("asset,ch", [(None, 6), ((48000, 8, 512), 8),
                                      ((96000, 2, 1024), 2)])
def test_dts_hd_channels_from_the_extension(wide, asset, ch):
    """A core 5.1 frame with an extension substream: labelled with the
    substream's nuTotalNumChs where its header carries static fields,
    else the core's; the core's rate and samples either way."""
    f = B.dts_core_frame(size=1024) + B.dts_exss(900, wide=wide,
                                                  asset=asset)
    h = F.dts_header(f)
    assert (h.size, h.samples, h.sample_rate, h.channels) == (1924, 512,
                                                              48000, ch)


def test_dts_express_frames_from_the_asset_descriptor():
    x = B.dts_exss(700, asset=(96000, 6, 1024))
    assert F.dts_header(x)[:4] == (700, 1024, 96000, 6)
    assert F.dts_header(B.dts_exss(700))[:4] == (700, 0, 0, 0)
    # a stray extension substream before a core frame is no frame
    core = [B.dts_core_frame(size=1024, fill=k) + B.dts_exss(300)
            for k in range(4)]
    fr = F.Framer("dts", quiet=True)
    got = fr.feed(B.dts_exss(300) + b"".join(core)) + fr.flush()
    assert [f.data for f in got] == core and fr.dropped == 300
