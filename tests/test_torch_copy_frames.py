"""A copied sound track of a program or transport stream cut into whole
frames on the port's job path (``audio/frames.py`` and ``work.py``'s
copy, on the CPU), beside the JAX package:

- each header reader against the port's own frames: AC-3 from its
  encoder at 48, 44.1 and 32 kHz in 1/0, 2/0 and 3/2+LFE, the E-AC-3
  access units of ``tests/test_torch_audio_copy_job.py`` and the
  committed E-AC-3 mkv, ``dts_core_frame`` alone and with the
  extension substreams of DTS-HD after it (``dts_exss``), the MP2
  fixture and MPEG audio headers of each version, ADTS from the AAC
  encoder;
- the framer against arbitrary cuts of the stream (hypothesis): the
  frames, their pts and their durations come back exactly, and no pts
  drifts from the sample clock; a head, a bad header and a tail that
  are no frame are dropped with one log line each;
- DVD folders whose AC-3 5.1 (448 and 640 kb/s) and DTS tracks are laid
  into 2048-byte sectors as an authoring tool lays them (frames across
  PES packets, a PTS only where a frame begins): copied to mp4 and mkv,
  each sample or block is one frame of the stream, the head and tail
  that are no frame dropped, the track labelled 6 channels at 48 kHz,
  and the copy decodes as the stream does.  The reference writes the
  448 kb/s stream's PES payloads as samples, labelled 2 channels, and
  raises TypeError on the 640 kb/s one, whose frames span two PES;
- TS and Blu-ray sources with several frames a PES and a frame split
  across two (AC-3, E-AC-3, DTS, DTS-HD as stream type 0x86, MP2, MP3
  at 44.1 kHz, ADTS AAC): every frame of the track one sample or
  block, in order and none lost, mp4 durations in samples, AAC without
  its ADTS header;
- a DVD copy job resumed from its journal equals the uninterrupted one;
- a copy with no whole frame raises, naming the track, before any file
  is written, and the sync never adds to a missing time."""
import functools
import os
import random
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from handbrake_tpu import work as jwork
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import checkpoint, work
from handbrake_tpu_torch.audio import frames as F
from handbrake_tpu_torch.audio.aac import AACEncoder
from handbrake_tpu_torch.audio.ac3dec import Ac3Decoder
from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.sources.ps import PSDemuxer
from handbrake_tpu_torch.sync.sync import SyncCore
from handbrake_tpu_torch.tools import source_builders as B
from test_torch_audio_copy_job import EAC3_STREAMS, eac3_frame
from test_torch_sources import FRAME, T0, h264_aus, mp2_frames, tone


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """The reference encodes on its device path, as the port does (some
    of its tests leave HB_TPU_DISABLE_DEVICE=1 set in the worker); its
    encoders of one shape share one jitted analyzer.  The port's jobs
    code 176x144 pictures on one host thread: more only contend with the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
            for name in ("build_p_analyzer", "build_p_analyzer_batch"):
                mp.setattr(encoder_tpu, name, functools.lru_cache(None)(
                    getattr(encoder_tpu, name)))
            yield
    finally:
        torch.set_num_threads(threads)


def _hdr(codec, frame):
    h = F.read_frame(codec, frame)
    return h.size, h.samples, h.sample_rate, h.channels


# ---------------------------------------------------------------------------
# the header readers
# ---------------------------------------------------------------------------
@functools.lru_cache(None)
def ac3_stream(rate, ch, kbps, seconds=0.1, seed=1):
    enc = Ac3Encoder(rate, ch, kbps * 1000)
    return tuple(enc.encode(tone(rate, ch, int(rate * seconds), seed))
                 + enc.flush())


@pytest.mark.parametrize("ch", [1, 2, 6])
@pytest.mark.parametrize("rate", [48000, 44100, 32000])
def test_ac3_header_of_the_encoder(rate, ch):
    # two frames' samples: the encoder's own and its flush
    frames = ac3_stream(rate, ch, 448 if ch == 6 else 192, 3072 / rate)
    assert len(frames) >= 2
    assert all(_hdr("ac3", f) == (len(f), 1536, rate, ch) for f in frames)


def test_eac3_headers_and_units():
    """Each syncframe reads alone; the framer keeps a dependent substream
    in its independent frame's access unit: 5.1, and 5.1 with Lrs/Rrs
    (7.1).  The committed E-AC-3 mkv's packets are whole units."""
    for name, ch in (("5.1", 6), ("5.1+Lrs/Rrs", 8)):
        unit = b"".join(EAC3_STREAMS[name])
        assert _hdr("eac3", EAC3_STREAMS[name][0]) == (512, 1536, 48000, 6)
        fr = F.Framer("eac3", quiet=True)
        got = fr.feed(unit * 3) + fr.flush()
        assert [(f.data, f.samples, f.sample_rate, f.channels)
                for f in got] == [(unit, 1536, 48000, ch)] * 3
    assert _hdr("eac3", eac3_frame(1, 2, 0, chanmap=1 << 9))[3] == 2
    src = os.path.join(B.FIXTURES, "eac3_176x144.mkv")
    d = MKVDemuxer(src)
    pkts = [bytes(b.data) for t, b in d.packets() if t == 1]
    d.close()
    assert pkts and all(_hdr("eac3", p) == (len(p), 1536, 48000, 2)
                        for p in pkts)


@pytest.mark.parametrize("amode,lff,sfreq,rate,ch,size,samples", [
    (9, 1, 13, 48000, 6, 1024, 512), (2, 0, 8, 44100, 2, 2012, 1024),
    (0, 0, 3, 32000, 1, 96, 256)])
def test_dts_core_header(amode, lff, sfreq, rate, ch, size, samples):
    f = B.dts_core_frame(amode=amode, lff=lff, sfreq=sfreq, size=size,
                         samples=samples)
    assert _hdr("dts", f) == (size, samples, rate, ch)
    assert F.read_frame("dts", f[:1] + b"\x00" + f[2:]) is None


def test_dts_hd_frame_takes_its_extension_substreams():
    """A DTS-HD frame is its core with the extension substreams after
    it, their sizes read from 8/16- and 12/20-bit fields; an extension
    whose header is not all there yet is not counted."""
    core = B.dts_core_frame(size=1024, fill=7)
    ext = B.dts_exss(700, fill=8)
    wide = B.dts_exss(70000, fill=9, wide=True)
    assert F.dts_exss_size(ext) == 700 and F.dts_exss_size(wide) == 70000
    assert _hdr("dts", core + ext + core) == (1724, 512, 48000, 6)
    assert _hdr("dts", core + ext + wide)[0] == 1024 + 700 + 70000
    assert _hdr("dts", core + ext[:9])[0] == 1024
    # packets that end where a core ends or inside the extension's
    # header: the framer waits for the header and keeps each frame whole
    _codec, frames, _n, _rate = _stream("dts-hd")
    for into in (0, 5):
        fr = F.Framer("dts", quiet=True)
        got = []
        for f in frames:
            got += fr.feed(f[:1024 + into]) + fr.feed(f[1024 + into:])
        got += fr.flush()
        assert [f.data for f in got] == frames and fr.dropped == 0


# MPEG audio headers: (bytes, size, samples, rate, channels)
MPA = {"mpeg1-l2-fixture": (None, 384, 1152, 48000, 2),
       "mpeg1-l3-128k": (b"\xff\xfb\x90\x64", 417, 1152, 44100, 2),
       "mpeg1-l3-padded-mono": (b"\xff\xfb\x92\xc4", 418, 1152, 44100, 1),
       "mpeg1-l1-384k": (b"\xff\xff\xc4\x00", 384, 384, 48000, 2),
       "mpeg2-l3-64k": (b"\xff\xf3\x80\x00", 208, 576, 22050, 2),
       "mpeg2.5-l3-32k": (b"\xff\xe3\x48\x00", 288, 576, 8000, 2)}


@pytest.mark.parametrize("name", list(MPA))
def test_mpeg_audio_header(name):
    head, *want = MPA[name]
    if head is None:
        frames = mp2_frames()
        assert all(_hdr("mp2", f) == tuple(want) for f in frames)
        return
    assert _hdr("mp3", head + bytes(16)) == tuple(want)


@pytest.mark.parametrize("rate,ch", [(48000, 2), (44100, 1)])
def test_adts_header_of_the_encoder(rate, ch):
    enc = AACEncoder(rate, ch, quality=120)
    aus = enc.encode(tone(rate, ch, rate // 10, 3)) + enc.flush()
    for au in aus:
        frame = enc.adts_header(len(au)) + au
        assert _hdr("aac", frame) == (len(frame), 1024, rate, ch)
        assert F.adts_payload(frame) == au
    asc = F.adts_config(F.adts_header(enc.adts_header(len(aus[0]))
                                      + aus[0]))
    assert asc == enc.audio_specific_config()
    with pytest.raises(ValueError):
        F.adts_payload(enc.adts_header(len(aus[0])) + aus[0] + b"\x00")
    # the muxer takes exactly one header off a sample, or refuses it
    frame = enc.adts_header(len(aus[0])) + aus[0]
    assert work._MuxAdapter._strip_adts(frame) == aus[0]
    for bad in (frame * 2, frame[:-1], aus[0]):
        with pytest.raises(work.WorkError, match="not one whole ADTS"):
            work._MuxAdapter._strip_adts(bad)


# ---------------------------------------------------------------------------
# the framer
# ---------------------------------------------------------------------------
def _stream(kind):
    """(codec, frames, samples a frame, rate) of one test stream."""
    if kind == "ac3":
        return "ac3", list(ac3_stream(48000, 2, 192, 0.2)), 1536, 48000
    if kind == "ac3-44.1":
        return "ac3", list(ac3_stream(44100, 1, 96, 0.2)), 1536, 44100
    if kind == "mp3-44.1":
        return "mp3", [b"\xff\xfb\x90\x64" + bytes([k]) * 413
                       for k in range(12)], 1152, 44100
    if kind == "dts":
        return "dts", [B.dts_core_frame(size=1024, fill=k + 1)
                       for k in range(10)], 512, 48000
    if kind == "dts-hd":
        # each core frame with an extension substream, as on a Blu-ray
        return "dts", [B.dts_core_frame(size=1024, fill=k + 1)
                       + B.dts_exss(300 + 16 * k, fill=k + 101)
                       for k in range(10)], 512, 48000
    if kind == "eac3":
        return "eac3", [b"".join(EAC3_STREAMS["5.1+Lrs/Rrs"])] * 6, \
            1536, 48000
    return "mp2", mp2_frames()[:12], 1152, 48000


def _cut_stream(frames, cuts, pts):
    """Packets of the stream cut at ``cuts``, each with the pts of the
    first frame beginning in it (None where none does)."""
    return [(payload, p) for p, payload, _n, _first in
            B.es_pieces(frames, pts, sorted(set(cuts)))]


def _spec_timing(frames, packets, samples, rate):
    """Each frame's (pts, stop) as the framer must give them: a packet's
    pts on the first frame beginning in it, then the samples since."""
    starts = np.cumsum([0] + [len(f) for f in frames[:-1]]).tolist()
    marks, off = {}, 0
    for payload, p in packets:
        first = next((s for s in starts if off <= s < off + len(payload)),
                     None)
        if p is not None:
            marks[first] = p
        off += len(payload)
    out, anchor, n = [], None, 0
    for s in starts:
        if s in marks:
            anchor, n = marks[s], 0
        out.append((anchor + n * 90000 // rate,
                    anchor + (n + samples) * 90000 // rate))
        n += samples
    return out


@settings(max_examples=40, deadline=None)
@given(kind=st.sampled_from(["ac3", "ac3-44.1", "mp3-44.1", "dts",
                             "dts-hd", "mp2", "eac3"]),
       seed=st.integers(0, 2 ** 16), ncuts=st.integers(0, 30))
def test_framer_against_arbitrary_cuts(kind, seed, ncuts):
    codec, frames, samples, rate = _stream(kind)
    es = b"".join(frames)
    rng = random.Random(seed)
    cuts = [rng.randrange(1, len(es)) for _ in range(ncuts)]
    # the sample clock, as a muxer on the encoder's side stamps each PES
    exact = [T0 + k * samples * 90000 // rate for k in range(len(frames))]
    packets = _cut_stream(frames, cuts, exact)
    fr = F.Framer(codec, quiet=True)
    got = [f for payload, p in packets for f in fr.feed(payload, p)]
    got += fr.flush()
    assert [f.data for f in got] == frames and fr.dropped == 0
    want = _spec_timing(frames, packets, samples, rate)
    assert [(f.pts, f.stop) for f in got] == want
    assert all(f.samples == samples and f.sample_rate == rate for f in got)
    # no drift: each pts within a tick of the sample clock
    assert max(abs(f.pts - e) for f, e in zip(got, exact)) <= 1


def test_framer_drops_what_is_no_frame(capfd):
    """A head that is no frame, a frame whose header does not parse and
    a partial frame at the end: each run dropped with one log line, the
    frames between kept."""
    frames = list(ac3_stream(48000, 2, 192, 0.2))
    bad = bytearray(frames[3])
    bad[4] = 0x3F                       # frmsizecod 63: no such size
    es = b"\x0b\x77" + bytes(300) + b"".join(frames[:3]) + bytes(bad) \
        + b"".join(frames[4:]) + frames[0][:500]
    fr = F.Framer("ac3", "audio track 1 (ac3)")
    got = []
    for i in range(0, len(es), 700):
        got += fr.feed(es[i:i + 700], T0 if i == 0 else None)
    got += fr.flush()
    assert [f.data for f in got] == frames[:3] + frames[4:]
    assert fr.dropped == 302 + len(bad) + 500
    err = [ln for ln in capfd.readouterr().err.splitlines()
           if "audio track 1 (ac3) copy" in ln]
    assert len(err) == 3
    assert "302 bytes dropped (before the first frame)" in err[0]
    assert f"{len(bad)} bytes dropped (no frame" in err[1]
    assert "500 bytes dropped (no whole frame at the end" in err[2]


# ---------------------------------------------------------------------------
# DVDs laid into sectors
# ---------------------------------------------------------------------------
HEAD_CUT, TAIL_CUT = 700, 900       # bytes of a frame the 640 kb/s DVD
                                    # starts within and ends within


DVD_PICTURES = 4      # the fixture's first: I P B B


def packed_dvd(root, kbps):
    """The 176x144 fixture's first DVD_PICTURES pictures with a 5.1 AC-3
    track at
    ``kbps`` and a 5.1 DTS track, each laid into 2048-byte sectors.  At
    640 kb/s the AC-3 stream begins HEAD_CUT bytes into a frame and ends
    TAIL_CUT bytes into one.  Returns (folder, the AC-3 frames whole in
    the stream, the stream's bytes, the DTS frames)."""
    es = b"".join(B.split_pictures(B.fixture("mpeg2_176x144.m2v"))
                  [:DVD_PICTURES])
    units = B.video_units(es, T0, FRAME)
    secs = len(units) * FRAME / 90000
    ac3 = list(ac3_stream(48000, 6, kbps, secs + 0.1, seed=5))
    if kbps == 640:
        pieces = [ac3[0][HEAD_CUT:]] + ac3[1:-1] + [ac3[-1][:TAIL_CUT]]
        whole = ac3[1:-1]
        pts = [None] + [T0 + k * 2880 for k in range(len(whole))] + [None]
    else:
        pieces = whole = ac3
        pts = [T0 + k * 2880 for k in range(len(ac3))]
    dts = [B.dts_core_frame(size=1024, fill=k + 1)
           for k in range(int(secs * 90000 / 960 + 2))]
    packs = B.sector_packs(0xBD, pieces, pts, 0x80)
    packs += B.sector_packs(0xBD, dts, [T0 + k * 960
                                        for k in range(len(dts))], 0x89)
    root = B.write_dvd(root, B.build_ps(units, packs), 2,
                       [secs / 2, secs / 2],
                       audio_attrs=[B.vts_audio_attr("ac3", 6, "en"),
                                    B.vts_audio_attr("dts", 6, "en")])
    return root, whole, b"".join(pieces), dts


@pytest.fixture(scope="module")
def dvds(tmp_path_factory):
    d = tmp_path_factory.mktemp("packed")
    return {kbps: packed_dvd(str(d / f"dvd{kbps}"), kbps)
            for kbps in (448, 640)}


def _job(Sm, src, out, mux, audio, keyint=None, **kw):
    """A job of schema module ``Sm``.  These tests hold the sound, so the
    video's in-loop filter is off: each job codes its pictures cheaply."""
    opts = "deblock=0" + (f":keyint={keyint}" if keyint else "")
    j = Sm.Job(path=src, file=out, mux=mux, vcodec="h264", quality=28.0,
               encoder_options=opts, **kw)
    j.audio = [Sm.AudioJobTrack(track=t, encoder=e) for t, e in audio]
    return j


def _stts(path):
    """Each track's mp4 sample durations, in its own timescale."""
    data = open(path, "rb").read()
    out, i = [], data.find(b"stts")
    while i > 0:
        n = struct.unpack(">I", data[i + 8:i + 12])[0]
        durs = []
        for k in range(n):
            c, dlt = struct.unpack(">II", data[i + 12 + 8 * k:i + 20 + 8 * k])
            durs += [dlt] * c
        out.append(durs)
        i = data.find(b"stts", i + 4)
    return out


def _read(path):
    """[(codec, rate, channels)], {track: [(pts, bytes)]}."""
    d = MKVDemuxer(path) if path.endswith(".mkv") else MP4Demuxer(path)
    try:
        tracks = [(t.codec, t.sample_rate, t.channels) for t in d.tracks]
        pk = {}
        for trk, b in d.packets():
            pk.setdefault(trk, []).append((b.pts, bytes(b.data)))
        return tracks, pk
    finally:
        d.close()


@pytest.fixture(scope="module")
def dvd_copies(dvds, tmp_path_factory):
    """The port's copies of each DVD: the AC-3 track to mp4, the AC-3
    and DTS tracks to mkv."""
    d = tmp_path_factory.mktemp("copies")
    out = {}
    for kbps, (root, *_rest) in dvds.items():
        for mux, audio in (("mp4", [(0, "copy:ac3")]),
                           ("mkv", [(0, "copy:ac3"), (1, "copy:dts")])):
            path = str(d / f"{kbps}.{mux}")
            work.do_job(_job(S, root, path, mux, audio), device="cpu")
            out[kbps, mux] = path
    return out


@pytest.mark.parametrize("mux", ["mp4", "mkv"])
@pytest.mark.parametrize("kbps", [448, 640])
def test_dvd_copy_is_written_frame_by_frame(dvds, dvd_copies, kbps, mux):
    _root, whole, stream, dts = dvds[kbps]
    tracks, pk = _read(dvd_copies[kbps, mux])
    assert tracks[1] == ("ac3", 48000, 6)
    got = [p for _t, p in pk[1]]
    assert got == whole
    # the stream less the head and tail that are no frame
    n = len(b"".join(whole))
    head = len(stream) - n - TAIL_CUT if kbps == 640 else 0
    assert b"".join(got) == stream[head:head + n]
    assert all(_hdr("ac3", p) == (len(p), 1536, 48000, 6) for p in got)
    pts = [t for t, _p in pk[1]]
    assert [b - a for a, b in zip(pts, pts[1:])] == [2880] * (len(pts) - 1)
    if mux == "mp4":
        assert _stts(dvd_copies[kbps, mux])[1] == [1536] * len(got)
    else:
        assert tracks[2] == ("dts", 48000, 6)
        assert [p for _t, p in pk[2]] == dts


def test_dvd_copy_decodes_as_the_stream(dvds, dvd_copies):
    """The port's AC-3 decoder on the 640 kb/s copy gives the stream's
    decode, frame for frame."""
    _root, whole, stream, _dts = dvds[640]
    _tracks, pk = _read(dvd_copies[640, "mp4"])
    got = Ac3Decoder().decode(b"".join(p for _t, p in pk[1]))
    want = Ac3Decoder().decode(stream)
    assert len(got) == len(want) == len(whole)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_reference_copies_pes_payloads(dvds, tmp_path):
    """The reference on the same DVDs: at 448 kb/s each mp4 sample is a
    PES payload (a frame's tail and the next one's head), labelled with
    the mixdown's 2 channels; at 640 kb/s, whose frames span a PES
    without a PTS, it raises TypeError in its sync."""
    root = dvds[448][0]
    out = str(tmp_path / "ref.mp4")
    jwork.do_job(_job(JS, root, out, "mp4", [(0, "copy:ac3")]))
    tracks, pk = _read(out)
    assert tracks[1] == ("ac3", 48000, 2)
    d = PSDemuxer(os.path.join(root, "VIDEO_TS", "VTS_01_1.VOB"))
    pes = [bytes(b.data) for t, b in d.packets() if t == 1]
    d.close()
    got = [p for _t, p in pk[1]]
    assert got[:len(pes)] == pes[:len(got)] and len(got) > 4
    assert any(_hdr("ac3", p)[0] != len(p) for p in got)
    with pytest.raises(TypeError, match="NoneType"):
        jwork.do_job(_job(JS, dvds[640][0], str(tmp_path / "ref640.mp4"),
                          "mp4", [(0, "copy:ac3")]))


# ---------------------------------------------------------------------------
# transport streams and Blu-ray
# ---------------------------------------------------------------------------
def _aac_stream():
    enc = AACEncoder(48000, 2, quality=120)
    aus = enc.encode(tone(48000, 2, 48000 // 4, 4)) + enc.flush()
    return [enc.adts_header(len(au)) + au for au in aus], aus


# kind: (stream type, PID, stream id, frames a PES, whether a frame is
# split across two PES)
TS_CASES = {
    "ac3": (0x81, 0x101, 0xBD, 1, True),
    "eac3": (0x87, 0x102, 0xBD, 2, False),
    "dts": (0x82, 0x103, 0xBD, 3, True),
    "dts-hd": (0x86, 0x107, 0xFD, 2, True),
    "mp2": (0x03, 0x104, 0xC0, 3, True),
    "mp3-44.1": (0x03, 0x105, 0xC1, 4, False),
    "aac": (0x0F, 0x106, 0xC2, 3, False),
}
TS_CHANNELS = {"ac3": 2, "eac3": 8, "dts": 6, "dts-hd": 6, "mp2": 2,
               "mp3-44.1": 2, "aac": 2}
# mp4 carries no DTS
IN_MP4 = [k for k in TS_CASES if not k.startswith("dts")]


@functools.lru_cache(None)
def _ts_track(kind):
    """(codec of the copy, frames, what the copy writes of each, samples
    a frame, rate, build_ts units) of one TS sound track."""
    _stype, pid, sid, per, split = TS_CASES[kind]
    if kind == "aac":
        frames, raw = _aac_stream()
        codec, samples, rate = "aac", 1024, 48000
    else:
        codec, frames, samples, rate = _stream(kind)
        raw = frames
    codec = "mp2" if codec == "mp3" else codec     # TS stream type 0x03
    pts = [T0 + k * samples * 90000 // rate for k in range(len(frames))]
    ends = np.cumsum([len(f) for f in frames]).tolist()
    cuts = ends[per - 1:-1:per]
    if split:
        cuts.append(ends[1] + len(frames[2]) // 2)
    return codec, frames, raw, samples, rate, B.pes_units(
        pid, sid, frames, pts, sorted(set(cuts)))


def _ts_source(path, kinds):
    """A TS of 4 H.264 pictures and one sound track of each of
    ``kinds``, in that order."""
    units = [(T0 + i * FRAME, 0x100, 0xE0, au, T0 + i * FRAME)
             for i, au in enumerate(h264_aus(n=4))]
    for k in kinds:
        units += _ts_track(k)[5]
    with open(path, "wb") as f:
        f.write(B.build_ts([(0x1B, 0x100, b"")] + [
            (TS_CASES[k][0], TS_CASES[k][1], b"") for k in kinds], units))
    return path


@pytest.fixture(scope="module")
def ts_copies(tmp_path_factory):
    """Every TS track copied in one job a container: {mux: (the kinds in
    track order, the output)}."""
    d = tmp_path_factory.mktemp("tscopies")
    src = _ts_source(str(d / "src.ts"), list(TS_CASES))
    out = {}
    for mux in ("mp4", "mkv"):
        kinds = IN_MP4 if mux == "mp4" else list(TS_CASES)
        out[mux] = (kinds, str(d / f"out.{mux}"))
        work.do_job(_job(S, src, out[mux][1], mux, [
            (list(TS_CASES).index(k), f"copy:{_ts_track(k)[0]}")
            for k in kinds]), device="cpu")
    return out


@pytest.mark.parametrize("kind,mux", [(k, "mp4") for k in IN_MP4]
                         + [(k, "mkv") for k in TS_CASES])
def test_ts_copy_is_written_frame_by_frame(ts_copies, kind, mux):
    _codec, _frames, raw, samples, rate, _units = _ts_track(kind)
    kinds, out = ts_copies[mux]
    trk = 1 + kinds.index(kind)
    tracks, pk = _read(out)
    got = [p for _t, p in pk[trk]]
    # each copied packet is one of the source's frames (ADTS: its access
    # unit), in order, and none is lost: the job keeps the whole track
    assert got == list(raw)
    assert tracks[trk][1:] == (rate, TS_CHANNELS[kind])
    if mux == "mp4":
        assert _stts(out)[trk] == [samples] * len(got)
    else:
        # each frame at the first one's time plus the samples before it
        # (mkv keeps milliseconds)
        pts = [t for t, _p in pk[trk]]
        assert all(abs(t - (T0 + k * samples * 90000 // rate)) <= 90
                   for k, t in enumerate(pts))


def test_bd_copy_is_written_frame_by_frame(tmp_path):
    """A Blu-ray folder over a TS whose AC-3 frames and DTS-HD frames
    (each a core and an extension substream, stream type 0x86) are split
    across PES packets: each mkv copy is the frames, whole."""
    kinds = ["ac3", "dts-hd"]
    src = _ts_source(str(tmp_path / "src.ts"), kinds)
    with open(src, "rb") as f:
        root = B.write_bd(str(tmp_path / "bd"), f.read(), 2, 4 / 30,
                          [(0, 0.0)])
    out = str(tmp_path / "bd.mkv")
    work.do_job(_job(S, root, out, "mkv", [(0, "copy:ac3"), (1, "copy:dts")]),
                device="cpu")
    tracks, pk = _read(out)
    assert tracks[2] == ("dts", 48000, 6)
    for trk, kind in enumerate(kinds, 1):
        assert [p for _t, p in pk[trk]] == list(_ts_track(kind)[1])


# ---------------------------------------------------------------------------
# resume, refusals, the sync
# ---------------------------------------------------------------------------
def test_dvd_copy_resume_equals_uninterrupted(dvds, tmp_path):
    """The 640 kb/s DVD's AC-3 copy beside AAC, keyint 2, checkpointed,
    its journal cut after the first GOP and resumed: the file equals the
    uninterrupted run's."""
    from test_torch_checkpoint import _cut
    root = dvds[640][0]
    audio = [(0, "copy:ac3"), (0, "aac")]
    ref = str(tmp_path / "ref.mp4")
    work.do_job(_job(S, root, ref, "mp4", audio, keyint=2),
                device="cpu")
    out = str(tmp_path / "out.mp4")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(checkpoint.CkptJournal, "close",
                  lambda self, complete=False: self.f.close())
        work.do_job(_job(S, root, out, "mp4", audio, checkpoint=True,
                         keyint=2), device="cpu")
    _cut("torch", out + ".ckpt", 1)
    os.unlink(out)
    stats = work.do_job(_job(S, root, out, "mp4", audio, resume=True,
                             keyint=2), device="cpu")
    assert stats["frames_out"] == DVD_PICTURES - 2
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_copy_without_a_whole_frame_raises(tmp_path):
    """A TS whose AC-3 track holds no whole frame: the copy raises,
    naming the track, and writes no file."""
    src = str(tmp_path / "src.ts")
    frame = ac3_stream(48000, 2, 192)[0]
    units = [(T0 + i * FRAME, 0x100, 0xE0, au, T0 + i * FRAME)
             for i, au in enumerate(h264_aus(n=4))]
    units += [(T0 + k * 2880, 0x101, 0xBD, frame[:100], T0 + k * 2880)
              for k in range(4)]
    with open(src, "wb") as f:
        f.write(B.build_ts([(0x1B, 0x100, b""), (0x81, 0x101, b"")], units))
    out = str(tmp_path / "out.mkv")
    with pytest.raises(work.WorkError, match="audio track 1: no whole ac3 "
                       "frame"):
        work.do_job(_job(S, src, out, "mkv", [(0, "copy:ac3")]),
                    device="cpu")
    assert not os.path.exists(out)
    # the copy's decoder itself, fed bytes that hold no frame
    dec = work._CopyAudioDecoder("ac3", "audio track 1 (ac3)")
    assert dec.feed(Buffer(data=frame[:100], pts=T0)) == []
    with pytest.raises(work.WorkError, match="audio track 1 \\(ac3\\): no "
                       "whole frame in the 100 bytes"):
        dec.flush()


def test_sync_never_adds_to_a_missing_time():
    """A buffer without a pts after one without a stop takes the one
    before's pts plus its duration; after one with neither, WorkError
    names the stream."""
    sync = SyncCore()
    a = sync.add_stream("audio", sid=3)
    sync.queue(a, Buffer(track_kind="audio", pts=100, duration=2880))
    nxt = Buffer(track_kind="audio", duration=2880)
    sync.queue(a, nxt)
    assert nxt.pts == 2980
    b = sync.add_stream("audio", sid=4)
    sync.queue(b, Buffer(track_kind="audio", pts=100))
    with pytest.raises(work.WorkError, match="stream 1 \\(id 4\\)"):
        sync.queue(b, Buffer(track_kind="audio"))
