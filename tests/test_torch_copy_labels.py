"""A copied sound track's true label (ROADMAP 3.18), each case beside the
JAX package's unchanged behaviour on the same input, on the CPU:

- (a) DTS-HD Master Audio: a core frame whose first extension
  substream's first asset codes XLL at 96 kHz is labelled 96000 in the
  TS title, the mkv copy and the log, each frame's samples doubled so
  its duration, and every pts, stays the core's; a DTS-HD High
  Resolution frame (no XLL) and a bare core keep the core's 48 kHz.
  The reference labels the TS track 48 kHz.
- (b) ADTS with a program config element: a stream whose
  channel_configuration is 0 is copied to mkv and mp4 with the element
  in its AudioSpecificConfig and out of its first access unit, as
  libavformat's aac_adtstoasc moves it (5.1 and 7.1 layouts); a stream
  whose first element is not a PCE is refused with the reason; the
  fallback decode gives the PCE's channel count.  The reference labels
  the TS track stereo.
- (c) AVI sound: MP2, MP3, AC-3 and DTS tracks are listed, their chunks
  timed from the stream header (per chunk where dwSampleSize is 0, by
  bytes at nAvgBytesPerSec otherwise), copied frame by frame, and MP2
  and AC-3 decoded to AAC; an MP3 or DTS decode is refused where
  libavcodec is missing, as on the card machine; another tag stays
  unknown, with a log line.  The reference lists each as unknown.

No independent encoder wrote these streams.  The ADTS frames and their
program config elements come from the small bit writer below (their
raw data blocks are silent elements written here, or one of the port's
AAC encoder's access units); the DTS frames, the extension substreams
and the AVI files from ``tools/source_builders.py``; the MP3 frames are
headers over filler.  They hold the port's readers to the syntax as
written here.  The MP2 and AC-3 frames are the committed libavcodec MP2
fixture and the port's AC-3 encoder's, as in ``test_torch_sources``."""
import functools

import numpy as np
import pytest

from handbrake_tpu.sources.avi import AVIDemuxer as JAVIDemuxer
from handbrake_tpu.sources.ts import TSDemuxer as JTSDemuxer
from handbrake_tpu_torch import work
from handbrake_tpu_torch.audio import frames as F
from handbrake_tpu_torch.audio.aac import AACEncoder
from handbrake_tpu_torch.audio.aacdec import AACDecoder
from handbrake_tpu_torch.audio.mp2dec import Mp2Decoder
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.sources.avi import AVIDemuxer
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.sources.ts import TSDemuxer
from handbrake_tpu_torch.tools import source_builders as B
from handbrake_tpu_torch.work import WorkError
from test_torch_sources import FRAME, T0, ac3_frames, h264_aus, mp2_frames
from torch_catalog import MISSING, hide

N = 8                        # video frames of each TS


class Bits:
    """A bit writer: fields most significant bit first."""

    def __init__(self):
        self.v = self.n = 0

    def put(self, v: int, n: int):
        assert 0 <= v < 1 << n or n == 0
        self.v, self.n = (self.v << n) | v, self.n + n

    def align(self):
        self.put(0, -self.n % 8)

    def data(self) -> bytes:
        self.align()
        return self.v.to_bytes(self.n // 8, "big")


# -- ADTS ----------------------------------------------------------------------
# a layout: (front, side, back: is_cpe of each element), LFE elements
LAYOUTS = {"5.1": ((0, 1), (), (1,), 1), "7.1": ((0, 1, 1), (), (1,), 1)}
CHANNELS = {"5.1": 6, "7.1": 8}


def pce_body(w: Bits, layout):
    """program_config_element() after its id: tag 0, LC, 48 kHz, the
    layout's elements (tags counted per kind), no mixdowns, aligned,
    no comment.  The alignment counts from the writer's start."""
    front, side, back, lfe = layout
    w.put(0, 4)
    w.put(1, 2)
    w.put(3, 4)
    for group in (front, side, back):
        w.put(len(group), 4)
    w.put(lfe, 2)
    w.put(0, 3)
    w.put(0, 4)
    w.put(0, 3)                       # mono, stereo, matrix mixdowns: none
    tags = {0: 0, 1: 0}
    for group in (front, side, back):
        for cpe in group:
            w.put(cpe, 1)
            w.put(tags[cpe], 4)
            tags[cpe] += 1
    for t in range(lfe):
        w.put(t, 4)
    w.align()
    w.put(0, 8)


def silent_ics(w: Bits, gain: int):
    """individual_channel_stream(): a long window, max_sfb 0, no pulse,
    TNS or gain control: silence."""
    w.put(gain, 8)
    w.put(0, 1 + 2 + 1)
    w.put(0, 6)
    w.put(0, 1)
    w.put(0, 3)


def raw_block(layout, gain: int, pce: bool = True) -> bytes:
    """A raw data block of the layout's elements in order, each silent,
    then END; opened with the layout's PCE where ``pce``."""
    front, side, back, lfe = layout
    w = Bits()
    if pce:
        w.put(5, 3)
        pce_body(w, layout)
    tags = {0: 0, 1: 0}
    for group in (front, side, back):
        for cpe in group:
            w.put(cpe, 3)             # ID_SCE 0, ID_CPE 1
            w.put(tags[cpe], 4)
            tags[cpe] += 1
            if cpe:
                w.put(0, 1)           # common_window
            for _ in range(1 + cpe):
                silent_ics(w, gain)
    for t in range(lfe):
        w.put(3, 3)                   # ID_LFE
        w.put(t, 4)
        silent_ics(w, gain)
    w.put(7, 3)                       # ID_END
    return w.data()


def adts(raw: bytes, channel_config: int) -> bytes:
    """An ADTS frame (MPEG-4, no CRC, LC, 48 kHz) around ``raw``."""
    w = Bits()
    n = 7 + len(raw)
    for v, bits in ((0xFFF, 12), (0, 1), (0, 2), (1, 1), (1, 2), (3, 4),
                    (0, 1), (channel_config, 3), (0, 4), (n, 13),
                    (0x7FF, 11), (0, 2)):
        w.put(v, bits)
    return w.data() + raw


def asc_with_pce(layout) -> bytes:
    """The AudioSpecificConfig aac_adtstoasc writes for such a stream:
    LC, 48 kHz, channelConfiguration 0, then the PCE."""
    w = Bits()
    w.put(2, 5)
    w.put(3, 4)
    w.put(0, 4)
    w.put(0, 3)
    pce_body(w, layout)
    return w.data()


def pce_frames(layout, n=12, pce=True):
    return [adts(raw_block(LAYOUTS[layout], 100 + k, pce), 0)
            for k in range(n)]


@functools.lru_cache(None)
def stereo_aus():
    """The port's AAC encoder's stereo access units of a tone (each a
    CPE then END)."""
    t = np.arange(48000 // 4) / 48000
    pcm = 0.3 * np.stack([np.sin(2 * np.pi * 440 * t),
                          np.sin(2 * np.pi * 660 * t)], 1)
    enc = AACEncoder(48000, 2, 128)
    return tuple(enc.encode(pcm.astype(np.float32)) + enc.flush())


# -- DTS -----------------------------------------------------------------------
def dts_ma(k: int, xll: bool = True) -> bytes:
    """A 48 kHz 5.1 core frame of 512 samples, then an extension
    substream whose first asset is 96 kHz 8 channels, lossless where
    ``xll`` (DTS-HD Master Audio), else not (High Resolution)."""
    return B.dts_core_frame(size=1024, fill=k + 1) + B.dts_exss(
        900 + 8 * k, fill=k + 30, asset=(96000, 8, 1024), xll=xll)


# -- sources -------------------------------------------------------------------
def _ts(path, audio):
    """H.264 (64x48) on 0x100 and ``audio``: (stream type, pid, stream
    id, frames, ticks a frame), three frames a PES."""
    pmt = [(0x1B, 0x100, b"")] + [(st, pid, b"") for st, pid, *_ in audio]
    units = [(T0 + i * FRAME, 0x100, 0xE0, au, T0 + i * FRAME)
             for i, au in enumerate(h264_aus(n=N))]
    for _st, pid, sid, frames, ticks in audio:
        pts = [T0 + k * ticks for k in range(len(frames))]
        ends = np.cumsum([len(f) for f in frames]).tolist()
        units += B.pes_units(pid, sid, frames, pts, ends[2:-1:3])
    with open(path, "wb") as f:
        f.write(B.build_ts(pmt, units))
    return str(path)


@pytest.fixture(scope="module")
def ts(tmp_path_factory):
    d = tmp_path_factory.mktemp("labels")
    dts = [dts_ma(k) for k in range(10)]
    return {
        "ma": (_ts(d / "ma.ts", [(0x86, 0x101, 0xFD, dts, 960)]), dts),
        **{lay: (_ts(d / f"pce{lay}.ts",
                     [(0x0F, 0x102, 0xC0, pce_frames(lay), 1920)]),
                 pce_frames(lay)) for lay in LAYOUTS},
        "no-pce": (_ts(d / "nopce.ts", [(0x0F, 0x102, 0xC0,
                                         pce_frames("5.1", pce=False),
                                         1920)]), None)}


def _job(src, out, audio, mux="mkv"):
    """The port's job: the 64x48 video without its in-loop filter (these
    tests hold the sound) and the outputs ``audio``: (track, encoder)."""
    return S.Job(path=src, file=out, mux=mux, vcodec="h264", quality=28.0,
                 encoder_options="deblock=0",
                 audio=[S.AudioJobTrack(track=t, encoder=e, bitrate=160)
                        for t, e in audio])


def _read(path):
    """[(codec, rate, channels, extradata)] of the sound tracks and
    {track: [(pts, bytes)]}."""
    d = MKVDemuxer(path) if path.endswith(".mkv") else MP4Demuxer(path)
    try:
        pk = {}
        for trk, b in d.packets():
            pk.setdefault(trk, []).append((b.pts, bytes(b.data)))
        return [(t.codec, t.sample_rate, t.channels, bytes(t.extradata))
                for t in d.tracks], pk
    finally:
        d.close()


# -- (a) DTS-HD Master Audio ---------------------------------------------------
def test_dts_ma_header_takes_the_lossless_asset_rate():
    """The core frame with its extension: 96 kHz and 1024 samples where
    the asset codes XLL; the core's 48 kHz and 512 samples for a High
    Resolution asset and for a bare core."""
    ma, hra = F.dts_header(dts_ma(0)), F.dts_header(dts_ma(0, xll=False))
    core = F.dts_header(B.dts_core_frame(size=1024))
    assert (ma.sample_rate, ma.samples, ma.channels, ma.xll) == \
        (96000, 1024, 8, True)
    assert (hra.sample_rate, hra.samples, hra.channels) == (48000, 512, 8)
    assert (core.sample_rate, core.samples) == (48000, 512)
    # the asset alone says it is lossless (coding mode 0, mask 0x20)
    assert F.dts_exss(B.dts_exss(900, asset=(96000, 8, 1024),
                                 xll=True)).xll


def test_dts_ma_pts_stay_the_core_s():
    """The framer gives each MA frame 1024 samples at 96 kHz: the same
    90 kHz pts as 512 at 48 kHz, frame for frame."""
    frames = [dts_ma(k) for k in range(10)]
    fr = F.Framer("dts", quiet=True)
    got = fr.feed(b"".join(frames), T0) + fr.flush()
    assert [f.data for f in got] == frames
    assert [(f.pts, f.stop, f.samples, f.sample_rate) for f in got] == [
        (T0 + 960 * k, T0 + 960 * (k + 1), 1024, 96000) for k in range(10)]


def test_dts_ma_copy_labelled_96k_beside_reference(ts, tmp_path, capfd):
    src, frames = ts["ma"]
    d, jd = TSDemuxer(src), JTSDemuxer(src)
    try:
        assert (d.tracks[1].codec, d.tracks[1].sample_rate,
                d.tracks[1].channels) == ("dts", 96000, 8)
        assert (jd.tracks[1].codec, jd.tracks[1].sample_rate,
                jd.tracks[1].channels) == ("dts", 48000, 2)
    finally:
        d.close()
        jd.close()
    capfd.readouterr()
    out = str(tmp_path / "ma.mkv")
    work.do_job(_job(src, out, [(0, "copy:dts")]), device="cpu")
    assert "the copy is labelled 8 channels at 96000 Hz from its first " \
        "frame's DTS-HD Master Audio asset" in capfd.readouterr().err
    tracks, pk = _read(out)
    assert tracks[1][:3] == ("dts", 96000, 8)
    assert [p for _t, p in pk[1]] == frames
    # mkv keeps milliseconds: each block at the core frame's time
    assert all(abs(t - (T0 + 960 * k)) <= 90
               for k, (t, _p) in enumerate(pk[1]))


# -- (b) ADTS with a program config element ------------------------------------
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adts_pce_read_as_aac_adtstoasc_moves_it(layout):
    frame = pce_frames(layout, 1)[0]
    p = F.adts_pce(frame)
    assert p.channels == CHANNELS[layout]
    assert p.config == asc_with_pce(LAYOUTS[layout])[2:]
    raw = raw_block(LAYOUTS[layout], 100, pce=False)
    assert frame[7 + p.size:] == raw
    h = F.adts_header(frame)
    assert F.adts_config(h, p.config) == asc_with_pce(LAYOUTS[layout])
    assert F.adts_pce(pce_frames(layout, 1, pce=False)[0]) is None


@pytest.mark.parametrize("mux", ["mkv", "mp4"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adts_pce_copy_beside_reference(ts, tmp_path, layout, mux):
    """The copy carries the PCE in its config and not in its first
    access unit; every later unit is its frame less the ADTS header; the
    track says the PCE's channels.  The reference lists the track as
    stereo."""
    src, frames = ts[layout]
    jd = JTSDemuxer(src)
    try:
        assert (jd.tracks[1].codec, jd.tracks[1].channels) == ("aac", 2)
    finally:
        jd.close()
    out = str(tmp_path / f"pce.{mux}")
    work.do_job(_job(src, out, [(0, "copy:aac")], mux), device="cpu")
    tracks, pk = _read(out)
    asc = asc_with_pce(LAYOUTS[layout])
    assert tracks[1] == ("aac", 48000, CHANNELS[layout], asc)
    blocks = [p for _t, p in pk[1]]
    pce = F.adts_pce(frames[0]).size
    assert blocks == [frames[0][7 + pce:]] + [f[7:] for f in frames[1:]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_source_builders_write_these_adts_frames(layout):
    """``tools/source_builders.py``'s ADTS PCE writers, which the card's
    smoke uses, give this file's frames and config bit for bit."""
    for pce in (True, False):
        assert B.adts_pce_frame(B.AAC_LAYOUTS[layout], 107, pce) == \
            adts(raw_block(LAYOUTS[layout], 107, pce), 0)
    assert B.aac_pce_config(B.AAC_LAYOUTS[layout]) == \
        asc_with_pce(LAYOUTS[layout])


def test_adts_without_leading_pce_refused(ts, tmp_path):
    out = tmp_path / "nopce.mkv"
    with pytest.raises(WorkError, match="channel_configuration is 0 and "
                       "whose first raw data block does not open with a "
                       "program config element"):
        work.do_job(_job(ts["no-pce"][0], str(out), [(0, "copy:aac")]),
                    device="cpu")
    assert not out.exists()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adts_pce_decode_gives_the_pce_channels(layout):
    """The fallback decode reads past the PCE: each frame decodes to the
    PCE's channel count (silence here)."""
    dec = AACDecoder()
    pcm = dec.decode_frame(pce_frames(layout, 1)[0])
    assert pcm.shape == (1024, CHANNELS[layout])
    assert not np.any(pcm)


def test_adts_pce_stereo_decodes_as_the_plain_stream():
    """The port's AAC encoder's stereo units: opened with a 2.0 PCE and
    channel_configuration 0, they decode to the PCM of the same units
    with channel_configuration 2."""
    layout = ((1,), (), (), 0)
    w = Bits()
    w.put(5, 3)
    pce_body(w, layout)
    pce = w.data()
    plain, with_pce = AACDecoder(), AACDecoder()
    for au in stereo_aus()[:6]:
        a = plain.decode_frame(adts(au, 2))
        b = with_pce.decode_frame(adts(pce + au, 0))
        assert a.shape == b.shape == (1024, 2)
        assert np.array_equal(a, b)
    assert F.adts_pce(adts(pce + stereo_aus()[0], 0)).channels == 2


# -- (c) AVI sound --------------------------------------------------------------
def mp3_frames(n=12):
    """MPEG-1 layer III frames, 128 kb/s at 48 kHz, of filler (384 bytes
    each): headers a framer reads, no decodable sound."""
    return [b"\xff\xfb\x94\x00" + bytes([k + 1]) * 380 for k in range(n)]


def avi_sounds():
    """Stream 1 MP2 (a chunk a frame), 2 MP3 (dwSampleSize 1: by bytes),
    3 AC-3 (a chunk a frame), 4 DTS (a chunk a frame), 5 WMA (0x161)."""
    mp2 = mp2_frames()[:8]
    ac3 = list(ac3_frames(seconds=0.2))
    dts = [B.dts_core_frame(size=1024, fill=k + 1) for k in range(8)]
    return [B.AviSound(0x50, 2, 48000, 48000, mp2, scale=1152),
            B.AviSound(0x55, 2, 48000, 16000, mp3_frames(), sample_size=1),
            B.AviSound(0x2000, 2, 48000, 24000, ac3, scale=1536),
            B.AviSound(0x2001, 6, 48000, 96000, dts, scale=512),
            B.AviSound(0x161, 2, 48000, 16000, [b"\x00" * 100] * 4,
                       sample_size=1)]


@pytest.fixture(scope="module")
def avi(tmp_path_factory):
    src = AVIDemuxer(B.FIXTURES + "/mjpeg_640x480.avi")
    try:
        video = [bytes(b.data) for _t, b in src.packets()][:3]
    finally:
        src.close()
    path = tmp_path_factory.mktemp("avi") / "sound.avi"
    path.write_bytes(B.build_avi(video, (25, 1), (640, 480), avi_sounds()))
    return str(path)


def test_avi_sound_listed_and_timed_beside_reference(avi, capfd):
    capfd.readouterr()
    d = AVIDemuxer(avi)
    err = capfd.readouterr().err
    jd = JAVIDemuxer(avi)
    try:
        assert [t.codec for t in d.tracks] == [
            "mjpeg", "mp2", "mp3", "ac3", "dts", "unknown"]
        assert [t.codec for t in jd.tracks] == [
            "mjpeg"] + ["unknown"] * 5
        assert "avi: stream 5: sound of WAVEFORMATEX tag 0x0161" in err
        got = {}
        for trk, b in d.packets():
            got.setdefault(trk, []).append((b.pts, bytes(b.data)))
        jgot = {}
        for trk, b in jd.packets():
            jgot.setdefault(trk, []).append((b.pts, bytes(b.data)))
    finally:
        d.close()
        jd.close()
    sounds = avi_sounds()
    # a chunk a frame: dwScale/dwRate a chunk (1152, 1536 and 512 at 48 kHz)
    for trk, ticks in ((1, 2160), (3, 2880), (4, 960)):
        assert got[trk] == [(k * ticks, c) for k, c in
                            enumerate(sounds[trk - 1].chunks)]
    # by bytes: 384 B a chunk at 16000 B/s
    assert got[2] == [(k * 384 * 90000 // 16000, c)
                      for k, c in enumerate(mp3_frames())]
    # the reference gives the same chunks with no timestamps
    assert {t: [p for _, p in v] for t, v in jgot.items()} == \
        {t: [p for _, p in v] for t, v in got.items()}
    assert all(p is None for t, v in jgot.items() if t for p, _ in v)


def _scaled(job):
    """``job`` with its 640x480 picture scaled to 160x120 (the sound is
    what these jobs hold; the encode stays cheap)."""
    job.filters = [S.FilterSpec(S.FILTER_CROP_SCALE,
                                {"width": 160, "height": 120})]
    return job


def test_avi_sound_copied_frame_by_frame(avi, tmp_path):
    out = str(tmp_path / "copies.mkv")
    work.do_job(_scaled(_job(avi, out, [(0, "copy:mp2"), (1, "copy:mp3"),
                                        (2, "copy:ac3"), (3, "copy:dts")])),
                device="cpu")
    tracks, pk = _read(out)
    assert [t[:3] for t in tracks[1:]] == [
        ("mp2", 48000, 2), ("mp3", 48000, 2), ("ac3", 48000, 2),
        ("dts", 48000, 6)]
    sounds = avi_sounds()
    for k in range(4):
        assert [p for _t, p in pk[k + 1]] == list(sounds[k].chunks)


def test_avi_mp2_and_ac3_decoded(avi, tmp_path):
    """MP2 and AC-3 decode on the host to AAC: the MP2 output's samples
    follow the MP2 decoder's, the AC-3 output's are finite and cover the
    stream."""
    out = str(tmp_path / "decoded.mkv")
    work.do_job(_scaled(_job(avi, out, [(0, "aac"), (2, "aac")])),
                device="cpu")
    tracks, pk = _read(out)
    assert [t[:3] for t in tracks[1:]] == [("aac", 48000, 2)] * 2
    sounds = avi_sounds()
    mp2 = np.concatenate(Mp2Decoder().feed(b"".join(sounds[0].chunks)))
    for trk, n in ((1, len(mp2)), (2, 1536 * len(sounds[2].chunks))):
        dec = AACDecoder(tracks[trk][3])
        pcm = np.concatenate([dec.decode_frame(p) for _t, p in pk[trk]])
        assert np.isfinite(pcm).all() and np.abs(pcm).max() > 0.05
        assert abs(len(pcm) - n) <= 2048


@pytest.mark.parametrize("track,codec", [(1, "mp3"), (3, "dts")])
def test_avi_mp3_and_dts_decode_refused_without_libavcodec(
        avi, tmp_path, monkeypatch, track, codec):
    hide(monkeypatch, tmp_path)
    out = tmp_path / "refused.mkv"
    with pytest.raises(WorkError, match=f"{codec}: decoding the track.*"
                       f"{MISSING}"):
        work.do_job(_scaled(_job(avi, str(out), [(track, "aac")])),
                    device="cpu")
    assert not out.exists()
