"""The port's disc and stream demuxers (``sources/{ps,dvd,ts,bd,avi}.py``)
held against the JAX package's on the same files: tracks, durations,
chapters and every packet (track, pts, dts, duration, bytes).  The files
are built here from the committed fixtures (``tests/data/torch_sources``)
and the port's H.264 and AC-3 encoders, by
``handbrake_tpu_torch/tools/source_builders.py``.  Also the copies: each
new module equals its original, with each intended edit listed; and
``open_source``'s routing.  The shared faults that stay so the files equal
the reference's are shown here too, and the two the port repairs (the
MPEG-2 aspect and rate) beside the reference's (ROADMAP §3.4)."""
import filecmp
import functools
import os

import numpy as np
import pytest

import handbrake_tpu
import handbrake_tpu_torch
from handbrake_tpu.sources import bd as jbd
from handbrake_tpu.sources import dvd as jdvd
from handbrake_tpu.sources.avi import AVIDemuxer as JAVIDemuxer
from handbrake_tpu.sources.probe import open_source as jopen
from handbrake_tpu.sources.ps import PSDemuxer as JPSDemuxer
from handbrake_tpu.sources.ts import TSDemuxer as JTSDemuxer
from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.codecs.registry import (Mpeg2VideoDecoder,
                                                 create_video_decoder)
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.sources import bd, dvd
from handbrake_tpu_torch.sources.avi import AVIDemuxer
from handbrake_tpu_torch.sources.probe import open_source, scan_paths
from handbrake_tpu_torch.sources.ps import PSDemuxer
from handbrake_tpu_torch.sources.ts import TSDemuxer
from handbrake_tpu_torch.subtitles.vobsub import build_spu
from handbrake_tpu_torch.tools import source_builders as B
from handbrake_tpu_torch.utils.synth import make_clip

FRAME = 3003
T0 = 4 * FRAME


@functools.lru_cache(None)
def h264_aus(w=64, h=48, n=8):
    enc = H264Encoder(EncoderConfig(width=w, height=h, qp=28, gop=4),
                      device="cpu")
    return tuple(enc.encode_frame(*f) for f in make_clip(w, h, n, seed=4))


def tone(sr, ch, n, seed):
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    return np.stack([0.4 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                     + 0.02 * rng.standard_normal(n) for c in range(ch)],
                    1).astype(np.float32)


@functools.lru_cache(None)
def ac3_frames(ch=2, seconds=0.5, seed=1):
    enc = Ac3Encoder(48000, ch, 192000 if ch == 2 else 384000)
    return tuple(enc.encode(tone(48000, ch, int(48000 * seconds), seed))
                 + enc.flush())


def mp2_frames():
    data = B.fixture("mp2_48k_stereo.mp2")       # 128 kb/s: 384 B frames
    return [data[i:i + 384] for i in range(0, len(data), 384)]


def read(d):
    """Everything a demuxer gives, closed after."""
    try:
        tracks = [(t.kind, t.codec, t.width, t.height, t.frame_rate,
                   t.par_num, t.par_den, t.sample_rate, t.channels,
                   t.extradata, t.language) for t in d.tracks]
        pkts = [(trk, b.pts, b.dts, b.duration, b.stop, b.track_kind,
                 bytes(b.data)) for trk, b in d.packets()]
        return tracks, pkts, d.duration, list(getattr(d, "chapters", []))
    finally:
        d.close()


def same(Port, Ref, path):
    got, want = read(Port(path)), read(Ref(path))
    assert got == want
    return got


# ---------------------------------------------------------------------------
# MPEG transport streams
# ---------------------------------------------------------------------------
def h264_ts(n=8, audio=()):
    """H.264 on PID 0x100 and the ``audio`` tracks: (stream_type, pid,
    stream_id, descriptors, frames, ticks a frame)."""
    streams = [(0x1B, 0x100, b"")] + [(st, pid, desc)
                                       for st, pid, _, desc, _, _ in audio]
    units = [(T0 + i * FRAME, 0x100, 0xE0, au, T0 + i * FRAME)
             for i, au in enumerate(h264_aus(n=n))]
    for st, pid, sid, desc, frames, ticks in audio:
        units += [(T0 + k * ticks, pid, sid, f, T0 + k * ticks)
                  for k, f in enumerate(frames)]
    return B.build_ts(streams, units)


@pytest.fixture(scope="module")
def ts_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsrc")
    ts = h264_ts(audio=[
        (0x03, 0x101, 0xC0, B.lang_descriptor("fre"), mp2_frames()[:10],
         2160),
        (0x06, 0x102, 0xBD, bytes([0x6A, 1, 0]) + B.lang_descriptor("eng"),
         ac3_frames(), 2880)])
    files = {"ts": ts, "m2ts": B.m2ts_wrap(ts)}
    # a corrupt sync byte of the 6th packet, after the PSI
    bad = bytearray(files["m2ts"])
    bad[5 * 192 + 4] = 0x00
    files["m2ts-corrupt-sync"] = bytes(bad)
    bad = bytearray(ts)
    bad[(len(ts) // 188 // 2) * 188] = 0x11
    files["ts-corrupt-sync"] = bytes(bad)
    # a non-PUSI video packet dropped mid-stream (a continuity gap)
    pkts = [ts[i:i + 188] for i in range(0, len(ts), 188)]
    k = next(i for i, p in enumerate(pkts[20:], 20)
             if ((p[1] & 0x1F) << 8 | p[2]) == 0x100 and not p[1] & 0x40)
    files["ts-cc-gap"] = b"".join(pkts[:k] + pkts[k + 1:])
    # a PES header split across two TS packets by a long adaptation field
    pes = B.ts_pes(0xE0, 123456, b"\xAB" * 100)
    room, pid = 7, 0x100
    af_len = 183 - room
    p1 = bytes([0x47, 0x40 | (pid >> 8), pid & 0xFF, 0x30]) \
        + bytes([af_len, 0]) + b"\xff" * (af_len - 1) + pes[:room]
    rest = pes[room:]
    pad = 184 - len(rest)
    p2 = bytes([0x47, pid >> 8, pid & 0xFF, 0x31]) + bytes([pad - 1, 0]) \
        + b"\xff" * (pad - 2) + rest
    files["ts-split-pes-header"] = B.pat() + B.pmt([(0x1B, pid, b"")]) \
        + p1 + p2
    paths = {}
    for name, data in files.items():
        ext = ".m2ts" if name.startswith("m2ts") else ".ts"
        paths[name] = str(d / (name + ext))
        with open(paths[name], "wb") as f:
            f.write(data)
    return paths


@pytest.mark.parametrize("name", ["ts", "m2ts", "m2ts-corrupt-sync",
                                  "ts-corrupt-sync", "ts-cc-gap",
                                  "ts-split-pes-header"])
def test_ts_demuxer_equals_reference(ts_files, name):
    tracks, pkts, duration, _ = same(TSDemuxer, JTSDemuxer, ts_files[name])
    video = [p for p in pkts if p[0] == 0]
    if name == "ts-split-pes-header":
        assert [(p[1], p[6]) for p in video] == [(123456, b"\xAB" * 100)]
        return
    assert [t[:2] for t in tracks] == [("video", "h264"), ("audio", "mp2"),
                                       ("audio", "ac3")]
    assert [t[10] for t in tracks] == ["und", "fre", "eng"]
    assert tracks[0][2:4] == (64, 48)
    if name in ("ts", "m2ts"):
        assert [p[1] for p in video] == [T0 + i * FRAME for i in range(8)]
        assert b"".join(p[6] for p in video) == b"".join(h264_aus())
        assert [p[6] for p in pkts if p[0] == 2] == list(ac3_frames())
        assert TSDemuxer(ts_files[name]).psz == (192 if name == "m2ts"
                                                 else 188)
    else:
        assert len(video) >= 6       # one PES lost at most a fault


def test_open_source_routes_ts(ts_files):
    for name in ("ts", "m2ts"):
        src = open_source(ts_files[name])
        assert isinstance(src, TSDemuxer)
        src.close()


# ---------------------------------------------------------------------------
# MPEG program streams and DVD folders
# ---------------------------------------------------------------------------
def dvd_units(es, spu_at=1):
    """The 176x144 fixture's pictures, a 0.4 s AC-3 track, DVD LPCM in
    pts-stamped packs of 480 samples and a white VobSub card."""
    units = B.video_units(es, T0, FRAME)
    units += [(T0 + k * 2880, 0xBD, f, B.ac3_sub, T0 + k * 2880)
              for k, f in enumerate(ac3_frames())]
    lp = tone(48000, 2, 48000 * 2 // 5, 2)
    units += [(T0 + k * 900, 0xBD, B.s16be_lpcm(lp[k * 480:(k + 1) * 480]),
               B.lpcm_sub, T0 + k * 900) for k in range(len(lp) // 480)]
    card = np.ones((16, 32), np.uint8)
    spu = build_spu(card, x=30, y=20, stop_delay=(6 * 3000) // 1024)
    at = T0 + spu_at * FRAME
    units.append((at, 0xBD, spu, B.spu_sub, at))
    return units


@pytest.fixture(scope="module")
def ps_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("psrc")
    es = B.fixture("mpeg2_176x144.m2v")
    paths = {}
    ps = B.build_ps(dvd_units(es))
    paths["dvd"] = B.write_dvd(str(d / "disc"), ps, 2, [0.2, 0.2])
    paths["vob"] = str(d / "a.vob")
    with open(paths["vob"], "wb") as f:
        f.write(ps)
    # H.264 in a PS with an AC-3 substream (the reference's round trip)
    units = [(T0 + i * FRAME, 0xE0, au, None, T0 + i * FRAME)
             for i, au in enumerate(h264_aus())]
    units += [(T0 + k * 2880, 0xBD, f, B.ac3_sub, T0 + k * 2880)
              for k, f in enumerate(ac3_frames())]
    paths["h264.mpg"] = str(d / "h264.mpg")
    with open(paths["h264.mpg"], "wb") as f:
        f.write(B.build_ps(units))
    return paths


@pytest.mark.parametrize("name", ["vob", "h264.mpg"])
def test_ps_demuxer_equals_reference(ps_files, name):
    tracks, pkts, duration, _ = same(PSDemuxer, JPSDemuxer, ps_files[name])
    video = b"".join(p[6] for p in pkts if p[0] == 0)
    if name == "vob":
        assert [t[:2] for t in tracks] == [
            ("video", "mpeg2"), ("audio", "ac3"), ("audio", "lpcm"),
            ("subtitle", "vobsub")]
        assert video == B.fixture("mpeg2_176x144.m2v")
        assert tracks[2][7:10] == (48000, 2, bytes([16]))
    else:
        assert [t[:2] for t in tracks] == [("video", "h264"),
                                           ("audio", "ac3")]
        assert video == b"".join(h264_aus())
        assert tracks[0][2:4] == (64, 48)
    assert [p[6] for p in pkts if p[0] == 1] == list(ac3_frames())
    src = open_source(ps_files[name])
    assert isinstance(src, PSDemuxer)
    src.close()


def test_dvd_scan_equals_reference(ps_files):
    got, want = dvd.scan_dvd(ps_files["dvd"]), jdvd.scan_dvd(ps_files["dvd"])
    assert len(got) == len(want) == 1
    assert vars(got[0]) == vars(want[0])
    t = got[0]
    assert abs(t.duration_s - 0.4) < 0.05
    assert len(t.chapter_times) == 2 and abs(t.chapter_times[1] - 0.2) < 0.05
    assert t.palette[:2] == [0x000000, 0xFFFFFF]
    assert [os.path.basename(p) for p in t.vob_paths] == [
        "VTS_01_1.VOB", "VTS_01_2.VOB"]
    assert dvd.is_dvd_folder(ps_files["dvd"])
    assert scan_paths(ps_files["dvd"]) == [ps_files["dvd"]]


def test_dvd_title_demuxer_equals_reference(ps_files):
    """open_dvd_title builds its PSDemuxer through __new__: every packet
    across the two VOBs, the palette extradata and the chapters."""
    got = read(dvd.open_dvd_title(ps_files["dvd"])[0])
    assert got == read(jdvd.open_dvd_title(ps_files["dvd"])[0])
    assert got == read(jopen(ps_files["dvd"]))
    tracks, pkts, duration, chapters = got
    assert tracks[3][9].startswith(b"palette: 000000, ffffff")
    assert chapters == [(0, "Chapter 1"), (18000, "Chapter 2")]
    assert b"".join(p[6] for p in pkts if p[0] == 0) == \
        B.fixture("mpeg2_176x144.m2v")
    # the folder's packets equal the single VOB's
    assert pkts == read(PSDemuxer(ps_files["vob"]))[1]
    src = open_source(ps_files["dvd"])
    assert isinstance(src, PSDemuxer) and src.chapters == chapters
    src.close()


def test_ps_demuxer_attributes_match_its_init(ps_files):
    """open_dvd_title makes its demuxer without __init__: it must hold
    every attribute __init__ gives one."""
    a = vars(PSDemuxer(ps_files["vob"]))
    b = vars(dvd.open_dvd_title(ps_files["dvd"])[0])
    assert set(a) <= set(b)


# ---------------------------------------------------------------------------
# Blu-ray folders
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bd_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bdsrc")
    ts = h264_ts(n=8, audio=[(0x81, 0x1100, 0xBD, b"", ac3_frames(), 2880)])
    root = B.write_bd(str(d / "disc"), ts, 2, 8 / 30, [(0, 0.0), (1, 0.05)])
    # a shorter playlist that the longest-first order puts second
    short = B.make_mpls(["00001"], 1000, [(0, 0)])
    with open(os.path.join(root, "BDMV", "PLAYLIST", "00001.mpls"),
              "wb") as f:
        f.write(short)
    return root


def test_bd_scan_equals_reference(bd_dir):
    got, want = bd.scan_bd(bd_dir), jbd.scan_bd(bd_dir)
    assert [vars(t) for t in got] == [vars(t) for t in want]
    assert [t.playlist for t in got] == ["00000.mpls", "00001.mpls"]
    t = got[0]
    assert len(t.clip_paths) == 2 and abs(t.duration_s - 8 / 30) < 0.01
    assert len(t.chapter_times) == 2
    assert abs(t.chapter_times[1] - (4 / 30 + 0.05)) < 0.01
    assert bd.is_bd_folder(bd_dir) and scan_paths(bd_dir) == [bd_dir]


def test_bd_title_demuxer_equals_reference(bd_dir):
    got = read(bd.open_bd_title(bd_dir)[0])
    assert got == read(jbd.open_bd_title(bd_dir)[0]) == read(jopen(bd_dir))
    tracks, pkts, duration, chapters = got
    assert [t[:2] for t in tracks] == [("video", "h264"), ("audio", "ac3")]
    assert b"".join(p[6] for p in pkts if p[0] == 0) == \
        b"".join(h264_aus())
    assert len(chapters) == 2
    src = open_source(bd_dir)
    assert isinstance(src, TSDemuxer) and src.psz == 192
    assert set(vars(TSDemuxer(src.path))) <= set(vars(src))
    src.close()


# ---------------------------------------------------------------------------
# AVI
# ---------------------------------------------------------------------------
AVI = os.path.join(B.FIXTURES, "mjpeg_640x480.avi")


def test_avi_demuxer_equals_reference():
    tracks, pkts, duration, _ = same(AVIDemuxer, JAVIDemuxer, AVI)
    assert tracks[0][:5] == ("video", "mjpeg", 640, 480, (25, 1))
    assert len(pkts) == 6 and all(p[6][:2] == b"\xff\xd8" for p in pkts)
    assert [p[1] for p in pkts] == [i * 3600 for i in range(6)]
    src = open_source(AVI)
    assert isinstance(src, AVIDemuxer)
    src.close()


def test_hevc_elementary_stream_still_raises(tmp_path, monkeypatch):
    """HEVC elementary streams open since item 1.9; one beyond the native
    decoder's subset (SAO on) opens as the reference opens it (no
    geometry) and, where libavcodec is missing, raises at its decode,
    naming ROADMAP item 1.10 and the missing library."""
    from torch_catalog import hide
    hide(monkeypatch, tmp_path)
    from handbrake_tpu_torch.codecs.registry import create_video_decoder
    from handbrake_tpu_torch.core.buffer import Buffer
    from test_torch_hevc import sao_stream
    p = tmp_path / "a.265"
    p.write_bytes(sao_stream())
    src = open_source(str(p))
    try:
        ti = src.tracks[0]
        assert (ti.codec, ti.width, ti.height) == ("hevc", 0, 0)
        pkt = next(b for _t, b in src.packets())
    finally:
        src.close()
    with pytest.raises(ValueError, match=r"item 1\.10\), and libavcodec "
                       r"is missing \(libavutil"):
        create_video_decoder("hevc", ti.extradata).feed(pkt)


# ---------------------------------------------------------------------------
# shared faults: the MPEG-2 aspect and rate, repaired in the port and held
# beside the reference; the DTS substream, left as the reference has it
# (ROADMAP §3.4)
# ---------------------------------------------------------------------------
def _patched_vob(tmp_path, aspect=None, rate=None, extra=()):
    es = bytearray(B.fixture("mpeg2_176x144.m2v"))
    i = es.find(b"\x00\x00\x01\xb3")
    if aspect is not None:
        es[i + 7] = (aspect << 4) | (es[i + 7] & 15)
    if rate is not None:
        es[i + 7] = (es[i + 7] & 0xF0) | rate
    units = B.video_units(bytes(es), T0, FRAME) + list(extra)
    p = str(tmp_path / "p.vob")
    with open(p, "wb") as f:
        f.write(B.build_ps(units))
    return p, bytes(es)


def test_repaired_16_9_vob_reads_its_aspect(tmp_path):
    """aspect_ratio_information 3 (16:9) on a 176x144 picture: the port's
    track and decoder info give 16:9 x 144/176 = 16:11; the reference's
    still say 1:1 (its ps.py:271-275, registry.py:263-268)."""
    from handbrake_tpu.codecs.registry import create_video_decoder as jcvd
    p, es = _patched_vob(tmp_path, aspect=3)
    for D, want in ((PSDemuxer, (16, 11)), (JPSDemuxer, (1, 1))):
        d = D(p)
        assert (d.tracks[0].par_num, d.tracks[0].par_den) == want
        d.close()
    for make, want in ((create_video_decoder, (16, 11)), (jcvd, (1, 1))):
        dec = make("mpeg2")
        dec.feed(Buffer(data=es, pts=0))
        assert dec.info()["sar"] == want


def test_repaired_pal_vob_is_labelled_25_fps(tmp_path):
    """frame_rate_code 3 (25 fps): the decoder's durations follow it in
    both packages; the port's track says 25/1, the reference's still
    30000/1001.  Only the rate differs between the two demuxers."""
    p, es = _patched_vob(tmp_path, rate=3)
    tracks = read(PSDemuxer(p))[0]
    ref = read(JPSDemuxer(p))[0]
    assert tracks[0][4] == (25, 1) and ref[0][4] == (30000, 1001)
    assert [t[:4] + t[5:] for t in tracks] == [t[:4] + t[5:] for t in ref]
    dec = Mpeg2VideoDecoder()
    frames = dec.feed(Buffer(data=es, pts=0)) + dec.flush()
    assert dec.dec.frame_rate == (25, 1)
    assert {f.duration for f in frames} == {3600}


def test_repaired_dts_substream_is_listed(tmp_path):
    """A DVD DTS substream (private stream 1, 0x88) is a ``dts`` track
    with the core frame header's rate and channels (44.1 kHz 2/0 here,
    not the track defaults), its packets the frames without the 4-byte
    preamble; the reference still lists no track for it."""
    frames = [B.dts_core_frame(amode=2, lff=0, sfreq=8, size=1000)
              for _ in range(4)]
    dts = [(T0 + k * 1045, 0xBD, f, B.dts_sub, T0 + k * 1045)
           for k, f in enumerate(frames)]
    p, _ = _patched_vob(tmp_path, extra=dts)
    d = JPSDemuxer(p)
    assert [t.kind for t in d.tracks] == ["video"]
    d.close()
    tracks, pkts, _, _ = read(PSDemuxer(p))
    assert [t[:2] for t in tracks] == [("video", "mpeg2"), ("audio", "dts")]
    assert tracks[1][7:9] == (44100, 2)
    assert b"".join(u[6] for u in pkts if u[0] == 1) == b"".join(frames)


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------
_MPEG2_FIELD_DCT = (
    ("""frame prediction + frame DCT (progressive sequences; field/interlaced
tools raise), custom quant matrices, full VLC layer (Tables B.1-B.15),
half-pel MC, mismatch control.
""", """frame prediction with frame or field DCT (the interlaced DVD's frame
pictures; field pictures and field motion raise), custom quant
matrices, full VLC layer (Tables B.1-B.15), half-pel MC, mismatch
control.
"""),
    ("""                    self.mb_h = (self.h + 15) // 16
            i += 4
""", """                    # an interlaced sequence codes whole field pairs of
                    # MB rows (6.3.3: 2 * ceil(h / 32))
                    self.mb_h = (self.h + 15) // 16 if self.progressive \\
                        else 2 * ((self.h + 31) // 32)
            i += 4
"""),
    ("""        if not st["frame_pred"] and (intra or pattern):
            br.u(1)                    # dct_type (frame DCT assumed)
""", """        field_dct = 0
        if not st["frame_pred"] and (intra or pattern):
            field_dct = br.u(1)        # dct_type: 1 = field DCT
"""),
    ("""            self._add_block(planes, mb_x, mb_row, blk, blkpix, intra)
""", """            self._add_block(planes, mb_x, mb_row, blk, blkpix, intra,
                            field_dct)
"""),
    ("""    def _add_block(self, planes, mb_x, mb_row, blk, blkpix, intra):
        y, u, v = planes
        if blk < 4:
            x0 = mb_x * 16 + (blk & 1) * 8
            y0 = mb_row * 16 + (blk >> 1) * 8
""", """    def _add_block(self, planes, mb_x, mb_row, blk, blkpix, intra,
                   field_dct=0):
        y, u, v = planes
        step = 1
        if blk < 4:
            x0 = mb_x * 16 + (blk & 1) * 8
            if field_dct:
                # field DCT (6.1.3, Figure 6-13): luma blocks 0-1 hold the
                # top field's lines of the MB, 2-3 the bottom field's
                y0 = mb_row * 16 + (blk >> 1)
                step = 2
            else:
                y0 = mb_row * 16 + (blk >> 1) * 8
"""),
    ("""        base = 0 if intra else tgt[y0:y0 + 8, x0:x0 + 8].astype(np.int32)
        tgt[y0:y0 + 8, x0:x0 + 8] = np.clip(base + blkpix, 0, 255)""",
     """        rows = slice(y0, y0 + 8 * step, step)
        base = 0 if intra else tgt[rows, x0:x0 + 8].astype(np.int32)
        tgt[rows, x0:x0 + 8] = np.clip(base + blkpix, 0, 255)"""))

# an HEVC track's picture size from its SPS (the reference reads none
# for HEVC and leaves the track 0x0)
_TS_HEVC_GEOMETRY = (
    ("""        if ti.frame_rate is None:
""", """        elif ti.codec == "hevc":
            # the picture's size: the SPS's coded size less its
            # conformance window (the reference reads no HEVC SPS here and
            # leaves the track 0x0)
            try:
                from ..codecs.h264.bits import ebsp_to_rbsp, split_annexb
                from ..codecs.hevc.syntax import SPS as HSPS
                for nal in split_annexb(bytes(es)):
                    if ((nal[0] >> 1) & 0x3F) == 33:
                        sps = HSPS.parse(ebsp_to_rbsp(nal[2:]))
                        ti.width = sps.width - sps.crop_right
                        ti.height = sps.height - sps.crop_bottom
                        break
            except AssertionError:
                pass            # beyond the native subset: the decoder says so
        if ti.frame_rate is None:
"""),)

_AVI_MPEG4 = (
    (r'''and PCM audio tracks, idx1 ignored (sequential read).
"""
''',
     r'''and PCM audio tracks, idx1 ignored (sequential read).

The port also reads MPEG-4 part 2 video (XVID, DIVX, DX50, FMP4, MP4V),
which libavcodec decodes.  AVI keeps one timestamp a chunk, in decode
order; with B-frames the demuxer gives each VOP its display time, read
from the VOP coding types, holding an anchor back until the next one is
seen (the reference reads no MPEG-4 in AVI).  A packed bitstream
(DivX's P-VOP and B-VOP in one chunk, then a chunk with an empty VOP)
leaves a chunk's time to two VOPs, so it is refused by name.
"""
'''),
    (r'''_VID_CODECS = {b"MJPG": "mjpeg", b"mjpg": "mjpeg", b"\x00\x00\x00\x00": "rawvideo"}
''',
     r'''_VID_CODECS = {b"MJPG": "mjpeg", b"mjpg": "mjpeg", b"\x00\x00\x00\x00": "rawvideo",
               b"XVID": "mpeg4", b"DIVX": "mpeg4", b"DX50": "mpeg4",
               b"FMP4": "mpeg4", b"MP4V": "mpeg4"}


def _vop_is_b(data: bytes) -> bool:
    """An MPEG-4 part 2 chunk whose first VOP is a B-VOP
    (vop_coding_type 2)."""
    i = data.find(b"\x00\x00\x01\xb6")
    return 0 <= i < len(data) - 4 and data[i + 4] >> 6 == 2


class _DisplayOrder:
    """One MPEG-4 track's chunks in decode order, each stamped with the
    decode-order frame time, restamped with display times: a B-VOP shows
    at the next free time and an anchor after the B-VOPs that follow it,
    so each anchor is held until the next one arrives."""

    def __init__(self):
        self.times, self.held = [], []

    def push(self, item) -> list:
        b = item[1]
        if b.data.count(b"\x00\x00\x01\xb6") > 1:
            raise DemuxError("mpeg4 in AVI: a packed bitstream (several "
                             "VOPs in one chunk) is not supported")
        self.times.append((b.pts, b.duration))
        out = []
        if not _vop_is_b(b.data) and self.held:
            out = self.flush()
        self.held.append(item)
        return out

    def flush(self) -> list:
        held, self.held = self.held, []
        for _trk, b in held[1:] + held[:1]:
            b.pts, b.duration = self.times.pop(0)
            b.stop = b.pts + b.duration
        return held
'''),
    (r'''                    self.tracks[-1].height = abs(h)
''',
     r'''                    self.tracks[-1].height = abs(h)
                    if self.tracks[-1].codec == "unknown":
                        # the strh handler left blank: biCompression
                        self.tracks[-1].codec = _VID_CODECS.get(
                            data[16:20].upper(), "unknown")
'''),
    (r'''    def packets(self, start_state=None):
''',
     r'''    def packets(self, start_state=None):
        order = {i: _DisplayOrder() for i, t in enumerate(self.tracks)
                 if t.codec == "mpeg4"}
        for trk, b in self._chunks(start_state):
            if trk in order:
                yield from order[trk].push((trk, b))
            else:
                yield trk, b
        for o in order.values():
            yield from o.flush()

    def _chunks(self, start_state=None):
'''),
)

# the pixel aspect and frame rate of an MPEG-2 track from its sequence
# header, through one helper (the reference reads the size alone and
# labels every track 30000/1001), and an H.264 track's VUI aspect
_PS_ASPECT = (
    ("""from ..core.buffer import Buffer, FrameType
from .common import DemuxError, TrackInfo

""",
     """from ..core.buffer import Buffer, FrameType
from ..utils.logging import log
from .common import (DemuxError, TrackInfo, read_audio_header,
                     read_mpeg2_header, read_stream_rate, read_vui_sar)

"""),
    ("""        elif ti.codec == "mpeg2":
            i = bytes(es).find(b"\\x00\\x00\\x01\\xb3")
            if i >= 0 and i + 8 <= len(es):
                ti.width = (es[i + 4] << 4) | (es[i + 5] >> 4)
                ti.height = ((es[i + 5] & 15) << 8) | es[i + 6]
        if ti.frame_rate is None:
""",
     """            read_vui_sar(ti, es, "ps")
        elif ti.codec == "mpeg2":
            # size, pixel aspect and rate from the sequence header (the
            # reference reads the size alone and labels every track
            # 30000/1001)
            read_mpeg2_header(ti, es, "ps")
        if ti.frame_rate is None:
"""),
)

_TS_ASPECT = (
    ("""from ..core.buffer import Buffer
from .common import DemuxError, TrackInfo

""",
     """from ..core.buffer import Buffer
from ..utils.logging import log
from .common import (DemuxError, TrackInfo, read_audio_header,
                     read_mpeg2_header, read_stream_rate, read_vui_sar)

"""),
    ("""                    break
        if ti.codec == "h264":
""",
     """                    break
        if ti.codec == "mpeg2":
            # stream types 0x01/0x02: size, pixel aspect and rate from the
            # sequence header (the reference leaves the track 0x0, 1:1,
            # 30000/1001)
            read_mpeg2_header(ti, es, "ts")
        if ti.codec == "h264":
"""),
    ("""            ti.frame_rate = (30000, 1001)

""",
     """            ti.frame_rate = (30000, 1001)
        if ti.codec in ("h264", "hevc"):
            # the rate the stream states (the reference labels every
            # H.264 and HEVC track 30000/1001)
            read_stream_rate(ti, es, where)
            read_vui_sar(ti, es, "ts")

"""),
)

# an H.264 (TS: and HEVC) track's frame rate from the timing its stream
# states (codecs/vui.stream_rate; the reference parses an SPS that stops
# before the VUI, so its rate is always the default), the rate's lines and
# the SPS's read fault logged rather than hidden
_PS_RATE = (
    ("""        if ti.codec == "h264":
            try:
""", """        if ti.codec == "h264":
            where = "ps: stream {:#04x}".format(next(
                k[0] for k, v in self._sid_to_track.items() if v == vids[0]))
            try:
"""),
    ("""                        ti.height = sps.height
                        if sps.vui_timing:
                            nu, ts_ = sps.vui_timing
                            ti.frame_rate = (ts_, nu * 2)
                        break
            except Exception:   # noqa: BLE001 — geometry stays unknown
                pass
""", """                        ti.height = sps.height
                        break
            except (IndexError, ValueError) as e:
                log(f"{where}: the h264 SPS gives no picture size "
                    f"({e or 'cut short'}); the track keeps 0x0")
            # the rate the stream states (the reference labels every
            # H.264 track 30000/1001)
            ti.frame_rate = (30000, 1001)
            read_stream_rate(ti, es, where)
"""),
)

_TS_RATE = (
    ("""        self._fill_video_info()

    def _fill_video_info(self):
""", """        self._fill_video_info()
        self._fill_dts_info()

    def _fill_dts_info(self):
        \"\"\"A DTS track's rate and channels from its first frame: a DTS-HD
        Master Audio track's are its lossless asset's (the reference
        leaves every DTS track at 48 kHz stereo).\"\"\"
        dts = {i: bytearray() for i, t in enumerate(self.tracks)
               if t.codec == "dts"}
        if not dts:
            return
        # a listed DTS PID that carries little stops the read at 16 MB
        seen = 0
        for trk, buf in self.packets():
            seen += len(buf.data or b"")
            if trk in dts and buf.data and len(dts[trk]) < 1 << 16:
                dts[trk] += buf.data
            if seen >= 1 << 24 or all(len(v) >= 1 << 16
                                      for v in dts.values()):
                break
        for i, es in dts.items():
            read_audio_header(self.tracks[i], es, f"ts: track {i}")

    def _fill_video_info(self):
"""),
    ("""        ti = self.tracks[vids[0]]
        es = bytearray()
""", """        ti = self.tracks[vids[0]]
        where = "ts: pid {:#x}".format(next(
            k for k, v in self._pid_to_track.items() if v == vids[0]))
        es = bytearray()
"""),
    ("""                        ti.height = sps.height
                        if sps.vui_timing:
                            num_units, time_scale = sps.vui_timing
                            ti.frame_rate = (time_scale, num_units * 2)
                        break
            except Exception:
                pass
""", """                        ti.height = sps.height
                        break
            except (IndexError, ValueError) as e:
                log(f"{where}: the h264 SPS gives no picture size "
                    f"({e or 'cut short'}); the track keeps 0x0")
"""),
)

# DTS substreams 0x88-0x8F as dts tracks, and an AC-3 or DTS track's rate
# and channels from its first frame (the reference lists no DTS track
# and leaves every AC-3 track at 48 kHz stereo); read_audio_header joins
# _PS_ASPECT's import
_PS_DTS = (
    ('''PES packets per stream id: video 0xE0-0xEF, MPEG audio 0xC0-0xDF, and
private-stream-1 (0xBD) substreams (AC-3 0x80-0x87, LPCM 0xA0-0xAF with
their 1-4 byte substream preambles).  Video codec is sniffed from the ES
(H.264 NALs vs MPEG-2 sequence headers).  Exposes the same interface as
TSDemuxer: tracks / duration / packets() / seek() / close().
"""
''',
     '''PES packets per stream id: video 0xE0-0xEF, MPEG audio 0xC0-0xDF, and
private-stream-1 (0xBD) substreams (AC-3 0x80-0x87, DTS 0x88-0x8F, LPCM
0xA0-0xAF with their 1-4 byte substream preambles; an AC-3 or DTS track
takes its rate and channels from its first frame).  Video codec is
sniffed from the ES (H.264 NALs vs MPEG-2 sequence headers).  Exposes
the same interface as TSDemuxer: tracks / duration / packets() / seek()
/ close().
"""
'''),
    ("""                sub = payload[0]
                if 0x80 <= sub <= 0x87:               # AC-3: 3 more bytes
                    payload = payload[4:]
""",
     """                sub = payload[0]
                if 0x80 <= sub <= 0x8F:       # AC-3, DTS: 3 more bytes
                    payload = payload[4:]
"""),
    ("""                return "audio", "ac3"
            if sub is not None and 0xA0 <= sub <= 0xAF:
""",
     """                return "audio", "ac3"
            if sub is not None and 0x88 <= sub <= 0x8F:
                return "audio", "dts"
            if sub is not None and 0xA0 <= sub <= 0xAF:
"""),
    ("""                ti.extradata = bytes([h["bits"]])
            self._sid_to_track[key] = len(self.tracks)
""",
     """                ti.extradata = bytes([h["bits"]])
            elif codec in ("ac3", "dts"):
                read_audio_header(ti, es, "ps")
            self._sid_to_track[key] = len(self.tracks)
"""),
    ("""    def seek(self, pts):
        return None                      # restart from byte 0 (linear)
""",
     '''    def stream_track(self, stream_id: int, substream=None):
        """The index of the track of PES stream ``stream_id`` (of private
        stream 1's ``substream``), or None where it has no track."""
        return self._sid_to_track.get((stream_id, substream))

    def seek(self, pts):
        return None                      # restart from byte 0 (linear)
'''),
)

# the VTS audio attributes (VTSI_MAT 0x203-0x243): languages onto the
# tracks, disagreements logged
_DVD_AUDIO_ATTRS = (
    ("""        0xE6 program map offset, 0xE8 cell playback info offset
Cells/angles beyond the first PGC and menu domains are out of scope.
""",
     """        0xE6 program map offset, 0xE8 cell playback info offset
  VTSI  0x203 the number of audio streams, 0x204 their attributes, 8
        bytes each (byte 0: coding mode 0 AC-3 / 2-3 MPEG / 4 LPCM / 6
        DTS, language type 1 = code present; byte 1: rate, channels - 1;
        bytes 2-3: the ISO 639-1 code)

The audio attributes go to the tracks of their stream numbers (substream
0x80 + i AC-3, 0x88 + i DTS, 0xA0 + i LPCM, stream 0xC0 + i MPEG): the
language is the IFO's, the codec and channels the stream's, and the log
says where the two disagree and which listed stream the VOBs never carry
(``apply_audio_attributes``; the reference reads no attributes).

Cells/angles beyond the first PGC and menu domains are out of scope.
"""),
    ("""                   "PAL": ((25, 1),)}


def _bcd(v: int) -> int:
""",
     """                   "PAL": ((25, 1),)}

# the audio attributes' coding modes, and the stream each one's stream
# number i is carried in: (stream id, substream id or None) at i = 0
_AUDIO_CODECS = {0: "ac3", 2: "mp2", 3: "mp2", 4: "lpcm", 6: "dts"}
_AUDIO_STREAMS = {"ac3": (0xBD, 0x80), "dts": (0xBD, 0x88),
                  "lpcm": (0xBD, 0xA0), "mp2": (0xC0, None)}


def _bcd(v: int) -> int:
"""),
    ("""    return h * 3600 + m * 60 + s + f / rate

""",
     '''    return h * 3600 + m * 60 + s + f / rate


class AudioAttributes(NamedTuple):
    """One audio stream's attributes (VTSI_MAT 0x204 + 8 i)."""
    codec: Optional[str]            # ac3 | mp2 | lpcm | dts; None: other
    channels: int
    sample_rate: int
    language: str                   # ISO 639-2, "und" where none is given

    @classmethod
    def parse(cls, attr: bytes) -> "AudioAttributes":
        from ..job.lang import to_iso639_2
        code = attr[2:4].decode("latin-1", "replace").strip("\\x00 ")
        lang = to_iso639_2(code) if (attr[0] >> 2) & 3 == 1 and code \\
            else "und"
        return cls(_AUDIO_CODECS.get(attr[0] >> 5), (attr[1] & 7) + 1,
                   96000 if (attr[1] >> 4) & 3 == 1 else 48000, lang)

'''),
    ("""            return VideoAttributes.parse(f.read(2).ljust(2, b"\\x00"))

""",
     '''            return VideoAttributes.parse(f.read(2).ljust(2, b"\\x00"))

    @property
    def audio(self) -> List[AudioAttributes]:
        """The title's VTS audio attributes, one a stream, from its IFO."""
        ifo = os.path.join(os.path.dirname(self.vob_paths[0]),
                           f"VTS_{self.vts:02d}_0.IFO")
        with open(ifo, "rb") as f:
            f.seek(0x202)
            head = f.read(2 + 8 * 8).ljust(66, b"\\x00")
        n = min(8, int.from_bytes(head[:2], "big"))
        return [AudioAttributes.parse(head[2 + 8 * i:10 + 8 * i])
                for i in range(n)]

'''),
    ("""    return DvdTitle(vts_nr, ttn, duration, chapter_times, palette, vobs)

""",
     '''    return DvdTitle(vts_nr, ttn, duration, chapter_times, palette, vobs)


def apply_audio_attributes(d, t: DvdTitle):
    """The title's audio tracks (demuxer ``d``) against the IFO's audio
    attributes: each listed stream i finds its track through the stream
    of its coding mode, or failing that through another mode's stream of
    number i; the track takes the IFO's language and keeps the stream's
    codec and channels, with a log line where the IFO says otherwise.  A
    listed stream that the VOBs never carry gets no track, and a log
    line."""
    from ..utils.logging import log

    def track(codec, i):
        sid, sub = _AUDIO_STREAMS[codec]
        return d.stream_track(sid + i) if sub is None \\
            else d.stream_track(sid, sub + i)

    for i, a in enumerate(t.audio):
        ifo = (f"{a.codec or 'an unknown coding mode'}, {a.channels} ch, "
               f"{a.language}")
        order = ([a.codec] if a.codec else []) + [
            c for c in _AUDIO_STREAMS if c != a.codec]
        idx = next((track(c, i) for c in order
                    if track(c, i) is not None), None)
        if idx is None:
            log(f"dvd: the IFO lists audio stream {i + 1} ({ifo}) that the "
                f"VOBs never carry; it gets no track")
            continue
        ti = d.tracks[idx]
        ti.language = a.language
        if a.codec != ti.codec:
            log(f"dvd: audio stream {i + 1} is {ti.codec} in the VOBs, "
                f"{a.codec or 'an unknown coding mode'} in the IFO; the "
                f"stream's codec is kept")
        if a.channels != ti.channels:
            log(f"dvd: audio stream {i + 1} ({ti.codec}) has "
                f"{ti.channels} channels in the VOBs, {a.channels} in the "
                f"IFO; the stream's count is kept")

'''),
    ("""        d.duration = int(t.duration_s * 90000)
    # IFO CLUT → vobsub tracks (decvobsub palette source)
""",
     """        d.duration = int(t.duration_s * 90000)
    apply_audio_attributes(d, t)
    # IFO CLUT → vobsub tracks (decvobsub palette source)
"""),
)

# the VTS video attributes (VTSI_MAT 0x200) against the sequence header
_DVD_VIDEO_ATTRS = (
    ("""           (type, angles, nr_ptts, parental, vts_nr, vts_ttn, vts_sect)
  VTSI  0x00 "DVDVIDEO-VTS", 0xCC VTS_PGCIT start sector
  VTS_PGCIT u16 count, u16 pad, u32 end; 8-byte srp entries
""",
     """           (type, angles, nr_ptts, parental, vts_nr, vts_ttn, vts_sect)
  VTSI  0x00 "DVDVIDEO-VTS", 0xCC VTS_PGCIT start sector, 0x200 the
        VTS video attributes (byte 0: MPEG version, NTSC/PAL, display
        aspect 0 = 4:3 / 3 = 16:9; byte 1 bits 3-2: picture size)
  VTS_PGCIT u16 count, u16 pad, u32 end; 8-byte srp entries
"""),
    ('''Cells/angles beyond the first PGC and menu domains are out of scope.
"""
''',
     '''Cells/angles beyond the first PGC and menu domains are out of scope.

The video attributes go to the title's video track (``open_dvd_title``):
the IFO's display aspect decides the track's pixel aspect where it names
the stream's picture size, and the log says where it and the sequence
header disagree (the reference reads no attributes).
"""
'''),
    ("""import os
from typing import List, Optional

_SECTOR = 2048

""",
     """import os
from fractions import Fraction
from typing import List, NamedTuple, Optional

_SECTOR = 2048
# the VTS video attributes' codes
_STANDARDS = {0: "NTSC", 1: "PAL"}
_ASPECTS = {0: (4, 3), 3: (16, 9)}
_WIDTHS = {0: 720, 1: 704, 2: 352, 3: 352}
# the frame rates each standard's MPEG-2 stream may carry
_STANDARD_RATES = {"NTSC": ((30000, 1001), (24000, 1001)),
                   "PAL": ((25, 1),)}

"""),
    ("""
class DvdTitle:
""",
     '''
class VideoAttributes(NamedTuple):
    """A VTS's video attributes (VTSI_MAT 0x200)."""
    standard: str                   # NTSC | PAL
    display_aspect: Optional[tuple]     # (4, 3), (16, 9); None: reserved
    picture_size: tuple             # the (width, height) they describe

    @classmethod
    def parse(cls, attr: bytes) -> "VideoAttributes":
        a, b = attr[0], attr[1]
        standard = _STANDARDS.get((a >> 4) & 3, "NTSC")
        size = (b >> 2) & 3
        lines = 576 if standard == "PAL" else 480
        return cls(standard, _ASPECTS.get((a >> 2) & 3),
                   (_WIDTHS[size], lines // 2 if size == 3 else lines))


class DvdTitle:
'''),
    ("""        self.vob_paths = vob_paths

""",
     '''        self.vob_paths = vob_paths

    @property
    def video(self) -> VideoAttributes:
        """The title's VTS video attributes, read from its IFO."""
        ifo = os.path.join(os.path.dirname(self.vob_paths[0]),
                           f"VTS_{self.vts:02d}_0.IFO")
        with open(ifo, "rb") as f:
            f.seek(0x200)
            return VideoAttributes.parse(f.read(2).ljust(2, b"\\x00"))

'''),
    ("""
class _ConcatFile:
""",
     '''
def apply_video_attributes(ti, t: DvdTitle):
    """The title's video track against the IFO's video attributes.  The
    IFO's display aspect sets the pixel aspect where the attributes name
    the track's picture size; a sequence header that says otherwise is
    overruled, with a log line.  A header's frame rate is kept, with a
    log line where it is not one of the IFO standard's.  Without a
    header (the track 0x0) the IFO gives the rate and the aspect."""
    from ..utils.logging import log
    v = t.video
    if v.display_aspect is None:
        log(f"dvd: VTS {t.vts}'s video attributes hold a reserved display "
            f"aspect code; the track keeps {ti.par_num}:{ti.par_den}")
        return
    w, h = v.picture_size
    n, d = v.display_aspect
    par = Fraction(n * h, d * w)
    ifo = f"{v.standard} {w}x{h} {n}:{d}"
    if not ti.width:
        ti.frame_rate = _STANDARD_RATES[v.standard][0]
        ti.par_num, ti.par_den = par.numerator, par.denominator
        log(f"dvd: no sequence header read; the IFO's attributes ({ifo}) "
            f"give {ti.frame_rate[0]}/{ti.frame_rate[1]} fps and pixel "
            f"aspect {ti.par_num}:{ti.par_den}")
        return
    if ti.frame_rate not in _STANDARD_RATES[v.standard]:
        log(f"dvd: the sequence header's {ti.frame_rate[0]}/"
            f"{ti.frame_rate[1]} fps is not {v.standard}'s (the IFO's "
            f"attributes: {ifo}); the header's rate is kept")
    if (ti.width, ti.height) != (w, h):
        log(f"dvd: the IFO's attributes ({ifo}) do not describe the "
            f"{ti.width}x{ti.height} stream; its sequence header's pixel "
            f"aspect {ti.par_num}:{ti.par_den} is kept")
        return
    if (ti.par_num, ti.par_den) != (par.numerator, par.denominator):
        log(f"dvd: the sequence header's pixel aspect {ti.par_num}:"
            f"{ti.par_den} disagrees with the IFO's display aspect "
            f"({ifo}); the IFO's {par.numerator}:{par.denominator} is "
            f"taken")
        ti.par_num, ti.par_den = par.numerator, par.denominator


class _ConcatFile:
'''),
    ("""    d._scan()
    if not d.duration and t.duration_s:
""",
     """    d._scan()
    vids = [ti for ti in d.tracks if ti.kind == "video"]
    if vids:
        apply_video_attributes(vids[0], t)
    if not d.duration and t.duration_s:
"""),
)

# aspect_ratio_information, frame_rate_extension_n/_d and the sequence
# display extension (the reference skips them)
_MPEG2_ASPECT = (
    ('''transform.
"""
from __future__ import annotations

''',
     '''transform.

The sequence header's aspect_ratio_information and frame_rate_code are
read with the sequence extension's frame_rate_extension_n/_d and the
sequence_display_extension's display size (6.3.3, Table 6-3):
``Mpeg2Decoder.sar`` and ``frame_rate``, and ``sequence_info`` for a
demuxer's track (the reference skips the aspect and the extensions).
"""
from __future__ import annotations

from fractions import Fraction

'''),
    ("""I_TYPE, P_TYPE, B_TYPE = 1, 2, 3

""",
     """I_TYPE, P_TYPE, B_TYPE = 1, 2, 3

# frame_rate_code (Table 6-4)
FRAME_RATES = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001),
               5: (30, 1), 6: (50, 1), 7: (60000, 1001), 8: (60, 1)}
# aspect_ratio_information 2-4: the display aspect ratio (Table 6-3; 1 is
# square samples)
DISPLAY_ASPECTS = {2: (4, 3), 3: (16, 9), 4: (221, 100)}

"""),
    ("""        self.frame_rate = (30000, 1001)

""",
     '''        self.frame_rate = (30000, 1001)
        self.aspect_code = 0    # aspect_ratio_information (0: none seen)
        self.mpeg2 = False      # a sequence extension follows the header
        self.display_size = None    # sequence_display_extension's

    @property
    def sar(self):
        """The sample aspect ratio (num, den) the last sequence header
        gives, or None where it gives none (no header, a reserved code,
        an MPEG-1 header, whose code is a pel aspect this decoder does
        not take).  1 is square, 2-4 a display aspect over the display
        extension's size, or the coded size without one (6.3.3)."""
        a = self.aspect_code
        if not self.w or not self.mpeg2:
            return None
        if a == 1:
            return (1, 1)
        dw, dh = self.display_size or (self.w, self.h)
        if a not in DISPLAY_ASPECTS or not dw or not dh:
            return None
        n, d = DISPLAY_ASPECTS[a]
        f = Fraction(n * dh, d * dw)
        return (f.numerator, f.denominator)

'''),
    ("""    # -- headers -----------------------------------------------------------
    def _parse_headers(self, data: bytes):
""",
     '''    # -- headers -----------------------------------------------------------
    def _sequence_ext_fields(self, br):
        """The sequence extension's frame_rate_extension_n/_d and the
        sequence display extension's size (6.2.2.3, 6.2.2.4)."""
        ext_id = br.u(4)
        if ext_id == 1:
            self.mpeg2 = True
            br.u(8 + 1 + 2 + 2 + 2)   # profile/level .. vertical size ext
            br.u(12 + 1 + 8 + 1)      # bit rate, vbv, low_delay
            n, d = br.u(2), br.u(5)
            if n or d:
                f = Fraction(self.frame_rate[0] * (n + 1),
                             self.frame_rate[1] * (d + 1))
                self.frame_rate = (f.numerator, f.denominator)
        elif ext_id == 2:
            br.u(3)                   # video_format
            if br.u(1):               # colour_description
                br.u(24)
            dw = br.u(14)
            br.u(1)
            self.display_size = (dw, br.u(14))

    def _parse_headers(self, data: bytes):
'''),
    ("""            br = _BR(data[i + 4:i + 4 + 256])
            if code == START_SEQ:
                self.w = br.u(12)
                self.h = br.u(12)
                br.u(4)               # aspect
                fr = br.u(4)
                rates = {1: (24000, 1001), 2: (24, 1), 3: (25, 1),
                         4: (30000, 1001), 5: (30, 1), 6: (50, 1),
                         7: (60000, 1001), 8: (60, 1)}
                self.frame_rate = rates.get(fr, (30000, 1001))
                br.u(18)              # bit_rate
""",
     """            br = _BR(data[i + 4:i + 4 + 256])
            if code == START_EXT:
                self._sequence_ext_fields(_BR(data[i + 4:i + 4 + 256]))
            if code == START_SEQ:
                self.w = br.u(12)
                self.h = br.u(12)
                self.aspect_code = br.u(4)
                self.mpeg2 = False
                self.display_size = None
                self.frame_rate = FRAME_RATES.get(br.u(4), (30000, 1001))
                br.u(18)              # bit_rate
"""),
    ("""        tgt[rows, x0:x0 + 8] = np.clip(base + blkpix, 0, 255)
""",
     '''        tgt[rows, x0:x0 + 8] = np.clip(base + blkpix, 0, 255)


def sequence_info(es: bytes):
    """The first sequence header of an MPEG-1/2 elementary stream, read
    with the extensions that follow it: {"width", "height", "sar",
    "frame_rate"} ("sar" None where the header gives none), or None
    where the stream holds no whole sequence header."""
    i = es.find(b"\\x00\\x00\\x01\\xb3")
    if i < 0:
        return None
    j = es.find(b"\\x00\\x00\\x01\\x00", i)
    dec = Mpeg2Decoder()
    try:
        dec._parse_headers(es[i:j if j > 0 else len(es)])
    except IndexError:          # cut inside the header
        return None
    if not dec.w or not dec.h:
        return None
    return {"width": dec.w, "height": dec.h, "sar": dec.sar,
            "frame_rate": dec.frame_rate}
'''),
)

# the port's Blu-ray streams: TrueHD with its AC-3 core by PES extension,
# E-AC-3, DTS-HD, DTS Express and PGS tracks, the skipped PMT entries logged
_TS_BD_STREAMS = (
    (r'''hook, decavcodec.c:2407).
"""
''',
     r'''hook, decavcodec.c:2407).

A Blu-ray's streams are listed as libavformat's mpegts.c lists them: a
TrueHD PID (stream type 0x83) carries its AC-3 core on the same PID, told
apart by the PES stream_id_extension (0x72 TrueHD, 0x76 AC-3), and
becomes two tracks, TrueHD then its core; a PGS PID (0x90) carries bare
segments, joined here into whole display sets.  Tracks are video first,
then audio in PMT order, then subtitles; each PMT entry of a type with
no track is logged with its PID.
"""
'''),
    (r"""    0x80: ("audio", "lpcm"),
}

""",
     r'''    0x80: ("audio", "lpcm"),
    # Blu-ray: TrueHD (with its AC-3 core), E-AC-3 and secondary E-AC-3,
    # DTS-HD High Resolution and DTS Express, PGS
    0x83: ("audio", "truehd"), 0x84: ("audio", "eac3"),
    0xA1: ("audio", "eac3"), 0x85: ("audio", "dts"),
    0xA2: ("audio", "dts"), 0x90: ("subtitle", "pgs"),
}
# the substreams of a TrueHD PID, by stream_id_extension: 0x76 is the
# AC-3 core, any other (0x72, or none) the TrueHD stream, as in mpegts.c
_TRUEHD_SUBSTREAMS = ((0x72, "truehd"), (0x76, "ac3"))
_KIND_ORDER = {"video": 0, "audio": 1, "subtitle": 2}


class _DisplaySets:
    """A PGS track's PES payloads → whole display sets (its segments,
    type u8, size u16 and payload, up to the END segment), each with the
    PTS and DTS of the PES its first byte came in.  A segment cut across
    PES packets is joined."""

    def __init__(self):
        self.buf = bytearray()
        self.stamp = (None, None)

    def feed(self, data: bytes, pts, dts) -> list:
        if not self.buf:
            self.stamp = (pts, dts)
        self.buf += data
        out = []
        i = 0
        while i + 3 <= len(self.buf):
            end = i + 3 + int.from_bytes(self.buf[i + 1:i + 3], "big")
            if end > len(self.buf):
                break
            seg, i = self.buf[i], end
            if seg == 0x80:               # END: the display set is whole
                out.append((bytes(self.buf[:i]), *self.stamp))
                del self.buf[:i]
                i = 0
                self.stamp = (pts, dts)
        return out

'''),
    (r'''        """Returns (pts, dts, payload_offset), None if not a PES start, or
        _PES_SHORT when the header (incl. PTS/DTS fields) is split across TS
        packets by a large adaptation field and more bytes are needed."""
''',
     r'''        """Returns (pts, dts, payload_offset, stream_id_extension or
        None), None if not a PES start, or _PES_SHORT when the header
        (incl. PTS/DTS fields, and the PES extension where its flag is
        set) is split across TS packets by a large adaptation field and
        more bytes are needed."""
'''),
    (r"""            need = 19
        if len(data) < need:
""",
     r"""            need = 19
        if flags & 0x01:
            need = max(need, 9 + data[8])
        if len(data) < need:
"""),
    (r"""        return pts, dts, 9 + data[8]

    # -- scan -----------------------------------------------------------------
    def _scan(self):
        pmts = set()
        es = {}
""",
     r'''        return pts, dts, 9 + data[8], self._pes_extension(data)

    @staticmethod
    def _pes_extension(data):
        """The 7-bit stream_id_extension of a whole PES header: after the
        fields its flags announce, the PES extension's flags, the fields
        they announce, then PES_extension_flag_2, the field length and
        the id (ISO/IEC 13818-1 2.4.3.7); None where there is none."""
        flags = data[7]
        if not flags & 0x01:
            return None
        i = 9 + (5 if flags & 0x80 else 0) + (5 if flags & 0x40 else 0) \
            + (6 if flags & 0x20 else 0) + (3 if flags & 0x10 else 0) \
            + (1 if flags & 0x08 else 0) + (1 if flags & 0x04 else 0) \
            + (2 if flags & 0x02 else 0)
        end = 9 + data[8]
        if i >= end:
            return None
        ext = data[i]
        i += 1 + (16 if ext & 0x80 else 0)
        if ext & 0x40 and i < end:
            i += 1 + data[i]
        i += (2 if ext & 0x20 else 0) + (2 if ext & 0x10 else 0)
        if not ext & 0x01 or i + 2 > end or not data[i] & 0x7F \
                or data[i + 1] & 0x80:
            return None
        return data[i + 1] & 0x7F

    # -- scan -----------------------------------------------------------------
    def _scan(self):
        from ..utils.logging import log
        pmts = set()
        es = {}
        skipped = set()
'''),
    (r"""                        es[spid] = (stype, lang)
            elif pid in es and pusi:
""",
     r"""                        es[spid] = (stype, lang)
                    elif stype not in _STREAM_TYPES \
                            and (spid, stype) not in skipped:
                        skipped.add((spid, stype))
                        log(f"ts: PMT entry of stream type {stype:#04x} on "
                            f"PID {spid:#06x} skipped: no track of that "
                            f"type is read")
            elif pid in es and pusi:
"""),
    (r"""        # build TrackInfo, video first
        ordered = sorted(es.items(),
                         key=lambda kv: 0 if _STREAM_TYPES[kv[1][0]][0]
                         == "video" else 1)
        for pid, (stype, lang) in ordered:
            kind, codec = _STREAM_TYPES[stype]
            ti = TrackInfo(kind=kind, codec=codec, language=lang)
            self._pid_to_track[pid] = len(self.tracks)
            self.tracks.append(ti)
""",
     r"""        # build TrackInfo: video first, then audio, then subtitles, each
        # in PMT order; a TrueHD PID's tracks are keyed (PID, extension)
        ordered = sorted(es.items(), key=lambda kv: _KIND_ORDER[
            _STREAM_TYPES[kv[1][0]][0]])
        self._ext_pids = set()
        self._pgs = set()
        for pid, (stype, lang) in ordered:
            kind, codec = _STREAM_TYPES[stype]
            subs = _TRUEHD_SUBSTREAMS if stype == 0x83 else ((None, codec),)
            for ext, codec in subs:
                if ext is not None:
                    self._ext_pids.add(pid)
                if codec == "pgs":
                    self._pgs.add(len(self.tracks))
                ti = TrackInfo(kind=kind, codec=codec, language=lang)
                self._pid_to_track[pid if ext is None else (pid, ext)] = \
                    len(self.tracks)
                self.tracks.append(ti)
"""),
    (r"""        for trk, b in self._packets_nodur(start_state):
            prev = held.get(trk)
""",
     r"""        for trk, b in self._packets_nodur(start_state):
            if trk in self._pgs:
                yield trk, b       # a display set lasts until the next
                continue
            prev = held.get(trk)
"""),
    (r"""        bufs = {pid: bytearray() for pid in self._pid_to_track}
        meta = {pid: (None, None) for pid in self._pid_to_track}
        pending = {}               # pid → partial PES header bytes

        def flush(pid):
            data = bytes(bufs[pid])
            bufs[pid] = bytearray()
            if not data:
                return None
            pts, dts = meta[pid]
            b = Buffer(pts=pts, dts=dts)
            b.data = data
            trk = self._pid_to_track[pid]
            b.track_kind = self.tracks[trk].kind
            b.stream_id = trk
            return trk, b

        for pkt in self._packets_raw(start_state or 0):
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            if pid not in self._pid_to_track:
""",
     r'''        from ..utils.logging import log
        bufs = {key: bytearray() for key in self._pid_to_track}
        meta = {key: (None, None) for key in self._pid_to_track}
        pids = {k[0] if isinstance(k, tuple) else k for k in bufs}
        cur = {pid: pid for pid in pids if pid not in self._ext_pids}
        pending = {}               # pid → partial PES header bytes
        sets = {trk: _DisplaySets() for trk in self._pgs}

        def buffers(trk, got):
            out = []
            for data, pts, dts in got:
                b = Buffer(pts=pts, dts=dts)
                b.data = data
                b.track_kind = self.tracks[trk].kind
                b.stream_id = trk
                out.append((trk, b))
            return out

        def flush(key):
            if key not in bufs:
                return []
            data = bytes(bufs[key])
            bufs[key] = bytearray()
            if not data:
                return []
            return buffers(self._pid_to_track[key], [(data, *meta[key])])

        def start(pid, hdr, payload):
            """A PES header of ``pid`` read: the key its payload now
            feeds (a TrueHD PID's by its extension) takes its
            timestamps; returns the payload."""
            pts, dts, poff, ext = hdr
            key = (pid, 0x76 if ext == 0x76 else 0x72) \
                if pid in self._ext_pids else pid
            cur[pid] = key
            meta[key] = (pts, dts)
            return payload[poff:]

        for pkt in self._packets_raw(start_state or 0):
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            if pid not in pids:
'''),
    (r"""                out = flush(pid)
                if out:
                    yield out
""",
     r"""                yield from flush(cur.get(pid))
"""),
    (r"""                    pts, dts, poff = hdr
                    meta[pid] = (pts, dts)
                    payload = payload[poff:]
""",
     r"""                    payload = start(pid, hdr, payload)
"""),
    (r"""                    pts, dts, poff = hdr
                    meta[pid] = (pts, dts)
                    payload = buffered[poff:]
                else:
                    payload = buffered
            bufs[pid] += payload
        for pid in list(bufs):
            out = flush(pid)
            if out:
                yield out
""",
     r"""                    payload = start(pid, hdr, buffered)
                else:
                    payload = buffered
            key = cur.get(pid)
            if self._pid_to_track.get(key) in sets:
                # a PGS display set goes out once its END segment is in,
                # not at the next PES
                trk = self._pid_to_track[key]
                yield from buffers(trk, sets[trk].feed(payload, *meta[key]))
            elif key in bufs:
                bufs[key] += payload
        for key in list(bufs):
            yield from flush(key)
        for trk, ds in sets.items():
            if ds.buf:
                log(f"ts: track {trk}: {len(ds.buf)} bytes of PGS segments "
                    f"after its last display set dropped")
"""),
)


# compressed sound in AVI (WAVEFORMATEX tags 0x50, 0x55, 0x2000, 0x2001)
# listed as mp2, mp3, ac3 and dts, an unknown tag logged, and their chunks
# timed as libavformat's avidec times them (the reference lists every
# such track as unknown, its chunks with no pts)
_AVI_SOUND = (
    ('''from ..core.buffer import Buffer
from .common import CLOCK, DemuxError, TrackInfo
''', '''from ..core.buffer import Buffer
from ..utils.logging import log
from .common import CLOCK, DemuxError, TrackInfo
'''),
    ('''

def probe_is_avi(path: str) -> bool:''', '''

# The port also lists MPEG audio (WAVEFORMATEX tag 0x50, "mp2"; 0x55,
# "mp3"), AC-3 (0x2000) and DTS (0x2001) tracks, which the reference lists
# as "unknown"; any other tag but PCM stays "unknown" and is logged.  Such
# a track's chunks carry timestamps as libavformat's avidec gives them:
# where the stream header's dwSampleSize is 0 a chunk is one frame, at
# dwScale/dwRate seconds a chunk; else the bytes before a chunk at the
# format's nAvgBytesPerSec.  The job cuts the chunks into whole frames.
_AUD_CODECS = {0x50: "mp2", 0x55: "mp3", 0x2000: "ac3", 0x2001: "dts"}


def probe_is_avi(path: str) -> bool:'''),
    ('''        self._rates = {}           # avi stream index → Fraction fps
''', '''        self._rates = {}           # avi stream index → Fraction fps
        # avi stream index → (dwScale, dwRate, dwSampleSize) of a sound
        # stream, then its nAvgBytesPerSec where it is framed
        self._clock = {}
'''),
    ('''                    self._rates[sidx] = Fraction(rate, max(1, scale))
                    self.tracks.append(ti)
''', '''                    self._rates[sidx] = Fraction(rate, max(1, scale))
                    self._clock[sidx] = (scale, rate, struct.unpack(
                        "<I", data[44:48])[0] if len(data) >= 48 else 0)
                    self.tracks.append(ti)
'''),
    ('''                        if fmt == 1 else "unknown"
''', '''                        if fmt == 1 else _AUD_CODECS.get(fmt, "unknown")
                    sidx = self._next_sidx - 1
                    if t.codec in _AUD_CODECS.values():
                        self._clock[sidx] += struct.unpack(
                            "<I", data[8:12])
                    elif t.codec == "unknown":
                        log(f"avi: stream {sidx}: sound of WAVEFORMATEX tag "
                            f"{fmt:#06x}, which the port neither decodes "
                            f"nor copies; listed as unknown")
'''),
    ('''        counts = {}
        pos = off''', '''        counts = {}
        sizes = {}                 # bytes of each stream's chunks so far
        pos = off'''),
    ('''            else:
                rate = self._rates.get(sidx) or 1
                b.pts = None
''', '''            else:
                b.pts = self._sound_pts(sidx, n, sizes.get(sidx, 0))
                sizes[sidx] = sizes.get(sidx, 0) + csz
'''),
    ('''    def seek(self, pts):
        return None
''', '''    def _sound_pts(self, sidx: int, n: int, before: int):
        \"\"\"The 90 kHz pts of chunk ``n`` of framed sound stream ``sidx``,
        after ``before`` bytes of it (None for PCM, as the reference).\"\"\"
        clock = self._clock.get(sidx, ())
        if len(clock) < 4:
            return None
        scale, rate, sample_size, avg = clock
        if not sample_size and rate:
            return n * CLOCK * scale // rate
        return before * CLOCK // avg if avg else None

    def seek(self, pts):
        return None
'''),
)

COPIES = {
    "sources/ps.py": _PS_ASPECT + _PS_DTS + _PS_RATE,
    "sources/dvd.py": _DVD_VIDEO_ATTRS + _DVD_AUDIO_ATTRS,
    "sources/ts.py": (_TS_HEVC_GEOMETRY + _TS_ASPECT + _TS_BD_STREAMS
                      + _TS_RATE),
    "sources/bd.py": (),
    "sources/avi.py": _AVI_MPEG4 + _AVI_SOUND,   # MPEG-4 part 2, sound
    "native/hbdecmjpeg.cpp": (),
    "codecs/mpeg2.py": _MPEG2_FIELD_DCT + _MPEG2_ASPECT,
}


@pytest.mark.parametrize("rel", list(COPIES))
def test_copy_equals_original(rel):
    port = os.path.join(os.path.dirname(handbrake_tpu_torch.__file__), rel)
    ref = os.path.join(os.path.dirname(handbrake_tpu.__file__), rel)
    if not COPIES[rel]:
        assert filecmp.cmp(port, ref, shallow=False)
        return
    with open(port) as f:
        got = f.read()
    with open(ref) as f:
        want = f.read()
    for old, new in COPIES[rel]:
        assert want.count(old) == 1 and got.count(new) == 1
        want = want.replace(old, new)
    assert got == want


def test_packed_bitstream_avi_refused(tmp_path):
    """DivX's packed bitstream: a P-VOP and the B-VOP after it in one
    chunk, which has one timestamp for two VOPs; the demuxer refuses it
    by name rather than give the frames wrong display times."""
    from handbrake_tpu_torch.sources.common import DemuxError
    from handbrake_tpu_torch.tools.make_source_fixtures import write_avi
    src = os.path.join(os.path.dirname(__file__), "data", "torch_sources",
                       "mpeg4_bframes_176x144.avi")
    d = AVIDemuxer(src)
    try:
        chunks = [b.data for _t, b in d._chunks()]
    finally:
        d.close()
    vop = b"\x00\x00\x01\xb6"
    kinds = [c[c.find(vop) + 4] >> 6 for c in chunks]
    assert kinds[:3] == [0, 1, 2]            # I, P, B in decode order
    path = str(tmp_path / "packed.avi")
    write_avi(path, 176, 144, 30, [chunks[0], chunks[1] + chunks[2]]
              + chunks[3:])
    d = AVIDemuxer(path)
    try:
        assert d.tracks[0].codec == "mpeg4"
        with pytest.raises(DemuxError, match="packed bitstream"):
            list(d.packets())
    finally:
        d.close()
