"""Pixel aspect and frame rate as the port reads and writes them, on the
CPU: the MPEG-2 sequence header's aspect_ratio_information, the
sequence and display extensions and frame_rate_code (``codecs/mpeg2.py``,
ISO/IEC 13818-2 §6.3.3, Tables 6-3 and 6-4); the H.264/HEVC VUI
(``codecs/vui.py``); the DVD IFO's video attributes (``sources/dvd.py``);
the anamorphic geometry (``job/geometry.py``) with the preset's
``PicturePAR`` (``job/presets.py``) and the CLI's flags; the mp4 ``pasp``
and the Matroska display size (``mux/``).  Where the JAX package computes
the same thing it is held beside the port: its geometry modes 0-3 must
agree, and its MPEG-2 readers still give 1:1 and the bare frame_rate_code
(ROADMAP §3.4).  Tolerance: none, every value is exact."""
import os
import struct
from fractions import Fraction

import pytest

from handbrake_tpu.codecs.mpeg2 import Mpeg2Decoder as JMpeg2Decoder
from handbrake_tpu.job import geometry as jgeo
from handbrake_tpu.mux.mkv import MKVWriter as JMKVWriter
from handbrake_tpu.mux.mp4 import MP4Writer as JMP4Writer
from handbrake_tpu_torch.cli.__main__ import apply_cli_overrides, build_parser
from handbrake_tpu_torch.codecs import vui
from handbrake_tpu_torch.codecs.h264.bits import BitReader
from handbrake_tpu_torch.codecs.h264.syntax import SPS
from handbrake_tpu_torch.codecs.hevc import syntax as hsyntax
from handbrake_tpu_torch.codecs.mpeg2 import Mpeg2Decoder, sequence_info
from handbrake_tpu_torch.codecs.registry import create_video_decoder
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.job import geometry as tgeo
from handbrake_tpu_torch.job import presets
from handbrake_tpu_torch.job.schema import Job
from handbrake_tpu_torch.job.title import Title
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.sources import dvd
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.sources.ps import PSDemuxer
from handbrake_tpu_torch.tools import source_builders as B
from handbrake_tpu_torch.utils import logging as hblog

# Table 6-4, and Table 6-3's display aspects
RATES = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001),
         5: (30, 1), 6: (50, 1), 7: (60000, 1001), 8: (60, 1)}
DARS = {2: (4, 3), 3: (16, 9), 4: (221, 100)}
# the DVD's own pixel aspects (what every DVD tool gives)
DVD_PARS = {(720, 480, 2): (8, 9), (720, 480, 3): (32, 27),
            (720, 576, 2): (16, 15), (720, 576, 3): (64, 45)}


def pack(fields) -> bytes:
    """(value, bits) fields, big-endian, zero-padded to a byte."""
    v = n = 0
    for value, bits in fields:
        v = (v << bits) | value
        n += bits
    pad = -n % 8
    return (v << pad).to_bytes((n + pad) // 8, "big")


def seq_header(w, h, aspect, rate):
    return b"\x00\x00\x01\xb3" + pack([
        (w, 12), (h, 12), (aspect, 4), (rate, 4), (0x3FFFF, 18), (1, 1),
        (112, 10), (0, 1), (0, 1), (0, 1)])


def seq_ext(n=0, d=0):
    return b"\x00\x00\x01\xb5" + pack([
        (1, 4), (0x48, 8), (1, 1), (1, 2), (0, 2), (0, 2), (0, 12), (1, 1),
        (0, 8), (0, 1), (n, 2), (d, 5)])


def display_ext(dw, dh, colour=False):
    return b"\x00\x00\x01\xb5" + pack(
        [(2, 4), (1, 3), (int(colour), 1)]
        + ([(1, 8), (1, 8), (1, 8)] if colour else [])
        + [(dw, 14), (1, 1), (dh, 14)])


# an I picture's header: temporal_reference 0, picture_coding_type 1
PICTURE = b"\x00\x00\x01\x00" + pack([(0, 10), (1, 3), (0xFFFF, 16)])


# ---------------------------------------------------------------------------
# MPEG-2: aspect_ratio_information, display extension, frame_rate_code
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("display", [None, "704", "704-colour"])
@pytest.mark.parametrize("aspect", [1, 2, 3, 4])
@pytest.mark.parametrize("size", [(176, 144), (720, 480), (720, 576)])
def test_mpeg2_aspect_codes(size, aspect, display):
    w, h = size
    es = seq_header(w, h, aspect, 3) + seq_ext()
    dw, dh = w, h
    if display:
        dw = 704
        es += display_ext(dw, dh, colour=display.endswith("colour"))
    info = sequence_info(es + PICTURE)
    if aspect == 1:
        want = (1, 1)
    else:
        n, d = DARS[aspect]
        f = Fraction(n * dh, d * dw)
        want = (f.numerator, f.denominator)
    if (w, h, aspect) in DVD_PARS and not display:
        assert want == DVD_PARS[(w, h, aspect)]
    assert info == {"width": w, "height": h, "sar": want,
                    "frame_rate": (25, 1)}
    dec = Mpeg2Decoder()
    dec._parse_headers(es)
    assert dec.sar == want
    # the reference reads the size and skips the aspect
    jdec = JMpeg2Decoder()
    jdec._parse_headers(es)
    assert (jdec.w, jdec.h, jdec.frame_rate) == (w, h, (25, 1))


@pytest.mark.parametrize("ext", [(0, 0), (1, 0), (0, 1), (3, 1)])
@pytest.mark.parametrize("code", list(RATES))
def test_mpeg2_frame_rate_codes(code, ext):
    """frame_rate = frame_rate_value x (n + 1) / (d + 1) (6.3.3); the
    reference takes the code alone."""
    n, d = ext
    es = seq_header(720, 576, 3, code) + seq_ext(n, d) + PICTURE
    num, den = RATES[code]
    f = Fraction(num * (n + 1), den * (d + 1))
    assert sequence_info(es)["frame_rate"] == (f.numerator, f.denominator)
    jdec = JMpeg2Decoder()
    jdec._parse_headers(es)
    assert jdec.frame_rate == RATES[code]


def test_mpeg2_decoder_durations_follow_the_rate_extension():
    """The 176x144 fixture (code 4) with frame_rate_extension_n = 1:
    60000/1001 fps, each frame's duration 90000 x 1001 / 60000 rounded."""
    es = bytearray(B.fixture("mpeg2_176x144.m2v"))
    i = es.find(b"\x00\x00\x01\xb5")
    assert es[i + 4] >> 4 == 1                  # the sequence extension
    es[i + 9] |= 1 << 5                          # its n's low bit
    dec = create_video_decoder("mpeg2")
    frames = dec.feed(Buffer(data=bytes(es), pts=0)) + dec.flush()
    assert dec.info()["vui_timing"] == (1001, 120000)
    assert {f.duration for f in frames} == {int(round(90000 * 1001
                                                      / 60000))}
    assert dec.info()["sar"] == (1, 1)


@pytest.mark.parametrize("code", [1, 3, 12])
def test_mpeg1_header_gives_no_aspect(code):
    """No sequence extension: an MPEG-1 header, whose code is a pel
    aspect (ISO/IEC 11172-2), not Table 6-3's: no aspect is taken."""
    info = sequence_info(seq_header(352, 288, code, 3) + PICTURE)
    assert info["sar"] is None and info["frame_rate"] == (25, 1)


def logged(fn):
    lines = []
    hblog.register_logger(lines.append)
    try:
        fn()
    finally:
        hblog.register_logger(None)
    return lines


@pytest.mark.parametrize("code", [0, 5, 15])
def test_reserved_aspect_keeps_the_track_square(tmp_path, code):
    """A reserved or forbidden code: the track keeps 1:1, and says so."""
    es = seq_header(720, 576, code, 3) + seq_ext() + PICTURE
    p = str(tmp_path / "r.vob")
    with open(p, "wb") as f:
        f.write(B.build_ps(B.video_units(es + es, 90000, 3600)))
    out = {}

    def scan():
        d = PSDemuxer(p)
        out["t"] = d.tracks[0]
        d.close()

    lines = logged(scan)
    t = out["t"]
    assert (t.width, t.height, t.par_num, t.par_den, t.frame_rate) == \
        (720, 576, 1, 1, (25, 1))
    assert any("gives no pixel aspect" in ln for ln in lines)


# ---------------------------------------------------------------------------
# the DVD's video attributes against the sequence header
# ---------------------------------------------------------------------------
def pal_es(pictures=4, rate=None):
    es = bytearray(b"".join(B.split_pictures(
        B.fixture("mpeg2_720x576_16x9.m2v"))[:pictures]))
    if rate is not None:
        i = es.find(b"\x00\x00\x01\xb3")
        es[i + 7] = (es[i + 7] & 0xF0) | rate
    return bytes(es)


def dvd_title(tmp_path, es, attr, fps=25):
    root = str(tmp_path / "dvd")
    units = B.video_units(es, 90000, 3600)
    B.write_dvd(root, B.build_ps(units), 1, [len(units) / 25], attr, fps)
    out = {}

    def scan():
        d, t = dvd.open_dvd_title(root)
        out["track"], out["title"] = d.tracks[0], t
        d.close()

    lines = [ln for ln in logged(scan) if "dvd:" in ln]
    return out["track"], out["title"], lines


def test_ifo_and_header_agree(tmp_path):
    ti, t, lines = dvd_title(tmp_path, pal_es(),
                             B.vts_video_attr("PAL", (16, 9)))
    assert t.video == dvd.VideoAttributes("PAL", (16, 9), (720, 576))
    assert (ti.par_num, ti.par_den, ti.frame_rate) == (64, 45, (25, 1))
    assert lines == []


def test_ifo_display_aspect_overrules_the_header(tmp_path):
    """The IFO says 4:3 over a header that says 16:9: the IFO's 16:15
    is taken, and the log says so."""
    ti, t, lines = dvd_title(tmp_path, pal_es(),
                             B.vts_video_attr("PAL", (4, 3)))
    assert (ti.par_num, ti.par_den) == (16, 15)
    assert len(lines) == 1 and "disagrees" in lines[0] \
        and "64:45" in lines[0] and "16:15" in lines[0]


def test_ifo_that_does_not_describe_the_stream(tmp_path):
    """The IFO describes 720x480 (NTSC); the stream is 176x144 with a
    16:9 header: its own aspect 16:11 is kept, and the log says why."""
    es = bytearray(B.fixture("mpeg2_176x144.m2v"))
    i = es.find(b"\x00\x00\x01\xb3")
    es[i + 7] = (3 << 4) | (es[i + 7] & 15)
    ti, _t, lines = dvd_title(tmp_path, bytes(es),
                              B.vts_video_attr("NTSC", (16, 9)), fps=30)
    assert (ti.par_num, ti.par_den) == (16, 11)
    assert len(lines) == 1 and "do not describe" in lines[0]


def test_header_rate_kept_where_the_ifo_standard_differs(tmp_path):
    """A 720x576 16:9 PAL IFO over a header at 30000/1001: the header's
    rate is kept (the decoder's durations follow it), with a log line."""
    ti, _t, lines = dvd_title(tmp_path, pal_es(rate=4),
                              B.vts_video_attr("PAL", (16, 9)))
    assert ti.frame_rate == (30000, 1001)
    assert (ti.par_num, ti.par_den) == (64, 45)
    assert len(lines) == 1 and "not PAL's" in lines[0]


def test_no_header_takes_the_ifo(tmp_path):
    """A track whose sequence header was not read (0x0, 1:1, no rate):
    the IFO gives the rate and the aspect of the size it names."""
    from handbrake_tpu_torch.sources.common import TrackInfo
    _ti, t, _lines = dvd_title(tmp_path, pal_es(),
                               B.vts_video_attr("PAL", (16, 9)))
    ti = TrackInfo(kind="video", codec="mpeg2")
    lines = [ln for ln in logged(lambda: dvd.apply_video_attributes(ti, t))
             if "dvd:" in ln]
    assert (ti.width, ti.par_num, ti.par_den, ti.frame_rate) == \
        (0, 64, 45, (25, 1))
    assert len(lines) == 1 and "no sequence header" in lines[0]


# ---------------------------------------------------------------------------
# the VUI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sar", [(64, 45), (32, 27), (4, 3), (65535, 1)])
@pytest.mark.parametrize("profile,poc", [(66, 2), (77, 0), (100, 2)])
def test_h264_vui_sar_round_trip(profile, poc, sar):
    sps = SPS(profile_idc=profile, width_mbs=45, height_mbs=36,
              crop_bottom=0, pic_order_cnt_type=poc,
              vui_timing=(1, 50), sar=sar)
    got = vui.h264_sps_vui(sps.write())
    assert got == {"sar": Fraction(*sar).as_integer_ratio(),
                   "timing": (1, 50)}
    assert vui.h264_sps_vui(SPS(profile_idc=profile, width_mbs=4,
                                height_mbs=3,
                                vui_timing=(1, 50)).write())["sar"] is None


def test_vui_table_aspects():
    """aspect_ratio_idc 1-16 (Table E-1) and a reserved one."""
    for idc in list(range(1, 17)) + [17, 254, 0]:
        bits = pack([(1, 1), (1, 1), (idc, 8), (0, 3), (1, 1), (1, 32),
                     (60, 32)])
        got = vui._vui(BitReader(bits), hevc=False)
        assert got["sar"] == vui.SAR_TABLE.get(idc)
        assert got["timing"] == (1, 60)


@pytest.mark.parametrize("sar", [(1, 1), (32, 27), (64, 45)])
def test_hevc_vui_sar_round_trip(sar):
    """The port's HEVC SPS writes Extended_SAR unless 1:1; its own parser
    and the general VUI reader read it back."""
    sps = hsyntax.SPS(width=736, height=480, crop_right=16,
                      vui_timing=(1001, 30000), sar=sar)
    nal = sps.to_nal()
    got = vui.stream_vui("hevc", nal)
    assert got == {"sar": None if sar == (1, 1) else sar,
                   "timing": (1001, 30000)}
    from handbrake_tpu_torch.codecs.h264.bits import (ebsp_to_rbsp,
                                                      split_annexb)
    back = hsyntax.SPS.parse(ebsp_to_rbsp(list(split_annexb(nal))[0][2:]))
    assert (back.sar, back.vui_timing) == (sar, (1001, 30000))


def test_x265_sps_reads_up_to_its_vui():
    """libx265's SPS (sub-layer info, reference picture sets, SAO) through
    the general reader: no aspect, 30 fps timing."""
    d = MKVDemuxer(os.path.join(B.FIXTURES, "x265_176x144.mkv"))
    t = d.tracks[0]
    d.close()
    assert vui.stream_vui("hevc", t.extradata) == {"sar": None,
                                                   "timing": (1, 30)}
    assert (t.par_num, t.par_den) == (1, 1)


@pytest.mark.parametrize("par,ok", [((130, 2), (65, 1)),
                                    ((65536, 2), (32768, 1)),
                                    ((65537, 1), None), ((131072, 2), None),
                                    ((0, 1), None)])
def test_sar16(par, ok):
    if ok:
        assert vui.sar16(*par) == ok
    else:
        with pytest.raises(ValueError, match="16-bit|positive"):
            vui.sar16(*par)


# ---------------------------------------------------------------------------
# geometry and presets
# ---------------------------------------------------------------------------
ANAMORPHIC = [(720, 480, Fraction(32, 27)), (720, 576, Fraction(64, 45)),
              (704, 480, Fraction(10, 11)), (720, 480, Fraction(8, 9)),
              (1440, 1080, Fraction(4, 3))]
REQUESTS = [dict(), dict(width=640), dict(max_width=960),
            dict(width=1024, height=576, keep_display_aspect=False),
            dict(max_width=640, max_height=360, modulus=16),
            dict(par_num=1, par_den=1)]
CROPS = [(0, 0, 0, 0), (72, 72, 0, 0), (2, 4, 8, 6)]


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("src", range(len(ANAMORPHIC)))
def test_modes_0_3_equal_reference_on_anamorphic_sources(mode, src):
    w, h, par = ANAMORPHIC[src]
    for req in REQUESTS:
        for crop in CROPS:
            want = jgeo.set_anamorphic_size2(
                w, h, par, jgeo.GeometrySettings(mode=mode, crop=crop,
                                                 **req))
            got = tgeo.set_anamorphic_size2(
                w, h, par, tgeo.GeometrySettings(mode=mode, crop=crop,
                                                 **req))
            assert got == want, (mode, src, req, crop)


def title(w, h, par=(1, 1), crop=(0, 0, 0, 0)):
    return Title(index=1, path="/media/src.mkv", width=w, height=h,
                 par_num=par[0], par_den=par[1], crop=crop,
                 vrate_num=25, vrate_den=1)


PRESETS = [p["PresetName"] for p in presets.flatten(presets.get_builtin())]


@pytest.mark.parametrize("name", PRESETS)
def test_auto_mode_on_square_pixels_is_the_preset_path(name):
    """On a square-pixel title every built-in preset's job is left
    unset (as the reference's), and the automatic mode gives that job's
    crop/scale at 1:1: job (a)'s 3840x2160 letterbox becomes 1920x804."""
    preset = presets.preset_search(name)
    for w, h, crop in ((3840, 2160, (276, 276, 0, 0)),
                       (1920, 1080, (0, 0, 0, 0)), (1916, 1076, (2, 2, 4, 4)),
                       (720, 480, (8, 8, 0, 0)), (64, 48, (0, 0, 0, 0))):
        job = presets.preset_to_job(title(w, h, crop=crop), preset)
        assert job.anamorphic_mode is None
        st = next(f.settings for f in job.filters
                  if f.id == presets.S.FILTER_CROP_SCALE)
        got = tgeo.set_anamorphic_size2(
            w, h, Fraction(1), tgeo.GeometrySettings(
                mode=tgeo.ANAMORPHIC_AUTO, width=st["width"],
                height=st["height"], crop=tuple(crop)))
        assert got == (st["width"], st["height"], Fraction(1),
                       st["width"])
        if (w, h) == (3840, 2160) and "1080p" in name \
                and "Fast" in name:
            assert (st["width"], st["height"]) == (1920, 804)


def test_auto_mode_keeps_the_display_aspect():
    auto = tgeo.ANAMORPHIC_AUTO
    # unscaled: the source's aspect
    assert tgeo.set_anamorphic_size2(
        720, 576, Fraction(64, 45), tgeo.GeometrySettings(
            mode=auto, width=720, height=576)) == (720, 576,
                                                   Fraction(64, 45), 1024)
    # scaled down: the cropped display aspect, exactly
    for req in (dict(max_width=640), dict(width=704, height=576),
                dict(max_height=360, modulus=16)):
        w, h, par, _ = tgeo.set_anamorphic_size2(
            720, 576, Fraction(64, 45), tgeo.GeometrySettings(
                mode=auto, crop=(0, 0, 8, 8), **req))
        assert par * w / h == Fraction(704, 576) * Fraction(64, 45)
    # a ratio too long for 16 bits comes back within them
    w, h, par, _ = tgeo.set_anamorphic_size2(
        719, 577, Fraction(64, 45), tgeo.GeometrySettings(
            mode=auto, width=710, height=572))
    exact = Fraction(719, 577) * Fraction(64, 45) * Fraction(572, 710)
    assert exact.denominator > 0xFFFF or exact.numerator > 0xFFFF
    assert par.numerator <= 0xFFFF and par.denominator <= 0xFFFF
    assert abs(par - exact) < Fraction(1, 10 ** 8)


@pytest.mark.parametrize("picture_par,mode", [
    ("off", 0), ("strict", 1), ("loose", 2), ("custom", 3), ("auto", 4)])
def test_picture_par_maps_to_the_mode(picture_par, mode):
    preset = dict(presets.preset_search("Fast 1080p30"),
                  PicturePAR=picture_par, PicturePARWidth=40,
                  PicturePARHeight=33)
    job = presets.preset_to_job(title(720, 576, (64, 45)), preset)
    assert job.anamorphic_mode == mode
    assert (job.par_num, job.par_den) == \
        ((40, 33) if picture_par == "custom" else (1, 1))
    if picture_par != "auto":
        # the mode holds on square pixels too
        job = presets.preset_to_job(title(720, 576), preset)
        assert job.anamorphic_mode == mode
    with pytest.raises(ValueError, match="PicturePAR 'wide'"):
        presets.preset_to_job(title(720, 576),
                              dict(preset, PicturePAR="wide"))


@pytest.mark.parametrize("flag,mode", [
    ("--non-anamorphic", 0), ("--strict-anamorphic", 1),
    ("--loose-anamorphic", 2), ("--custom-anamorphic", 3),
    ("--auto-anamorphic", 4)])
def test_cli_anamorphic_flags(flag, mode):
    """``--auto-anamorphic`` is the automatic mode; the reference takes
    it as strict."""
    args = build_parser().parse_args(["-i", "a", "-o", "b.mp4", flag])
    job = apply_cli_overrides(Job(), args)
    assert job.anamorphic_mode == mode
    from handbrake_tpu.cli.__main__ import build_parser as jparser
    jargs = jparser().parse_args(["-i", "a", "-o", "b.mp4", flag])
    assert jargs.anamorphic == (1 if mode == 4 else mode)


# ---------------------------------------------------------------------------
# the containers
# ---------------------------------------------------------------------------
AU = b"\x00\x00\x00\x01\x65" + bytes(range(40))


def _write_mp4(W, path, par):
    w = W(path)
    kw = {} if par is None else {"par": par}
    t = w.add_video_track(codec="h264", width=720, height=576,
                          extradata=b"\x01\x64\x00\x28\xff\xe0\x00", **kw)
    for i in range(3):
        w.write_sample(t, AU, 3600, sync=i == 0)
    w.finalize()
    with open(path, "rb") as f:
        return f.read()


def test_mp4_pasp(tmp_path):
    """A pasp box in the sample entry where the PAR is not 1:1, read back
    by the demuxer; at 1:1 the file equals the reference writer's."""
    ref = _write_mp4(JMP4Writer, str(tmp_path / "ref.mp4"), None)
    assert _write_mp4(MP4Writer, str(tmp_path / "sq.mp4"), (1, 1)) == ref
    got = _write_mp4(MP4Writer, str(tmp_path / "par.mp4"), (64, 45))
    pasp = struct.pack(">I", 16) + b"pasp" + struct.pack(">II", 64, 45)
    assert got.count(pasp) == 1 and b"pasp" not in ref
    assert len(got) == len(ref) + 16
    d = MP4Demuxer(str(tmp_path / "par.mp4"))
    assert (d.tracks[0].par_num, d.tracks[0].par_den) == (64, 45)
    d.close()


def _write_mkv(W, path, par, codec="vp9"):
    w = W(path)
    kw = {} if par is None else {"par": par}
    t = w.add_video_track(codec=codec, width=720, height=480, fps=25.0,
                          **kw)
    for i in range(3):
        w.write_sample(t, bytes(range(50)), i * 3600, 3600, sync=i == 0)
    w.finalize()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("par,display,read", [
    ((32, 27), (853, 480), (853, 720)), ((8, 9), (640, 480), (8, 9)),
    ((2, 1), (1440, 480), (2, 1))])
def test_mkv_display_size(tmp_path, par, display, read):
    """DisplayWidth = width x PAR rounded half up, DisplayHeight =
    height; a track without a VUI reads the display size back (rounded);
    at 1:1 the file equals the reference writer's."""
    ref = _write_mkv(JMKVWriter, str(tmp_path / "ref.mkv"), None)
    assert _write_mkv(MKVWriter, str(tmp_path / "sq.mkv"), (1, 1)) == ref
    got = _write_mkv(MKVWriter, str(tmp_path / "par.mkv"), par)
    elems = bytes.fromhex("54b0") + bytes([0x80 | 2]) \
        + display[0].to_bytes(2, "big") + bytes.fromhex("54ba") \
        + bytes([0x80 | 2]) + display[1].to_bytes(2, "big")
    assert elems in got
    d = MKVDemuxer(str(tmp_path / "par.mkv"))
    assert (d.tracks[0].par_num, d.tracks[0].par_den) == read
    d.close()
    assert vui.display_size(720, 480, *par) == display
