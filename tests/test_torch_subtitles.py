"""Subtitles in the port, module by module, held against the JAX package
on the CPU:

- the host copies (``subtitles/``): the SRT, SSA, WebVTT parsers and the
  format sniffer, the PGS and VobSub decoders with their packet builders,
  and the CEA-608 decoder with its GA94 extractors give the reference's
  events on the reference tests' inputs;
- the rasterizer: OpenCV's and the bitmap font's RGBA and placement equal
  the reference's (OpenCV blocked through ``sys.modules`` for the bitmap
  path), and only a missing OpenCV selects the bitmap font;
- ``filters/rendersub.py`` ``blend_rgba`` against the JAX function, byte
  for byte: 64x48 and 66x50 frames, 8 and 10 bits, 4:2:0, 4:2:2 and
  4:4:4, even and odd offsets, alpha 0, 255 and random, patches from one
  pixel (the dot's fused tail) to the whole frame;
- ``RenderSubFilter`` against the reference's: queued events, the clear
  marker's retirement, the clamping at the frame's edges, the error for a
  patch larger than the frame, and the graph's routing.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu.core.buffer import Geometry as JGeometry
from handbrake_tpu.core.buffer import PIX_FMTS as JPIX
from handbrake_tpu.filters import base as jbase
from handbrake_tpu.filters import graph as jgraph
from handbrake_tpu.filters import rendersub as jr
from handbrake_tpu.subtitles import cea608 as jcc
from handbrake_tpu.subtitles import pgs as jpgs
from handbrake_tpu.subtitles import raster as jraster
from handbrake_tpu.subtitles import srt as jsrt
from handbrake_tpu.subtitles import vobsub as jvob
from handbrake_tpu_torch.core.buffer import Buffer, Geometry, PIX_FMTS
from handbrake_tpu_torch.filters import base as tbase
from handbrake_tpu_torch.filters import graph as tgraph
from handbrake_tpu_torch.filters import rendersub as tr
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.subtitles import cea608 as tcc
from handbrake_tpu_torch.subtitles import pgs as tpgs
from handbrake_tpu_torch.subtitles import raster as traster
from handbrake_tpu_torch.subtitles import srt as tsrt
from handbrake_tpu_torch.subtitles import vobsub as tvob

# -- the parsers (inputs of tests/test_subtitles.py) -------------------------
SRT = b"""1
00:00:01,000 --> 00:00:02,500
Hello <i>world</i>

2
00:00:03.000 --> 00:00:04.000
Line one
Line two

garbage-not-an-index
00:00:05,000 --> 00:00:04,000
negative duration dropped

3
00:00:06,000 --> 00:00:07,250
{\\an8}Styled away
"""
ASS = b"""[Script Info]
Title: t
ScriptType: v4.00+

[V4+ Styles]
Format: Name, Fontname
Style: Default,Arial

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:01.00,0:00:02.50,Default,,0,0,0,,Hello {\\i1}world{\\i0}
Dialogue: 0,0:00:03.20,0:00:04.00,Default,,0,0,0,,Line one\\NLine two, with comma
Comment: 0,0:00:05.00,0:00:06.00,Default,,0,0,0,,not shown
"""
VTT = b"""WEBVTT

NOTE this block
is skipped

cue-1
00:01.000 --> 00:02.500 position:50%
Hello <b>world</b>

00:00:03.200 --> 00:00:04.000
Line one
Line two
"""
U16 = b"\xff\xfe" + "1\n00:00:01,000 --> 00:00:02,000\nUni\xe9\n\n".encode(
    "utf-16-le")
LATIN1 = "1\n00:00:01,000 --> 00:00:02,000\nCaf\xe9\n\n".encode("latin-1")


def _events(evs):
    return [(e.pts, e.stop, e.text) for e in evs]


@pytest.mark.parametrize("call", [
    ("parse_srt", SRT, {}), ("parse_srt", b"\xef\xbb\xbf" + SRT,
                             {"offset_ms": 500}),
    ("parse_srt", U16, {}), ("parse_srt", LATIN1, {}),
    ("parse_ssa", ASS, {}), ("parse_vtt", VTT, {}),
    ("parse_textsub", ASS, {}), ("parse_textsub", VTT, {}),
    ("parse_textsub", SRT, {"fmt": "SRT"}),
    ("parse_textsub", ASS, {"fmt": "SSA", "offset_ms": -200})],
    ids=lambda c: c[0])
def test_parsers_equal_reference(call):
    name, data, kw = call
    want = _events(getattr(jsrt, name)(data, **kw))
    assert want and _events(getattr(tsrt, name)(data, **kw)) == want


# -- PGS and VobSub ----------------------------------------------------------
PGS_PALETTE = [(0, 128, 128, 0), (235, 128, 128, 255), (81, 90, 240, 255),
               (145, 54, 34, 200)]


def _bitmap(w=60, h=24):
    idx = np.zeros((h, w), np.uint8)
    idx[2:-2, 2:-2] = 1
    idx[6:10, 10:50] = 2
    idx[12, ::3] = 3
    return idx


def _pgs_events(mod, packets):
    dec = mod.PgsDecoder()
    out = []
    for pts, pkt in packets:
        for e in dec.feed(pkt, pts):
            out.append((e.pts, e.x, e.y, None if e.rgba is None
                        else e.rgba.tobytes()))
    return out


def test_pgs_copy_equals_reference():
    pal = np.zeros((256, 4), np.uint8)
    for i, v in enumerate(PGS_PALETTE):
        pal[i] = v
    rng = np.random.default_rng(0)
    wild = rng.integers(0, 4, (37, 129)).astype(np.uint8)
    wild[:, 90:] = 0
    for idx in (_bitmap(), wild):
        assert tpgs.rle_encode(idx) == jpgs.rle_encode(idx)
        assert np.array_equal(
            tpgs.rle_decode(jpgs.rle_encode(idx), *idx.shape[::-1]), idx)
    sets = [(90000, _bitmap(), 100, 200, {}),
            (180000, wild, 7, 9, {"screen": (320, 240)}),
            (270000, _bitmap(), 0, 0, {"clear": True})]
    packets = [(pts, jpgs.build_display_set(pts, idx, pal, x, y, **kw))
               for pts, idx, x, y, kw in sets]
    assert [tpgs.build_display_set(pts, idx, pal, x, y, **kw)
            for pts, idx, x, y, kw in sets] == [p for _t, p in packets]
    want = _pgs_events(jpgs, packets)
    assert len(want) == 5 and _pgs_events(tpgs, packets) == want


def _vob_events(mod, packets, palette):
    dec = mod.VobSubDecoder(palette)
    out = []
    for pts, pkt in packets:
        for e in dec.feed(pkt, pts):
            out.append((e.pts, e.x, e.y, None if e.rgba is None
                        else e.rgba.tobytes()))
    return out


def test_vobsub_copy_equals_reference():
    idx = np.zeros((20, 41), np.uint8)
    idx[2:-2, 3:-3] = 1
    idx[5:9, 5:30] = 2
    idx[11, ::2] = 3
    private = (b"size: 720x480\npalette: " + b", ".join(
        b"%06x" % c for c in (0x000000, 0xffffff, 0x808080, 0xff0000)
        + (0x101010,) * 12) + b"\n")
    assert tvob.parse_idx_palette(private) == \
        jvob.parse_idx_palette(private)
    assert tvob.parse_idx_palette(b"") == jvob.parse_idx_palette(b"")
    pal = jvob.parse_idx_palette(private)
    packets = [(9000, jvob.build_spu(idx, 10, 30, stop_delay=50)),
               (99000, jvob.build_spu(idx[:, :40], 3, 5,
                                      alpha=(0, 15, 8, 4)))]
    assert tvob.build_spu(idx, 10, 30, stop_delay=50) == packets[0][1]
    assert tvob.build_spu(idx[:, :40], 3, 5, alpha=(0, 15, 8, 4)) == \
        packets[1][1]
    want = _vob_events(jvob, packets, pal)
    assert len(want) >= 2 and _vob_events(tvob, packets, pal) == want


# -- CEA-608 -----------------------------------------------------------------
def _pairs_for(rows):
    pairs = [(0x14, 0x20), (0x14, 0x20), (0x14, 0x2E)]
    for r, row in enumerate(rows):
        pairs.append((0x14, 0x40 + r))
        data = row.encode("ascii")
        for i in range(0, len(data), 2):
            pairs.append((data[i], data[i + 1] if i + 1 < len(data) else 0))
    return pairs


def _cc_data(pairs):
    return bytes([0x40 | len(pairs), 0xFF]) + b"".join(
        bytes([0xFC, a, b]) for a, b in pairs) + b"\xff"


def ga94_sei(pairs) -> bytes:
    """An annex-B H.264 SEI NAL carrying `pairs` as A/53 cc_data
    (registered ITU-T T.35, payload type 4)."""
    payload = b"\xb5\x00\x31GA94\x03" + _cc_data(pairs)
    body = bytes([4, len(payload)]) + payload + b"\x80"
    out, zeros = bytearray(), 0
    for b in body:                      # emulation prevention
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return b"\x00\x00\x00\x01\x06" + bytes(out)


def _cc_events(mod, feeds):
    dec = mod.Cea608Decoder()
    out = []
    for pairs, pts in feeds:
        out += [(e.pts, e.stop, e.text) for e in dec.feed(pairs, pts)]
    out += [(e.pts, e.stop, e.text) for e in dec.flush(10 * 90000)]
    return out


def test_cea608_copy_equals_reference():
    feeds = [(_pairs_for(["HELLO", "WORLD"]), 0),
             ([(0x14, 0x2F), (0x14, 0x2F)], 90000),
             ([(0x14, 0x2C)], 3 * 90000),
             ([(0x14, 0x25), (ord("H"), ord("I")), (0x11, 0x37)], 4 * 90000),
             ([(0x14, 0x2D)], 5 * 90000),
             (_pairs_for(["AGAIN"]) + [(0x14, 0x2F)], 6 * 90000)]
    want = _cc_events(jcc, feeds)
    assert len(want) >= 2 and _cc_events(tcc, feeds) == want
    pairs = _pairs_for(["SEI CAPTION"])
    es = (b"\x00\x00\x00\x01\x09\xf0" + ga94_sei(pairs)
          + b"\x00\x00\x00\x01\x65\x88\x84")
    assert tcc.extract_cc_h264(es) == jcc.extract_cc_h264(es) != []
    mp2 = (b"\x00\x00\x01\xb3" + b"\x06\x00\x40" + bytes(5)
           + b"\x00\x00\x01\xb2GA94\x03" + _cc_data(pairs)
           + b"\x00\x00\x01\x00" + bytes(4))
    assert tcc.extract_cc_mpeg2(mp2) == jcc.extract_cc_mpeg2(mp2) != []


# -- the rasterizer ----------------------------------------------------------
TEXTS = ["Hello world", "Two lines\nof text", "Unicode \xe9 and ?", "x"]


@pytest.fixture
def no_cv2(monkeypatch):
    """OpenCV blocked: `import cv2` raises ImportError in both packages."""
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.mark.parametrize("size", [(96, 64), (1920, 1080), (320, 240)])
def test_opencv_raster_equals_reference(size):
    pytest.importorskip("cv2")
    assert traster.rasterizer() == traster.OPENCV
    for text in TEXTS:
        want, wpos = jraster.render_text_rgba(text, *size)
        got, gpos = traster.render_text_rgba(text, *size)
        assert gpos == wpos and np.array_equal(got, want)


@pytest.mark.parametrize("size", [(96, 64), (1920, 1080), (320, 240)])
def test_bitmap_raster_equals_reference(no_cv2, size):
    assert traster.rasterizer() == traster.BITMAP
    for text in TEXTS:
        want, wpos = jraster.render_text_rgba(text, *size)
        got, gpos = traster.render_text_rgba(text, *size)
        assert gpos == wpos and np.array_equal(got, want)
        assert got[..., 3].any()


def test_raster_fallback_only_for_a_missing_opencv(monkeypatch):
    """The reference draws the bitmap font after any error of the OpenCV
    path; the port only where cv2 is missing, and raises otherwise."""
    pytest.importorskip("cv2")

    def broken(*_a):
        raise RuntimeError("putText failed")
    monkeypatch.setattr(jraster, "_render_cv2", broken)
    monkeypatch.setattr(traster, "_render_cv2", broken)
    img, _pos = jraster.render_text_rgba("Hello", 96, 64)
    assert img.shape[0] > 0                  # the reference falls back
    with pytest.raises(RuntimeError, match="putText"):
        traster.render_text_rgba("Hello", 96, 64)


# -- blend_rgba against the JAX function -------------------------------------
FMT = {(2, 2): "yuv420p", (2, 1): "yuv422p", (1, 1): "yuv444p"}
# (patch h, w, x0, y0): even and odd offsets; one pixel and the dot's
# fused tails (n < 16, 16 <= n < 32 with n % 8 >= 4, and n % 8 pixels of a
# larger patch); a patch as large as the frame
PATCHES = [(20, 30, 4, 6), (13, 17, 3, 5), (1, 1, 7, 9), (3, 5, 0, 1),
           (4, 5, 9, 2), (2, 11, 1, 1), (5, 7, 10, 11), (17, 3, 21, 0)]


def _planes(h, w, bits, sw, sh, rng):
    mx = (1 << bits) - 1
    dt = np.uint8 if bits == 8 else np.uint16
    ch, cw = -(-h // sh), -(-w // sw)
    return (rng.integers(0, mx + 1, (h, w)).astype(dt),
            rng.integers(0, mx + 1, (ch, cw)).astype(dt),
            rng.integers(0, mx + 1, (ch, cw)).astype(dt))


def _rgba(ph, pw, alpha, rng):
    rgba = rng.integers(0, 256, (ph, pw, 4)).astype(np.uint8)
    if alpha != "random":
        rgba[..., 3] = alpha
    return rgba


def _differ(want, got):
    return [int((np.asarray(w) != g.numpy()).sum())
            for w, g in zip(want, got)]


@pytest.mark.parametrize("alpha", [0, 255, "random"])
@pytest.mark.parametrize("sub", list(FMT))
@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("frame", [(48, 64), (50, 66)])
def test_blend_equals_reference(frame, bits, sub, alpha):
    h, w = frame
    sw, sh = sub
    mx = (1 << bits) - 1
    rng = np.random.default_rng(h * 131 + bits * 7 + sw * 3 + sh)
    for ph, pw, x0, y0 in PATCHES + [(h, w, 0, 0)]:
        y, u, v = _planes(h, w, bits, sw, sh, rng)
        rgba = _rgba(ph, pw, alpha, rng)
        want = jr.blend_rgba(*(jnp.asarray(p) for p in (y, u, v, rgba)),
                             x0=x0, y0=y0, sw=sw, sh=sh, maxval=mx)
        got = tr.blend_rgba(*(torch.from_numpy(p) for p in (y, u, v, rgba)),
                            x0=x0, y0=y0, sw=sw, sh=sh, maxval=mx)
        assert _differ(want, got) == [0, 0, 0], (ph, pw, x0, y0)


def test_blend_at_1080p_equals_reference():
    """A 1400x200 random patch at an odd offset on 1080p frames."""
    rng = np.random.default_rng(5)
    for bits in (8, 10):
        for sw, sh in FMT:
            y, u, v = _planes(1080, 1920, bits, sw, sh, rng)
            rgba = _rgba(200, 1400, "random", rng)
            kw = dict(x0=261, y0=811, sw=sw, sh=sh, maxval=(1 << bits) - 1)
            want = jr.blend_rgba(*(jnp.asarray(p) for p in (y, u, v, rgba)),
                                 **kw)
            got = tr.blend_rgba(*(torch.from_numpy(p)
                                  for p in (y, u, v, rgba)), **kw)
            assert _differ(want, got) == [0, 0, 0]


# -- the filter and the graph ------------------------------------------------
def _frame(mod_buffer, pix, planes, pts):
    return mod_buffer(planes=[p.copy() for p in planes], pix_fmt=pix,
                      pts=pts, duration=3000)


def _event(mod_buffer, rgba, rect, pts, stop=None, clear=False):
    b = mod_buffer(track_kind="subtitle", pts=pts, stop=stop)
    if clear:
        b.sub_clear = True
    else:
        b.planes = [rgba]
        b.rect = rect
    return b


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv422p10", "yuv444p"])
def test_filter_equals_reference(fmt):
    """Events queued through the graph, a clear marker, an event clamped
    at the right and bottom edges and one past the top-left corner, over
    frames before, during and after them; each event is queued ahead of
    the first frame at or past its pts, the order the sync gives them
    where no filter holds a frame back.  (Where one does, the reference
    drops the events a clear marker ends before the held frame comes:
    ``tests/test_torch_burn_held_frame.py``.)"""
    rng = np.random.default_rng(11)
    pix = PIX_FMTS[fmt]
    sw, sh = pix.subsampling
    planes = _planes(50, 66, pix.bit_depth, sw, sh, rng)
    cards = [_rgba(10, 20, "random", rng), _rgba(12, 9, 255, rng),
             _rgba(7, 30, "random", rng)]
    spec = [{"ID": S.FILTER_RENDER_SUB, "Settings": {}}]
    jg = jgraph.FilterGraph(spec, jbase.FilterInit(
        geometry=JGeometry(66, 50), pix_fmt=JPIX[fmt]))
    tg = tgraph.FilterGraph(spec, tbase.FilterInit(
        geometry=Geometry(66, 50), pix_fmt=pix, device="cpu"))
    events = [(cards[0], (5, 3), 3000, None, False),
              (cards[1], (60, 45), 6000, 15000, False),   # clamped
              (None, None, 9000, None, True),              # clears card 0
              (cards[2], (-4, -2), 9000, None, False)]
    queued = 0
    for pts in (0, 3000, 6000, 9000, 12000, 15000, 18000):
        while queued < len(events) and events[queued][2] <= pts:
            rgba, rect, at, stop, clear = events[queued]
            for g, buf in ((jg, JBuffer), (tg, Buffer)):
                assert g.queue_subtitle(_event(buf, rgba, rect, at, stop,
                                               clear))
            queued += 1
        want = jg.work(_frame(JBuffer, JPIX[fmt], planes, pts))[0].planes
        got = tg.work(_frame(Buffer, pix, planes, pts))[0].planes
        for w, g in zip(want, got):
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            assert np.array_equal(np.asarray(w), g), pts


def test_patch_larger_than_the_frame_raises_like_reference():
    rng = np.random.default_rng(2)
    planes = _planes(48, 64, 8, 2, 2, rng)
    rgba = _rgba(60, 30, 255, rng)
    f = jr.RenderSubFilter({})
    f.init(jbase.FilterInit(geometry=JGeometry(64, 48),
                            pix_fmt=JPIX["yuv420p"]))
    f.queue_subtitle(_event(JBuffer, rgba, (0, 0), 0))
    with pytest.raises(TypeError):
        f.work(_frame(JBuffer, JPIX["yuv420p"], planes, 0))
    t = tr.RenderSubFilter({})
    t.init(tbase.FilterInit(geometry=Geometry(64, 48),
                            pix_fmt=PIX_FMTS["yuv420p"], device="cpu"))
    t.queue_subtitle(_event(Buffer, rgba, (0, 0), 0))
    with pytest.raises(TypeError, match="does not fit"):
        t.work(_frame(Buffer, PIX_FMTS["yuv420p"], planes, 0))


def test_event_uploaded_once_and_no_event_no_copy():
    """The RGBA of an event is a tensor on the filter's device from the
    moment it is queued; a frame with no active event passes through."""
    t = tr.RenderSubFilter({})
    t.init(tbase.FilterInit(geometry=Geometry(64, 48),
                            pix_fmt=PIX_FMTS["yuv420p"], device="cpu"))
    rgba = np.full((4, 4, 4), 255, np.uint8)
    t.queue_subtitle(_event(Buffer, rgba, (0, 0), 3000, 6000))
    assert isinstance(t.events[0].planes[0], torch.Tensor)
    frame = _frame(Buffer, PIX_FMTS["yuv420p"],
                   _planes(48, 64, 8, 2, 2, np.random.default_rng(0)), 0)
    assert t.work(frame)[0] is frame
