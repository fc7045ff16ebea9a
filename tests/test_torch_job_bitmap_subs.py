"""Bitmap subtitles and captions on the port's job path (on the CPU), held
against the JAX package byte for byte: mkv sources that the port's own
encoder and muxer write (96x64, 10 frames of H.264):

- an S_HDMV/PGS track (a display set at frame 2, a clear at frame 7)
  burned in, through ``do_job`` and through the CLI's ``-s 1
  --subtitle-burned 1``;
- an S_VOBSUB track with its idx palette in CodecPrivate, burned in;
- CEA-608 captions in GA94 SEI NALs of an annex-B H.264 stream, decoded
  into an mkv text track, and ``scan_title`` listing the "cc" track that
  the CLI's ``-s`` then selects.  Both packages also copy each T.35 SEI
  of an H.264 source into their output as HDR10+ metadata
  (``codecs/hdr.py``), so the GA94 SEIs come through in both files.
"""
import functools
from fractions import Fraction

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu.scan import scan_title as jscan
from handbrake_tpu_torch import work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.scan import scan_title
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.subtitles.pgs import build_display_set
from handbrake_tpu_torch.subtitles.vobsub import build_spu
from handbrake_tpu_torch.utils.synth import make_clip
from test_torch_subtitles import _pairs_for, ga94_sei
from torch_rates import reference_reads_rate  # noqa: F401  (a fixture)
from torch_rates import (reference_rule, shaper_input, times_of, vfr_c_rule,
                         vfr_c_shaper, video_times)

W, H, N = 96, 64, 10
FRAME = 3000


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


@functools.lru_cache(None)
def _video():
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=26, gop=N,
                                    deblock=True, cabac=True,
                                    transform8x8=True), device="cpu")
    return [enc.encode_frame(*f) for f in make_clip(W, H, N, seed=6)]


def _mkv(path, codec, packets, private=b""):
    """An mkv of the clip and one subtitle track of (pts, payload)."""
    w = MKVWriter(path)
    vi = w.add_video_track(codec="h264", width=W, height=H, fps=30.0)
    si = w.add_subtitle_track(codec=codec, private=private)
    for i, au in enumerate(_video()):
        w.write_sample(vi, au, pts_90k=i * FRAME, duration_90k=FRAME,
                       sync=i == 0, annexb=True)
        if i == 0:
            for pts, pkt in packets:
                w.write_sample(si, pkt, pts_90k=pts)
    w.finalize()
    return path


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("tbmp")
    pal = np.zeros((256, 4), np.uint8)
    pal[1] = (235, 128, 128, 255)            # white, opaque
    pal[2] = (81, 90, 240, 180)              # red-ish, translucent
    card = np.ones((16, 33), np.uint8)
    card[4:12, 5:28] = 2
    pgs = _mkv(str(d / "pgs.mkv"), "pgs", [
        (2 * FRAME, build_display_set(2 * FRAME, card, pal, 31, 21,
                                      screen=(W, H))),
        (7 * FRAME, build_display_set(7 * FRAME, card, pal, 0, 0,
                                      screen=(W, H), clear=True))])
    idx = np.zeros((14, 40), np.uint8)
    idx[1:-1, 2:-2] = 1
    idx[4:10, 6:30] = 2
    clut = b", ".join(b"%06x" % c for c in (0x000000, 0xf0f0f0, 0x2040e0,
                                             0x808080) + (0,) * 12)
    vob = _mkv(str(d / "vob.mkv"), "vobsub", [
        (FRAME, build_spu(idx, 17, 31, alpha=(0, 15, 11, 15),
                          stop_delay=60))],
        private=b"size: 96x64\npalette: " + clut + b"\n")
    # captions: load on frame 1, display (EOC) on frame 2, erase on 8
    inject = {1: ga94_sei(_pairs_for(["CAPTION ONE"])),
              2: ga94_sei([(0x14, 0x2F)]), 8: ga94_sei([(0x14, 0x2C)])}
    cc = str(d / "cc.264")
    with open(cc, "wb") as f:
        for i, au in enumerate(_video()):
            f.write(inject.get(i, b"") + au)
    return {"pgs": pgs, "vob": vob, "cc": cc}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _job(Sm, src, out, subs):
    j = Sm.Job(path=src, file=out, mux="mkv", vcodec="h264", quality=28.0,
               encoder_profile="high")
    j.subtitles = [Sm.SubtitleJobTrack(**s) for s in subs]
    return j


def _texts(path):
    d = MKVDemuxer(path)
    try:
        return [bytes(b.data) for t, b in d.packets()
                if d.tracks[t].kind == "subtitle"]
    finally:
        d.close()


@pytest.mark.parametrize("src,subs", [
    ("pgs", [dict(track=0, burn=True)]),
    ("vob", [dict(track=0, burn=True)]),
    ("cc", [dict(cc=True, language="eng")])], ids=["pgs-burn", "vobsub-burn",
                                                   "cea608-text"])
def test_bitmap_and_caption_jobs_equal_reference(sources, tmp_path, src,
                                                 subs, reference_reads_rate):
    """The annex-B caption source states its rate, which the port reads
    and the reference is given (``torch_rates``)."""
    jout, tout = str(tmp_path / "ref.mkv"), str(tmp_path / "port.mkv")
    jwork.do_job(_job(JS, sources[src], jout, subs))
    work.do_job(_job(S, sources[src], tout, subs), device="cpu")
    if src == "cc":
        assert any(b"CAPTION ONE" in t for t in _texts(tout))
    assert _bytes(tout) == _bytes(jout)


def test_burned_pgs_differs_from_the_plain_job(sources, tmp_path):
    """The burned card shows: the output differs from the same job
    without subtitles."""
    a, b = str(tmp_path / "burn.mkv"), str(tmp_path / "plain.mkv")
    work.do_job(_job(S, sources["pgs"], a, [dict(track=0, burn=True)]),
                device="cpu")
    work.do_job(_job(S, sources["pgs"], b, []), device="cpu")
    assert _bytes(a) != _bytes(b)


def test_scan_finds_the_caption_track(sources):
    t, jt = scan_title(sources["cc"], preview_count=2), \
        jscan(sources["cc"], preview_count=2)
    assert [(s.source, s.language) for s in t.subtitles] == \
        [(s.source, s.language) for s in jt.subtitles] == [("cc", "und")]
    assert scan_title(sources["pgs"], preview_count=2).subtitles[0].source \
        == "pgs"


@pytest.mark.parametrize("src,extra", [
    ("pgs", ["-s", "1", "--subtitle-burned", "1"]),
    ("cc", ["-s", "1"])], ids=["pgs-burned", "cc"])
def test_cli_subtitle_selection_equals_reference(sources, tmp_path, src,
                                                 extra, reference_reads_rate):
    """The PGS source's mkv states a default duration of 33333333 ns, a
    hair over 30 fps, so its frames reach the default preset's peak-rate
    shaper (30) 2999 ticks long: the port's shaper stops each on the
    peak's grid, 3000 ticks apart, at 30 fps (vfr.c's rule, ROADMAP
    3.20), so the file equals the reference's with its shaper on that
    rule; the reference's own shaper keeps the 2999 ticks."""
    jout, tout = str(tmp_path / "ref.mkv"), str(tmp_path / "port.mkv")
    args = ["-i", sources[src], "-e", "h264", "-q", "28",
            "--encoder-profile", "high", "--crop", "0:0:0:0", *extra]
    with vfr_c_shaper():
        assert jcli([*args, "-o", jout]) == 0
    with shaper_input() as frames:
        assert cli([*args, "-o", tout, "--device", "cpu"]) == 0
    assert _bytes(tout) == _bytes(jout)
    peak = Fraction(30)
    if src == "pgs":
        own = str(tmp_path / "ref_own.mkv")
        assert jcli([*args, "-o", own]) == 0
        assert {d for _p, d in frames} == {2999}
        assert video_times(tout) == times_of(vfr_c_rule(frames, peak), True)
        assert video_times(own) == times_of(reference_rule(frames, peak),
                                            True)
    else:                        # 30000/1001: the rule keeps every time
        assert vfr_c_rule(frames, peak) == [
            (i, p, d) for i, (p, d) in enumerate(frames)]
