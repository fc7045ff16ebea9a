"""Text subtitles on the port's job path (``work.do_job``, ``hb.Handle``
and the CLI, on the CPU), held against the JAX package: each output file
must equal the reference's byte for byte.  The sources are a 96x64 y4m of
10 frames, SRT and WebVTT files, and an mp4 whose tx3g track carries a cue:

- an SRT import kept soft, to mp4 (tx3g) and to mkv (S_TEXT/UTF8), and
  burned in on an unscaled job;
- the tx3g track of an mp4 source to an mkv text track, and burned in;
- the CLI's ``--srt-file/--srt-lang/--srt-offset/--srt-burn/--srt-default``
  against the JAX CLI's;
- ``hb.Handle`` with ``Search`` enabled: the search pass, then the job;
- a burned text cue on a cropped and scaled job, where the reference lays
  the text out for the output size but blends it onto the uncropped source
  frame: its text lands in the top of the picture, the port's
  bottom-centred (the placement the port repairs);
- a subtitle track with no decoder raises, where the reference drops it.
"""
import functools
import os

import numpy as np
import pytest

from handbrake_tpu import hb as jhb
from handbrake_tpu import work as jwork
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import hb, work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.codecs.registry import create_video_decoder
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.probe import open_source
from handbrake_tpu_torch.utils.synth import make_clip, write_y4m

W, H, N = 96, 64, 10
FRAME = 3003

SRT = (b"1\n00:00:00,050 --> 00:00:00,150\nFirst cue\n\n"
       b"2\n00:00:00,120 --> 00:00:00,300\nTwo\nlines\n\n")
VTT = (b"WEBVTT\n\n00:00.030 --> 00:00.200\nA <b>web</b> cue\n\n"
       b"00:00.250 --> 00:00.320\nLast\n")


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """Each shape compiles the reference's analyzer once in this module;
    the reference encodes on its device path, as the port does (some of
    the JAX package's tests leave HB_TPU_DISABLE_DEVICE=1 set)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        yield


@functools.lru_cache(None)
def _video(w=W, h=H):
    enc = H264Encoder(EncoderConfig(width=w, height=h, qp=26, gop=N,
                                    deblock=True, cabac=True,
                                    transform8x8=True), device="cpu")
    return [enc.encode_frame(*f) for f in make_clip(w, h, N, seed=5)]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsub")
    y4m = str(d / "src.y4m")
    write_y4m(y4m, make_clip(W, H, N, seed=3), W, H)
    srt, vtt = str(d / "a.srt"), str(d / "b.vtt")
    with open(srt, "wb") as f:
        f.write(SRT)
    with open(vtt, "wb") as f:
        f.write(VTT)
    tx3g = str(d / "tx3g.mp4")
    w = MP4Writer(tx3g)
    vi = w.add_video_track(codec="h264", width=W, height=H)
    si = w.add_subtitle_track(codec="tx3g", language="eng")
    for i, au in enumerate(_video()):
        w.write_sample(vi, au, duration=FRAME, sync=i == 0, annexb=True)
    cue = "Hello tx3g".encode()
    w.write_sample(si, b"\x00\x00", duration=2 * FRAME)
    w.write_sample(si, len(cue).to_bytes(2, "big") + cue,
                   duration=5 * FRAME)
    w.write_sample(si, b"\x00\x00", duration=3 * FRAME)
    w.finalize()
    dvb = str(d / "dvb.mkv")
    w = MKVWriter(dvb)
    vi = w.add_video_track(codec="h264", width=W, height=H, fps=30.0)
    si = w.add_subtitle_track(codec="pgs")
    w.tracks[si].codec_id = "S_DVBSUB"
    for i, au in enumerate(_video()):
        w.write_sample(vi, au, pts_90k=i * FRAME, duration_90k=FRAME,
                       sync=i == 0, annexb=True)
    w.write_sample(si, b"\x0f" * 8, pts_90k=FRAME)
    w.finalize()
    # 192x144: a 192x96 picture between 24-row bars
    bars = str(d / "bars.y4m")
    write_y4m(bars, make_clip(192, 96, N, seed=4), 192, 144, bar=24)
    return {"y4m": y4m, "srt": srt, "vtt": vtt, "tx3g": tx3g, "dvb": dvb,
            "bars": bars}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _job(Sm, src, out, mux, subs, **kw):
    j = Sm.Job(path=src, file=out, mux=mux, vcodec="h264", quality=28.0,
               encoder_profile="high", **kw)
    j.subtitles = [Sm.SubtitleJobTrack(**s) for s in subs]
    return j


def _pair(sources, tmp_path, src, mux, subs, name="job"):
    jout = str(tmp_path / f"ref-{name}.{mux}")
    tout = str(tmp_path / f"port-{name}.{mux}")
    jwork.do_job(_job(JS, sources[src], jout, mux, subs))
    work.do_job(_job(S, sources[src], tout, mux, subs), device="cpu")
    return jout, tout


def _sub_packets(path):
    d = MKVDemuxer(path) if path.endswith(".mkv") else open_source(path)
    try:
        if path.endswith(".mkv"):
            return [bytes(b.data) for t, b in d.packets()
                    if d.tracks[t].kind == "subtitle"]
        return [bytes(d.read_sample(i, k).data) for i, t in
                enumerate(d.tracks) if t.kind == "subtitle"
                for k in range(d.n_samples(i))]
    finally:
        d.close()


# job name: (source, mux, subtitle tracks)
JOBS = {
    "srt-soft-mp4": ("y4m", "mp4", "srt", dict(language="fre")),
    "srt-soft-mkv": ("y4m", "mkv", "srt", dict(language="fre", offset=40)),
    "vtt-soft-mkv": ("y4m", "mkv", "vtt", dict(import_format="VTT")),
    "srt-burn-mp4": ("y4m", "mp4", "srt", dict(burn=True)),
    "tx3g-soft-mkv": ("tx3g", "mkv", None, dict(track=0, language="eng")),
    "tx3g-burn-mp4": ("tx3g", "mp4", None, dict(track=0, burn=True)),
}


@pytest.mark.parametrize("name", list(JOBS))
def test_subtitle_job_equals_reference(sources, tmp_path, name):
    src, mux, imp, spec = JOBS[name]
    spec = dict(spec)
    if imp:
        spec.update(track=-1, import_file=sources[imp])
    jout, tout = _pair(sources, tmp_path, src, mux, [spec], name)
    assert _bytes(tout) == _bytes(jout)
    subs = _sub_packets(tout)
    if spec.get("burn"):
        assert subs == []
    else:
        assert any(b"cue" in p or b"tx3g" in p for p in subs), subs


def test_tx3g_samples_fill_gaps_and_trim_overlaps(sources, tmp_path):
    """The SRT's two cues overlap (120 ms < 150 ms): the tx3g track has
    an empty lead-in, the first cue, then the second trimmed to start
    where the first ends, each as the reference writes it."""
    _jout, tout = _pair(sources, tmp_path, "y4m", "mp4",
                        [dict(track=-1, import_file=sources["srt"])])
    samples = _sub_packets(tout)
    assert samples[0] == b"\x00\x00"
    assert samples[1] == b"\x00\x09First cue"
    assert samples[2] == b"\x00\x09Two\nlines"


def _cli(src, out, *extra):
    return ["-i", src, "-o", out, "-e", "h264", "-q", "28",
            "--encoder-profile", "high", "--crop", "0:0:0:0", *extra]


@pytest.mark.parametrize("extra", [
    ["--srt-file", "{srt},{vtt}", "--srt-lang", "fre,eng",
     "--srt-offset", "0,100", "--srt-default", "2"],
    ["--srt-file", "{vtt},{srt}", "--srt-burn", "2"]])
def test_cli_srt_flags_equal_reference(sources, tmp_path, extra):
    extra = [e.format(**sources) for e in extra]
    jout, tout = str(tmp_path / "ref.mkv"), str(tmp_path / "port.mkv")
    assert jcli(_cli(sources["y4m"], jout, *extra)) == 0
    assert cli(_cli(sources["y4m"], tout, *extra, "--device", "cpu")) == 0
    assert _bytes(tout) == _bytes(jout)
    assert _sub_packets(tout)


def test_handle_with_search_equals_reference(sources, tmp_path):
    """Search enabled: the reference's passes (a search pass, id -1, that
    runs the whole job, then the job), and the same file."""
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    subs = [dict(track=-1, import_file=sources["srt"], burn=True)]
    jj, tj = (_job(m, sources["y4m"], o, "mp4", subs)
              for m, o in ((JS, jout), (S, tout)))
    for j in (jj, tj):
        j.subtitle_search = {"Enable": True}
    assert [p.pass_id for p in hb.setup_passes(tj)] == \
        [p.pass_id for p in jhb.setup_passes(jj)] == [-1, 0]
    jh = jhb.Handle()
    jh.add(jj)
    jh.start()
    assert jh.work_wait(300) == 0
    th = hb.Handle(device="cpu")
    th.add(tj)
    th.start()
    assert th.work_wait(300) == 0 and th.work_exception is None
    assert _bytes(tout) == _bytes(jout)


def _luma(path):
    d = open_source(path)
    try:
        dec = create_video_decoder("h264", d.tracks[0].extradata)
        frames = []
        for k in range(d.n_samples(0)):
            frames += dec.feed(d.read_sample(0, k))
        frames += dec.flush()
        return [np.asarray(f.planes[0]).astype(np.int32) for f in frames]
    finally:
        d.close()


def test_burned_text_placement_repairs_reference_fault(sources, tmp_path):
    """192x144 with 24-row bars, cropped to the 192x96 picture and scaled
    to 96x48.  The reference rasterizes the cue for 96x48 and blends it at
    its place in a 96x48 frame, but onto the 192x144 source: near the top
    of the picture, left of centre, half size.  The port rasterizes it
    for the 192x96 the crop keeps and places it there: bottom-centred in
    the output."""
    subs = [dict(track=-1, import_file=sources["srt"], burn=True)]
    kw = dict(filters=[S.FilterSpec(S.FILTER_CROP_SCALE, {
        "crop-top": 24, "crop-bottom": 24, "width": 96, "height": 48})])
    jkw = dict(filters=[JS.FilterSpec(JS.FILTER_CROP_SCALE, dict(
        kw["filters"][0].settings))])
    outs = {}
    for name, Sm, run, k, sub in (
            ("ref", JS, jwork.do_job, jkw, subs),
            ("ref-plain", JS, jwork.do_job, jkw, []),
            ("port", S, lambda j: work.do_job(j, device="cpu"), kw, subs),
            ("port-plain", S, lambda j: work.do_job(j, device="cpu"), kw,
             [])):
        outs[name] = str(tmp_path / f"{name}.mp4")
        run(_job(Sm, sources["bars"], outs[name], "mp4", sub, **k))
    assert _bytes(outs["port-plain"]) == _bytes(outs["ref-plain"])
    plain = _luma(outs["port-plain"])
    # frames 3-4 show the first cue (50-150 ms)
    for who, top_half in (("ref", True), ("port", False)):
        got = _luma(outs[who])
        mask = sum((np.abs(got[i] - plain[i]) > 24) for i in (3, 4)) > 0
        rows, cols = np.nonzero(mask)
        assert rows.size > 20, who
        centre_y, centre_x = rows.mean(), cols.mean()
        if top_half:
            assert centre_y < 48 * 0.4
        else:
            assert centre_y > 48 * 0.6
            assert abs(centre_x - 48) < 8


def test_subtitle_track_without_decoder_raises(sources, tmp_path):
    """An S_DVBSUB track has no decoder in either package: the reference
    logs and drops it, the port raises and writes no file."""
    subs = [dict(track=0, burn=True)]
    jout, tout = str(tmp_path / "ref.mkv"), str(tmp_path / "port.mkv")
    jwork.do_job(_job(JS, sources["dvb"], jout, "mkv", subs))
    assert os.path.exists(jout)
    with pytest.raises(work.WorkError, match="S_DVBSUB"):
        work.do_job(_job(S, sources["dvb"], tout, "mkv", subs),
                    device="cpu")
    assert not os.path.exists(tout)
