"""The port's own copies of the JAX package's host modules behave like
their originals: the Job JSON codec, presets, the anamorphic geometry
calculator, the synchronizer, the mp4 writer and the y4m, annex-B and
mp4 demuxers (exact equality: they hold no arithmetic that could round
differently)."""
from fractions import Fraction

import numpy as np
import pytest

from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu.job import geometry as jgeo
from handbrake_tpu.job import presets as jpresets
from handbrake_tpu.job import schema as jschema
from handbrake_tpu.job import title as jtitle
from handbrake_tpu.mux.mp4 import MP4Writer as JMP4Writer
from handbrake_tpu.sources.probe import open_source as j_open_source
from handbrake_tpu.sync.sync import SyncCore as JSyncCore
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.job import geometry as tgeo
from handbrake_tpu_torch.job import presets as tpresets
from handbrake_tpu_torch.job import schema as tschema
from handbrake_tpu_torch.job import title as ttitle
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.sources.probe import open_source
from handbrake_tpu_torch.sync.sync import SyncCore
from handbrake_tpu_torch.utils.synth import make_clip
from torch_rates import (reference_reads_mp4_rate,  # noqa: F401
                         reference_reads_rate)      # (fixtures)


def _jobs(S):
    """The same jobs built with one package's schema module."""
    plain = S.Job(path="in.y4m", file="out.mp4", quality=28.0)
    full = S.Job(
        sequence_id=7, path="/media/film.mkv", title=2, anamorphic_mode=2,
        modulus=16, max_width=1920, max_height=1080,
        keep_display_aspect=False, range=S.RangeSpec("frame", 10, 200),
        mux="mkv", file="film.mkv", chapter_markers=True,
        chapter_names=["Intro", "Main"], par_num=8, par_den=9,
        vcodec="x264", quality=None, vbitrate=4500, multipass=True,
        encoder_preset="slow", encoder_profile="high",
        encoder_options="keyint=120:cabac=1", color={"Matrix": 9},
        audio=[S.AudioJobTrack(track=1, encoder="ac3", bitrate=384,
                               mixdown="5point1", gain=-2.0)],
        subtitles=[S.SubtitleJobTrack(track=-1, import_file="a.srt",
                                      burn=True, offset=250)],
        metadata={"Name": "Film"},
        filters=[S.FilterSpec(S.FILTER_VFR, {"mode": 1, "rate-num": 24,
                                             "rate-den": 1}),
                 S.FilterSpec(S.FILTER_CROP_SCALE,
                              {"crop-top": 140, "width": 1280,
                               "height": 536})])
    timed = S.Job(path="clip.mp4", range=S.RangeSpec("time", 5, 65),
                  bframes=3, gop_parallel=4, checkpoint=True)
    return {"plain": plain, "full": full, "timed": timed}


@pytest.mark.parametrize("name", ["plain", "full", "timed"])
def test_job_json_round_trip(name):
    j = _jobs(jschema)[name].to_json()
    t = _jobs(tschema)[name].to_json()
    assert t == j
    back = tschema.Job.from_json(t)
    assert back.to_json() == j
    assert back.to_json() == jschema.Job.from_json(j).to_json()


def _title(T):
    t = T.Title(index=1, path="/media/src.mkv", name="src", width=1920,
                height=1080, par_num=1, par_den=1, vrate_num=24000,
                vrate_den=1001, video_codec="h264", crop=(132, 140, 0, 2),
                duration=90000 * 600, nframes=14385)
    t.audio = [T.AudioTrack(track=0, codec="ac3", channels=6),
               T.AudioTrack(track=1, codec="aac", language="eng")]
    t.chapters = [T.Chapter(name="One", duration=90000 * 300),
                  T.Chapter(name="", duration=90000 * 300)]
    t.metadata = {"Name": "src", "ReleaseDate": "2024"}
    return t


PRESETS = [p["PresetName"] for p in jpresets.flatten(jpresets.get_builtin())]


def test_builtin_preset_trees_equal():
    assert tpresets.builtin_presets() == jpresets.builtin_presets()


@pytest.mark.parametrize("name", PRESETS)
def test_preset_to_job_equals_reference(name):
    want = jpresets.preset_to_job(_title(jtitle),
                                  jpresets.preset_search(name))
    got = tpresets.preset_to_job(_title(ttitle),
                                 tpresets.preset_search(name))
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("name", PRESETS)
def test_preset_encoders_are_the_jobs(name):
    """What the port's CLI reads of a preset before the scan (the
    container, the video encoder's settings, the audio tracks) is what
    ``preset_to_job`` gives after it; with no title, no audio track."""
    preset = tpresets.preset_search(name)
    t = _title(ttitle)
    job = tpresets.preset_to_job(t, preset)
    enc = tpresets.preset_encoders(preset, ["und"] * len(t.audio))
    for f in ("mux", "vcodec", "quality", "vbitrate", "multipass",
              "turbo_first_pass", "encoder_preset", "encoder_tune",
              "encoder_profile", "encoder_level", "encoder_options",
              "audio", "audio_fallback", "audio_copy_mask"):
        assert getattr(enc, f) == getattr(job, f), f
    assert tpresets.preset_encoders(preset).audio == []


GEO_SOURCES = [(1920, 1080, Fraction(1, 1)), (720, 480, Fraction(8, 9)),
               (720, 576, Fraction(16, 15)), (3840, 2160, Fraction(1, 1)),
               (1440, 1080, Fraction(4, 3))]
GEO_REQUESTS = [dict(), dict(width=1280), dict(height=600),
                dict(width=1000, height=700, keep_display_aspect=False),
                dict(max_width=1280, max_height=720, modulus=16),
                dict(modulus=8, par_num=32, par_den=27),
                dict(max_width=640)]
GEO_CROPS = [(0, 0, 0, 0), (138, 138, 0, 0), (10, 12, 6, 8), (1, 3, 5, 7)]


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("src", range(len(GEO_SOURCES)))
def test_set_anamorphic_size2_equals_reference(mode, src):
    w, h, par = GEO_SOURCES[src]
    for req in GEO_REQUESTS:
        for crop in GEO_CROPS:
            want = jgeo.set_anamorphic_size2(
                w, h, par, jgeo.GeometrySettings(mode=mode, crop=crop,
                                                 **req))
            got = tgeo.set_anamorphic_size2(
                w, h, par, tgeo.GeometrySettings(mode=mode, crop=crop,
                                                 **req))
            assert got == want, (mode, src, req, crop)


def _timeline(B):
    """Video with a gap, an overlap and jitter, audio starting late with
    a gap: (kind, pts, duration) through one package's Buffer."""
    vid = [0, 3003, 6006, 15015, 18018, 20000, 24027, 27030, 30033]
    aud = [4000 + i * 1920 for i in range(8)] + \
          [4000 + i * 1920 + 30000 for i in range(8, 14)]
    out = []
    for p in vid:
        out.append(B(track_kind="video", pts=p, duration=3003, stop=p + 3003))
    for p in aud:
        out.append(B(track_kind="audio", pts=p, duration=1920, stop=p + 1920))
    return out


@pytest.mark.parametrize("start,stop", [(None, None), (6000, None),
                                        (None, 24000)])
def test_sync_core_equals_reference(start, stop):
    def run(Core, B):
        sc = Core(pts_start=start, pts_stop=stop)
        v = sc.add_stream("video", width=64, height=48, frame_duration=3003)
        a = sc.add_stream("audio", sample_rate=48000, channels=2)
        outs = []
        for b in _timeline(B):
            sc.queue(v if b.track_kind == "video" else a, b)
            outs += sc.poll()
        sc.set_eof(v)
        sc.set_eof(a)
        outs += sc.poll()
        outs += sc.poll()
        return ([(b.track_kind, b.pts, b.duration, b.stop,
                  b.planes is not None) for b in outs],
                sc.cadence.info())
    assert run(SyncCore, Buffer) == run(JSyncCore, JBuffer)


def _aus():
    """Five H.264 access units (IDR every third frame) from the port's
    encoder on the CPU."""
    enc = H264Encoder(EncoderConfig(width=48, height=32, qp=30, gop=3,
                                    deblock=True, cabac=True,
                                    transform8x8=True), device="cpu")
    return [enc.encode_frame(*f) for f in make_clip(48, 32, 5, seed=4)]


def test_mp4_writer_bytes_equal_reference(tmp_path):
    aus = _aus()
    asc = bytes([0x12, 0x10])

    def write(Writer, path):
        w = Writer(path)
        v = w.add_video_track(codec="h264", width=48, height=32)
        a = w.add_audio_track(codec="aac", sample_rate=48000, channels=2,
                              extradata=asc)
        w.tracks[v].color = {"Primaries": 1, "Transfer": 1, "Matrix": 1,
                             "Range": 1}
        w.add_chapter(0, "One")
        w.add_chapter(9009, "Two")
        w.metadata = {"Name": "clip"}
        for i, au in enumerate(aus):
            w.write_sample(v, au, duration=3003, sync=i % 3 == 0,
                           annexb=True)
            w.write_sample(a, bytes([i]) * 11, duration=1024)
        w.finalize()
        with open(path, "rb") as f:
            return f.read()

    got = write(MP4Writer, str(tmp_path / "port.mp4"))
    assert got == write(JMP4Writer, str(tmp_path / "ref.mp4"))
    assert np.frombuffer(got[4:8], np.uint8).tobytes() == b"ftyp"


def _write_sources(d):
    """An annex-B stream, an mp4 and a y4m of the same short clip."""
    aus = _aus()
    es = d / "clip.264"
    es.write_bytes(b"".join(aus))
    mp4 = str(d / "clip.mp4")
    w = MP4Writer(mp4)
    v = w.add_video_track(codec="h264", width=48, height=32)
    for i, au in enumerate(aus):
        w.write_sample(v, au, duration=3003, sync=i % 3 == 0, annexb=True)
    w.finalize()
    y4m = d / "clip.y4m"
    with open(y4m, "wb") as f:
        f.write(b"YUV4MPEG2 W48 H32 F25:1 Ip A1:1 C420\n")
        for y, u, v in make_clip(48, 32, 3, seed=5):
            f.write(b"FRAME\n" + y.tobytes() + u.tobytes() + v.tobytes())
    return {"annexb": str(es), "mp4": mp4, "y4m": str(y4m)}


@pytest.mark.parametrize("kind", ["annexb", "mp4", "y4m"])
def test_sources_equal_reference(tmp_path, kind, reference_reads_rate,
                                 reference_reads_mp4_rate):
    """open_source of each container the port opens gives the reference
    demuxer's tracks and packets, and seeks to the same place.  The
    annex-B stream states 30000/1001, which the port reads, and so do
    the mp4's samples of 3003 ticks, which the port labels it with; the
    reference is given both (``torch_rates``)."""
    path = _write_sources(tmp_path)[kind]

    def read(opener):
        src = opener(path)
        try:
            tracks = [(t.kind, t.codec, t.width, t.height, t.frame_rate,
                       t.extradata) for t in src.tracks]
            pkts = [(trk, b.pts, b.duration, int(b.frametype),
                     bytes(b.data) if b.data is not None else
                     b"".join(p.tobytes() for p in b.planes))
                    for trk, b in src.packets()]
            return tracks, pkts, src.duration, src.seek(6006)
        finally:
            src.close()

    got = read(open_source)
    assert got == read(j_open_source)
    assert len(got[1]) in (3, 5)


# -- the filter suite's jax-free copies -----------------------------------
COLOR_NAMES = sorted(__import__("handbrake_tpu.job.colormap", fromlist=[
    "COLORS"]).COLORS) + ["#123456", "0xFF8000", " Navy "]


@pytest.mark.parametrize("matrix", ["bt601", "bt709"])
@pytest.mark.parametrize("bits", [8, 10])
def test_colormap_equals_reference(bits, matrix):
    from handbrake_tpu.job import colormap as jcm
    from handbrake_tpu_torch.job import colormap as tcm
    assert tcm.COLORS == jcm.COLORS
    for name in COLOR_NAMES:
        rgb = tcm.name_to_rgb(name)
        assert rgb == jcm.name_to_rgb(name)
        assert tcm.rgb_to_yuv(rgb, bits, matrix) == \
            jcm.rgb_to_yuv(rgb, bits, matrix)
    for bad in ("no-such-color", ""):
        with pytest.raises(ValueError):
            tcm.name_to_rgb(bad)
        with pytest.raises(ValueError):
            jcm.name_to_rgb(bad)


AVFILTER_GRAPHS = ["hqdn3d=y_spatial=4,unsharp",
                   "denoise=y_spatial=2.5:y_temporal=3, scale=width=32",
                   "deinterlace=mode=7,transpose=angle=90,format",
                   "nlmeans=y_strength=6.0:y_patch_size=5:kernel=isolap",
                   ",,deblock=thresh=30:=9,", "no_such_filter=1"]


@pytest.mark.parametrize("graph", AVFILTER_GRAPHS)
def test_avfilter_parse_equals_reference(graph):
    from handbrake_tpu.filters import avfilter as jav
    from handbrake_tpu.filters.base import FilterError as JFilterError
    from handbrake_tpu_torch.filters import avfilter as tav
    from handbrake_tpu_torch.filters.base import FilterError
    try:
        want = jav._parse_graph(graph)
    except JFilterError as e:
        with pytest.raises(FilterError, match=str(e)):
            tav._parse_graph(graph)
        return
    assert tav._parse_graph(graph) == want
    assert tav._NAME_TO_ID == jav._NAME_TO_ID
    assert tav._ALIASES == jav._ALIASES


@pytest.mark.parametrize("crop,area", [((0, 0, 0, 0), (16, 16, 8, 8)),
                                       ((4, 2, 6, 8), (16, 12, 8, 10)),
                                       ((140, 140, 0, 0), (0, 0, 140, 140))])
def test_rpu_equals_reference(crop, area):
    from handbrake_tpu.core.buffer import Geometry as JGeometry
    from handbrake_tpu.filters.base import FilterInit as JFilterInit
    from handbrake_tpu.filters.rpu import RPUFilter as JRPU
    from handbrake_tpu_torch.core.buffer import Geometry
    from handbrake_tpu_torch.filters.base import FilterInit
    from handbrake_tpu_torch.filters.rpu import RPUFilter

    def run(F, FI, G, B):
        f = F({"source-width": 1920, "source-height": 1080})
        fi = FI(geometry=G(1280, 536))
        fi.crop = crop
        f.init(fi)
        outs = []
        for rpu in ({"active_area": area}, b"\x01\x02", None):
            b = B(planes=None, pts=0)
            if rpu is not None:
                b.side_data["dovi_rpu"] = rpu
            outs.append(f.work(b)[0].side_data.get("dovi_rpu"))
        return outs

    assert run(RPUFilter, FilterInit, Geometry, Buffer) == \
        run(JRPU, JFilterInit, JGeometry, JBuffer)
