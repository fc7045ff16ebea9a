"""Anamorphic jobs on the port's job path, on the CPU, held against the
JAX package.  The reference reads a y4m's ``A`` tag and drops it, so it
is handed a y4m of the same frames and rate, and its file says 1:1; the
port's file must equal it in everything but the pixel aspect:

- the slice NAL units (the samples) byte for byte;
- the SPS equal once its VUI aspect is taken out (``torch_par``);
- every other mp4 box or Matroska element equal, apart from the port's
  ``pasp`` or DisplayWidth/DisplayHeight and the Cues' cluster positions,
  which move by what the Tracks element grew (the display elements and
  the SPS's aspect in the CodecPrivate; the Tracks element is ahead of
  the clusters).  The mp4's moov is written after the samples, so the
  pasp moves no chunk offset.

The jobs: a DVD folder whose MPEG-2 header says 16:9 and 25 fps
(176x144, so the IFO's 720x480 attributes do not describe it: the header
gives 16:11) through ``do_job`` with the preset's framerate shaper, to
mp4 and mkv; a 96x64 y4m with ``A32:27`` through the CLI (H.264 to mp4
and mkv, HEVC to mkv).  Then the round trip (the port's scan reads back
the aspect its files write, H.264, HEVC and AV1, mp4 and mkv), the
B-frame, GOP-parallel (one rank and two), resumed and controller paths
(each file equal to the same job's at 1:1 but for the aspect), and a
pixel aspect that no 16-bit VUI field can hold, refused."""
import functools
import os
import struct

import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.codecs.h264 import encoder_tpu as jh264_tpu
from handbrake_tpu.codecs.hevc import encoder_tpu as jhevc_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs.h264.bits import split_annexb
from handbrake_tpu_torch.codecs.mpeg2 import Mpeg2Decoder
from handbrake_tpu_torch.codecs.vui import display_size
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.scan import scan_title
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.tools import source_builders as B
from handbrake_tpu_torch.utils.synth import make_clip
from handbrake_tpu_torch.work import WorkError
from torch_par import mkv_elements, mp4_boxes, sar_of, strip_config_sar

W, H, N = 96, 64, 4
PAR = (32, 27)
DVD_PAR = (16, 11)        # 16:9 on a 176x144 picture


@pytest.fixture(scope="module", autouse=True)
def _reference_device_path():
    """The reference encodes on its device path, as the port does; its
    encoders of one shape share one jitted analyzer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        mp.setattr(jhevc_tpu, "build_ctu_analyzer",
                   functools.lru_cache(None)(jhevc_tpu.build_ctu_analyzer))
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(jh264_tpu, name,
                       functools.lru_cache(None)(getattr(jh264_tpu, name)))
        yield


def write_y4m(path, frames, w, h, par, rate=(25, 1)):
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{rate[0]}:{rate[1]} Ip "
                f"A{par[0]}:{par[1]} C420\n".encode())
        for planes in frames:
            f.write(b"FRAME\n" + b"".join(p.tobytes() for p in planes))
    return path


@pytest.fixture(scope="module")
def srcs(tmp_path_factory):
    """The y4m at 32:27 and at 1:1; the DVD folder and the y4m of its
    decoded frames at the header's 16:11 and 25 fps."""
    d = tmp_path_factory.mktemp("parjob")
    frames = make_clip(W, H, N, seed=5)
    out = {"par": write_y4m(str(d / "par.y4m"), frames, W, H, PAR),
           "square": write_y4m(str(d / "sq.y4m"), frames, W, H, (1, 1))}
    es = bytearray(B.fixture("mpeg2_176x144.m2v"))
    i = es.find(b"\x00\x00\x01\xb3")
    es[i + 7] = 0x33                       # 16:9, 25 fps
    es = b"".join(B.split_pictures(bytes(es))[:4])
    # the first picture at pts 0, as the y4m's: a later start is kept as
    # every sample's composition offset (ctts), in both packages
    units = B.video_units(es, 0, 3600)
    out["dvd"] = B.write_dvd(str(d / "dvd"), B.build_ps(units), 1,
                             [len(units) / 25])
    out["dvd_frames"] = str(d / "dvd_frames.y4m")
    write_y4m(out["dvd_frames"], Mpeg2Decoder().decode(es), 176, 144,
              DVD_PAR)
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def equal_but_par(port, ref, par):
    """The port's file is the reference's (which says 1:1) with the pixel
    aspect `par` written: pasp, or DisplayWidth/DisplayHeight; the SPS's
    VUI aspect."""
    codec = {b"avc1": "h264", b"hvc1": "hevc", b"av01": "av1"}
    if port.endswith(".mp4"):
        got, want = mp4_boxes(_bytes(port)), mp4_boxes(_bytes(ref))
        pasp = [b for p, b in got if p[-1] == b"pasp"]
        assert pasp == [struct.pack(">II", *par)]
        assert not [p for p, _ in want if p[-1] == b"pasp"]
        got = [(p, b) for p, b in got if p[-1] != b"pasp"]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            if path[-1] in (b"avcC", b"hvcC"):
                c = codec[path[-2]]
                assert sar_of(c, g) == par and sar_of(c, w) is None
                assert strip_config_sar(g, c) == w
            else:
                assert g == w, path
        return
    pb, rb = _bytes(port), _bytes(ref)
    got, want = mkv_elements(pb), mkv_elements(rb)
    # the clusters move by what the Tracks element grew (the display
    # elements and the longer SPS in the CodecPrivate)
    cluster = bytes.fromhex("1f43b675")
    shift = pb.index(cluster) - rb.index(cluster)
    shown = {p[-1]: int.from_bytes(b, "big") for p, b in got
             if p[-1] in (0x54B0, 0x54BA)}
    pw = next(int.from_bytes(b, "big") for p, b in got if p[-1] == 0xB0)
    ph = next(int.from_bytes(b, "big") for p, b in got if p[-1] == 0xBA)
    assert (shown[0x54B0], shown[0x54BA]) == display_size(pw, ph, *par)
    assert not [p for p, _ in want if p[-1] in (0x54B0, 0x54BA)]
    got = [(p, b) for p, b in got if p[-1] not in (0x54B0, 0x54BA)]
    assert [p for p, _ in got] == [p for p, _ in want]
    kind = next(b for p, b in got if p[-1] == 0x86).decode()
    c = {"V_MPEG4/ISO/AVC": "h264", "V_MPEGH/ISO/HEVC": "hevc"}.get(kind)
    for (path, g), (_, w) in zip(got, want):
        if path[-1] == 0x63A2 and c:            # CodecPrivate
            assert sar_of(c, g) == par and sar_of(c, w) is None
            assert strip_config_sar(g, c) == w
        elif path[-1] == 0xF1:                  # CueClusterPosition
            assert int.from_bytes(g, "big") - int.from_bytes(w, "big") \
                == shift
        else:
            assert g == w, path


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def _dvd_job(Sm, path, out, mux, **kw):
    """The default preset's video settings: H.264 High at 28 and its
    peak-framerate shaper (30 fps)."""
    return Sm.Job(path=path, file=out, mux=mux, vcodec="h264",
                  quality=28.0, encoder_profile="high",
                  filters=[Sm.FilterSpec(Sm.FILTER_VFR, {
                      "mode": 2, "rate-num": 30, "rate-den": 1})], **kw)


@pytest.mark.parametrize("mux", ["mp4", "mkv"])
def test_dvd_job_equals_reference_but_its_par(srcs, tmp_path, mux):
    """The DVD's 16:9 PAL-rate header: the port's job (the automatic
    mode) keeps 176x144 at 16:11 and every 25 fps frame through the
    shaper; the reference's job on the same frames as a y4m writes the
    same file but for the aspect."""
    port, ref = str(tmp_path / f"port.{mux}"), str(tmp_path / f"ref.{mux}")
    stats = work.do_job(_dvd_job(S, srcs["dvd"], port, mux,
                                 anamorphic_mode=4), device="cpu")
    jstats = jwork.do_job(_dvd_job(JS, srcs["dvd_frames"], ref, mux))
    assert stats["frames_in"] == stats["frames_out"] == 4
    assert (stats["width"], stats["height"]) == (176, 144)
    assert stats["frames_out"] == jstats["frames_out"]
    equal_but_par(port, ref, DVD_PAR)


@pytest.mark.parametrize("codec,mux", [("h264", "mp4"), ("h264", "mkv"),
                                       ("x265", "mkv")])
def test_y4m_cli_job_equals_reference_but_its_par(srcs, tmp_path, codec,
                                                  mux):
    """The CLI's default preset on a 32:27 y4m (the automatic mode keeps
    96x64 at 32:27); the reference's CLI reads the tag and drops it."""
    port, ref = str(tmp_path / f"port.{mux}"), str(tmp_path / f"ref.{mux}")
    args = ["-i", srcs["par"], "-e", codec, "-q", "28", "--previews", "2"]
    assert cli([*args, "-o", port, "--device", "cpu"]) == 0
    assert jcli([*args, "-o", ref]) == 0
    equal_but_par(port, ref, PAR)


# ---------------------------------------------------------------------------
# the round trip
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec,mux", [
    ("h264", "mp4"), ("h264", "mkv"), ("x265", "mp4"), ("x265", "mkv"),
    ("svt_av1", "mp4"), ("svt_av1", "mkv")])
def test_scan_reads_back_the_par(srcs, tmp_path, codec, mux):
    """The port's scan reads the aspect its own files write: pasp,
    the VUI where the display size agrees with it, and for AV1 in
    Matroska (no VUI) the display size, whose width is rounded."""
    out = str(tmp_path / f"o.{mux}")
    assert cli(["-i", srcs["par"], "-o", out, "-e", codec, "-q", "28",
                "--previews", "2", "--device", "cpu"]) == 0
    t = scan_title(out, preview_count=1)
    got = (t.par_num, t.par_den)
    if (codec, mux) == ("svt_av1", "mkv"):
        assert got != PAR and display_size(W, H, *got) == \
            display_size(W, H, *PAR)
    else:
        assert got == PAR


# ---------------------------------------------------------------------------
# every path writes the same aspect
# ---------------------------------------------------------------------------
def _h264_job(path, out, **kw):
    return S.Job(**{**dict(path=path, file=out, mux="mp4", vcodec="h264",
                           quality=28.0, encoder_profile="high",
                           anamorphic_mode=4), **kw})


@pytest.mark.parametrize("path_kw", [
    dict(bframes=2, encoder_profile="auto"), dict(gop_parallel=2),
    dict(encoder_options="keyint=2")], ids=["bframes", "gop-parallel",
                                            "keyint"])
def test_job_paths_keep_the_par(srcs, tmp_path, path_kw):
    """A B-frame and a GOP-parallel job of the 32:27 y4m equal the same
    jobs of the 1:1 y4m but for the aspect."""
    outs = {}
    for k in ("par", "square"):
        outs[k] = str(tmp_path / f"{k}.mp4")
        work.do_job(_h264_job(srcs[k], outs[k], **path_kw), device="cpu")
    equal_but_par(outs["par"], outs["square"], PAR)


def test_resumed_job_keeps_the_par(srcs, tmp_path, monkeypatch):
    """A checkpointed job killed after its first GOP and resumed: the
    file equals the uninterrupted run, aspect included."""
    from test_torch_checkpoint import _crash, _cut
    out, full = str(tmp_path / "r.mp4"), str(tmp_path / "full.mp4")
    kw = dict(encoder_options="keyint=2")
    with monkeypatch.context() as m:
        _crash(m, "torch")
        work.do_job(_h264_job(srcs["par"], out, checkpoint=True, **kw),
                    device="cpu")
    _cut("torch", out + ".ckpt", 1)
    os.unlink(out)
    work.do_job(_h264_job(srcs["par"], out, resume=True, **kw),
                device="cpu")
    work.do_job(_h264_job(srcs["par"], full, **kw), device="cpu")
    assert _bytes(out) == _bytes(full)
    d = MP4Demuxer(out)
    assert (d.tracks[0].par_num, d.tracks[0].par_den) == PAR
    d.close()


def _gop_sars(streams):
    return [sar_of("h264", s) for s in streams]


def test_gop_parallel_ranks_write_the_par(tmp_path):
    """Each GOP's SPS carries the aspect, on one rank and over two ranks
    (GOP 1 is coded on rank 1): the streams equal the one-rank call's,
    and the 1:1 call's but for the aspect."""
    from torch_mesh_world import Call, spawn
    from handbrake_tpu_torch.parallel.gop import encode_gop_parallel
    from torch_par import strip_sar
    frames = make_clip(W, H, 6, seed=6)
    one = encode_gop_parallel(frames, W, H, 28, 2, device="cpu", sar=PAR)
    sq = encode_gop_parallel(frames, W, H, 28, 2, device="cpu")
    two = spawn(2, [Call("handbrake_tpu_torch.parallel.gop:"
                         "encode_gop_parallel", (frames, W, H, 28, 2),
                         {"device": "cpu", "sar": PAR})],
                workdir=str(tmp_path), limit_s=240, device="cpu")[0]
    assert two[0] == one[0]
    assert _gop_sars(one[0]) == [PAR, PAR] and _gop_sars(sq[0]) == [None,
                                                                    None]

    def square(stream):
        return [strip_sar(n, "h264") if n[0] & 0x1F == 7 else n
                for n in split_annexb(stream)]

    assert [square(s) for s in one[0]] == \
        [list(split_annexb(s)) for s in sq[0]]


@pytest.mark.parametrize("mux", ["mp4", "mkv"])
def test_controller_remux_keeps_the_par(srcs, tmp_path, mux):
    """The controller's segments (each a do_job of a range) carry the
    pasp, and its remux writes the aspect into the whole file: a pasp,
    or the display size (its mkv has no CodecPrivate, so the display
    size alone is read back, the width rounded)."""
    from handbrake_tpu_torch.parallel.controller import Controller
    segs = []
    for k, (a, b) in enumerate(((0, 2), (2, 4))):
        seg = str(tmp_path / f"seg{k}.mp4")
        work.do_job(_h264_job(srcs["par"], seg, range=S.RangeSpec(
            "frame", a, b)), device="cpu")
        segs.append(_bytes(seg))
    out = str(tmp_path / f"whole.{mux}")
    Controller._mux_segments(segs, out)
    d = (MP4Demuxer if mux == "mp4" else MKVDemuxer)(out)
    got = (d.tracks[0].par_num, d.tracks[0].par_den)
    d.close()
    if mux == "mp4":
        assert got == PAR
    else:
        assert display_size(W, H, *got) == display_size(W, H, *PAR)


# ---------------------------------------------------------------------------
# a pixel aspect that cannot be written
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["h264", "x265", "svt_av1"])
def test_par_beyond_16_bits_is_refused(srcs, tmp_path, codec):
    """70001:3 reduces to itself, over 16 bits: the job refuses before
    any file, naming it (the reference's H.264 job resolves it and
    drops it)."""
    kw = dict(path=srcs["square"], mux="mkv", vcodec=codec, quality=28.0,
              anamorphic_mode=3, par_num=70001, par_den=3)
    out = str(tmp_path / "o.mkv")
    with pytest.raises(WorkError, match="70001:3 .* 16-bit"):
        work.do_job(S.Job(file=out, **kw), device="cpu")
    assert not os.path.exists(out)
    if codec == "h264":
        ref = str(tmp_path / "ref.mkv")
        jwork.do_job(JS.Job(file=ref, **kw))
        assert os.path.exists(ref)
