"""An H.264 or HEVC track's frame rate read from its stream (ROADMAP
3.17), on the CPU, each case beside the JAX package's unchanged label:

- annex-B (``.264``, ``.265``): the port's reader takes the rate the
  SPS's VUI states (H.264 time_scale / 2 num_units_in_tick, HEVC
  time_scale / num_units_in_tick, reduced), and its ``fps``, duration
  and every access unit's pts follow it; the reference labels every
  stream 25 fps.  An HEVC SPS without timing takes the VPS's.  A stream
  that states no rate, or a zero term, or whose VUI cannot be read,
  keeps 25 with a log line;
- PS (H.264) and TS (H.264 and HEVC): the title's label is the stream's
  rate, the PES timestamps stay as they are (every packet equal to the
  reference's); the reference labels each 30000/1001;
- jobs: the file carries the rate in the coded VUI and in the mp4
  ``stts`` or the mkv ``DefaultDuration``, and the default preset's
  peak-rate shaper (30 fps) brings a 50 fps stream to 30 fps at its own
  length (ROADMAP 3.20), where the reference, given the stream's rate,
  halves it.

The streams are the port's own encoders' on the CPU (64x64, three to
six frames), laid into PS and TS by ``tools/source_builders.py``; the
HEVC VPS with timing, and the SPSs without timing or with a zero term,
are written by the bit writers of this file and of the port's encoders:
no independent encoder wrote them."""
import functools
from fractions import Fraction

import pytest

from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.scan import scan_title as jscan
from handbrake_tpu.sources.ps import PSDemuxer as JPSDemuxer
from handbrake_tpu.sources.raw import AnnexBReader as JAnnexBReader
from handbrake_tpu.sources.ts import TSDemuxer as JTSDemuxer
from handbrake_tpu_torch import work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.codecs import vui
from handbrake_tpu_torch.codecs.h264.bits import split_annexb
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.codecs.hevc import encoder as hevc
from handbrake_tpu_torch.codecs.hevc.syntax import NAL_VPS, nal_unit
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.scan import scan_title
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.sources.ps import PSDemuxer
from handbrake_tpu_torch.sources.raw import AnnexBReader
from handbrake_tpu_torch.sources.ts import TSDemuxer
from handbrake_tpu_torch.tools import source_builders as B
from handbrake_tpu_torch.utils.synth import make_clip
from torch_par import mkv_elements, mp4_boxes
from torch_rates import reference_reads_rate  # noqa: F401  (a fixture)

W = H = 64
N = 3
T0 = 90000
RATES = {"24000/1001": (24000, 1001), "25": (25, 1), "50": (50, 1),
         "30000/1001": (30000, 1001)}
HEVC_RATES = ("24000/1001", "50")


def _encoder(codec, fps):
    if codec == "h264":
        return H264Encoder(EncoderConfig(width=W, height=H, qp=30, gop=N,
                                         fps=fps), device="cpu")
    return hevc.HEVCEncoder(hevc.EncoderConfig(width=W, height=H, qp=30,
                                               gop=N, fps=fps), device="cpu")


@functools.lru_cache(None)
def aus(codec, rate, n=N):
    """The port's access units of ``n`` frames stating ``RATES[rate]``."""
    enc = _encoder(codec, RATES[rate])
    return tuple(enc.encode_frame(*f) for f in make_clip(W, H, n, seed=6))


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _es(tmp_path, codec, rate, n=N):
    return _write(tmp_path, f"s.{'264' if codec == 'h264' else '265'}",
                  b"".join(aus(codec, rate, n)))


def _ticks(rate, i):
    num, den = RATES[rate]
    return i * 90000 * den // num


def _packets(d):
    try:
        return [(trk, b.pts, b.dts, b.duration, bytes(b.data))
                for trk, b in d.packets()]
    finally:
        d.close()


# -- annex-B ------------------------------------------------------------------
@pytest.mark.parametrize("codec,rate", [("h264", r) for r in RATES]
                         + [("hevc", r) for r in HEVC_RATES])
def test_annexb_rate_beside_reference(tmp_path, codec, rate, capfd):
    es = _es(tmp_path, codec, rate)
    capfd.readouterr()
    r = AnnexBReader(es, codec)
    assert f"annex-B: {codec} {'/'.join(map(str, RATES[rate]))} fps from " \
        f"the SPS's VUI" in capfd.readouterr().err
    fps = Fraction(*RATES[rate])
    assert r.fps == fps and r.tracks[0].frame_rate == RATES[rate]
    assert r.duration == int(N * 90000 / fps)
    pk = [(b.pts, b.duration) for _t, b in r.packets()]
    assert pk == [(int(i * 90000 / fps), int((i + 1) * 90000 / fps)
                   - int(i * 90000 / fps)) for i in range(N)]
    j = JAnnexBReader(es, codec)
    assert j.fps == 25 and j.tracks[0].frame_rate == (25, 1)
    assert [b.pts for _t, b in j.packets()] == [3600 * i for i in range(N)]


def _hevc_vps_with_timing(nu, scale) -> bytes:
    """A VPS NAL unit (annex-B) as the port's HEVC encoder writes it, but
    with vps_timing_info_present_flag set and (nu, scale)."""
    bits = []

    def put(v, n):
        bits.append(format(v, f"0{n}b") if n else "")

    def ue(v):
        x = v + 1
        put(0, x.bit_length() - 1)
        put(x, x.bit_length())
    put(0, 4)
    put(3, 2)
    put(0, 6)
    put(0, 3)
    put(1, 1)
    put(0xFFFF, 16)
    put(0, 3)
    put(1, 5)                          # general profile: Main
    put(1 << 30, 32)
    put(0b1011, 4)
    put(0, 44)
    put(120, 8)                        # level 4
    put(1, 1)
    ue(1)
    ue(0)
    ue(0)
    put(0, 6)
    ue(0)
    put(1, 1)                          # vps_timing_info_present_flag
    put(nu, 32)
    put(scale, 32)
    put(0, 1)                          # vps_poc_proportional_to_timing
    ue(0)                              # vps_num_hrd_parameters
    put(0, 1)                          # vps_extension
    s = "".join(bits) + "1"
    s += "0" * (-len(s) % 8)
    return nal_unit(NAL_VPS, int(s, 2).to_bytes(len(s) // 8, "big"))


def test_hevc_rate_from_the_vps(tmp_path, capfd):
    """An HEVC SPS with no VUI and a VPS with timing: the rate is the
    VPS's, as libavcodec's HEVC decoder takes it; the reference's 25."""
    enc = _encoder("hevc", (30000, 1001))
    enc.sps.vui_timing = None          # no VUI at all
    enc.vps.to_nal = lambda: _hevc_vps_with_timing(1001, 60000)
    es = _write(tmp_path, "vps.265", b"".join(
        enc.encode_frame(*f) for f in make_clip(W, H, N, seed=6)))
    with open(es, "rb") as f:
        data = f.read()
    assert vui.stream_vui("hevc", data)["timing"] is None
    assert vui.stream_rate("hevc", data) == (Fraction(60000, 1001),
                                             "the VPS")
    capfd.readouterr()
    assert AnnexBReader(es, "hevc").fps == Fraction(60000, 1001)
    assert "hevc 60000/1001 fps from the VPS" in capfd.readouterr().err
    assert JAnnexBReader(es, "hevc").fps == 25


@pytest.mark.parametrize("timing,why", [
    ((), "no timing in the SPS's VUI"),
    ((0, 48000), "the SPS's VUI states num_units_in_tick 0 and time_scale "
     "48000, which is no rate"),
    ((1001, 0), "the SPS's VUI states num_units_in_tick 1001 and "
     "time_scale 0, which is no rate")],
    ids=["none", "zero-tick", "zero-scale"])
def test_no_rate_keeps_25_fps(tmp_path, capfd, timing, why):
    enc = _encoder("h264", (24000, 1001))
    enc.sps.vui_timing = timing
    es = _write(tmp_path, "t.264", b"".join(
        enc.encode_frame(*f) for f in make_clip(W, H, N, seed=6)))
    capfd.readouterr()
    r = AnnexBReader(es)
    err = capfd.readouterr().err
    assert f"annex-B: h264: {why}; the track keeps 25/1 fps" in err
    assert r.fps == JAnnexBReader(es).fps == 25
    assert _packets(r) == _packets(JAnnexBReader(es))


def test_unreadable_vui_is_logged_and_keeps_25_fps(tmp_path, capfd):
    """An SPS cut inside its VUI: the size still reads, the rate does
    not, and the log says why; the track opens at 25 fps."""
    au = aus("h264", "24000/1001")[0]
    nals = list(split_annexb(au))
    sps = next(n for n in nals if n[0] & 0x1F == 7)
    cut = sps[:-6]                    # into the VUI's time_scale
    es = _write(tmp_path, "cut.264", au.replace(sps, cut)
                + b"".join(aus("h264", "24000/1001")[1:]))
    capfd.readouterr()
    r = AnnexBReader(es)
    err = capfd.readouterr().err
    assert "annex-B: h264: h264: the SPS cannot be read up to its VUI" in err
    assert "the track keeps 25/1 fps" in err
    assert (r.fps, r.tracks[0].width, r.tracks[0].height) == (25, W, H)


# -- PS and TS ----------------------------------------------------------------
def _ps(tmp_path, rate):
    units = [(T0 + _ticks(rate, i), 0xE0, au, None, T0 + _ticks(rate, i))
             for i, au in enumerate(aus("h264", rate))]
    return _write(tmp_path, "s.mpg", B.build_ps(units))


def _ts(tmp_path, codec, rate, n=N):
    units = [(T0 + _ticks(rate, i), 0x100, 0xE0, au, T0 + _ticks(rate, i))
             for i, au in enumerate(aus(codec, rate, n))]
    return _write(tmp_path, "s.ts", B.build_ts(
        [(0x1B if codec == "h264" else 0x24, 0x100, b"")], units))


@pytest.mark.parametrize("rate", list(RATES))
def test_ps_rate_beside_reference(tmp_path, rate, capfd):
    src = _ps(tmp_path, rate)
    capfd.readouterr()
    d = PSDemuxer(src)
    assert d.tracks[0].frame_rate == RATES[rate]
    assert f"ps: stream 0xe0 h264 {'/'.join(map(str, RATES[rate]))} fps " \
        f"from the SPS's VUI" in capfd.readouterr().err
    j = JPSDemuxer(src)
    assert j.tracks[0].frame_rate == (30000, 1001)
    assert _packets(d) == _packets(j)


@pytest.mark.parametrize("codec,rate", [("h264", r) for r in RATES]
                         + [("hevc", r) for r in HEVC_RATES])
def test_ts_rate_beside_reference(tmp_path, codec, rate, capfd):
    src = _ts(tmp_path, codec, rate)
    capfd.readouterr()
    d = TSDemuxer(src)
    assert d.tracks[0].frame_rate == RATES[rate]
    assert f"ts: pid 0x100 {codec} {'/'.join(map(str, RATES[rate]))} fps " \
        f"from the SPS's VUI" in capfd.readouterr().err
    j = JTSDemuxer(src)
    assert j.tracks[0].frame_rate == (30000, 1001)
    assert _packets(d) == _packets(j)


# -- jobs ---------------------------------------------------------------------
def _job(src, out, mux, vcodec="h264"):
    return S.Job(path=src, file=out, mux=mux, vcodec=vcodec, quality=30.0)


def _mp4_video(path):
    """(mdhd timescale, stts durations, avcC/hvcC) of an mp4's video."""
    with open(path, "rb") as f:
        boxes = mp4_boxes(f.read())
    mdhd = next(p for k, p in boxes if k[-1] == b"mdhd")
    stts = next(p for k, p in boxes if k[-1] == b"stts")
    durs = []
    for i in range(int.from_bytes(stts[4:8], "big")):
        e = stts[8 + 8 * i:16 + 8 * i]
        durs += [int.from_bytes(e[4:], "big")] * int.from_bytes(e[:4], "big")
    d = MP4Demuxer(path)
    try:
        config = bytes(d.tracks[0].extradata)
    finally:
        d.close()
    return int.from_bytes(mdhd[12:16], "big"), durs, config


def _mkv_video(path):
    """(DefaultDuration ns, CodecPrivate) of an mkv's video track."""
    with open(path, "rb") as f:
        els = mkv_elements(f.read())
    dd = next(p for k, p in els if k[-1] == 0x23E383)
    d = MKVDemuxer(path)
    try:
        config = bytes(d.tracks[0].extradata)
    finally:
        d.close()
    return int.from_bytes(dd, "big"), config


def test_annexb_24p_job_carries_the_rate(tmp_path):
    """A 24000/1001 .264 to mp4 and mkv: the coded VUI states 24000/1001,
    the mp4 samples last 3753-3754 ticks of 90 kHz and the mkv's default
    duration is 41.708 ms; the reference's scan says 25."""
    es = _es(tmp_path, "h264", "24000/1001")
    mp4, mkv = str(tmp_path / "o.mp4"), str(tmp_path / "o.mkv")
    work.do_job(_job(es, mp4, "mp4"), device="cpu")
    work.do_job(_job(es, mkv, "mkv"), device="cpu")
    scale, durs, avcc = _mp4_video(mp4)
    assert vui.stream_rate("h264", avcc)[0] == Fraction(24000, 1001)
    assert scale == 90000 and len(durs) == N
    assert durs[:-1] == [_ticks("24000/1001", i + 1) - _ticks(
        "24000/1001", i) for i in range(N - 1)]
    dd, avcc = _mkv_video(mkv)
    assert dd == int(1e9 * 1001 / 24000)
    assert vui.stream_rate("h264", avcc)[0] == Fraction(24000, 1001)
    assert (scan_title(es, preview_count=1).vrate_num,
            jscan(es, preview_count=1).vrate_num) == (24000, 25)


@pytest.mark.parametrize("codec,vcodec", [("h264", "h264"),
                                          ("hevc", "hevc")])
def test_ts_25p_job_carries_the_rate(tmp_path, codec, vcodec):
    """A 25 fps TS to mkv: DefaultDuration 40 ms and a coded VUI of 25
    fps, where the reference labels the track 30000/1001."""
    src = _ts(tmp_path, codec, "25")
    out = str(tmp_path / "o.mkv")
    stats = work.do_job(_job(src, out, "mkv", vcodec), device="cpu")
    assert stats["frames_out"] == N
    dd, config = _mkv_video(out)
    assert dd == 40000000
    assert vui.stream_rate(vcodec, config)[0] == 25
    j = JTSDemuxer(src)
    try:
        assert j.tracks[0].frame_rate == (30000, 1001)
    finally:
        j.close()


@pytest.mark.parametrize("rate,ref_kept", [("50", 3), ("25", 6)])
def test_default_preset_shapes_from_the_true_rate(tmp_path, rate, ref_kept,
                                                  reference_reads_rate,
                                                  monkeypatch):
    """The CLI's default preset (Fast 1080p30: peak rate 30) on a .264 of
    6 frames.  At 50 fps the port's peak-rate shaper keeps frames 0, 1,
    3 and 5, each 3000 ticks long (30 of every 50 frames, the source's
    length kept), and the coded VUI states 30; the reference, given the
    stream's 50 fps, keeps 3 frames with their own 1800 ticks and states
    50.  At 25 fps both keep every frame with its own 3600 ticks."""
    es = _es(tmp_path, "h264", rate, n=6)
    out, ref = str(tmp_path / "o.mp4"), str(tmp_path / "ref.mp4")
    assert cli(["-i", es, "-o", out, "--device", "cpu"]) == 0
    assert jcli(["-i", es, "-o", ref]) == 0
    _scale, durs, avcc = _mp4_video(out)
    _scale, ref_durs, ref_avcc = _mp4_video(ref)
    if rate == "50":
        assert durs == [3000] * 4
        assert vui.stream_rate("h264", avcc)[0] == 30
        assert ref_durs == [1800] * ref_kept
    else:
        assert durs == ref_durs == [3600] * ref_kept
        assert vui.stream_rate("h264", avcc)[0] == 25
    assert vui.stream_rate("h264", ref_avcc)[0] == int(rate)
    monkeypatch.undo()                 # the reference left alone reads 25
    assert JAnnexBReader(es).fps == 25
